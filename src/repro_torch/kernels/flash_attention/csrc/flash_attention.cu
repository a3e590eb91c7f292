// Tiled online-softmax attention (flash attention): the forward, which can
// also write each query row's log-sum-exp, and its backward (at the end).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_attn_kernel): grid (B, H, Sq/BQ, Sk/BK) with the KV axis sequential and
// the running max, sum and accumulator in VMEM scratch.  Same semantics:
// query and key positions both count from 0; query head h reads KV head
// h / (H/KV) without repeating K/V in memory; logits are scaled, then
// soft-capped (cap * tanh(s / cap)), then masked to -1e30 (causal: key <=
// query; window: query - key < window); the output is acc / max(l, 1e-30)
// in q's type.  Unlike the Pallas kernel, any Sq and Sk work: keys past Sk
// get a logit of -inf (weight exactly 0) and query rows past Sq are not
// stored.  Both variants walk only the K tiles that the causal/window mask
// leaves live (Pallas's pl.when skip: at S=4096, window 2048, 62.5% of the
// pairs are masked and nearly all of them in skipped tiles).
//
// What bounds it on an H100: at the main path's shape (B=4, S=4096, H=10,
// KV=1, hd=256, window 2048, causal, bf16) the live (q, k) pairs need
// 4*hd flops each, about 258 GFLOP, against about 185 MB of q/k/v/o: it is
// bound by operations, 0.26 ms at the bf16 tensor-core peak.
//
// bfloat16 (the serving path): a warp-specialised Hopper kernel.  One CTA
// of 384 threads per (128-row Q tile, head, batch): a producer warpgroup
// whose first warp issues TMA loads (Q once; K and V tiles of 64 keys into
// a ring of two stages, each completed on its own mbarrier), and two
// consumer warpgroups of 64 query rows each.  setmaxnreg moves registers
// from the producer (24) to the consumers (240).  Per K tile a consumer
// computes S = Q K^T with wgmma.m64n64k16 (both operands in shared memory,
// K-major, 128-byte swizzled as TMA writes them), keeps S in f32 registers,
// runs the online softmax there (row max and sum over the 4 threads that
// share a row, with shuffles; exp2 of logits pre-scaled by log2 e), rounds
// P to bf16 in registers and feeds it as the register A operand of
// wgmma.m64n{HDP}k16 with V as the shared-memory B operand, transposed
// (V is row-major, so its N axis is contiguous).  O stays in registers
// (64 x 256 f32 per consumer: 128 per thread).  The mask is applied only
// on edge tiles; a consumer skips the products of a tile wholly masked for
// its 64 rows.  hd is padded to HDP = 64, 128 or 256: TMA zero-fills the
// columns past hd and the store writes only columns < hd.  The grid puts
// the heads of one (q tile, batch) next to each other, so the CTAs that
// share a KV head run together and read K/V from L2.
//
// float32 (off the serving paths): one CTA of 256 threads per (32-row Q
// tile, head, batch), Q/K/V tiles, S, P and the accumulator in shared
// memory, f32 FMAs on the CUDA cores, so f32 keeps f32 accuracy.

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's masked logit

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KV, hd;
  int causal, window;  // window <= 0: no window
  float scale, cap;    // cap <= 0: no soft-cap
  // (B, H, Sq) natural-log log-sum-exp of each row's scaled, capped,
  // masked scores, for the backward; null: not written (the serving path)
  float* lse;
};

// K tiles [lo, hi) of a Q tile of rows [q0, q0 + BQ) with tiles of BK keys:
// tiles wholly above the diagonal or wholly outside the window are not
// live (an empty range leaves the rows' output 0)
template <int BQ, int BK, class A>
__host__ __device__ inline void live_tiles(const A& a, int q0, int& lo,
                                           int& hi) {
  const int nk = (a.Sk + BK - 1) / BK;
  hi = nk;
  if (a.causal && (q0 + BQ - 1) / BK + 1 < nk) hi = (q0 + BQ - 1) / BK + 1;
  lo = 0;
  if (a.window > 0 && q0 - a.window - (BK - 1) >= 0)
    lo = (q0 - a.window - (BK - 1)) / BK + 1;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BQ = 32, kF32BK = 32;

struct F32Layout {
  int ldq, lds, ldo;
  __host__ __device__ explicit F32Layout(int hd)
      : ldq(hd + 1), lds(kF32BK + 1), ldo(hd + 4) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)(kF32BQ + 2 * kF32BK) * ldq +
                            2 * (size_t)kF32BQ * lds + (size_t)kF32BQ * ldo);
  }
};

// rows [s0, s0 + R) of head `head` of a (B, S, NH, hd) tensor into smem
// (row stride ld); rows past S are zero
template <int R>
__device__ void load_rows_f32(float* dst, int ld, const float* src, int b,
                              int s0, int S, int NH, int head, int hd) {
  for (int e = threadIdx.x; e < R * hd; e += kF32Threads) {
    const int r = e / hd, c = e % hd;
    const int s = s0 + r;
    dst[r * ld + c] = s < S ? src[(((size_t)b * S + s) * NH + head) * hd + c]
                            : 0.f;
  }
}

__global__ void __launch_bounds__(kF32Threads, 1)
    flash_f32_kernel(const Args a) {
  constexpr int BQ = kF32BQ, BK = kF32BK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = a.hd;
  const F32Layout lay(hd);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * lay.ldq;
  float* Vs = Ks + BK * lay.ldq;
  float* Ss = Vs + BK * lay.ldq;
  float* Ps = Ss + BQ * lay.lds;
  float* Os = Ps + BQ * lay.lds;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  // softmax layout: TPR threads per query row, columns interleaved
  constexpr int TPR = kF32Threads / BQ;
  constexpr int CPT = BK / TPR;
  static_assert(TPR * BQ == kF32Threads && CPT * TPR == BK && TPR <= 32, "");
  const int srow = tid / TPR, spart = tid % TPR;
  const int qpos = q0 + srow;
  float m_run = kMasked, l_run = 0.f;

  load_rows_f32<BQ>(Qs, lay.ldq, q, b, q0, a.Sq, a.H, h, hd);
  for (int e = tid; e < BQ * lay.ldo; e += kF32Threads) Os[e] = 0.f;

  int lo, hi;
  live_tiles<BQ, BK>(a, q0, lo, hi);
  for (int ik = lo; ik < hi; ++ik) {
    const int k0 = ik * BK;
    load_rows_f32<BK>(Ks, lay.ldq, k, b, k0, a.Sk, a.KV, kvh, hd);
    load_rows_f32<BK>(Vs, lay.ldq, v, b, k0, a.Sk, a.KV, kvh, hd);
    __syncthreads();

    // S = Q K^T (raw dot products)
    for (int e = tid; e < BQ * BK; e += kF32Threads) {
      const int r = e / BK, c = e % BK;
      const float* qr = Qs + r * lay.ldq;
      const float* kr = Ks + c * lay.ldq;
      float acc = 0.f;
      for (int dd = 0; dd < hd; ++dd) acc = fmaf(qr[dd], kr[dd], acc);
      Ss[r * lay.lds + c] = acc;
    }
    __syncthreads();

    // online softmax over this tile, one row per TPR threads
    {
      float s[CPT];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = spart + TPR * j;
        const int kpos = k0 + c;
        float sv = Ss[srow * lay.lds + c] * a.scale;
        if (a.cap > 0.f) sv = a.cap * tanhf(sv / a.cap);
        if (kpos >= a.Sk)
          sv = -INFINITY;  // ragged edge: no weight at all
        else if ((a.causal && qpos < kpos) ||
                 (a.window > 0 && qpos - kpos >= a.window))
          sv = kMasked;
        s[j] = sv;
        mt = fmaxf(mt, sv);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run, mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(s[j] - m_new);
        Ps[srow * lay.lds + spart + TPR * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + rs;
      m_run = m_new;
      for (int c = spart; c < hd; c += TPR) Os[srow * lay.ldo + c] *= alpha;
    }
    __syncthreads();

    // O += P V
    for (int e = tid; e < BQ * hd; e += kF32Threads) {
      const int r = e / hd, c = e % hd;
      float acc = Os[r * lay.ldo + c];
      for (int j = 0; j < BK; ++j)
        acc = fmaf(Ps[r * lay.lds + j], Vs[j * lay.ldq + c], acc);
      Os[r * lay.ldo + c] = acc;
    }
    __syncthreads();
  }

  if (qpos < a.Sq) {
    const float denom = fmaxf(l_run, 1e-30f);
    float* out = static_cast<float*>(a.o) + (((size_t)b * a.Sq + qpos) * a.H + h) * hd;
    for (int c = spart; c < hd; c += TPR) out[c] = Os[srow * lay.ldo + c] / denom;
    if (a.lse != nullptr && spart == 0)
      a.lse[((size_t)b * a.H + h) * a.Sq + qpos] = m_run + logf(l_run);
  }
}

int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = F32Layout(a.hd).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + kF32BQ - 1) / kF32BQ, a.H, a.B);
  flash_f32_kernel<<<grid, kF32Threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: Hopper (TMA, mbarrier, wgmma, setmaxnreg)
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;           // Q rows per CTA: two consumers of 64
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kBox = 64 * 64 * 2;  // one 64-row x 64-column bf16 TMA box
constexpr int kThreadsTC = 384;    // producer warpgroup + two consumers
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte aligned boxes).  K-major
// operands (Q, K): rows of 128 bytes, 8-row groups SBO = 1024 bytes apart,
// LBO unused; a k-step of 16 columns moves the start by 32 bytes.
// MN-major operand (V, transposed): 8-key groups SBO = 1024 bytes apart,
// 64-column boxes LBO = kBox bytes apart; a k-step of 16 keys moves the
// start by 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t desc = (uint64_t)((saddr & 0x3FFFFu) >> 4);
  desc |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
  desc |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
  desc |= (uint64_t)1 << 62;  // SWIZZLE_128B
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving register accesses across an async wgmma
template <int N>
__device__ __forceinline__ void pin_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs_m64n256k16(float* d, const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// O += P V for one k-step of 16 keys: wgmma.m64n{HDP}k16, A = P in registers
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HDP == 64) wgmma_rs_m64n64k16(o, a, db);
  if constexpr (HDP == 128) wgmma_rs_m64n128k16(o, a, db);
  if constexpr (HDP == 256) wgmma_rs_m64n256k16(o, a, db);
}

// Shared memory of the Hopper kernel, offsets from a 1024-byte aligned base:
// Q [consumer][box][64 rows][128 B], then per stage K [box][64 keys][128 B]
// and V [box][64 keys][128 B], then the mbarriers.
template <int HDP>
struct TcLayout {
  static constexpr int NB = HDP / 64;  // 64-column boxes per row
  static constexpr int Q = 0;
  static constexpr int K = Q + 2 * NB * kBox;
  static constexpr int V = K + kStages * NB * kBox;
  static constexpr int BAR = V + kStages * NB * kBox;
  // q_full, k_full[S], v_full[S], empty[S]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * kStages);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// kLse: also store each row's log-sum-exp (the training forward); the
// serving forward (a null lse) runs the instantiation without the store,
// whose code is the kernel as it was before the store existed
template <int HDP, bool kLse>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV, const Args a) {
  using L = TcLayout<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // 0: producer, 1 and 2: consumers
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int kvh = h / (a.H / a.KV);
  int lo, hi;
  live_tiles<kBQ, kBK>(a, q0, lo, hi);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, 2 * NB * kBox);
      for (int c = 0; c < 2; ++c)
        for (int x = 0; x < NB; ++x)
          tma_load_4d(base + L::Q + (c * NB + x) * kBox, &tmQ, q_full, x * 64,
                      h, q0 + c * 64, b);
      for (int t = 0; t < hi - lo; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, ((t / kStages) - 1) & 1);
        const int k0 = (lo + t) * kBK;
        mbar_expect_tx(k_full + 8 * s, NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(base + L::K + (s * NB + x) * kBox, &tmK, k_full + 8 * s,
                      x * 64, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * s, NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(base + L::V + (s * NB + x) * kBox, &tmV, v_full + 8 * s,
                      x * 64, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int c = wg - 1;
    const int w = warp % 4, g = lane / 4, t4 = lane % 4;
    const int rq = q0 + c * 64 + w * 16 + g;  // this thread's rows: rq, rq + 8
    const int qa = q0 + c * 64, qb = qa + 63;  // the consumer's rows
    const float sl2 = a.scale * kLog2e;
    const float s_cap = a.cap > 0.f ? a.scale / a.cap : 0.f;
    const float cap_l2 = a.cap * kLog2e;

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
    const uint32_t qs = base + L::Q + c * NB * kBox;
    mbar_wait(q_full, 0);

    for (int t = 0; t < hi - lo; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int k0 = (lo + t) * kBK;
      mbar_wait(k_full + 8 * s, par);
      // a tile wholly masked for these 64 rows adds exactly nothing to rows
      // that see a live key elsewhere: skip its products
      const bool dead = (a.causal && k0 > qb) ||
                        (a.window > 0 && qa - (k0 + kBK - 1) >= a.window);
      if (dead) {
        mbar_wait(v_full + 8 * s, par);
        mbar_arrive(empty + 8 * s);
        continue;
      }
      // ---- S = Q K^T ----
      float sc[32];
      const uint32_t ks = base + L::K + s * NB * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_m64n64k16(sc, wgmma_desc(qs + off, 16, 1024),
                           wgmma_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      pin_regs<32>(sc);

      // ---- online softmax in registers (log2 domain) ----
      const bool edge = (k0 + kBK > a.Sk) || (a.causal && k0 + kBK - 1 > qa) ||
                        (a.window > 0 && qb - k0 >= a.window);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * i + e];
          x = a.cap > 0.f ? cap_l2 * tanhf(x * s_cap) : x * sl2;
          if (edge) {
            const int qp = rq + (e >> 1) * 8;
            const int kp = k0 + 8 * i + 2 * t4 + (e & 1);
            if (kp >= a.Sk)
              x = -INFINITY;  // ragged edge: no weight at all
            else if ((a.causal && qp < kp) ||
                     (a.window > 0 && qp - kp >= a.window))
              x = kMasked;
          }
          sc[4 * i + e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m_run[r], mt[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      uint32_t pa[4][4];  // P as the A operand of 4 k-steps of 16 keys
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(sc[4 * i + e] - m_run[e >> 1]);
          l_run[e >> 1] += p[e];
        }
        pa[i / 2][(i % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        o[4 * i + 0] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }

      // ---- O += P V ----
      mbar_wait(v_full + 8 * s, par);
      const uint32_t vs = base + L::V + s * NB * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<HDP>(o, pa[kk], wgmma_desc(vs + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait0();
      pin_regs<HDP / 2>(o);
      mbar_arrive(empty + 8 * s);
    }

    // ---- O / l, rows < Sq and columns < hd only ----
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qp = rq + 8 * r;
      if constexpr (kLse) {
        if (t4 == 0 && qp < a.Sq)  // log2 domain -> ln
          a.lse[((size_t)b * a.H + h) * a.Sq + qp] =
              (m_run[r] + log2f(l)) * 0.6931471805599453f;
      }
      if (qp < a.Sq) {
        __nv_bfloat16* row = out + (((size_t)b * a.Sq + qp) * a.H + h) * a.hd;
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          const int col = 8 * i + 2 * t4;
          if (col < a.hd)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps through the driver entry point (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Make the device that holds p current on this thread:
// cuTensorMapEncodeTiled needs a current context, which a thread that has
// made no CUDA call yet (the autograd engine's, for one) lacks.
bool bind_device(const void* p) {
  cudaPointerAttributes attr;
  return cudaPointerGetAttributes(&attr, p) == cudaSuccess &&
         cudaSetDevice(attr.device) == cudaSuccess;
}

// bf16 tensor of `dims` (innermost first) with byte strides of dims 1..n-1,
// read in boxes of `box`, 128-byte swizzled, zeros past every edge
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B, S, NH, hd) bf16 read as 64-row x 64-column boxes of one head
bool make_bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int NH,
                   int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)NH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)NH * hd * 2,
                                 (cuuint64_t)S * NH * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return make_map(map, ptr, 4, dims, strides, box);
}

template <int HDP>
int launch_tc(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!bind_device(a.q) || !make_bshd_map(&tq, a.q, a.B, a.Sq, a.H, a.hd) ||
      !make_bshd_map(&tk, a.k, a.B, a.Sk, a.KV, a.hd) ||
      !make_bshd_map(&tv, a.v, a.B, a.Sk, a.KV, a.hd))
    return (int)cudaErrorInvalidValue;
  const int smem = TcLayout<HDP>::ALLOC;
  auto kern = a.lse != nullptr ? flash_tc_kernel<HDP, true>
                                : flash_tc_kernel<HDP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, (a.Sq + kBQ - 1) / kBQ, a.B);
  kern<<<grid, kThreadsTC, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// probe: the two shared-memory layouts and the register A operand, alone.
// s = A B^T (wgmma.m64n64k16, both operands K-major from TMA boxes) and
// o = A V (wgmma.m64n256k16, A from registers, V MN-major across four
// boxes): the descriptors, fragments and maps the attention kernel uses.
// A (64, 64), B (64, 64), V (64, 256) bf16 row-major; s (64, 64), o (64,
// 256) f32.  One CTA of one warpgroup.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128, 1)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB,
                       const __grid_constant__ CUtensorMap tmV,
                       const __nv_bfloat16* A, float* s_out, float* o_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base, sb = base + kBox, sv = base + 2 * kBox;
  const uint32_t bar = base + 6 * kBox;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 6 * kBox);
    tma_load_4d(sa, &tmA, bar, 0, 0, 0, 0);
    tma_load_4d(sb, &tmB, bar, 0, 0, 0, 0);
    for (int x = 0; x < 4; ++x)
      tma_load_4d(sv + x * kBox, &tmV, bar, x * 64, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  float sc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_m64n64k16(sc, wgmma_desc(sa + kk * 32, 16, 1024),
                       wgmma_desc(sb + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  pin_regs<32>(sc);

  // A's register fragments, read from global memory
  uint32_t pa[4][4];
  const int r0 = w * 16 + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + (j & 1) * 8, col = kk * 16 + (j >> 1) * 8 + 2 * t4;
      pa[kk][j] = *reinterpret_cast<const uint32_t*>(A + row * 64 + col);
    }
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  pin_regs<16>(&pa[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_m64n256k16(o, pa[kk], wgmma_desc(sv + kk * 2048, kBox, 1024));
  wgmma_commit();
  wgmma_wait0();
  pin_regs<128>(o);

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(r0 + (e >> 1) * 8) * 64 + 8 * i + 2 * t4 + (e & 1)] = sc[4 * i + e];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(r0 + (e >> 1) * 8) * 256 + 8 * i + 2 * t4 + (e & 1)] = o[4 * i + e];
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
//
// No TPU kernel to replace: the JAX package has no backward kernel and
// trains by differentiating its plain attention
// (src/repro/models/layers.py::attention) with jax.grad.  Here the forward
// is a hand-written kernel, so its gradient is one too.  With P_ij =
// exp(S_ij - lse_i) recomputed from the forward's log-sum-exp (S the
// scaled, capped, masked scores; P = 0 on masked pairs) and D_i = dO_i . O_i:
//   dV_j = sum_i P_ij dO_i                dP_ij = dO_i . V_j
//   dS_ij = P_ij (dP_ij - D_i) (1 - tanh^2(s_ij / cap)) scale
//   dQ_i = sum_j dS_ij K_j                dK_j = sum_i dS_ij Q_i
// (the tanh factor is 1 without a cap), dK and dV of a KV head summed over
// the H/KV query heads that read it.  Three launches (four under GQA/MQA):
//   flash_bwd_delta: D, one warp a (batch, query, head) row;
//   dK/dV: one block per key tile and query head; it loops over the query
//     tiles that the causal mask and the window leave live, with dK and dV
//     in registers, and stores them (H == KV) or its head's float32
//     partials, (B, Sk, H, hd) each;
//   flash_bwd_group_sum (H > KV): each KV head's dK and dV, the partials
//     of its H/KV query heads summed in head order;
//   dQ: one block per query tile and head; it loops over the live key
//     tiles (the forward's live_tiles), dQ in registers.
// A dK/dV block per query head, not per KV head, gives MQA many blocks of
// about equal work.  Every output element has one writer: no atomics, so
// two calls give the same bits whatever order the blocks run in (the
// checkpoint resume rests on that).  The price is that the dQ pass
// recomputes S and dP: a live (query, key) pair costs seven hd-long
// products where five would do (S, dP, dV, dK, dQ), so this design's
// ceiling is 5/7 of the tensor-core peak against a bound that counts five.
//
// bfloat16 (the training path): warp-specialised Hopper kernels in the
// forward's mould.  64-row tiles come by TMA (64 x 64 boxes, 128-byte
// swizzle) into mbarrier rings that one producer thread keeps full; the
// products are wgmma with float32 accumulators; setmaxnreg gives the
// producer warpgroup's registers to the consumers.
//   flash_bwd_dkdv_tc: 384 threads per (64-key tile, query head, batch).
//     K and V stay resident; Q and dO of each live 64-row query tile come
//     through a ring of two stages.  Consumer c (0 or 1) computes S^T = K
//     Q^T and dP^T = V dO^T for query columns [32c, 32c + 32)
//     (wgmma.m64n32k16, both operands K-major), P^T and dS^T from them in
//     float32 registers, and writes both, rounded to bf16, to shared
//     memory in the 128-byte swizzled K-major layout TMA writes.  After a
//     named barrier consumer 0 accumulates dV += P^T dO and consumer 1
//     dK += dS^T Q (wgmma.m64n{HDP}k16, A from shared memory, B = dO or Q
//     MN-major as V in the forward).  So each consumer holds one 64 x HDP
//     float32 accumulator, 128 registers a thread at hd 256, where dK and
//     dV together would need 256.  Shared memory at hd 256: K and V 64 KB,
//     two stages of Q and dO 128 KB, P^T and dS^T 16 KB.
//   flash_bwd_dq_tc: NC consumer warpgroups of 64 query rows, 128 (NC + 1)
//     threads per (64 NC-row query tile, head, batch): NC = 1 at hd 256,
//     where Q and dO take 64 KB and K and V 64 KB a stage, and 2 at hd
//     <= 128.  Q and dO stay resident; K and V of each live key tile come
//     through a ring of two stages.  S = Q K^T and dP = dO V^T by
//     wgmma.m64n64k16, P and dS in float32 registers, dS rounded to bf16
//     as the register A operand of dQ += dS K (K MN-major).  As in the
//     forward, a consumer skips the products of a key tile wholly masked
//     for its rows.
// The one rounding these add is P and dS to bf16 before their products
// (`ref.attention_bwd(..., tile_dtype=torch.bfloat16)` is its plain
// twin); every sum is float32.  hd is padded to HDP = 64, 128 or 256 as in
// the forward: TMA zero-fills columns past hd and rows past Sq and Sk, P
// is 0 on pairs that the mask or a ragged edge drops, and only columns
// < hd and rows < Sq (keys < Sk) are stored.
//
// What bounds it on an H100: at the training shape (B=1, S=4096, H=10,
// KV=1, hd=256, causal, window 2048) the live pairs need five hd-long
// products, some 161 GFLOP: 0.163 ms at the bf16 tensor-core peak, and
// this design's seven make it 0.228 ms.  MQA's float32 partials add 84 MB
// written by the dK/dV launch and read by the group sum.
//
// float32 (no card path trains in float32): the first design on the CUDA
// cores, 32 x 32 tiles staged in shared memory as float32 and float32
// FMAs, so float32 keeps float32 accuracy.  Its hd-long passes read one
// operand broadcast and one row a warp from shared memory: it is bound by
// shared-memory loads.

constexpr int kBwdThreads = 256;
constexpr int kBwdB = 32;  // float32: query rows and keys per tile
constexpr int kBwdLdp = kBwdB + 1;
constexpr int kBwdTile = 64;  // bfloat16: keys per dK/dV block, rows per consumer

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq), the forward's
  float* delta;      // (B, H, Sq) scratch: D
  void* dq;
  void* dk;
  void* dv;
  float* part;  // (2, B, Sk, H, hd) scratch: dK, dV partials; null if H == KV
  int B, Sq, Sk, H, KV, hd;
  int causal, window;
  float scale, cap;
};

template <typename T>
__device__ __forceinline__ float ld_f(const T* p);
template <>
__device__ __forceinline__ float ld_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float ld_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool pair_live(const BwdArgs& a, int qp, int kp) {
  return qp < a.Sq && kp < a.Sk && !(a.causal && qp < kp) &&
         !(a.window > 0 && qp - kp >= a.window);
}

// the query tiles [qlo, qhi) of BT rows that see a key of [k0, k0 + BT):
// causal, rows >= k0; a window, rows <= k0 + BT - 1 + window - 1
template <int BT>
__device__ inline void query_tiles(const BwdArgs& a, int k0, int& qlo,
                                   int& qhi) {
  const int nq = (a.Sq + BT - 1) / BT;
  qlo = a.causal ? k0 / BT : 0;
  qhi = nq;
  if (a.window > 0) {
    const long long last = (long long)k0 + BT - 1 + a.window - 1;
    if (last / BT + 1 < qhi) qhi = (int)(last / BT + 1);
  }
}

// D_i = sum_c dO_ic O_ic, one warp per row of the (B, Sq, H) rows
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta(const BwdArgs a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.Sq * a.H) return;  // the whole warp
  const T* o = static_cast<const T*>(a.o) + row * a.hd;
  const T* d = static_cast<const T*>(a.dout) + row * a.hd;
  float s = 0.f;
  for (int c = lane; c < a.hd; c += 32) s = fmaf(ld_f(o + c), ld_f(d + c), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const long long bi = row / a.H;
    const int i = (int)(bi % a.Sq), b = (int)(bi / a.Sq);
    a.delta[((size_t)b * a.H + h) * a.Sq + i] = s;
  }
}

// dK and dV of each (batch, key, KV head) column: the float32 partials of
// the group's query heads summed in head order, one thread an element
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_group_sum(const BwdArgs a) {
  const long long n = (long long)a.B * a.Sk * a.KV * a.hd;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  const int rep = a.H / a.KV, c = (int)(e % a.hd);
  const long long row = e / a.hd;  // (b * Sk + key) * KV + kvh
  const int kvh = (int)(row % a.KV);
  const size_t part_n = (size_t)a.B * a.Sk * a.H * a.hd;
  const float* pk =
      a.part + ((size_t)(row / a.KV) * a.H + (size_t)kvh * rep) * a.hd + c;
  float sk = 0.f, sv = 0.f;
  for (int hh = 0; hh < rep; ++hh) {
    sk += pk[(size_t)hh * a.hd];
    sv += pk[part_n + (size_t)hh * a.hd];
  }
  st_f(static_cast<T*>(a.dk) + e, sk);
  st_f(static_cast<T*>(a.dv) + e, sv);
}

// ---- float32: CUDA cores ------------------------------------------------

// shared memory of both tile kernels: Q, dO, K, V tiles (32 rows of hd + 1
// floats), P and dS (32 x 33), lse and D of the query rows
struct BwdLayout {
  int ld;
  __host__ __device__ explicit BwdLayout(int hd) : ld(hd + 1) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (4 * (size_t)kBwdB * ld + 2 * kBwdB * kBwdLdp +
                            2 * kBwdB);
  }
};

// rows [s0, s0 + 32) of head `head` of a (B, S, NH, hd) tensor, with row
// stride ld; rows past S are zero
__device__ void load_tile(float* dst, int ld, const float* src, int b, int s0,
                          int S, int NH, int head, int hd) {
  for (int e = threadIdx.x; e < kBwdB * hd; e += kBwdThreads) {
    const int r = e / hd, c = e % hd;
    const int s = s0 + r;
    dst[r * ld + c] = s < S ? src[(((size_t)b * S + s) * NH + head) * hd + c]
                            : 0.f;
  }
}

// lse and D of query rows [q0, q0 + 32) of head h (0 past Sq)
__device__ void load_rows_stats(const BwdArgs& a, float* lse_s, float* D_s,
                                int b, int h, int q0) {
  const int t = threadIdx.x;
  if (t < kBwdB) {
    const int qp = q0 + t;
    const size_t r = ((size_t)b * a.H + h) * a.Sq + qp;
    lse_s[t] = qp < a.Sq ? a.lse[r] : 0.f;
    D_s[t] = qp < a.Sq ? a.delta[r] : 0.f;
  }
}

// P and dS of one (32-query, 32-key) tile from the staged Q, dO, K, V
__device__ void tile_p_ds(const BwdArgs& a, const float* Qs, const float* dOs,
                          const float* Ks, const float* Vs,
                          const float* lse_s, const float* D_s, float* Ps,
                          float* DSs, int q0, int k0, int ld) {
  for (int e = threadIdx.x; e < kBwdB * kBwdB; e += kBwdThreads) {
    const int i = e / kBwdB, j = e % kBwdB;  // a warp: one row i, 32 keys
    const float* qr = Qs + i * ld;
    const float* dr = dOs + i * ld;
    const float* kr = Ks + j * ld;
    const float* vr = Vs + j * ld;
    float s = 0.f, dp = 0.f;
    for (int c = 0; c < a.hd; ++c) {
      s = fmaf(qr[c], kr[c], s);
      dp = fmaf(dr[c], vr[c], dp);
    }
    float x = s * a.scale, dcap = 1.f;
    if (a.cap > 0.f) {
      const float t = tanhf(x / a.cap);
      x = a.cap * t;
      dcap = 1.f - t * t;
    }
    const float p = pair_live(a, q0 + i, k0 + j) ? expf(x - lse_s[i]) : 0.f;
    Ps[i * kBwdLdp + j] = p;
    DSs[i * kBwdLdp + j] = p * (dp - D_s[i]) * dcap * a.scale;
  }
}

// HDP = NR * 256 / 32 columns (64, 128 or 256): thread t owns elements
// e = t + 256 r (r < NR) of a 32 x HDP accumulator, row e / HDP, column
// e % HDP (a warp: one row, 32 consecutive columns)
template <int NR>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkdv_f32(const BwdArgs a) {
  constexpr int HDP = NR * kBwdThreads / kBwdB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, ld = BwdLayout(hd).ld, tid = threadIdx.x;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kBwdB * ld;
  float* Ks = dOs + kBwdB * ld;
  float* Vs = Ks + kBwdB * ld;
  float* Ps = Vs + kBwdB * ld;
  float* DSs = Ps + kBwdB * kBwdLdp;
  float* lse_s = DSs + kBwdB * kBwdLdp;
  float* D_s = lse_s + kBwdB;
  const int k0 = blockIdx.x * kBwdB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  load_tile(Ks, ld, static_cast<const float*>(a.k), b, k0, a.Sk, a.KV, kvh,
            hd);
  load_tile(Vs, ld, static_cast<const float*>(a.v), b, k0, a.Sk, a.KV, kvh,
            hd);

  float dk[NR], dv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) dk[r] = dv[r] = 0.f;
  int qlo, qhi;
  query_tiles<kBwdB>(a, k0, qlo, qhi);
  for (int iq = qlo; iq < qhi; ++iq) {
    const int q0 = iq * kBwdB;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Qs, ld, q, b, q0, a.Sq, a.H, h, hd);
    load_tile(dOs, ld, dout, b, q0, a.Sq, a.H, h, hd);
    load_rows_stats(a, lse_s, D_s, b, h, q0);
    __syncthreads();
    tile_p_ds(a, Qs, dOs, Ks, Vs, lse_s, D_s, Ps, DSs, q0, k0, ld);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = tid + kBwdThreads * r;
      const int j = e / HDP, c = e % HDP;
      if (c < hd) {
        float av = dv[r], ak = dk[r];
        for (int i = 0; i < kBwdB; ++i) {
          av = fmaf(Ps[i * kBwdLdp + j], dOs[i * ld + c], av);
          ak = fmaf(DSs[i * kBwdLdp + j], Qs[i * ld + c], ak);
        }
        dv[r] = av;
        dk[r] = ak;
      }
    }
  }
  // H == KV: dK and dV themselves; else this head's float32 partials
  const size_t part_n = (size_t)a.B * a.Sk * a.H * hd;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int e = tid + kBwdThreads * r;
    const int j = e / HDP, c = e % HDP;
    if (c < hd && k0 + j < a.Sk) {
      const size_t row = (size_t)b * a.Sk + k0 + j;
      if (a.part == nullptr) {
        const size_t off = (row * a.KV + kvh) * hd + c;
        static_cast<float*>(a.dk)[off] = dk[r];
        static_cast<float*>(a.dv)[off] = dv[r];
      } else {
        const size_t off = (row * a.H + h) * hd + c;
        a.part[off] = dk[r];
        a.part[part_n + off] = dv[r];
      }
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_f32(const BwdArgs a) {
  constexpr int HDP = NR * kBwdThreads / kBwdB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, ld = BwdLayout(hd).ld, tid = threadIdx.x;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kBwdB * ld;
  float* Ks = dOs + kBwdB * ld;
  float* Vs = Ks + kBwdB * ld;
  float* Ps = Vs + kBwdB * ld;
  float* DSs = Ps + kBwdB * kBwdLdp;
  float* lse_s = DSs + kBwdB * kBwdLdp;
  float* D_s = lse_s + kBwdB;
  const int q0 = blockIdx.x * kBwdB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  load_tile(Qs, ld, static_cast<const float*>(a.q), b, q0, a.Sq, a.H, h, hd);
  load_tile(dOs, ld, static_cast<const float*>(a.dout), b, q0, a.Sq, a.H, h,
            hd);
  load_rows_stats(a, lse_s, D_s, b, h, q0);

  float dq[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) dq[r] = 0.f;
  int lo, hi;
  live_tiles<kBwdB, kBwdB>(a, q0, lo, hi);
  for (int ik = lo; ik < hi; ++ik) {
    const int k0 = ik * kBwdB;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, ld, k, b, k0, a.Sk, a.KV, kvh, hd);
    load_tile(Vs, ld, v, b, k0, a.Sk, a.KV, kvh, hd);
    __syncthreads();
    tile_p_ds(a, Qs, dOs, Ks, Vs, lse_s, D_s, Ps, DSs, q0, k0, ld);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int e = tid + kBwdThreads * r;
      const int i = e / HDP, c = e % HDP;
      if (c < hd) {
        float acc = dq[r];
        // unrolled 8 deep: the full 32 at NR 16 and 8 spilled (255
        // registers, the loads of every r hoisted together)
#pragma unroll 8
        for (int j = 0; j < kBwdB; ++j)
          acc = fmaf(DSs[i * kBwdLdp + j], Ks[j * ld + c], acc);
        dq[r] = acc;
      }
    }
  }
  float* dq_out = static_cast<float*>(a.dq);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int e = tid + kBwdThreads * r;
    const int i = e / HDP, c = e % HDP;
    if (c < hd && q0 + i < a.Sq)
      dq_out[(((size_t)b * a.Sq + q0 + i) * a.H + h) * hd + c] = dq[r];
  }
}

// ---- bfloat16: Hopper ----------------------------------------------------

__device__ __forceinline__ void wgmma_ss_m64n32k16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_sst_m64n64k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_sst_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_sst_m64n256k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

// D += A B for one k-step of 16: wgmma.m64n{HDP}k16, A K-major and B
// MN-major, both from shared memory
template <int HDP>
__device__ __forceinline__ void wgmma_sst(float* d, uint64_t da, uint64_t db) {
  if constexpr (HDP == 64) wgmma_sst_m64n64k16(d, da, db);
  if constexpr (HDP == 128) wgmma_sst_m64n128k16(d, da, db);
  if constexpr (HDP == 256) wgmma_sst_m64n256k16(d, da, db);
}

// x, which the compiler may not assume loop-invariant
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// byte offset of element (row r, column col) of a 64 x 64 bf16 tile stored
// K-major with the 128-byte swizzle, as TMA writes a box: the 16-byte
// chunk index of each 128-byte row XORed with the row's index mod 8
__device__ __forceinline__ uint32_t swizzled(int r, int col) {
  return r * 128 + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) * 2));
}

// P and dS of one pair from its raw products s = q . k and dp = dO . v,
// the row's lse in log2 units and its D (the forward's log2 domain); P is
// 0 on a pair that is not live
__device__ __forceinline__ void p_ds(const BwdArgs& a, float s, float dp,
                                     float lse2, float D, bool live,
                                     float& p, float& ds) {
  float x, dcap = 1.f;
  if (a.cap > 0.f) {
    const float th = tanhf(s * (a.scale / a.cap));
    x = a.cap * kLog2e * th;
    dcap = 1.f - th * th;
  } else {
    x = s * (a.scale * kLog2e);
  }
  p = live ? exp2f(x - lse2) : 0.f;
  ds = p * (dp - D) * dcap * a.scale;
}

// Shared memory of the dK/dV kernel, offsets from a 1024-byte aligned base:
// K and V [box][64 keys][128 B], per stage Q and dO [box][64 rows][128 B],
// P^T and dS^T [64 keys][128 B], then the mbarriers.
template <int HDP>
struct DkdvLayout {
  static constexpr int NB = HDP / 64;
  static constexpr int K = 0;
  static constexpr int V = K + NB * kBox;
  static constexpr int Q = V + NB * kBox;
  static constexpr int DO = Q + kStages * NB * kBox;
  static constexpr int P = DO + kStages * NB * kBox;
  static constexpr int DS = P + kBox;
  static constexpr int BAR = DS + kBox;
  // kv_full, full[S], empty[S]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * kStages);
  static constexpr int ALLOC = BYTES + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tmQ,
                      const __grid_constant__ CUtensorMap tmK,
                      const __grid_constant__ CUtensorMap tmV,
                      const __grid_constant__ CUtensorMap tmDO,
                      const BwdArgs a) {
  using L = DkdvLayout<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_full = base + L::BAR;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // 0: producer, 1 and 2: consumers
  const int k0 = blockIdx.x * kBwdTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  int qlo, qhi;
  query_tiles<kBwdTile>(a, k0, qlo, qhi);
  const int n = qhi > qlo ? qhi - qlo : 0;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then Q and dO of each query tile -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * NB * kBox);
      for (int x = 0; x < NB; ++x) {
        tma_load_4d(base + L::K + x * kBox, &tmK, kv_full, x * 64, kvh, k0, b);
        tma_load_4d(base + L::V + x * kBox, &tmV, kv_full, x * 64, kvh, k0, b);
      }
      for (int t = 0; t < n; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, ((t / kStages) - 1) & 1);
        const int q0 = (qlo + t) * kBwdTile;
        mbar_expect_tx(full + 8 * s, 2 * NB * kBox);
        for (int x = 0; x < NB; ++x) {
          tma_load_4d(base + L::Q + (s * NB + x) * kBox, &tmQ, full + 8 * s,
                      x * 64, h, q0, b);
          tma_load_4d(base + L::DO + (s * NB + x) * kBox, &tmDO, full + 8 * s,
                      x * 64, h, q0, b);
        }
      }
    }
  } else {
    // ---- consumers: S^T, dP^T of 32 query columns each; then dV or dK ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int c = wg - 1;
    const int w = warp % 4, g = lane / 4, t4 = lane % 4;
    const int kr = w * 16 + g;  // this thread's key rows: kr, kr + 8
    // consumer 0: dV += P^T dO; consumer 1: dK += dS^T Q
    const uint32_t a_op = base + (c == 0 ? L::P : L::DS);
    const uint32_t b_op = base + (c == 0 ? L::DO : L::Q);
    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int t = 0; t < n; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int q0 = (qlo + t) * kBwdTile;
      const int qc = q0 + 32 * c;  // this consumer's query columns
      // lse (log2 units) and D of the thread's columns qc + 8 i + 2 t4 + e
      float lse2[8], dl[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qp = qc + 8 * (j >> 1) + 2 * t4 + (j & 1);
        const size_t r = ((size_t)b * a.H + h) * a.Sq + qp;
        lse2[j] = qp < a.Sq ? a.lse[r] * kLog2e : 0.f;
        dl[j] = qp < a.Sq ? a.delta[r] : 0.f;
      }
      mbar_wait(full + 8 * s, par);
      // ---- S^T = K Q^T and dP^T = V dO^T, 32 query columns ----
      const uint32_t qs = base + L::Q + s * NB * kBox + c * 32 * 128;
      const uint32_t dos = base + L::DO + s * NB * kBox + c * 32 * 128;
      float st[16], dpt[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_m64n32k16(st, wgmma_desc(base + L::K + off, 16, 1024),
                           wgmma_desc(qs + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_m64n32k16(dpt, wgmma_desc(base + L::V + off, 16, 1024),
                           wgmma_desc(dos + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      pin_regs<16>(st);
      pin_regs<16>(dpt);

      // ---- P^T and dS^T in float32, rounded to bf16 pairs ----
      const bool edge = q0 + kBwdTile > a.Sq || k0 + kBwdTile > a.Sk ||
                        (a.causal && k0 + kBwdTile - 1 > q0) ||
                        (a.window > 0 && q0 + kBwdTile - 1 - k0 >= a.window);
      uint32_t pw[4][2], dw[4][2];  // [column group i][key row half]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p2[2], d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * i + 2 * r + e;
            const int qp = qc + 8 * i + 2 * t4 + e;
            const bool live = !edge || pair_live(a, qp, k0 + kr + 8 * r);
            p_ds(a, st[j], dpt[j], lse2[2 * i + e], dl[2 * i + e], live,
                 p2[e], d2[e]);
          }
          pw[i][r] = pack_bf16(p2[0], p2[1]);
          dw[i][r] = pack_bf16(d2[0], d2[1]);
        }
      }
      named_sync(1, 256);  // the last tile's products have read P^T, dS^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swizzled(kr + 8 * r, 32 * c + 8 * i + 2 * t4);
          st_shared_u32(base + L::P + off, pw[i][r]);
          st_shared_u32(base + L::DS + off, dw[i][r]);
        }
      }
      // the generic proxy's stores, before wgmma (the async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(2, 256);

      // ---- dV += P^T dO (consumer 0) or dK += dS^T Q (consumer 1) ----
      const uint32_t bs = b_op + s * NB * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_sst<HDP>(acc, wgmma_desc(a_op + kk * 32, 16, 1024),
                       wgmma_desc(bs + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait0();
      pin_regs<HDP / 2>(acc);
      mbar_arrive(empty + 8 * s);
    }

    // ---- dV or dK (H == KV) or this head's float32 partials ----
    const size_t part_n = (size_t)a.B * a.Sk * a.H * a.hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = k0 + kr + 8 * r;
      if (kp < a.Sk) {
        const size_t row = (size_t)b * a.Sk + kp;
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          const int col = 8 * i + 2 * t4;
          if (col < a.hd) {
            const float v0 = acc[4 * i + 2 * r], v1 = acc[4 * i + 2 * r + 1];
            if (a.part == nullptr) {
              void* out = c == 0 ? a.dv : a.dk;
              *reinterpret_cast<uint32_t*>(
                  static_cast<__nv_bfloat16*>(out) +
                  (row * a.KV + kvh) * a.hd + col) = pack_bf16(v0, v1);
            } else {
              *reinterpret_cast<float2*>(a.part + (c == 0 ? part_n : 0) +
                                         (row * a.H + h) * a.hd + col) =
                  make_float2(v0, v1);
            }
          }
        }
      }
    }
  }
}

// Shared memory of the dQ kernel, offsets from a 1024-byte aligned base:
// Q and dO [consumer][box][64 rows][128 B], per stage K and V [box][64
// keys][128 B], then the mbarriers.
template <int HDP, int NC>
struct DqLayout {
  static constexpr int NB = HDP / 64;
  static constexpr int Q = 0;
  static constexpr int DO = Q + NC * NB * kBox;
  static constexpr int K = DO + NC * NB * kBox;
  static constexpr int V = K + kStages * NB * kBox;
  static constexpr int BAR = V + kStages * NB * kBox;
  // q_full, k_full[S], v_full[S], empty[S]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * kStages);
  static constexpr int ALLOC = BYTES + 1024;
};

template <int HDP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmDO,
                    const BwdArgs a) {
  using L = DqLayout<HDP, NC>;
  constexpr int NB = L::NB;
  constexpr int BQ = 64 * NC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // 0: producer, then the consumers
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int kvh = h / (a.H / a.KV);
  int lo, hi;
  live_tiles<BQ, kBwdTile>(a, q0, lo, hi);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO once, then K and V of each key tile ---------
    // (with one consumer the block's 256 threads fit 255 registers each)
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, 2 * NC * NB * kBox);
      for (int cc = 0; cc < NC; ++cc)
        for (int x = 0; x < NB; ++x) {
          tma_load_4d(base + L::Q + (cc * NB + x) * kBox, &tmQ, q_full,
                      x * 64, h, q0 + cc * 64, b);
          tma_load_4d(base + L::DO + (cc * NB + x) * kBox, &tmDO, q_full,
                      x * 64, h, q0 + cc * 64, b);
        }
      for (int t = 0; t < hi - lo; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * s, ((t / kStages) - 1) & 1);
        const int k0 = (lo + t) * kBwdTile;
        mbar_expect_tx(k_full + 8 * s, NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(base + L::K + (s * NB + x) * kBox, &tmK, k_full + 8 * s,
                      x * 64, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * s, NB * kBox);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(base + L::V + (s * NB + x) * kBox, &tmV, v_full + 8 * s,
                      x * 64, kvh, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----------------------------------
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int c = wg - 1;
    const int w = warp % 4, g = lane / 4, t4 = lane % 4;
    const int rq = q0 + c * 64 + w * 16 + g;  // this thread's rows: rq, rq + 8
    const int qa = q0 + c * 64, qb = qa + 63;  // the consumer's rows
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = rq + 8 * r;
      const size_t i = ((size_t)b * a.H + h) * a.Sq + qp;
      lse2[r] = qp < a.Sq ? a.lse[i] * kLog2e : 0.f;
      dl[r] = qp < a.Sq ? a.delta[i] : 0.f;
    }
    float dq[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
    const uint32_t qs0 = base + L::Q + c * NB * kBox;
    const uint32_t dos0 = base + L::DO + c * NB * kBox;
    mbar_wait(q_full, 0);

    for (int t = 0; t < hi - lo; ++t) {
      const int s = t % kStages;
      const uint32_t par = (t / kStages) & 1;
      const int k0 = (lo + t) * kBwdTile;
      mbar_wait(k_full + 8 * s, par);
      // a tile wholly masked for these 64 rows adds nothing to their dQ
      const bool dead = (a.causal && k0 > qb) ||
                        (a.window > 0 && qa - (k0 + kBwdTile - 1) >= a.window);
      if (dead) {
        mbar_wait(v_full + 8 * s, par);
        mbar_arrive(empty + 8 * s);
        continue;
      }
      // ---- S = Q K^T and dP = dO V^T ----
      // Q's and dO's addresses made opaque each tile: hoisted out of the
      // loop, their 2 x HDP / 16 descriptors would hold registers that the
      // 64 x HDP accumulator needs (at hd 256 ptxas spilled)
      const uint32_t qs = opaque(qs0), dos = opaque(dos0);
      const uint32_t ks = base + L::K + s * NB * kBox;
      const uint32_t vs = base + L::V + s * NB * kBox;
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_m64n64k16(sc, wgmma_desc(qs + off, 16, 1024),
                           wgmma_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      mbar_wait(v_full + 8 * s, par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_m64n64k16(dp, wgmma_desc(dos + off, 16, 1024),
                           wgmma_desc(vs + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      pin_regs<32>(sc);
      pin_regs<32>(dp);

      // ---- dS in float32, rounded to bf16 as the A operand ----
      const bool edge = (k0 + kBwdTile > a.Sk) ||
                        (a.causal && k0 + kBwdTile - 1 > qa) ||
                        (a.window > 0 && qb - k0 >= a.window);
      uint32_t da[4][4];  // dS as the A operand of 4 k-steps of 16 keys
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float d4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = rq + (e >> 1) * 8;
          const int kp = k0 + 8 * i + 2 * t4 + (e & 1);
          const bool live = !edge || pair_live(a, qp, kp);
          float p;
          p_ds(a, sc[4 * i + e], dp[4 * i + e], lse2[e >> 1], dl[e >> 1],
               live, p, d4[e]);
        }
        da[i / 2][(i % 2) * 2 + 0] = pack_bf16(d4[0], d4[1]);
        da[i / 2][(i % 2) * 2 + 1] = pack_bf16(d4[2], d4[3]);
      }

      // ---- dQ += dS K ----
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_pv<HDP>(dq, da[kk], wgmma_desc(ks + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait0();
      pin_regs<HDP / 2>(dq);
      mbar_arrive(empty + 8 * s);
    }

    // ---- dQ, rows < Sq and columns < hd only ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = rq + 8 * r;
      if (qp < a.Sq) {
        __nv_bfloat16* row = static_cast<__nv_bfloat16*>(a.dq) +
                             (((size_t)b * a.Sq + qp) * a.H + h) * a.hd;
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          const int col = 8 * i + 2 * t4;
          if (col < a.hd)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// ---- launches -------------------------------------------------------------

template <typename T>
int launch_delta(const BwdArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group_sum(const BwdArgs& a, cudaStream_t stream) {
  if (a.part == nullptr) return 0;
  const long long n = (long long)a.B * a.Sk * a.KV * a.hd;
  flash_bwd_group_sum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// parts: a mask of the launches to make (1 the D pre-pass, 2 dK and dV with
// their group sum, 4 dQ); 7 is the backward, the others are for timing
template <int NR>
int launch_bwd_f32(const BwdArgs& a, int parts, cudaStream_t stream) {
  const int smem = (int)BwdLayout(a.hd).bytes();
  auto dkdv = flash_bwd_dkdv_f32<NR>;
  auto dq = flash_bwd_dq_f32<NR>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int e = 0;
  if ((parts & 1) && (e = launch_delta<float>(a, stream)) != 0) return e;
  if (parts & 2) {
    dkdv<<<dim3((a.Sk + kBwdB - 1) / kBwdB, a.H, a.B), kBwdThreads, smem,
           stream>>>(a);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    if ((e = launch_group_sum<float>(a, stream)) != 0) return e;
  }
  if (parts & 4)
    dq<<<dim3((a.Sq + kBwdB - 1) / kBwdB, a.H, a.B), kBwdThreads, smem,
         stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_bwd_tc(const BwdArgs& a, int parts, cudaStream_t stream) {
  constexpr int NC = HDP <= 128 ? 2 : 1;
  CUtensorMap tq, tk, tv, tdo;
  if (!bind_device(a.q) || !make_bshd_map(&tq, a.q, a.B, a.Sq, a.H, a.hd) ||
      !make_bshd_map(&tk, a.k, a.B, a.Sk, a.KV, a.hd) ||
      !make_bshd_map(&tv, a.v, a.B, a.Sk, a.KV, a.hd) ||
      !make_bshd_map(&tdo, a.dout, a.B, a.Sq, a.H, a.hd))
    return (int)cudaErrorInvalidValue;
  auto dkdv = flash_bwd_dkdv_tc<HDP>;
  auto dq = flash_bwd_dq_tc<HDP, NC>;
  const int smem_kv = DkdvLayout<HDP>::ALLOC;
  const int smem_q = DqLayout<HDP, NC>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  int e = 0;
  if ((parts & 1) && (e = launch_delta<__nv_bfloat16>(a, stream)) != 0)
    return e;
  if (parts & 2) {
    dkdv<<<dim3((a.Sk + kBwdTile - 1) / kBwdTile, a.H, a.B), kThreadsTC,
           smem_kv, stream>>>(tq, tk, tv, tdo, a);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    if ((e = launch_group_sum<__nv_bfloat16>(a, stream)) != 0) return e;
  }
  if (parts & 4)
    dq<<<dim3(a.H, (a.Sq + 64 * NC - 1) / (64 * NC), a.B), 128 * (NC + 1),
         smem_q, stream>>>(tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Returns the
// cudaGetLastError of the launch (0 on success).
// lse: (B, H, Sq) float32 or null (see Args::lse).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int dtype,
                                   int causal, int window, float scale,
                                   float cap, float* lse,
                                   cudaStream_t stream) {
  if (B > 65535 || H > 65535 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, Sq, Sk, H, KV, hd, causal, window, scale, cap, lse};
  if (dtype == 1) {
    if (hd % 16 != 0 || hd > 256) return (int)cudaErrorInvalidValue;
    if (hd <= 64) return launch_tc<64>(a, stream);
    if (hd <= 128) return launch_tc<128>(a, stream);
    return launch_tc<256>(a, stream);
  }
  if (dtype == 0) return launch_f32(a, stream);
  return (int)cudaErrorInvalidValue;
}

// the wgmma probe (see wgmma_probe_kernel); a, b, v bf16, s and o float32
extern "C" int flash_wgmma_probe(const void* a, const void* b, const void* v,
                                 float* s, float* o, cudaStream_t stream) {
  if (!bind_device(a)) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tv;
  const cuuint64_t dims64[4] = {64, 1, 64, 1}, dims256[4] = {256, 1, 64, 1};
  const cuuint64_t st64[3] = {128, 128, 64 * 128};
  const cuuint64_t st256[3] = {512, 512, 64 * 512};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  if (!make_map(&ta, a, 4, dims64, st64, box) ||
      !make_map(&tb, b, 4, dims64, st64, box) ||
      !make_map(&tv, v, 4, dims256, st256, box))
    return (int)cudaErrorInvalidValue;
  const int smem = 6 * kBox + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_probe_kernel<<<1, 128, smem, stream>>>(
      ta, tb, tv, static_cast<const __nv_bfloat16*>(a), s, o);
  return (int)cudaGetLastError();
}

// The backward: q, k, v, o, dout and the outputs dq (like q), dk and dv
// (like k) share dtype (0 = float32, 1 = bfloat16); lse (B, H, Sq) is the
// forward's; delta is (B, H, Sq) float32 scratch; part is (2, B, Sk, H, hd)
// float32 scratch when H > KV (null when H == KV); parts selects the
// launches (see launch_bwd).  Returns the cudaGetLastError of the launches
// (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   float* part, int B, int Sq, int Sk, int H,
                                   int KV, int hd, int dtype, int causal,
                                   int window, float scale, float cap,
                                   int parts, cudaStream_t stream) {
  if (B > 65535 || H > 65535 || KV <= 0 || H % KV != 0 || hd < 1 ||
      hd > 256)
    return (int)cudaErrorInvalidValue;
  if ((part == nullptr) != (H == KV)) return (int)cudaErrorInvalidValue;
  BwdArgs a{q,  k,  v,  o,      dout,   lse,   delta, dq, dk, dv, part,
            B,  Sq, Sk, H, KV, hd,   causal, window, scale, cap};
  if (dtype == 1) {  // the forward's widths
    if (hd % 16 != 0) return (int)cudaErrorInvalidValue;
    if (hd <= 64) return launch_bwd_tc<64>(a, parts, stream);
    if (hd <= 128) return launch_bwd_tc<128>(a, parts, stream);
    return launch_bwd_tc<256>(a, parts, stream);
  }
  if (dtype == 0) {
    if (hd <= 64) return launch_bwd_f32<8>(a, parts, stream);
    if (hd <= 128) return launch_bwd_f32<16>(a, parts, stream);
    return launch_bwd_f32<32>(a, parts, stream);
  }
  return (int)cudaErrorInvalidValue;
}
