// Tiled online-softmax attention (flash attention, forward only).
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
// stored.
//
// What bounds it on an H100: at the main path's shape (B=4, S=4096, H=10,
// KV=1, hd=256, window 2048, causal, bf16) the live (q, k) pairs need
// 4*hd flops each, about 258 GFLOP, against about 185 MB of q/k/v/o: it is
// bound by operations, 0.26 ms at the bf16 tensor-core peak.
//
// Design (simple first; wgmma, TMA and warp specialisation are later
// work): one CTA of 256 threads per (q tile, head, batch).  The Q tile,
// one K tile and one V tile are staged in shared memory; the CTA walks
// only the K tiles that the causal/window mask leaves live (Pallas's
// pl.when skip: at S=4096, window 2048, 62.5% of the pairs are masked and
// nearly all of them in skipped tiles).  For bf16 the two products run on
// the tensor cores through WMMA (mma.sync, 16x16x16, bf16 in, f32
// accumulate) with P rounded to bf16; for f32 they are f32 FMAs on the
// CUDA cores, so f32 keeps f32 accuracy.  Softmax statistics are f32 in
// registers (one row per group of threads); the f32 accumulator
// (BQ x hd, 64 KB at hd=256) lives in shared memory so that its rows can
// be rescaled between tiles.  The bf16 variant at hd=256 takes 194,560
// bytes of shared memory, above the 48 KB default, so the launcher raises
// the limit with cudaFuncSetAttribute; a refused launch comes back from
// cudaGetLastError to the wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;  // the reference's masked logit

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KV, hd;
  int causal, window;  // window <= 0: no window
  float scale, cap;    // cap <= 0: no soft-cap
};

// the f32 (CUDA-core) variant reads every operand as float
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout of one variant, in elements of each buffer's type.
// Row pads keep WMMA pointers 32-byte aligned (bf16) or spread rows over
// the banks (f32).
template <typename T, int BQ, int BK, bool TC>
struct Layout {
  using PT = typename std::conditional<TC, __nv_bfloat16, float>::type;
  int ldq, lds, ldp, ldo;
  __host__ __device__ explicit Layout(int hd)
      : ldq(hd + (TC ? 8 : 1)), lds(BK + 4), ldp(BK + (TC ? 8 : 1)),
        ldo(hd + 4) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(T) * (size_t)(BQ + 2 * BK) * ldq +
           sizeof(float) * (size_t)BQ * lds + sizeof(PT) * (size_t)BQ * ldp +
           sizeof(float) * (size_t)BQ * ldo;
  }
};

// rows [s0, s0 + R) of head `head` of a (B, S, NH, hd) tensor into smem
// (row stride ld); rows past S are zero.
template <typename T, int R, bool VEC>
__device__ void load_rows(T* dst, int ld, const T* src, int b, int s0, int S,
                          int NH, int head, int hd) {
  if constexpr (VEC) {  // 16-byte chunks; bf16 with hd % 16 == 0
    const int chunks = hd / 8;
    for (int e = threadIdx.x; e < R * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      const int s = s0 + r;
      if (s < S)
        val = *reinterpret_cast<const uint4*>(
            src + (((size_t)b * S + s) * NH + head) * hd + c * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
    }
  } else {
    for (int e = threadIdx.x; e < R * hd; e += kThreads) {
      const int r = e / hd, c = e % hd;
      const int s = s0 + r;
      dst[r * ld + c] =
          s < S ? src[(((size_t)b * S + s) * NH + head) * hd + c] : from_f<T>(0.f);
    }
  }
}

template <typename T, int BQ, int BK, bool TC>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const Args a) {
  using L = Layout<T, BQ, BK, TC>;
  using PT = typename L::PT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hd = a.hd;
  const L lay(hd);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * lay.ldq;
  T* Vs = Ks + BK * lay.ldq;
  float* Ss = reinterpret_cast<float*>(Vs + BK * lay.ldq);
  PT* Ps = reinterpret_cast<PT*>(Ss + BQ * lay.lds);
  float* Os = reinterpret_cast<float*>(Ps + BQ * lay.ldp);

  const int tid = threadIdx.x, warp = tid / 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  // softmax layout: TPR threads per query row, columns interleaved
  constexpr int TPR = kThreads / BQ;
  constexpr int CPT = BK / TPR;
  static_assert(TPR * BQ == kThreads && CPT * TPR == BK && TPR <= 32, "");
  const int srow = tid / TPR, spart = tid % TPR;
  const int qpos = q0 + srow;
  float m_run = kMasked, l_run = 0.f;

  load_rows<T, BQ, TC>(Qs, lay.ldq, q, b, q0, a.Sq, a.H, h, hd);
  for (int e = tid; e < BQ * lay.ldo; e += kThreads) Os[e] = 0.f;

  const int nk = (a.Sk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    // tiles wholly above the diagonal or wholly outside the window
    if (a.causal && q0 + BQ - 1 < k0) break;
    if (a.window > 0 && q0 - (k0 + BK - 1) >= a.window) continue;
    load_rows<T, BK, TC>(Ks, lay.ldq, k, b, k0, a.Sk, a.KV, kvh, hd);
    load_rows<T, BK, TC>(Vs, lay.ldq, v, b, k0, a.Sk, a.KV, kvh, hd);
    __syncthreads();

    // S = Q K^T (raw dot products, f32)
    if constexpr (TC) {
      constexpr int FR = BQ / 16, FC = BK / 16;
      for (int f = warp; f < FR * FC; f += kWarps) {
        const int fr = f % FR, fc = f / FR;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < hd; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + fr * 16 * lay.ldq + kk, lay.ldq);
          wmma::load_matrix_sync(fb, Ks + fc * 16 * lay.ldq + kk, lay.ldq);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + fr * 16 * lay.lds + fc * 16, acc,
                                lay.lds, wmma::mem_row_major);
      }
    } else {
      for (int e = tid; e < BQ * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const T* qr = Qs + r * lay.ldq;
        const T* kr = Ks + c * lay.ldq;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(to_f(qr[d]), to_f(kr[d]), acc);
        Ss[r * lay.lds + c] = acc;
      }
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
        const PT pt = from_f<PT>(pj);
        Ps[srow * lay.ldp + spart + TPR * j] = pt;
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
    if constexpr (TC) {
      constexpr int FR = BQ / 16, FK = BK / 16;
      const int FO = hd / 16;
      for (int f = warp; f < FR * FO; f += kWarps) {
        const int fr = f % FR, fc = f / FR;
        float* o_ptr = Os + fr * 16 * lay.ldo + fc * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, o_ptr, lay.ldo, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < FK; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + fr * 16 * lay.ldp + kk * 16,
                                 lay.ldp);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * lay.ldq + fc * 16,
                                 lay.ldq);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(o_ptr, acc, lay.ldo, wmma::mem_row_major);
      }
    } else {
      for (int e = tid; e < BQ * hd; e += kThreads) {
        const int r = e / hd, c = e % hd;
        float acc = Os[r * lay.ldo + c];
        for (int j = 0; j < BK; ++j)
          acc = fmaf(to_f(Ps[r * lay.ldp + j]), to_f(Vs[j * lay.ldq + c]), acc);
        Os[r * lay.ldo + c] = acc;
      }
    }
    __syncthreads();
  }

  if (qpos < a.Sq) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* out = static_cast<T*>(a.o) + (((size_t)b * a.Sq + qpos) * a.H + h) * hd;
    for (int c = spart; c < hd; c += TPR)
      out[c] = from_f<T>(Os[srow * lay.ldo + c] / denom);
  }
}

template <typename T, int BQ, int BK, bool TC>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<T, BQ, BK, TC>(a.hd).bytes();
  auto kern = flash_kernel<T, BQ, BK, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Returns the
// cudaGetLastError of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int dtype,
                                   int causal, int window, float scale,
                                   float cap, cudaStream_t stream) {
  if (B > 65535 || H > 65535 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, Sq, Sk, H, KV, hd, causal, window, scale, cap};
  if (dtype == 1) {
    if (hd % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16, 64, 64, true>(a, stream);
  }
  if (dtype == 0) return launch<float, 32, 32, false>(a, stream);
  return (int)cudaErrorInvalidValue;
}
