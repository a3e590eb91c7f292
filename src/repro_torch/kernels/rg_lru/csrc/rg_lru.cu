// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t, per (batch, channel).
//
// Replaces the TPU kernel src/repro/kernels/rg_lru/kernel.py::rglru_scan
// (_rglru_kernel), which streamed (chunk, 128) tiles through VMEM with h in
// a VMEM scratch carried along a sequential grid axis.
//
// What bounds it on an H100: the data is 12 bytes per element (x and a
// read, y written, all f32) for two flops, so the floor is the memory rate
// (at B=4, S=4096, D=2560: 503 MB, 0.150 ms at 3.35 TB/s).  The recurrence
// is a dependent chain of S steps per channel, and there are only B*D
// chains (10,240 on the main path), too few threads to hide the memory
// latency by occupancy: the card needs about 2 MB in flight (3.35 TB/s
// times ~0.7 us), some 17 KB per SM.  The chain itself is short: 4,096
// dependent mul+add pairs, ~33k cycles (~18 us) against the 150 us floor.
//
// Design: keep the loads running ahead of the chain.  One warp per block,
// one lane per channel (32 consecutive channels of one batch row, so every
// load and store of a step is one 128-byte coalesced row), and a ring of
// RGLRU_STAGES stages of RGLRU_T steps of x and a in shared memory, filled
// by cp.async: each lane copies its own channel, so a lane waits only on
// its own copies (cp.async.wait_group) and the ring needs no barrier.
// While the chain runs over one stage, the next RGLRU_STAGES - 1 stages
// (56 steps, 14 KB a warp at the defaults) are in flight.  The main path's
// 320 blocks (B=4, D=2560) all stay resident (16 KB of shared memory a
// block), two or three a SM, so no second wave of blocks trails the first;
// the SMs with three carry 1.24x the mean, within what their in-flight
// bytes can pull.  y is stored with streaming stores as each step
// completes.  D need not be a multiple of anything: each lane copies 4
// bytes, so only float alignment is needed, and lanes past D do nothing.
// The decode step (S=1) has nothing to run ahead of: it takes a one-step
// kernel with direct loads, at the first kernel's 64 channels a block (the
// ring's cp.async round trip, its commits and 1-warp blocks made it ~15%
// slower there).  Neither path adds host work or a tensor map.
//
// The step is spelled __fadd_rn(__fmul_rn(a, h), x), each channel's chain
// runs in order, and nvcc cannot contract it into an FMA: the kernel is
// bit-identical to the plain PyTorch loop (one mul, one add).

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef RGLRU_T
#define RGLRU_T 8          // steps per stage
#endif
#ifndef RGLRU_STAGES
#define RGLRU_STAGES 8     // stages in the ring
#endif

namespace {

constexpr int kLanes = 32;
constexpr int kT = RGLRU_T;
constexpr int kStages = RGLRU_STAGES;
static_assert(kStages >= 2, "the ring needs two stages at least");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

typedef float Stage[kT][2][kLanes];   // [step][0: x, 1: a][lane]

// Stage s (steps [s*kT, s*kT + kT), those below S) into slot s % kStages,
// this lane's channel only; committed as a group even when empty, so the
// ring's wait counts stages.
__device__ __forceinline__ void load_stage(Stage* ring, int s,
                                           int n_stages, int S, int lane,
                                           const float* xp, const float* ap,
                                           size_t stride) {
  if (s < n_stages) {
    Stage& st = ring[s % kStages];
    const int t0 = s * kT;
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      const int t = t0 + u;
      if (t < S) {
        cp_async4(&st[u][0][lane], xp + (size_t)t * stride);
        cp_async4(&st[u][1][lane], ap + (size_t)t * stride);
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kLanes)
    rglru_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int S, int D) {
  // the ring of stages: lanes on consecutive words, no bank conflicts
  __shared__ Stage ring[kStages];
  const int lane = threadIdx.x;
  const int d = blockIdx.x * kLanes + lane;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t stride = (size_t)D;
  const size_t base = (size_t)b * (size_t)S * stride + (size_t)d;
  const float* xp = x + base;
  const float* ap = a + base;
  float* yp = y + base;
  const int n_stages = (S + kT - 1) / kT;

  for (int s = 0; s < kStages - 1; ++s)
    load_stage(ring, s, n_stages, S, lane, xp, ap, stride);
  float h = h0[(size_t)b * stride + d];
  for (int s = 0; s < n_stages; ++s) {
    // refill the slot the previous stage's steps were read from (this
    // lane's own reads, done: the chain consumed them in order)
    load_stage(ring, s + kStages - 1, n_stages, S, lane, xp, ap, stride);
    cp_async_wait_ring();              // stage s has landed
    const int slot = s % kStages;
    const int t0 = s * kT;
    float* yo = yp + (size_t)t0 * stride;
    if (t0 + kT <= S) {
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        h = __fadd_rn(__fmul_rn(ring[slot][u][1][lane], h),
                      ring[slot][u][0][lane]);
        __stcs(yo + (size_t)u * stride, h);
      }
    } else {
      for (int u = 0; u < S - t0; ++u) {
        h = __fadd_rn(__fmul_rn(ring[slot][u][1][lane], h),
                      ring[slot][u][0][lane]);
        __stcs(yo + (size_t)u * stride, h);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  hT[(size_t)b * stride + d] = h;
}

// One step (the decode step): nothing to run ahead of, so each lane loads
// its a and x straight into registers; 64 channels a block, as the first
// kernel had, so the decode launch is no larger than it was.
constexpr int kStepThreads = 64;

__global__ void __launch_bounds__(kStepThreads)
    rglru_step_kernel(const float* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int D) {
  const int d = blockIdx.x * kStepThreads + threadIdx.x;
  const size_t i = (size_t)blockIdx.y * D + d;
  if (d >= D) return;
  const float h = __fadd_rn(__fmul_rn(__ldg(a + i), __ldg(h0 + i)),
                            __ldg(x + i));
  y[i] = h;
  hT[i] = h;
}


// Backward of the recurrence.  No TPU kernel to replace: the JAX package
// trains through lax.associative_scan (src/repro/models/layers.py::
// rglru_scan) and jax.grad.  With g_{S-1} = dh_{S-1} + dhT and
// g_t = dh_t + a_{t+1} g_{t+1} (run in reverse, as a carry c_t = a_t g_t):
// dx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0), dh0 = a_0 g_0.  It reads
// the forward's h.  Each step is spelled g = __fadd_rn(dh, c),
// da = __fmul_rn(g, h_prev), c = __fmul_rn(a, g), each channel's chain in
// order from t = S-1 down to 0: bitwise equal to the plain reverse loop.
//
// What bounds it on an H100: a, h and dh read and dx and da written, 20
// bytes an element (at B=1, S=4096, D=2560: 210 MB, 0.063 ms at 3.35
// TB/s); the dependent chain is one add and one multiply a step, 4,096
// steps, about 0.02 ms.  At B=1 there are only 2,560 chains, so the time
// is one chain's steps times the latency of a step, unless the loads run
// far enough ahead and nothing else waits on the chain.
//
// Design: the chain stays sequential and everything else comes off it,
// onto other warps and the TMA.  One warp doing its own per-lane copies,
// shared loads and stores around its chain (the first design, 82 ns a
// step) stays near 60 ns a step however deep its ring: that warp's own
// instruction stream, not memory, sets the pace (PERF.md).  So a
// block is three warps over the same 32 channels of one batch row
// (kLanes, a lane each):
//   the loader brings dh_t, a_t and h_{t-1} of RGLRU_BWD_STAGES stages of
//     RGLRU_BWD_T steps ahead into a ring in shared memory: one TMA box
//     (32 channels x RGLRU_BWD_T steps) per array and stage from one
//     thread, completing on the stage's mbarrier, so it never waits for
//     data;
//   the chain warp runs g = dh + c, c = a g over each stage as it lands,
//     the stage's dh and a first into registers, g written over dh: a
//     step is the add, the multiply and one shared store;
//   the storer reads the stage's g and h_{t-1} (h0 at t = 0), all loads
//     first (a branch in its loop made it the slowest warp), writes
//     da = g h_{t-1} over h_{t-1}, and one thread stores both boxes to dx
//     and da by TMA; a stage is freed for the loader once the TMA has
//     read it, checked two stages later.
// Each warp waits only on mbarriers (stage landed, g written, stage
// freed).  The TMA needs D a multiple of 4 and 16-byte aligned pointers;
// otherwise the loader copies with per-lane cp.async and the storer stores
// per lane.  Rows before t = 0 and channels past D load as zeros and are
// not stored; the ragged last stage (S not a multiple of RGLRU_BWD_T) is
// stored per lane, as a box would start before t = 0.  The ring's
// defaults come from scripts/rglru_versions.py --backward (PERF.md): 8
// stages of 32 steps, 96 KB a block.
#ifndef RGLRU_BWD_STAGES
#define RGLRU_BWD_STAGES 8  // stages in the ring
#endif
#ifndef RGLRU_BWD_T
#define RGLRU_BWD_T 32      // steps a stage (a TMA box: at most 256)
#endif

constexpr int kBwdStages = RGLRU_BWD_STAGES;
constexpr int kBwdT = RGLRU_BWD_T;
constexpr int kBwdThreads = 3 * kLanes;  // loader, chain, storer
static_assert(kBwdStages >= 2, "the ring needs two stages at least");
static_assert(kBwdT <= 256, "a TMA box is at most 256 rows");

// the ring: [stage][dh then g (dx), a, h_prev then da][row][lane], row r
// of a stage starting at time t0 holding t = t0 - (kBwdT - 1) + r
// (ascending, as a TMA box), then the mbarriers of each stage: landed (the
// loader's copies), g written, freed
enum { kDh, kA, kHp, kArrays };
// the storer frees a stage once the TMA has read it, kStoreLag stages later
constexpr int kStoreLag = kBwdStages > 2 ? 2 : 1;
struct BwdShared {
  float v[kBwdStages][kArrays][kBwdT][kLanes];
  uint64_t landed[kBwdStages], written[kBwdStages], freed[kBwdStages];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// box (c0, row, b) of a (B, S, D) float32 map into shared memory
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int row,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const float* src, int c0,
                                             int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(row), "r"(b)
      : "memory");
}

// the five maps of the TMA route: dh, a, h read; dx, da written
struct BwdMaps {
  CUtensorMap dh, a, h, dx, da;
};

template <bool kTma>
__global__ void __launch_bounds__(kBwdThreads)
    rglru_scan_bwd_kernel(const __grid_constant__ BwdMaps maps,
                          const float* __restrict__ a,
                          const float* __restrict__ h,
                          const float* __restrict__ h0,
                          const float* __restrict__ dh,
                          const float* __restrict__ dhT,
                          float* __restrict__ dx, float* __restrict__ da,
                          float* __restrict__ dh0, int S, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(
      smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128));
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int c0 = blockIdx.x * kLanes;  // the block's first channel
  const int d = c0 + lane;
  const int b = blockIdx.y;
  const bool on = d < D;  // lanes past D do no global access, but arrive
  const size_t stride = (size_t)D;
  const size_t base = (size_t)b * (size_t)S * stride + (size_t)d;
  const size_t row = (size_t)b * stride + d;
  const int n_stages = (S + kBwdT - 1) / kBwdT;
  const int n_full = S / kBwdT;  // stages of kBwdT steps; then the ragged one
  const int shift = 1;           // da_t reads h_{t - shift}

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sh.landed[s], kTma ? 1 : kLanes);
      mbar_init(&sh.written[s], kLanes);
      mbar_init(&sh.freed[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- loader: stage s holds times t0 - kBwdT + 1 .. t0 ----
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % kBwdStages;
      const int t0 = S - 1 - s * kBwdT;
      if (s >= kBwdStages)
        mbar_wait(&sh.freed[slot], ((s / kBwdStages) - 1) & 1);
      float (*st)[kBwdT][kLanes] = sh.v[slot];
      if constexpr (kTma) {
        if (lane == 0) {
          const int r0 = t0 - (kBwdT - 1);  // may be < 0: zeros
          mbar_expect_tx(&sh.landed[slot], 3 * kBwdT * kLanes * 4);
          tma_load_3d(&st[kDh][0][0], &maps.dh, &sh.landed[slot], c0, r0, b);
          tma_load_3d(&st[kA][0][0], &maps.a, &sh.landed[slot], c0, r0, b);
          tma_load_3d(&st[kHp][0][0], &maps.h, &sh.landed[slot], c0,
                      r0 - shift, b);
        }
      } else {
        if (on) {
#pragma unroll
          for (int r = 0; r < kBwdT; ++r) {
            const int t = t0 - (kBwdT - 1) + r;
            if (t >= 0) {
              cp_async4(&st[kDh][r][lane], dh + base + (size_t)t * stride);
              cp_async4(&st[kA][r][lane], a + base + (size_t)t * stride);
              cp_async4(&st[kHp][r][lane],
                        t - shift >= 0
                            ? h + base + (size_t)(t - shift) * stride
                            : h0 + row);
            }
          }
        }
        mbar_arrive_on_copies(&sh.landed[slot]);
      }
    }
  } else if (warp == 1) {
    // ---- the chain: g = dh + c, c = a g, from t = S-1 down; g over dh ----
    float c = on && dhT != nullptr ? dhT[row] : 0.f;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % kBwdStages;
      mbar_wait(&sh.landed[slot], (s / kBwdStages) & 1);
      float (*st)[kBwdT][kLanes] = sh.v[slot];
      if (s < n_full) {
        float vdh[kBwdT], va[kBwdT];
#pragma unroll
        for (int r = 0; r < kBwdT; ++r) {
          vdh[r] = st[kDh][r][lane];
          va[r] = st[kA][r][lane];
        }
#pragma unroll
        for (int r = kBwdT - 1; r >= 0; --r) {
          const float g = __fadd_rn(vdh[r], c);
          st[kDh][r][lane] = g;
          c = __fmul_rn(va[r], g);
        }
      } else {
        for (int r = kBwdT - 1; r >= kBwdT - (S - s * kBwdT); --r) {
          const float g = __fadd_rn(st[kDh][r][lane], c);
          st[kDh][r][lane] = g;
          c = __fmul_rn(st[kA][r][lane], g);
        }
      }
      mbar_arrive(&sh.written[slot]);
    }
    if (on) dh0[row] = c;
  } else {
    // ---- storer: dx = g, da = g h_{t-1} over h_{t-1}, then free ----
    const float h0v = on ? h0[row] : 0.f;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % kBwdStages;
      const uint32_t par = (s / kBwdStages) & 1;
      const int t0 = S - 1 - s * kBwdT;
      mbar_wait(&sh.landed[slot], par);
      mbar_wait(&sh.written[slot], par);
      float (*st)[kBwdT][kLanes] = sh.v[slot];
      const int r0 = t0 - (kBwdT - 1);  // the stage's first row (time)
      if (s < n_full) {
        // straight-line: every load first, then the products and stores
        float g[kBwdT], hp[kBwdT];
#pragma unroll
        for (int r = 0; r < kBwdT; ++r) {
          g[r] = st[kDh][r][lane];
          hp[r] = st[kHp][r][lane];
        }
#pragma unroll
        for (int r = 0; r < kBwdT; ++r) {
          const float ga = __fmul_rn(g[r], r0 + r == 0 ? h0v : hp[r]);
          if constexpr (kTma) {
            st[kDh][r][lane] = g[r];  // again: this warp's fence covers it
            st[kHp][r][lane] = ga;
          } else if (on) {
            __stcs(dx + base + (size_t)(r0 + r) * stride, g[r]);
            __stcs(da + base + (size_t)(r0 + r) * stride, ga);
          }
        }
      } else if (on) {
        // the ragged stage (a TMA box would start before t = 0): per lane
        for (int r = kBwdT - (S - s * kBwdT); r < kBwdT; ++r) {
          const float g = st[kDh][r][lane];
          __stcs(dx + base + (size_t)(r0 + r) * stride, g);
          __stcs(da + base + (size_t)(r0 + r) * stride,
                 __fmul_rn(g, r0 + r == 0 ? h0v : st[kHp][r][lane]));
        }
      }
      if (kTma && s < n_full) {
        // the generic proxy's writes, before the TMA (async proxy) reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          tma_store_3d(&maps.dx, &st[kDh][0][0], c0, r0, b);
          tma_store_3d(&maps.da, &st[kHp][0][0], c0, r0, b);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          // stage s - kStoreLag's boxes have been read: free it
          asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kStoreLag)
                       : "memory");
          if (s >= kStoreLag)
            mbar_arrive(&sh.freed[(s - kStoreLag) % kBwdStages]);
        }
      } else if (!kTma) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&sh.freed[slot]);
      }
    }
    if constexpr (kTma) {
      if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  }
}

// ---- host side: the tensor maps (cuTensorMapEncodeTiled, no -lcuda) ----

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

// (B, S, D) float32 in boxes of 32 channels x kBwdT steps, zeros past the
// edges (rows before 0 included); D % 4 == 0 and ptr 16-byte aligned
bool make_bsd_map(CUtensorMap* map, const float* ptr, int B, int S, int D) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {kLanes, kBwdT, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int rglru_scan(const float* x, const float* a, const float* h0,
                          float* y, float* hT, int B, int S, int D,
                          cudaStream_t stream) {
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (S == 1) {
    dim3 grid((D + kStepThreads - 1) / kStepThreads, B);
    rglru_step_kernel<<<grid, kStepThreads, 0, stream>>>(x, a, h0, y, hT, D);
  } else {
    dim3 grid((D + kLanes - 1) / kLanes, B);
    rglru_scan_kernel<<<grid, kLanes, 0, stream>>>(x, a, h0, y, hT, S, D);
  }
  return (int)cudaGetLastError();
}

// The backward: a, h (the forward's output), h0, dh (B, S, D) / (B, D)
// float32; dhT (B, D) or null (no gradient of hT) -> dx, da (B, S, D) and
// dh0 (B, D).  Returns the cudaGetLastError of the launch.
extern "C" int rglru_scan_bwd(const float* a, const float* h, const float* h0,
                              const float* dh, const float* dhT, float* dx,
                              float* da, float* dh0, int B, int S, int D,
                              cudaStream_t stream) {
  if (B > 65535 || S < 1) return (int)cudaErrorInvalidConfiguration;
  // the TMA route where every row and pointer is 16-byte aligned;
  // cuTensorMapEncodeTiled needs a current context (a thread that has made
  // no CUDA call yet, the autograd engine's, has none)
  const void* ptrs[] = {a, h, dh, dx, da};
  bool tma = D % 4 == 0;
  for (const void* p : ptrs)
    tma = tma && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  BwdMaps maps;
  if (tma) {
    cudaPointerAttributes attr;
    if (cudaPointerGetAttributes(&attr, a) != cudaSuccess ||
        cudaSetDevice(attr.device) != cudaSuccess ||
        !make_bsd_map(&maps.dh, dh, B, S, D) ||
        !make_bsd_map(&maps.a, a, B, S, D) ||
        !make_bsd_map(&maps.h, h, B, S, D) ||
        !make_bsd_map(&maps.dx, dx, B, S, D) ||
        !make_bsd_map(&maps.da, da, B, S, D))
      return (int)cudaErrorInvalidValue;
  }
  auto kern = tma ? rglru_scan_bwd_kernel<true> : rglru_scan_bwd_kernel<false>;
  const int smem = (int)sizeof(BwdShared) + 128;  // room to align to 128
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + kLanes - 1) / kLanes, B);
  kern<<<grid, kBwdThreads, smem, stream>>>(maps, a, h, h0, dh, dhT, dx, da,
                                            dh0, S, D);
  return (int)cudaGetLastError();
}
