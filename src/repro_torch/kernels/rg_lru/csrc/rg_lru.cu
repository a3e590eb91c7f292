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
// the forward's h.  Same design as the forward, the chain running from
// t = S-1 down to 0: one warp of 32 channels a block, a cp.async ring of
// RGLRU_STAGES stages of RGLRU_T steps each holding dh_t, a_t and h_{t-1}
// of the lane's channel, dx and da stored with streaming stores.  The
// bound: a, h and dh read and dx and da written, 20 bytes an element (at
// B=1, S=4096, D=2560: 210 MB, 0.063 ms at 3.35 TB/s).  Each step is
// spelled g = __fadd_rn(dh, c), da = __fmul_rn(g, h_prev),
// c = __fmul_rn(a, g): bitwise equal to the plain reverse loop.
typedef float BwdStage[kT][3][kLanes];  // [step][dh, a, h_prev][lane]

__device__ __forceinline__ void load_bwd_stage(BwdStage* ring, int s,
                                               int n_stages, int S, int lane,
                                               const float* dhp,
                                               const float* ap,
                                               const float* hp,
                                               const float* h0p,
                                               size_t stride) {
  if (s < n_stages) {
    BwdStage& st = ring[s % kStages];
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      const int t = S - 1 - (s * kT + u);
      if (t >= 0) {
        cp_async4(&st[u][0][lane], dhp + (size_t)t * stride);
        cp_async4(&st[u][1][lane], ap + (size_t)t * stride);
        cp_async4(&st[u][2][lane],
                  t > 0 ? hp + (size_t)(t - 1) * stride : h0p);
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kLanes)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ h,
                          const float* __restrict__ h0,
                          const float* __restrict__ dh,
                          const float* __restrict__ dhT,
                          float* __restrict__ dx, float* __restrict__ da,
                          float* __restrict__ dh0, int S, int D) {
  __shared__ BwdStage ring[kStages];
  const int lane = threadIdx.x;
  const int d = blockIdx.x * kLanes + lane;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t stride = (size_t)D;
  const size_t base = (size_t)b * (size_t)S * stride + (size_t)d;
  const size_t row = (size_t)b * stride + d;
  const int n_stages = (S + kT - 1) / kT;

  for (int s = 0; s < kStages - 1; ++s)
    load_bwd_stage(ring, s, n_stages, S, lane, dh + base, a + base, h + base,
                   h0 + row, stride);
  float c = dhT != nullptr ? dhT[row] : 0.f;
  for (int s = 0; s < n_stages; ++s) {
    load_bwd_stage(ring, s + kStages - 1, n_stages, S, lane, dh + base,
                   a + base, h + base, h0 + row, stride);
    cp_async_wait_ring();  // stage s has landed
    const int slot = s % kStages;
    const int t0 = S - 1 - s * kT;
    const int n = t0 + 1 < kT ? t0 + 1 : kT;
    for (int u = 0; u < n; ++u) {
      const size_t off = base + (size_t)(t0 - u) * stride;
      const float g = __fadd_rn(ring[slot][u][0][lane], c);
      __stcs(dx + off, g);
      __stcs(da + off, __fmul_rn(g, ring[slot][u][2][lane]));
      c = __fmul_rn(ring[slot][u][1][lane], g);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  dh0[row] = c;
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
  dim3 grid((D + kLanes - 1) / kLanes, B);
  rglru_scan_bwd_kernel<<<grid, kLanes, 0, stream>>>(a, h, h0, dh, dhT, dx,
                                                     da, dh0, S, D);
  return (int)cudaGetLastError();
}
