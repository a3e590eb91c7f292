// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t, per (batch, channel).
//
// Replaces the TPU kernel src/repro/kernels/rg_lru/kernel.py::rglru_scan
// (_rglru_kernel), which streamed (chunk, 128) tiles through VMEM with h in
// a VMEM scratch carried along a sequential grid axis.
//
// What bounds it on an H100: the data is 12 bytes per element (x and a
// read, y written, all f32) for two flops, so the floor is the memory rate
// (at B=4, S=4096, D=2560: 503 MB, 0.150 ms at 3.35 TB/s).  But the
// recurrence is a dependent chain of S steps per channel, and there are
// only B*D chains (10,240 on the main path), too few threads to hide
// memory latency by occupancy alone.
//
// Design: one thread per (b, channel), h in a register, blocks of 64
// channels so loads are coalesced across channels and the 160 blocks of
// the main path spread over the 132 SMs.  The loads of x and a do not
// depend on h, so each thread issues UNROLL steps of loads at once and
// only then runs the chain over registers: one memory round trip per
// UNROLL steps instead of one per step.  The step is spelled
// __fadd_rn(__fmul_rn(a, h), x) so nvcc cannot contract it into an FMA:
// the kernel is bit-identical to the plain PyTorch loop (one mul, one add).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 32;

__global__ void rglru_scan_kernel(const float* __restrict__ x,
                                  const float* __restrict__ a,
                                  const float* __restrict__ h0,
                                  float* __restrict__ y,
                                  float* __restrict__ hT, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t stride = (size_t)D;
  const size_t base = (size_t)b * (size_t)S * stride + (size_t)d;
  float h = h0[(size_t)b * stride + d];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + (size_t)(t + u) * stride;
      av[u] = __ldg(a + i);
      xv[u] = __ldg(x + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      y[base + (size_t)(t + u) * stride] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + (size_t)t * stride;
    h = __fadd_rn(__fmul_rn(__ldg(a + i), h), __ldg(x + i));
    y[i] = h;
  }
  hT[(size_t)b * stride + d] = h;
}

}  // namespace

extern "C" int rglru_scan(const float* x, const float* a, const float* h0,
                          float* y, float* hT, int B, int S, int D,
                          cudaStream_t stream) {
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, stream>>>(x, a, h0, y, hT, S, D);
  return (int)cudaGetLastError();
}
