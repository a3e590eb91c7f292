// RWKV6 (Finch) WKV recurrence with data-dependent decay, per (batch, head):
//
//   y_t[j]  = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// all in float32; y is written in r's dtype (bf16 or f32), the final state
// in f32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::wkv6
// (_wkv_kernel), which kept the whole (N, N) state of one (b, h) as a VMEM
// tile and walked the time chunks along a sequential grid axis.
//
// What bounds it on an H100: at the serving path's prefill (B=4, S=4096,
// H=64, N=64, bf16 r/k/v, f32 w) the data is 814 MB (0.24 ms at
// 3.35 TB/s), and each state element needs 5 float32 operations a step
// (y += r*S, an FMA; S = w*S + k*v, a product and an FMA) while the bonus
// is v[j] times one dot product a step: 21.8 GFLOP, 0.33 ms at
// 67 TFLOP/s, so operations bound it.
// But the recurrence is a dependent chain of S steps, and a (b, h) has only
// N*N state elements, so the work in flight at any moment is small.
//
// Design: column j of the state, with y[j], depends only on v[j] and on the
// full vectors r, k, w and u, so there are B*H*N independent chains.  One
// block of N threads per (b, h); thread j keeps S[:, j] (N floats) in
// registers.  The block stages r, k, w and v for kChunk timesteps at a time
// in shared memory, converting to f32 as it loads (coalesced: the N values
// of one (b, t, h) are contiguous); each step then reads r, k, w and u as
// broadcast float4s.  The sum over i runs in four partial sums to shorten
// the dependent chain, so it is not in the plain version's order: the
// kernel agrees with it within float32 rounding, not bitwise.  Contraction
// into FMAs is allowed (no -fmad=false): the tolerance is 2e-5 in f32.
// Any S >= 1 works (S = 1 is the decode step); N is 16, 32 or 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kChunk = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ sT, int S, int H) {
  __shared__ __align__(16) float rs[kChunk][N];
  __shared__ __align__(16) float ks[kChunk][N];
  __shared__ __align__(16) float ws[kChunk][N];
  __shared__ __align__(16) float vs[kChunk][N];
  __shared__ __align__(16) float us[N];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  us[j] = u[(size_t)h * N + j];

  float st[N];
  const size_t sbase = (size_t)bh * N * N + j;
#pragma unroll
  for (int i = 0; i < N; ++i) st[i] = s0[sbase + (size_t)i * N];

  const size_t row = (size_t)H * N;                    // one timestep
  const size_t base = ((size_t)b * S * H + h) * N + j;  // (b, 0, h, j)
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < n) {
        const size_t off = base + (size_t)(t0 + c) * row;
        rs[c][j] = to_f32(r[off]);
        ks[c][j] = to_f32(k[off]);
        vs[c][j] = to_f32(v[off]);
        ws[c][j] = w[off];
      }
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        float kv;
        kv = k4.x * vj;
        y0 = fmaf(r4.x, fmaf(u4.x, kv, st[i]), y0);
        st[i] = fmaf(w4.x, st[i], kv);
        kv = k4.y * vj;
        y1 = fmaf(r4.y, fmaf(u4.y, kv, st[i + 1]), y1);
        st[i + 1] = fmaf(w4.y, st[i + 1], kv);
        kv = k4.z * vj;
        y2 = fmaf(r4.z, fmaf(u4.z, kv, st[i + 2]), y2);
        st[i + 2] = fmaf(w4.z, st[i + 2], kv);
        kv = k4.w * vj;
        y3 = fmaf(r4.w, fmaf(u4.w, kv, st[i + 3]), y3);
        st[i + 3] = fmaf(w4.w, st[i + 3], kv);
      }
      y[base + (size_t)(t0 + c) * row] = from_f32<T>((y0 + y1) + (y2 + y3));
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sT[sbase + (size_t)i * N] = st[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* sT, int B, int S,
           int H, int N, cudaStream_t stream) {
  const dim3 grid(B * H);
  const T *rp = static_cast<const T*>(r), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v);
  T* yp = static_cast<T*>(y);
  switch (N) {
    case 16:
      wkv6_kernel<T, 16><<<grid, 16, 0, stream>>>(rp, kp, vp, w, u, s0, yp,
                                                   sT, S, H);
      break;
    case 32:
      wkv6_kernel<T, 32><<<grid, 32, 0, stream>>>(rp, kp, vp, w, u, s0, yp,
                                                   sT, S, H);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, stream>>>(rp, kp, vp, w, u, s0, yp,
                                                   sT, S, H);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v: (B, S, H, N) bf16 (is_bf16 = 1) or f32; w: (B, S, H, N) f32;
// u: (H, N) f32; s0, sT: (B, H, N, N) f32; y: (B, S, H, N) in r's dtype.
// All contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0,
                        void* y, float* sT, int B, int S, int H, int N,
                        int is_bf16, cudaStream_t stream) {
  if ((long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, S, H, N,
                                 stream);
  return launch<float>(r, k, v, w, u, s0, y, sT, B, S, H, N, stream);
}
