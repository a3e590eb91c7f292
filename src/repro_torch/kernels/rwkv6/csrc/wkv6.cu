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
// 67 TFLOP/s, so operations bound it.  The recurrence is a dependent chain
// of S steps per state element, so the card is filled only by running many
// elements side by side, each thread's instructions mostly FMAs.
//
// Design.  Column j of the state, with y[j], depends only on v[j] and on
// the full vectors r, k, w and u, so columns are independent chains.  One
// block per (b, h); each thread holds an R-row x C-column tile of the state
// in registers (R = 16, C = 4 at N = 64: 64 threads, P = N / R = 4 row
// groups).  A step costs a thread 3 instructions per state element (acc +=
// r*S, kv = k*v, S = w*S + kv) plus 3R/4 + 1 shared-memory loads of r, k,
// w and v shared by its C columns.  The P row groups of a column sit in
// lanes CGW = 32 / P apart in one warp; their partial sums over rows are
// added in a shuffle tree that also scatters the C columns over the P
// lanes, so each lane ends with whole columns to write.  The bonus
// u_i k_i v_j is v_j * sum_i r_i u_i k_i: the dot product is taken once
// per step while the step is staged (each staging lane sums its rows,
// then a shuffle tree over the lanes of that step), and y_j gets v_j
// times it in one FMA.
//
// Staging: r, k, v (converted to f32) and w for kChunk steps sit in shared
// memory, double buffered.  The next chunk's 16-byte global loads are
// issued into registers before this chunk's steps run and land in the
// other buffer after them, so one barrier a chunk is all the staging
// costs.  Each step's arithmetic is the same wherever a chunk begins, so
// a run split into halves (the state carried across) is bitwise the
// whole run.  Sums run in another order than the plain version's (rows in
// groups of R, the groups in a tree; the bonus factored), so the kernel
// agrees with it within float32 rounding, not bitwise; FMA contraction is
// allowed (the tolerance is 2e-5 in f32).  Any S >= 1 works (S = 1 is the
// decode step: the state's read and write are then the whole cost, and
// each warp reads whole 16-byte rows of it); N is 16, 32 or 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// the state tile of a thread at N = 64: WKV_ROWS rows x WKV_COLS columns
#ifndef WKV_ROWS
#define WKV_ROWS 16
#endif
#ifndef WKV_COLS
#define WKV_COLS 4
#endif

namespace {

constexpr int kChunk = 16;             // steps staged at a time
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one 16-byte unit of r, k or v as f32: 8 bf16 (exactly, by a shift) or
// 4 f32
template <typename T>
__device__ __forceinline__ void unpack(uint4 q, float* f) {
  const unsigned x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if constexpr (sizeof(T) == 2) {
      f[2 * a] = __uint_as_float(x[a] << 16);
      f[2 * a + 1] = __uint_as_float(x[a] & 0xffff0000u);
    } else {
      f[a] = __uint_as_float(x[a]);
    }
  }
}

// C consecutive floats at p (16-, 8- or 4-byte aligned)
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c);
      out[c] = q.x, out[c + 1] = q.y, out[c + 2] = q.z, out[c + 3] = q.w;
    }
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x, out[1] = q.y;
  } else {
    out[0] = *p;
  }
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float* in) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(in[c], in[c + 1], in[c + 2], in[c + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

template <typename T, int N, int R, int C>
struct Tile {
  static constexpr int P = N / R;          // row groups summed per column
  static constexpr int CG = N / C;         // column groups
  static constexpr int NT = P * CG;        // threads per (b, h)
  static constexpr int CGW = 32 / P;       // column groups per warp
  static constexpr int EPU = 16 / (int)sizeof(T);  // r/k/v values a unit
  static constexpr int U = N / EPU;        // units of r, k or v a step
  static constexpr int UW = N / 4;         // units of w a step
  static constexpr int QR = kChunk * U / NT;   // r/k/v units a thread stages
  static constexpr int QW = kChunk * UW / NT;  // w units a thread stages
  static constexpr int LV = log2i(P);      // shuffle levels
  static constexpr int SC = log2i(C) < LV ? log2i(C) : LV;  // scatter levels
  static constexpr int KEEP = C >> SC;     // columns a lane ends with
  static_assert(P * R == N && C * CG == N && (P & (P - 1)) == 0, "tile");
  static_assert(NT % 32 == 0 && CG % CGW == 0, "whole warps");
  static_assert(32 % U == 0 && NT % U == 0 && NT % UW == 0, "staging lanes");
  static_assert(QR * NT == kChunk * U && QW * NT == kChunk * UW, "staging");
  static_assert(R % 4 == 0, "rows in float4s");
};

template <typename T, int N, int R, int C>
__global__ void __launch_bounds__(Tile<T, N, R, C>::NT)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ sT, int S, int H) {
  using G = Tile<T, N, R, C>;
  constexpr int NT = G::NT, CGW = G::CGW, EPU = G::EPU, U = G::U;
  constexpr int UW = G::UW, QR = G::QR, QW = G::QW;
  __shared__ __align__(16) float rs[2][kChunk][N];
  __shared__ __align__(16) float ks[2][kChunk][N];
  __shared__ __align__(16) float ws[2][kChunk][N];
  __shared__ __align__(16) float vs[2][kChunk][N];
  __shared__ float bonus[2][kChunk];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = lane / CGW;                      // this lane's row group
  const int j0 = ((tid >> 5) * CGW + lane % CGW) * C;  // first column
  const int i0 = p * R;                          // first row

  // u for the rows this thread stages (the same unit of every step)
  const int part = tid % U;
  float uu[EPU];
#pragma unroll
  for (int e = 0; e < EPU; ++e) uu[e] = u[(size_t)h * N + part * EPU + e];

  float st[R][C];
  const size_t sbase = (size_t)bh * N * N + (size_t)i0 * N + j0;
#pragma unroll
  for (int i = 0; i < R; ++i)
    load_cols<C>(s0 + sbase + (size_t)i * N, st[i]);

  const size_t row = (size_t)H * N;                     // one timestep
  const size_t base = ((size_t)b * S * H + h) * N;      // (b, 0, h, 0)
  uint4 pr[QR], pk[QR], pv[QR];
  float4 pw[QW];

  // the 16-byte global loads of chunk t0 into registers
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < QR; ++q) {
      const int e = tid + q * NT, t = t0 + e / U;
      pr[q] = pk[q] = pv[q] = make_uint4(0u, 0u, 0u, 0u);
      if (t < S) {
        const size_t off = base + (size_t)t * row + (e % U) * EPU;
        pr[q] = __ldg(reinterpret_cast<const uint4*>(r + off));
        pk[q] = __ldg(reinterpret_cast<const uint4*>(k + off));
        pv[q] = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
    }
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      const int e = tid + q * NT, t = t0 + e / UW;
      pw[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < S)
        pw[q] = __ldg(reinterpret_cast<const float4*>(
            w + base + (size_t)t * row + (e % UW) * 4));
    }
  };
  // the fetched chunk into shared buffer `buf` as f32, with each step's
  // bonus dot product sum_i r_i u_i k_i: rows in order within a unit, then
  // a tree over the U lanes that staged the step
  auto stage = [&](int buf) {
#pragma unroll
    for (int q = 0; q < QR; ++q) {
      const int e = tid + q * NT, t = e / U, i = (e % U) * EPU;
      float fr[EPU], fk[EPU], fv[EPU];
      unpack<T>(pr[q], fr);
      unpack<T>(pk[q], fk);
      unpack<T>(pv[q], fv);
      store_cols<EPU>(&rs[buf][t][i], fr);
      store_cols<EPU>(&ks[buf][t][i], fk);
      store_cols<EPU>(&vs[buf][t][i], fv);
      float dot = (fr[0] * uu[0]) * fk[0];
#pragma unroll
      for (int a = 1; a < EPU; ++a) dot = fmaf(fr[a] * uu[a], fk[a], dot);
#pragma unroll
      for (int o = 1; o < U; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
      if (part == 0) bonus[buf][t] = dot;
    }
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      const int e = tid + q * NT;
      *reinterpret_cast<float4*>(&ws[buf][e / UW][(e % UW) * 4]) = pw[q];
    }
  };

  fetch(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kChunk, buf ^= 1) {
    const int n = min(kChunk, S - t0);
    const bool more = t0 + kChunk < S;
    if (more) fetch(t0 + kChunk);  // in flight while this chunk runs
    for (int c = 0; c < n; ++c) {
      float rr[R], kk[R], ww[R], vv[C], acc[C];
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        load_cols<4>(&rs[buf][c][i0 + i], rr + i);
        load_cols<4>(&ks[buf][c][i0 + i], kk + i);
        load_cols<4>(&ws[buf][c][i0 + i], ww + i);
      }
      load_cols<C>(&vs[buf][c][j0], vv);
#pragma unroll
      for (int cc = 0; cc < C; ++cc) acc[cc] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          acc[cc] = fmaf(rr[i], st[i][cc], acc[cc]);
          st[i][cc] = fmaf(ww[i], st[i][cc], kk[i] * vv[cc]);
        }
      }
      // sum the P row groups: a tree over lanes CGW apart, level l adding
      // the partner whose bit l of p differs; while a lane holds several
      // columns, it keeps half of them and hands the other half over
      int off = 0;
#pragma unroll
      for (int l = 0; l < G::LV; ++l) {
        const int o = CGW << l;
        const bool hi = (p >> l) & 1;
        if (l < G::SC) {
          const int half = C >> (l + 1);
#pragma unroll
          for (int q = 0; q < C / 2; ++q) {
            if (q < half) {
              const float send = hi ? acc[q] : acc[q + half];
              const float keep = hi ? acc[q + half] : acc[q];
              acc[q] = keep + __shfl_xor_sync(kFull, send, o);
            }
          }
          off += hi ? half : 0;
        } else {
          acc[0] += __shfl_xor_sync(kFull, acc[0], o);
        }
      }
      if ((p >> G::SC) == 0) {
        const size_t yo = base + (size_t)(t0 + c) * row;
#pragma unroll
        for (int q = 0; q < G::KEEP; ++q) {
          const int j = j0 + off + q;
          const float yj = fmaf(vs[buf][c][j], bonus[buf][c], acc[q]);
          y[yo + j] = from_f32<T>(yj);
        }
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    store_cols<C>(sT + sbase + (size_t)i * N, st[i]);
}

template <typename T, int N, int R, int C>
int launch_tile(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, void* y, float* sT, int B,
                int S, int H, cudaStream_t stream) {
  wkv6_kernel<T, N, R, C><<<B * H, Tile<T, N, R, C>::NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), sT, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* sT, int B, int S,
           int H, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_tile<T, 16, 8, 1>(r, k, v, w, u, s0, y, sT, B, S, H,
                                      stream);
    case 32:
      return launch_tile<T, 32, 16, 2>(r, k, v, w, u, s0, y, sT, B, S, H,
                                       stream);
    case 64:
      return launch_tile<T, 64, WKV_ROWS, WKV_COLS>(r, k, v, w, u, s0, y, sT,
                                                    B, S, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (B, S, H, N) bf16 (is_bf16 = 1) or f32; w: (B, S, H, N) f32;
// u: (H, N) f32; s0, sT: (B, H, N, N) f32; y: (B, S, H, N) in r's dtype.
// All contiguous and 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
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
