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

#include <atomic>

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

// ----------------------------------------------------------------------
// The backward: the gradients of the recurrence above by the reverse
// recurrence.  Per (b, h), G_t = dL/dS_t (G after the last step is dsT,
// or 0), S_{t-1} the state before step t:
//
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]      + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]      + dy_t[j] sum_i r_t[i] u[i] k_t[i]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,        ds0 = G_0
//
// The TPU kernel has no backward: the JAX package differentiates its plain
// WKV (src/repro/kernels/rwkv6/ref.py:18, jax.checkpoint per chunk).
//
// What bounds it on an H100: at a training microbatch (B=1, S=4096, H=64,
// N=64) the function needs 14 float32 operations per state element and
// step (3 to rebuild S, 3 for G's update, 2 for each of the four sums)
// and 15 N per (b, t, h) for the bonus terms: 15.3 GFLOP, 0.228 ms at
// 67 TFLOP/s, against 0.11 ms for its bytes, so operations bound it.
//
// Design (simple first; its Hopper redesign waits for a benchmark).  Column
// j of S evolves with w, k and v[j] alone, column j of G with w, r and
// dy[j] alone, so a thread owns the same R-row x CC-column tile of both
// chains.  One block per (b, h); lanes of a warp split the columns (LC = 16
// lanes of CC = N / 16 columns) and two row groups of R = 8 rows, warps
// the remaining rows.  dr, dk and dw sum across columns: inside the
// thread, then a shuffle tree over the LC lanes that also scatters the R
// rows, one row to a lane.  dv sums across rows: inside the thread, a
// shuffle over the two row groups, then per-warp partials in shared memory
// added in warp order once a chunk.  du sums over t in each (b, h) block,
// then a second launch adds the B partials of each head in order.  No
// atomics: every output element has one writer, so two calls agree
// bitwise.
//
// S_{t-1} is never recovered by dividing by w (w = exp(-exp(x)) underflows
// towards 0): a first pass stores every kBwdChunk-th state to a scratch
// (S / kBwdChunk states a (b, h)); then each chunk, last first, rebuilds
// its kBwdChunk states into shared memory from the one stored at its start
// and walks back through them.  r, k, v, w and dy of the chunk are staged
// in shared memory as f32, with each step's v . dy and sum_i r u k.

namespace {

constexpr int kBwdChunk = 8;           // states rebuilt at a time

template <int N>
struct BwdTile {
  static constexpr int R = 8;              // rows a thread holds
  static constexpr int LC = 16;            // lanes across the columns
  static constexpr int LR = 32 / LC;       // row groups in a warp
  static constexpr int CC = N / LC;        // columns a thread holds
  static constexpr int W = N / (R * LR);   // warps
  static constexpr int NT = 32 * W;        // threads per (b, h)
  static constexpr int RC = R * CC;        // tile elements
  static constexpr int SCR = log2i(R) < log2i(LC) ? log2i(R) : log2i(LC);
  static constexpr int SCC = log2i(CC) < log2i(LR) ? log2i(CC) : log2i(LR);
  // shared floats: the rebuilt states, r/k/w/v/dy staged, u, each step's
  // bonus and v . dy, per-warp dv partials
  static constexpr int KN = kBwdChunk * N;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)kBwdChunk * N * N + 5 * KN + N +
                       2 * kBwdChunk + (size_t)W * KN);
  static_assert(CC * LC == N && W * R * LR == N && W >= 1, "bwd tile");
  static_assert(KN % 4 == 0 && N % 4 == 0, "float4 carving");
};

// levels of a tree over L lanes, and those that scatter V values
template <int V, int L>
struct Scatter {
  static constexpr int LV = log2i(L);
  static constexpr int SC = log2i(V) < LV ? log2i(V) : LV;
};

// a[0..V) summed over the L lanes idx ^ (1 << l) (lane stride STRIDE);
// while a lane holds more than one value it keeps half of them and hands
// the other half to its partner, so it ends with V >> SC totals: those
// of indices scatter_off(idx) .. + (V >> SC)
template <int V, int L, int STRIDE>
__device__ __forceinline__ void reduce_scatter(float* a, int idx) {
  constexpr int LV = Scatter<V, L>::LV, SC = Scatter<V, L>::SC;
#pragma unroll
  for (int l = 0; l < LV; ++l) {
    const int o = STRIDE << l;
    if (l < SC) {
      const int half = V >> (l + 1);
      const bool hi = (idx >> l) & 1;
#pragma unroll
      for (int q = 0; q < (V + 1) / 2; ++q) {
        if (q < half) {
          const float send = hi ? a[q] : a[q + half];
          const float keep = hi ? a[q + half] : a[q];
          a[q] = keep + __shfl_xor_sync(kFull, send, o);
        }
      }
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], o);
    }
  }
}
template <int V, int L>
__device__ __forceinline__ int scatter_off(int idx) {
  constexpr int SC = Scatter<V, L>::SC;
  int off = 0;
#pragma unroll
  for (int l = 0; l < SC; ++l) off += ((idx >> l) & 1) ? (V >> (l + 1)) : 0;
  return off;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(BwdTile<N>::NT)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    const T* __restrict__ dy, const float* __restrict__ dsT,
                    float* __restrict__ drg, float* __restrict__ dkg,
                    float* __restrict__ dvg, float* __restrict__ dwg,
                    float* __restrict__ du_part, float* __restrict__ ds0,
                    float* __restrict__ ckpt, int S, int H) {
  using G = BwdTile<N>;
  constexpr int R = G::R, CC = G::CC, LC = G::LC, NT = G::NT, RC = G::RC;
  constexpr int K = kBwdChunk, KN = G::KN;
  extern __shared__ float4 smem4[];
  float* const stash = reinterpret_cast<float*>(smem4);  // [K][RC][NT]
  float* const rs = stash + (size_t)K * N * N;           // [K][N] each
  float* const ks = rs + KN;
  float* const ws = ks + KN;
  float* const vs = ws + KN;
  float* const ds = vs + KN;
  float* const us = ds + KN;                             // [N]
  float* const bonus = us + N;                           // [K]
  float* const vdy = bonus + K;                          // [K]
  float* const dvp = vdy + K;                            // [W][K][N]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wi = tid >> 5, lane = tid & 31;
  const int lc = lane % LC, lr = lane / LC;
  const int i0 = (wi * G::LR + lr) * R;          // first row of the tile
  const int j0 = lc * CC;                        // first column
  const int roff = scatter_off<R, LC>(lc);       // the row a lane sums
  const bool rwriter = (lc >> G::SCR) == 0;
  const int row = i0 + roff;
  const int voff = scatter_off<CC, G::LR>(lr);   // the columns it sums
  const bool vwriter = (lr >> G::SCC) == 0;

  for (int e = tid; e < N; e += NT) us[e] = u[(size_t)h * N + e];
  __syncthreads();
  const int n_chunks = (S + K - 1) / K;
  const size_t row_stride = (size_t)H * N;               // one timestep
  const size_t base = ((size_t)b * S * H + h) * N;       // (b, 0, h, 0)
  float* const my_ckpt = ckpt + (size_t)bh * n_chunks * RC * NT + tid;

  // chunk t0's n steps of the given inputs into shared memory as f32
  // (steps past S as 0)
  auto stage = [&](int t0, bool all) {
    for (int e = tid; e < KN; e += NT) {
      const int t = t0 + e / N;
      const size_t off = base + (size_t)t * row_stride + e % N;
      const bool in = t < S;
      ks[e] = in ? to_f32<T>(k[off]) : 0.f;
      vs[e] = in ? to_f32<T>(v[off]) : 0.f;
      ws[e] = in ? w[off] : 0.f;
      if (all) {
        rs[e] = in ? to_f32<T>(r[off]) : 0.f;
        ds[e] = in ? to_f32<T>(dy[off]) : 0.f;
      }
    }
  };
  // one forward step on the tile: S = w S + k v
  auto advance = [&](float (&st)[R][CC], int m) {
    float kk[R], ww[R], vv[CC];
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      load_cols<4>(&ks[m * N + i0 + i], kk + i);
      load_cols<4>(&ws[m * N + i0 + i], ww + i);
    }
    load_cols<CC>(&vs[m * N + j0], vv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < CC; ++c) st[i][c] = fmaf(ww[i], st[i][c], kk[i] * vv[c]);
  };

  // pass 1: the state at the start of every chunk, into the scratch
  float st[R][CC];
  const size_t sbase = (size_t)bh * N * N + (size_t)i0 * N + j0;
#pragma unroll
  for (int i = 0; i < R; ++i) load_cols<CC>(s0 + sbase + (size_t)i * N, st[i]);
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        my_ckpt[((size_t)c * RC + i * CC + cc) * NT] = st[i][cc];
    if (c + 1 == n_chunks) break;     // the last chunk's steps are not needed
    stage(c * K, false);
    __syncthreads();
#pragma unroll 1
    for (int m = 0; m < K; ++m) advance(st, m);
    __syncthreads();
  }

  // pass 2: each chunk, last first, rebuilt and walked back
  float g[R][CC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (dsT != nullptr) {
      load_cols<CC>(dsT + sbase + (size_t)i * N, g[i]);
    } else {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) g[i][cc] = 0.f;
    }
  }
  const float u_row = us[row];
  float du_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * K, n = min(K, S - t0);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        st[i][cc] = my_ckpt[((size_t)c * RC + i * CC + cc) * NT];
    stage(t0, true);
    __syncthreads();
    if (tid < n) {       // step tid's v . dy and sum_i r u k, in order
      float a = 0.f, bo = 0.f;
      for (int j = 0; j < N; ++j) a = fmaf(vs[tid * N + j], ds[tid * N + j], a);
      for (int i = 0; i < N; ++i)
        bo = fmaf(rs[tid * N + i] * us[i], ks[tid * N + i], bo);
      vdy[tid] = a;
      bonus[tid] = bo;
    }
#pragma unroll 1
    for (int m = 0; m < n; ++m) {     // stash[m] = S before step t0 + m
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
          stash[((size_t)m * RC + i * CC + cc) * NT + tid] = st[i][cc];
      if (m + 1 < n) advance(st, m);
    }
    __syncthreads();
#pragma unroll 1
    for (int m = n - 1; m >= 0; --m) {
      float rr[R], kk[R], ww[R], vv[CC], dd[CC];
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        load_cols<4>(&rs[m * N + i0 + i], rr + i);
        load_cols<4>(&ks[m * N + i0 + i], kk + i);
        load_cols<4>(&ws[m * N + i0 + i], ww + i);
      }
      load_cols<CC>(&vs[m * N + j0], vv);
      load_cols<CC>(&ds[m * N + j0], dd);
      float pr[R], pk[R], pw[R], pv[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) pv[cc] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pr[i] = pk[i] = pw[i] = 0.f;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float sp = stash[((size_t)m * RC + i * CC + cc) * NT + tid];
          pr[i] = fmaf(sp, dd[cc], pr[i]);
          pk[i] = fmaf(g[i][cc], vv[cc], pk[i]);
          pw[i] = fmaf(g[i][cc], sp, pw[i]);
          pv[cc] = fmaf(g[i][cc], kk[i], pv[cc]);
          g[i][cc] = fmaf(ww[i], g[i][cc], rr[i] * dd[cc]);
        }
      }
      reduce_scatter<R, LC, 1>(pr, lc);
      reduce_scatter<R, LC, 1>(pk, lc);
      reduce_scatter<R, LC, 1>(pw, lc);
      reduce_scatter<CC, G::LR, LC>(pv, lr);
      const int t = t0 + m;
      const float a = vdy[m];
      if (rwriter) {
        const size_t o = base + (size_t)t * row_stride + row;
        const float r_i = rs[m * N + row], k_i = ks[m * N + row];
        drg[o] = pr[0] + u_row * k_i * a;
        dkg[o] = pk[0] + r_i * u_row * a;
        dwg[o] = pw[0];
        du_acc = fmaf(r_i * k_i, a, du_acc);
      }
      if (vwriter) {
#pragma unroll
        for (int q = 0; q < (CC >> G::SCC); ++q)
          dvp[(wi * K + m) * N + j0 + voff + q] = pv[q];
      }
    }
    __syncthreads();
    // dv: the warps' partials in order, then dy_j times the step's bonus
    for (int e = tid; e < n * N; e += NT) {
      const int m = e / N, j = e % N;
      float a = dvp[m * N + j];
      for (int x = 1; x < G::W; ++x) a += dvp[(x * K + m) * N + j];
      dvg[base + (size_t)(t0 + m) * row_stride + j] =
          fmaf(ds[m * N + j], bonus[m], a);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) store_cols<CC>(ds0 + sbase + (size_t)i * N, g[i]);
  if (rwriter) du_part[(size_t)bh * N + row] = du_acc;
}

// du[h][i] = sum_b du_part[b][h][i], b in order
__global__ void wkv6_du_kernel(const float* __restrict__ du_part,
                               float* __restrict__ du, int B, int H, int N) {
  const int h = blockIdx.x, i = threadIdx.x;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += du_part[((size_t)b * H + h) * N + i];
  du[(size_t)h * N + i] = a;
}

template <typename T, int N>
int launch_bwd(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, const void* dy,
               const float* dsT, float* dr, float* dk, float* dv, float* dw,
               float* du, float* ds0, float* ckpt, float* du_part, int B,
               int S, int H, cudaStream_t stream) {
  using G = BwdTile<N>;
  // more than 48 KB of dynamic shared memory, allowed once per device: a
  // launch inside a CUDA graph's capture then sets no attribute
  static std::atomic<unsigned> allowed{0u};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(wkv6_bwd_kernel<T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::SMEM);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  wkv6_bwd_kernel<T, N><<<B * H, G::NT, G::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<const T*>(dy), dsT, dr,
      dk, dv, dw, du_part, ds0, ckpt, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_du_kernel<<<H, N, 0, stream>>>(du_part, du, B, H, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_n(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* s0, const void* dy,
                 const float* dsT, float* dr, float* dk, float* dv, float* dw,
                 float* du, float* ds0, float* ckpt, float* du_part, int B,
                 int S, int H, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_bwd<T, 16>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du,
                               ds0, ckpt, du_part, B, S, H, stream);
    case 32:
      return launch_bwd<T, 32>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du,
                               ds0, ckpt, du_part, B, S, H, stream);
    case 64:
      return launch_bwd<T, 64>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du,
                               ds0, ckpt, du_part, B, S, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The scratch ``ckpt`` holds B * H * ceil(S / 8) * N * N floats (the
// states stored by the first pass, wkv6_bwd_ckpt_floats), ``du_part`` B * H
// * N.  r, k, v, dy: (B, S, H, N) bf16 (is_bf16 = 1) or f32; w (B, S, H, N),
// u (H, N), s0 and dsT (B, H, N, N; dsT may be null for 0) f32; dr, dk, dv,
// dw (B, S, H, N), du (H, N), ds0 (B, H, N, N) f32.  All contiguous and
// 16-byte aligned; S >= 1.  Returns cudaGetLastError() after the launches.
extern "C" long long wkv6_bwd_ckpt_floats(int B, int S, int H, int N) {
  return (long long)B * H * ((S + kBwdChunk - 1) / kBwdChunk) * N * N;
}

extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0,
                        const void* dy, const float* dsT, float* dr,
                        float* dk, float* dv, float* dw, float* du,
                        float* ds0, float* ckpt, float* du_part, int B, int S,
                        int H, int N, int is_bf16, cudaStream_t stream) {
  if ((long long)B * H > 0x7fffffffLL || S < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (is_bf16)
    return launch_bwd_n<__nv_bfloat16>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv,
                                       dw, du, ds0, ckpt, du_part, B, S, H, N,
                                       stream);
  return launch_bwd_n<float>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du,
                             ds0, ckpt, du_part, B, S, H, N, stream);
}
