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

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

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
// 67 TFLOP/s, against 0.11 ms for its bytes, so operations bound it.  The
// two recurrences are chains of S dependent steps per state element, so
// the card is filled only by running many elements side by side.
//
// Design.  Column j of S evolves with w, k and v[j] alone, column j of G
// with w, r and dy[j] alone, so the columns of one (b, h) split across
// CTAs with no exchange in the recurrences; only the sums across columns
// (dr, dk, dw) meet.  Each (b, h) is a thread-block cluster of CL = N / NC
// CTAs (NC = WKV_BWD_COLS columns each, 32 by default: 2 CTAs of 256
// threads at N = 64, 128 CTAs at B = 1 on 132 SMs; 16 columns, 4 CTAs of
// 128, measured slower at B = 1 and B = 4, PERF.md).  A thread holds the
// same 2-row x 4-column tile of S and of G in registers.
//
//   * States.  A first pass walks forward and writes every kBwdK-th state
//     (16) to a scratch (`wkv6_bwd_ckpt_floats`: 268 MB at B = 1 x 4,096,
//     each way, 0.16 ms round trip at 3.35 TB/s).  Then each chunk of
//     kBwdK steps, last first, is walked back half a chunk at a time: the
//     half's 8 states are rebuilt into registers (indexed at compile time:
//     the loops are unrolled) from the chunk's stored state, the second
//     half's after 8 steps more.  S_{t-1} is never recovered by dividing
//     by w (w = exp(-exp(x)) underflows towards 0).
//   * Inputs.  A chunk's r, k, v, w and dy are (kBwdK steps x N) boxes at
//     a row stride of H N: warp 0 loads them by TMA (one lane issues) into
//     a ring of WKV_BWD_RING raw buffers, completing on each buffer's
//     mbarrier, that many chunks ahead (the first pass loads k, v and w
//     only, and reads them as they landed).  For the second pass all
//     threads convert a landed chunk to float32 in one of three staging
//     slots, with each step's v . dy and sum_i r u k (8 elements in order
//     a thread, then a tree over the N / 8 threads of the step).
//   * Sums.  dv sums across rows, all inside the CTA: in the thread, a
//     reduce-scatter over the warp's row groups, per-warp partials in
//     shared memory.  dr, dk and dw: in the thread over its 4 columns, one
//     reduce-scatter of the three over the NC / 4 lanes of the CTA's
//     columns, then each lane stores its total straight into the shared
//     memory of the row's owner (distributed shared memory).  After a
//     cluster barrier, the CTA of rank q adds, for the NC rows it owns,
//     the totals of ranks 0 .. CL-1 in rank order: one exchange a chunk,
//     no atomics, every output element one writer, so two calls agree
//     bitwise.  The exchange of chunk c+1 runs once chunk c's first states
//     are rebuilt, so the barrier's release finds the walk's stores done.
//   * The walk back loads a step's operands a step ahead and reduces each
//     step's products a step behind them, so loads, products and lane
//     trees of three steps overlap; no step has a branch.
//   * du sums over t in the owning threads (a fixed set of steps each,
//     then the threads of a row in order), then a second launch adds the B
//     partials of each head in order.
//
// Summation orders (the CPU twin is ref.wkv6_bwd_tiled): dr/dk/dw, 4
// columns in order, a pairwise tree over the lanes, ranks in order, then
// the bonus term; dv, 2 rows, a pairwise tree over the warp's row groups,
// warps in order, then dy times the bonus.

namespace {

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

#ifndef WKV_BWD_COLS
#define WKV_BWD_COLS 32  // columns of the state one CTA owns
#endif
#ifndef WKV_BWD_RING
#define WKV_BWD_RING 4   // chunks landing at once by TMA
#endif
static_assert(WKV_BWD_COLS == 16 || WKV_BWD_COLS == 32, "CTA columns");
static_assert(WKV_BWD_RING >= 2, "a ring of two at least");

constexpr int kBwdK = 16;  // steps a chunk: the checkpoint stride

template <int N>
struct Bwd {
  static constexpr int NC = WKV_BWD_COLS < N ? WKV_BWD_COLS : N;
  static constexpr int CL = N / NC;        // CTAs a cluster: one (b, h)
  static constexpr int R = 2, C = 4;       // the tile of a thread
  static constexpr int RC = R * C;
  static constexpr int LC = NC / C;        // lanes across the CTA's columns
  static constexpr int RGW = 32 / LC;      // row groups a warp
  static constexpr int W = N / (R * RGW);  // warps
  static constexpr int NT = 32 * W;        // threads a CTA
  static constexpr int K = kBwdK;
  static constexpr int U = N / 8;          // staging threads a step
  static constexpr int SCV = Scatter<C, RGW>::SC;   // dv levels
  static_assert(CL * NC == N && CL <= 8, "a portable cluster");
  static_assert(W >= 1 && W * R * RGW == N && LC * C == NC, "bwd tile");
  static_assert(R == 2 && (LC == 4 || LC == 8), "the dr/dk/dw lane tree");
  static_assert(NT / U >= K && (K * U) % 32 == 0, "one staging pass");
  static_assert(NT % NC == 0, "a fixed row per exchanging thread");
};

template <typename T, int N>
struct BwdShared {
  using G = Bwd<N>;
  static constexpr int K = G::K, NC = G::NC;
  struct Raw {          // a chunk as it lands by TMA
    T r[K][N], k[K][N], v[K][N], dy[K][N];
    float w[K][N];
  };
  struct Stage {        // a chunk in float32; v and dy for this CTA's columns
    float r[K][N], k[K][N], w[K][N], v[K][NC], dy[K][NC], vdy[K], bonus[K];
  };
  Raw raw[WKV_BWD_RING];
  Stage stage[3];
  float part[2][3][K][G::CL][NC];  // the ranks' totals of this CTA's rows
  float dvp[2][G::W][K][NC];    // per-warp dv partials
  float u[N];
  float dusum[G::NT];
  uint64_t bar[WKV_BWD_RING];   // raw buffer landed
};

struct BwdMaps {
  CUtensorMap r, k, v, dy, w;
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

// The TMA's instructions take predicate `on`: a whole warp runs the code
// that computes their operands (warp-uniform, so no divergent loop wraps
// them) and one lane issues them.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes,
                                               bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes), "r"((int)on)
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

// box (x, t, b) of a (B, S, H N) map into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int t,
                                            int b, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n}" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(t), "r"(b), "r"((int)on)
      : "memory");
}

// the cluster's barrier, split: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// n = 2 or 4 consecutive elements of r, k, v or dy as float32
template <typename T, int n>
__device__ __forceinline__ void load_t(const T* p, float* f) {
  if constexpr (sizeof(T) == 4) {
    load_cols<n>(reinterpret_cast<const float*>(p), f);
  } else if constexpr (n == 2) {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    f[0] = __uint_as_float(x << 16), f[1] = __uint_as_float(x & 0xffff0000u);
  } else {
    static_assert(n == 4, "two or four elements");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(x.x << 16);
    f[1] = __uint_as_float(x.x & 0xffff0000u);
    f[2] = __uint_as_float(x.y << 16);
    f[3] = __uint_as_float(x.y & 0xffff0000u);
  }
}

// 8 consecutive elements of r, k, v or dy as float32
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
  unpack<T>(*reinterpret_cast<const uint4*>(p), f);
  if constexpr (sizeof(T) == 4)
    unpack<T>(*reinterpret_cast<const uint4*>(p + 4), f + 4);
}

template <typename T, int N>
__global__ void __launch_bounds__(Bwd<N>::NT)
    wkv6_bwd_kernel(const __grid_constant__ BwdMaps maps,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    const float* __restrict__ dsT, float* __restrict__ drg,
                    float* __restrict__ dkg, float* __restrict__ dvg,
                    float* __restrict__ dwg, float* __restrict__ du_part,
                    float* __restrict__ ds0, float* __restrict__ ckpt, int S,
                    int H) {
  using G = Bwd<N>;
  using SH = BwdShared<T, N>;
  using Raw = typename SH::Raw;
  using Stage = typename SH::Stage;
  constexpr int kRing = WKV_BWD_RING;
  constexpr int K = G::K, HK = K / 2, NC = G::NC, CL = G::CL, NT = G::NT;
  constexpr int R = G::R;
  constexpr int C = G::C, LC = G::LC, RGW = G::RGW, U = G::U, RC = G::RC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SH& sh = *reinterpret_cast<SH*>(smem_raw +
                                  ((128 - smem_addr(smem_raw) % 128) % 128));
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();  // this CTA's column group
  const int bh = blockIdx.x / CL;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wi = tid >> 5, lane = tid & 31;
  const int lc = lane % LC, rg = lane / LC;
  const int i0 = (wi * RGW + rg) * R;  // first row of the tile
  const int jl = lc * C;               // first column, within the CTA's
  const int nch = (S + K - 1) / K;
  const size_t rs = (size_t)H * N;                  // one timestep
  const size_t base = ((size_t)b * S * H + h) * N;  // (b, 0, h, 0)
  const size_t sbase = (size_t)bh * N * N + (size_t)i0 * N + q * NC + jl;
  float* const my_ckpt =
      ckpt + (size_t)blockIdx.x * nch * NT * RC + (size_t)tid * RC;

  for (int e = tid; e < N; e += NT) sh.u[e] = u[(size_t)h * N + e];
  if (tid == 0) {
    for (int x = 0; x < kRing; ++x) mbar_init(&sh.bar[x], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The loads, in order: the first pass's chunks 0 .. nch-2 (k, v, w),
  // then the second pass's nch-1 .. 0 (all five).  Load L goes to raw
  // buffer L % kRing; its mbarrier's phase L / kRing.  Warp 0 runs it,
  // its lane 0 issues.
  const bool lead = lane == 0;
  auto issue = [&](int L) {
    const bool full = L >= nch - 1;
    const int c = full ? 2 * (nch - 1) - L : L;
    Raw& rw = sh.raw[L % kRing];
    uint64_t* bar = &sh.bar[L % kRing];
    constexpr uint32_t kT = K * N * sizeof(T), kW = K * N * 4;
    mbar_expect_tx(bar, (full ? 4 : 2) * kT + kW, lead);
    const int x = h * N, t = c * K;
    tma_load_3d(&rw.k[0][0], &maps.k, bar, x, t, b, lead);
    tma_load_3d(&rw.v[0][0], &maps.v, bar, x, t, b, lead);
    tma_load_3d(&rw.w[0][0], &maps.w, bar, x, t, b, lead);
    if (full) {
      tma_load_3d(&rw.r[0][0], &maps.r, bar, x, t, b, lead);
      tma_load_3d(&rw.dy[0][0], &maps.dy, bar, x, t, b, lead);
    }
  };
  // load L, once landed, into staging slot sg as float32 (steps past S
  // landed as zeros)
  const int e0 = (tid % U) * 8;
  float uu[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) uu[a] = sh.u[e0 + a];
  auto convert = [&](int L, Stage& sg) {
    mbar_wait(&sh.bar[L % kRing], (L / kRing) & 1);
    const bool full = L >= nch - 1;
    const Raw& rw = sh.raw[L % kRing];
    const int m = tid / U;
    if (m < K) {
      float fk[8], fv[8], fw[8];
      load8<T>(&rw.k[m][e0], fk);
      load8<T>(&rw.v[m][e0], fv);
      load_cols<4>(&rw.w[m][e0], fw);
      load_cols<4>(&rw.w[m][e0 + 4], fw + 4);
      store_cols<8>(&sg.k[m][e0], fk);
      store_cols<8>(&sg.w[m][e0], fw);
      const int jo = e0 - q * NC;
      const bool own = jo >= 0 && jo < NC;
      if (own) store_cols<8>(&sg.v[m][jo], fv);
      if (full) {
        float fr[8], fd[8];
        load8<T>(&rw.r[m][e0], fr);
        load8<T>(&rw.dy[m][e0], fd);
        store_cols<8>(&sg.r[m][e0], fr);
        if (own) store_cols<8>(&sg.dy[m][jo], fd);
        float a = fv[0] * fd[0], bo = (fr[0] * uu[0]) * fk[0];
#pragma unroll
        for (int x = 1; x < 8; ++x) {
          a = fmaf(fv[x], fd[x], a);
          bo = fmaf(fr[x] * uu[x], fk[x], bo);
        }
#pragma unroll
        for (int o = 1; o < U; o <<= 1) {
          a += __shfl_xor_sync(kFull, a, o);
          bo += __shfl_xor_sync(kFull, bo, o);
        }
        if (tid % U == 0) sg.vdy[m] = a, sg.bonus[m] = bo;
      }
    }
  };
  // operands of one forward step on a tile: k and w of its rows, v of its
  // columns; from a staging slot, or from a chunk as it landed
  struct Fwd {
    float k[R], w[R], v[C];
  };
  auto fwd_stage = [&](const Stage& sg, int m, Fwd& f) {
    load_cols<R>(&sg.k[m][i0], f.k);
    load_cols<R>(&sg.w[m][i0], f.w);
    load_cols<C>(&sg.v[m][jl], f.v);
  };
  auto fwd_raw = [&](const Raw& rw, int m, Fwd& f) {
    load_t<T, R>(&rw.k[m][i0], f.k);
    load_cols<R>(&rw.w[m][i0], f.w);
    load_t<T, C>(&rw.v[m][q * NC + jl], f.v);
  };
  // S = w S + k v
  auto advance = [&](const float (&s)[R][C], float (&o)[R][C],
                     const Fwd& f) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[i][c] = fmaf(f.w[i], s[i][c], f.k[i] * f.v[c]);
  };

  // pass 1: the state at the start of every chunk, into the scratch; k, v
  // and w read as they landed, a step's loads issued a step ahead
  float cur[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) load_cols<C>(s0 + sbase + (size_t)i * N, cur[i]);
  const int n_loads = 2 * nch - 1;
  if (wi == 0)
    for (int x = 0; x < kRing && x < n_loads; ++x) issue(x);
  int L = 0;
  for (int c = 0; c < nch; ++c) {
    float* const ck = my_ckpt + (size_t)c * NT * RC;
#pragma unroll
    for (int i = 0; i < R; ++i) __stcs(reinterpret_cast<float4*>(ck + i * C),
                                       make_float4(cur[i][0], cur[i][1],
                                                   cur[i][2], cur[i][3]));
    if (c + 1 == nch) break;  // the last chunk's steps are not needed
    mbar_wait(&sh.bar[L % kRing], (L / kRing) & 1);
    const Raw& rw = sh.raw[L % kRing];
    Fwd f[2];
    fwd_raw(rw, 0, f[0]);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (m + 1 < K) fwd_raw(rw, m + 1, f[(m + 1) & 1]);
      advance(cur, cur, f[m & 1]);
    }
    __syncthreads();  // raw buffer L % kRing read by all: load the next
    if (wi == 0 && L + kRing < n_loads) issue(L + kRing);
    ++L;
  }

  // pass 2: each chunk, last first, rebuilt and walked back
  float g[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (dsT != nullptr) {
      load_cols<C>(dsT + sbase + (size_t)i * N, g[i]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) g[i][c] = 0.f;
    }
  }
  float du_acc = 0.f;
  const int rl = tid % NC, rown = q * NC + rl;  // the row it exchanges
  // chunk cx's dr, dk, dw for the rows this CTA owns (ranks' totals in
  // rank order, then the bonus terms), its dv for this CTA's columns, and
  // du's share; cx's totals are in part[cx & 1], its inputs in slot sx
  auto exchange = [&](int cx, int sx) {
    const Stage& sg = sh.stage[sx];
    const int bx = cx & 1, t0 = cx * K, n = min(K, S - t0);
    const float u_i = sh.u[rown];
    constexpr int kPairs = K * NC / NT;  // (step, row) pairs a thread
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int m = (tid + j * NT) / NC;
      if (m < n) {
        float a[3];
#pragma unroll
        for (int y = 0; y < 3; ++y) {
          a[y] = sh.part[bx][y][m][0][rl];
#pragma unroll
          for (int x = 1; x < CL; ++x) a[y] += sh.part[bx][y][m][x][rl];
        }
        const float vd = sg.vdy[m], r_i = sg.r[m][rown], k_i = sg.k[m][rown];
        const size_t o = base + (size_t)(t0 + m) * rs + rown;
        drg[o] = a[0] + u_i * k_i * vd;
        dkg[o] = a[1] + r_i * u_i * vd;
        dwg[o] = a[2];
        du_acc = fmaf(r_i * k_i, vd, du_acc);
      }
    }
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int e = tid + j * NT, m = e / NC, jj = e % NC;
      if (m < n) {
        float a = sh.dvp[bx][0][m][jj];
#pragma unroll
        for (int x = 1; x < G::W; ++x) a += sh.dvp[bx][x][m][jj];
        dvg[base + (size_t)(t0 + m) * rs + q * NC + jj] =
            fmaf(sg.dy[m][jj], sg.bonus[m], a);
      }
    }
  };

  // dr, dk and dw of the tile's 2 rows summed over the LC lanes of the
  // CTA's columns in one tree of three levels (LC = 8; the first two at
  // LC = 4), each level adding the lane whose bit l differs: bit 0 keeps
  // a row, bit 1 dr or dk (dw summed whole), bit 2 dr/dk or dw.  A lane
  // ends with the total of row i0 + b0 of (b2 ? dw : b1 ? dk : dr); at LC
  // = 4, of (b1 ? dk : dr) and of dw.  Lanes that differ only in a bit
  // that summed whole hold the same total, bit for bit (a + b == b + a),
  // and store it to the same place: every lane stores, the walk has no
  // branch.
  const bool b0 = lc & 1, b1 = (lc >> 1) & 1, b2 = (lc >> 2) & 1;
  const int rwr = i0 + b0;  // the row a lane writes
  // where it writes: the row's slot for this rank at the row's owner
  constexpr int kA = K * CL * NC;  // one of dr, dk, dw
  float* const push = cluster.map_shared_rank(&sh.part[0][0][0][0][0],
                                              rwr / NC) +
                      q * NC + rwr % NC + (LC == 8 && b2 ? 2 : b1) * kA;
  const int voff = scatter_off<C, RGW>(rg);     // the columns it writes

  // operands of one step back: r, k, w of the tile's rows, v, dy of its
  // columns; the step's products, summed over the tile's columns (r, k,
  // w) and rows (v)
  struct Back {
    float r[R], k[R], w[R], v[C], d[C];
  };
  struct Part {
    float r[R], k[R], w[R], v[C];
  };
  auto back_ops = [&](const Stage& sg, int m, Back& o) {
    load_cols<R>(&sg.r[m][i0], o.r);
    load_cols<R>(&sg.k[m][i0], o.k);
    load_cols<R>(&sg.w[m][i0], o.w);
    load_cols<C>(&sg.v[m][jl], o.v);
    load_cols<C>(&sg.dy[m][jl], o.d);
  };
  // a step's products with S_{t-1} = s and G_t, then G_{t-1} = w G + r dy
  auto products = [&](const float (&s)[R][C], const Back& o, Part& p) {
#pragma unroll
    for (int x = 0; x < C; ++x) p.v[x] = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      p.r[i] = p.k[i] = p.w[i] = 0.f;
#pragma unroll
      for (int x = 0; x < C; ++x) {
        const float sv = s[i][x];
        p.r[i] = fmaf(sv, o.d[x], p.r[i]);
        p.k[i] = fmaf(g[i][x], o.v[x], p.k[i]);
        p.w[i] = fmaf(g[i][x], sv, p.w[i]);
        p.v[x] = fmaf(g[i][x], o.k[i], p.v[x]);
        g[i][x] = fmaf(o.w[i], g[i][x], o.r[i] * o.d[x]);
      }
    }
  };
  // step m's sums across lanes, then to the rows' owners and the warp's
  // dv partials
  auto reduce_store = [&](Part& p, int m, int bx) {
    const float xr = (b0 ? p.r[1] : p.r[0]) +
                     __shfl_xor_sync(kFull, b0 ? p.r[0] : p.r[1], 1);
    const float xk = (b0 ? p.k[1] : p.k[0]) +
                     __shfl_xor_sync(kFull, b0 ? p.k[0] : p.k[1], 1);
    const float xw = (b0 ? p.w[1] : p.w[0]) +
                     __shfl_xor_sync(kFull, b0 ? p.w[0] : p.w[1], 1);
    const float y = (b1 ? xk : xr) + __shfl_xor_sync(kFull, b1 ? xr : xk, 2);
    const float z = xw + __shfl_xor_sync(kFull, xw, 2);
    float* const to = push + ((bx * 3) * K + m) * CL * NC;
    if constexpr (LC == 8) {
      to[0] = (b2 ? z : y) + __shfl_xor_sync(kFull, b2 ? y : z, 4);
    } else {
      to[0] = y;
      to[(2 - b1) * kA] = z;
    }
    reduce_scatter<C, RGW, LC>(p.v, rg);
#pragma unroll
    for (int x = 0; x < (C >> G::SCV); ++x)
      sh.dvp[bx][wi][m][jl + voff + x] = p.v[x];
  };
  // The states of a chunk are rebuilt half a chunk (HK steps) at a time.
  // sp[0] = s, the state before step a; sp[m] the state after m more steps
  // (cnt states); a step's loads issued a step ahead
  auto rebuild = [&](float (&sp)[HK][R][C], const float (&s)[R][C],
                     const Stage& sg, int a, int cnt) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) sp[0][i][c] = s[i][c];
    Fwd f[2];
    fwd_stage(sg, a, f[0]);
#pragma unroll
    for (int m = 1; m < HK; ++m) {
      if (m < cnt) {
        if (m + 1 < cnt) fwd_stage(sg, a + m, f[m & 1]);
        advance(sp[m - 1], sp[m], f[(m - 1) & 1]);
      }
    }
  };
  // s advanced over the HK steps from a
  auto run = [&](float (&s)[R][C], const Stage& sg, int a) {
    Fwd f[2];
    fwd_stage(sg, a, f[0]);
#pragma unroll
    for (int m = 0; m < HK; ++m) {
      if (m + 1 < HK) fwd_stage(sg, a + m + 1, f[(m + 1) & 1]);
      advance(s, s, f[m & 1]);
    }
  };
  // the walk back over the HK steps from a (all below S): operands loaded
  // a step ahead, each step's sums a step behind its products, so the
  // loads, the products and the lane trees of three steps overlap
  auto walk = [&](const float (&sp)[HK][R][C], const Stage& sg, int a,
                  int bx) {
    Back o[2];
    Part p[2];
    back_ops(sg, a + HK - 1, o[(HK - 1) & 1]);
#pragma unroll
    for (int m = HK - 1; m >= 0; --m) {
      const int y = m & 1;
      if (m > 0) back_ops(sg, a + m - 1, o[y ^ 1]);
      products(sp[m], o[y], p[y]);
      if (m + 1 < HK) reduce_store(p[y ^ 1], a + m + 1, bx);
    }
    reduce_store(p[0], a, bx);
  };
  // the same over the cnt steps from a of the ragged last chunk, in turn
  auto walk_ragged = [&](const float (&sp)[HK][R][C], const Stage& sg,
                         int a, int cnt, int bx) {
#pragma unroll
    for (int m = HK - 1; m >= 0; --m) {
      if (m < cnt) {
        Back o;
        Part p;
        back_ops(sg, a + m, o);
        products(sp[m], o, p);
        reduce_store(p, a + m, bx);
      }
    }
  };

  // the checkpoint of the chunk after the current one, loaded a chunk early
  float4 next[R];
  auto fetch_ckpt = [&](int c) {
    const float* const ck = my_ckpt + (size_t)c * NT * RC;
#pragma unroll
    for (int i = 0; i < R; ++i)
      next[i] = __ldcs(reinterpret_cast<const float4*>(ck + i * C));
  };
  fetch_ckpt(nch - 1);
  int slot = 0, prev = 0;
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * K, n = min(K, S - t0), bx = c & 1;
    float c0[R][C];  // the state before step t0
#pragma unroll
    for (int i = 0; i < R; ++i) {
      c0[i][0] = next[i].x, c0[i][1] = next[i].y;
      c0[i][2] = next[i].z, c0[i][3] = next[i].w;
    }
    if (c > 0) fetch_ckpt(c - 1);
    Stage& sg = sh.stage[slot];
    convert(L, sg);
    __syncthreads();  // raw buffer L % kRing read by all: load the next
    if (wi == 0 && L + kRing < n_loads) issue(L + kRing);
    ++L;
    float sp[HK][R][C];
    // the second half first; chunk c + 1's exchange once the first
    // states are rebuilt, so the cluster barrier's wait sits behind them
    if (n > HK) {
      float s[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int x = 0; x < C; ++x) s[i][x] = c0[i][x];
      run(s, sg, 0);
      if (n == K)
        rebuild(sp, s, sg, HK, HK);
      else
        rebuild(sp, s, sg, HK, n - HK);
      if (c + 1 < nch) {
        cluster_arrive();
        cluster_wait();
        exchange(c + 1, prev);
      }
      if (n == K)
        walk(sp, sg, HK, bx);
      else
        walk_ragged(sp, sg, HK, n - HK, bx);
      rebuild(sp, c0, sg, 0, HK);
      walk(sp, sg, 0, bx);
    } else {
      rebuild(sp, c0, sg, 0, n);
      if (c + 1 < nch) {
        cluster_arrive();
        cluster_wait();
        exchange(c + 1, prev);
      }
      walk_ragged(sp, sg, 0, n, bx);
    }
    prev = slot;
    slot = slot == 2 ? 0 : slot + 1;
  }
  cluster_arrive();
  cluster_wait();
  exchange(0, prev);
#pragma unroll
  for (int i = 0; i < R; ++i) store_cols<C>(ds0 + sbase + (size_t)i * N, g[i]);
  // du: the threads of a row in order
  sh.dusum[tid] = du_acc;
  __syncthreads();
  if (tid < NC) {
    float a = sh.dusum[tid];
    for (int x = 1; x < NT / NC; ++x) a += sh.dusum[tid + x * NC];
    du_part[(size_t)bh * N + q * NC + tid] = a;
  }
  // no CTA leaves while another may still read its shared memory
  cluster_arrive();
  cluster_wait();
}

// du[h][i] = sum_b du_part[b][h][i], b in order
__global__ void wkv6_du_kernel(const float* __restrict__ du_part,
                               float* __restrict__ du, int B, int H, int N) {
  const int h = blockIdx.x, i = threadIdx.x;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += du_part[((size_t)b * H + h) * N + i];
  du[(size_t)h * N + i] = a;
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

// (B, S, H N) in boxes of N elements x kBwdK steps, zeros past S
bool make_bshn_map(CUtensorMap* map, const void* ptr, bool bf16, int B,
                   int S, int H, int N) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = bf16 ? 2 : 4, row = (cuuint64_t)H * N;
  const cuuint64_t dims[3] = {row, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {row * es, (cuuint64_t)S * row * es};
  const cuuint32_t box[3] = {(cuuint32_t)N, kBwdK, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int N>
int launch_bwd(const void* r, const void* k, const void* v, const float* w,
               const float* u, const float* s0, const void* dy,
               const float* dsT, float* dr, float* dk, float* dv, float* dw,
               float* du, float* ds0, float* ckpt, float* du_part, int B,
               int S, int H, cudaStream_t stream) {
  using G = Bwd<N>;
  const size_t smem = sizeof(BwdShared<T, N>) + 128;  // room to align
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
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    // all of the SM's shared memory: two CTAs of 16 columns fit on one
    e = cudaFuncSetAttribute(wkv6_bwd_kernel<T, N>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit);
  }
  // the maps need a current context (the autograd engine's thread may
  // have made no CUDA call yet)
  const bool bf16 = sizeof(T) == 2;
  BwdMaps maps;
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, r) != cudaSuccess ||
      cudaSetDevice(attr.device) != cudaSuccess ||
      !make_bshn_map(&maps.r, r, bf16, B, S, H, N) ||
      !make_bshn_map(&maps.k, k, bf16, B, S, H, N) ||
      !make_bshn_map(&maps.v, v, bf16, B, S, H, N) ||
      !make_bshn_map(&maps.dy, dy, bf16, B, S, H, N) ||
      !make_bshn_map(&maps.w, w, false, B, S, H, N))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * G::CL), 1, 1);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = G::CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<T, N>, maps, u, s0, dsT, dr,
                         dk, dv, dw, du_part, ds0, ckpt, S, H);
  if (e != cudaSuccess) return (int)e;
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

// The scratch ``ckpt`` holds B * H * ceil(S / 16) * N * N floats (the
// states stored by the first pass, wkv6_bwd_ckpt_floats), ``du_part`` B * H
// * N.  r, k, v, dy: (B, S, H, N) bf16 (is_bf16 = 1) or f32; w (B, S, H, N),
// u (H, N), s0 and dsT (B, H, N, N; dsT may be null for 0) f32; dr, dk, dv,
// dw (B, S, H, N), du (H, N), ds0 (B, H, N, N) f32.  All contiguous and
// 16-byte aligned; S >= 1.  Returns cudaGetLastError() after the launches.
extern "C" long long wkv6_bwd_ckpt_floats(int B, int S, int H, int N) {
  return (long long)B * H * ((S + kBwdK - 1) / kBwdK) * N * N;
}

extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0,
                        const void* dy, const float* dsT, float* dr,
                        float* dk, float* dv, float* dw, float* du,
                        float* ds0, float* ckpt, float* du_part, int B, int S,
                        int H, int N, int is_bf16, cudaStream_t stream) {
  if ((long long)B * H * 8 > 0x7fffffffLL || S < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (is_bf16)
    return launch_bwd_n<__nv_bfloat16>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv,
                                       dw, du, ds0, ckpt, du_part, B, S, H, N,
                                       stream);
  return launch_bwd_n<float>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du,
                             ds0, ckpt, du_part, B, S, H, N, stream);
}
