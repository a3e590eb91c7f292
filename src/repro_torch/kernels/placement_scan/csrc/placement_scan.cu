// Placement-scan kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by kernels/placement_scan/kernel.py.
//
// Three kernels carry the scheduler's main path:
//
//   ps_scan_bitmaps        replaces src/repro/kernels/placement_scan/kernel.py
//                          scan_bitmaps (_scan_kernel): the builder's windowed
//                          feasibility scan.
//   ps_heartbeat_eligible  replaces kernel.py heartbeat_eligible (_elig_kernel):
//                          the online matcher's sound-superset machine filter.
//   ps_match_wave          replaces kernel.py match_wave_walk (_wave_kernel
//                          running core/engine/wave.py wave_core): one whole
//                          heartbeat wave in float64.
//
// Exactness.  The scan and the eligibility test are float32 comparisons
// plus integer counting, so they are bit-identical to the plain versions by
// construction.  The wave must reproduce the numpy matcher's float64
// arithmetic to the last bit: every product is rounded on its own before
// the add that consumes it (__dmul_rn / __dadd_rn, and the file is built
// with -fmad=false so no expression can contract into an FMA), dot products
// accumulate left to right over d, and every argmax takes the first maximal
// index (NaN counting as the maximum, as numpy's argmax does).
//
// Every entry point launches on the stream it is handed, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// Kernel 1: windowed feasibility scan
//
// Bound: bytes.  Each (g, w, m) output reads at most k window cells of d
// floats; the window itself is a few tens of KB (m ~ 4 machines x L ~ 224
// ticks x d = 4) and stays in L1/L2, so the kernel is one short launch whose
// time is launch latency.  Design: one thread per output cell with a direct
// k-tick test that stops at the first infeasible tick; a start is good iff
// every tick in [w, w + k) is below t_live and fits on every dim, which is
// exactly the plain version's cumsum test run[w] == k (L >= W + max(ks)
// keeps every read in bounds).
// ---------------------------------------------------------------------------

__global__ void scan_bitmaps_kernel(const float* __restrict__ win,
                                    const float* __restrict__ Vs,
                                    const int* __restrict__ ks, int t_live,
                                    int m, int L, int d, int g, int W,
                                    int8_t* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)g * W * m;
  if (idx >= total) return;
  int mm = (int)(idx % m);
  int w = (int)((idx / m) % W);
  int gg = (int)(idx / ((long long)m * W));
  int k = ks[gg];
  const float* v = Vs + (long long)gg * d;
  const float* row = win + (long long)mm * L * d;
  int8_t good = 1;
  for (int t = w; t < w + k; ++t) {
    if (t >= t_live || t >= L) { good = 0; break; }
    const float* cell = row + (long long)t * d;
    bool ok = true;
    for (int j = 0; j < d; ++j) ok = ok && (cell[j] >= v[j]);
    if (!ok) { good = 0; break; }
  }
  out[idx] = good;
}

extern "C" int ps_scan_bitmaps(const float* win, const float* Vs,
                               const int* ks, int t_live, int m, int L, int d,
                               int g, int W, int8_t* out, void* stream) {
  long long total = (long long)g * W * m;
  if (total > 0) {
    int threads = 256;
    int blocks = (int)((total + threads - 1) / threads);
    scan_bitmaps_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        win, Vs, ks, t_live, m, L, d, g, W, out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 2: heartbeat eligibility (sound superset)
//
// Bound: bytes.  The (n, m) int8 output (512 x 2048 = 1 MB on the main
// path) dominates the traffic; the (m, d) thresholds and (n, d) demands are
// read from L2.  Design: one thread per (candidate, machine) pair, neighbour
// threads on neighbouring machines so the int8 stores coalesce; masked-out
// dims compare against +inf exactly as the plain version does.
// ---------------------------------------------------------------------------

__global__ void heartbeat_eligible_kernel(
    const float* __restrict__ dem, const float* __restrict__ thr_fit,
    const float* __restrict__ thr_fung, const float* __restrict__ fd_mask,
    const float* __restrict__ rd_mask, const float* __restrict__ gd_mask,
    int n, int m, int d, int8_t* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * m) return;
  int mm = (int)(idx % m);
  int c = (int)(idx / m);
  const float inf = __int_as_float(0x7f800000);
  bool fits = true, rigid = true, fung = true;
  for (int j = 0; j < d; ++j) {
    float x = dem[(long long)c * d + j];
    float tf = thr_fit[(long long)mm * d + j];
    float tg = thr_fung[(long long)mm * d + j];
    fits = fits && (x <= (fd_mask[j] > 0.0f ? tf : inf));
    rigid = rigid && (x <= (rd_mask[j] > 0.0f ? tf : inf));
    fung = fung && (x <= (gd_mask[j] > 0.0f ? tg : inf));
  }
  out[idx] = (int8_t)(fits || (rigid && fung));
}

extern "C" int ps_heartbeat_eligible(const float* dem, const float* thr_fit,
                                     const float* thr_fung,
                                     const float* fd_mask,
                                     const float* rd_mask,
                                     const float* gd_mask, int n, int m,
                                     int d, int8_t* out, void* stream) {
  long long total = (long long)n * m;
  if (total > 0) {
    int threads = 256;
    int blocks = (int)((total + threads - 1) / threads);
    heartbeat_eligible_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dem, thr_fit, thr_fung, fd_mask, rd_mask, gd_mask, n, m, d, out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 3: one heartbeat wave
//
// Bound: latency of a sequential walk.  Machines are visited in host order
// and every pick changes the availability the next comparison sees, so
// machines and picks cannot run in parallel; the data (2048 x 4 avail
// rows, <= a few hundred candidate rows, a handful of ledger entries) is
// well under a MB.  What bounds the kernel is the chain of block-wide
// barriers per pick iteration.  Design: one CTA; candidates are strided
// over its threads, the per-machine state (local/row availability, the EMA
// pair, the dense deficit ledger, taken flags) lives in shared memory, and
// each pick iteration is: one pass computing fit/overbook flags, a block OR
// for the deficit-forced group, a second pass for the eligible pool, one
// block argmax (first index wins) over the scores, and one thread applying
// the pick.  A visit whose first iteration finds nothing eligible costs one
// such iteration; the walk stops once every candidate is taken (later
// visits could pick nothing).
// ---------------------------------------------------------------------------

#define WAVE_THREADS 256
#define WAVE_MAXD 8

enum { C_EPS = 0, C_SLACK, C_RP, C_ETA_M, C_THRESH, C_A, C_1MA, C_FLOOR };
enum { F_PACKING = 1, F_SRPT = 2, F_OVERBOOK = 4, F_DRF = 8 };
enum { B_FITS = 1, B_OVER = 2, B_ELIG = 4 };

// numpy argmax order: NaN is the maximum, ties go to the first index
__device__ __forceinline__ bool beats(double a, int ia, double b, int ib) {
  bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? (ia < ib) : na;
  if (a > b) return true;
  if (a < b) return false;
  return ia < ib;
}

__device__ __forceinline__ double clip0(double x) { return x < 0.0 ? 0.0 : x; }

// score base of candidate c against the machine's local availability:
// seq_dot(dem, clip(local, 0)) * rp, shrunk by the overshoot penalty when
// the candidate only fits by overbooking (wave.py wave_core, step by step)
__device__ double cand_base(int c, bool fits, int mid, const double* dem,
                            const int* loc, const double* local,
                            const unsigned char* fg_mask, int d,
                            const double* consts, int flags) {
  double rp = (loc[c] >= 0 && loc[c] != mid) ? consts[C_RP] : 1.0;
  const double* dc = dem + (long long)c * d;
  double dot;
  if (flags & F_PACKING) {
    double acc = __dmul_rn(dc[0], clip0(local[0]));
    for (int k = 1; k < d; ++k)
      acc = __dadd_rn(acc, __dmul_rn(dc[k], clip0(local[k])));
    dot = __dmul_rn(acc, rp);
  } else {
    dot = rp;
  }
  if (fits) return dot;
  double shoot = -INFINITY;
  for (int k = 0; k < d; ++k) {
    if (fg_mask[k]) {
      double x = __dsub_rn(dc[k], local[k]);
      // jnp.max propagates NaN
      if (isnan(x) || x > shoot || isnan(shoot)) shoot = isnan(shoot) ? shoot : x;
    }
  }
  shoot = clip0(shoot);
  double f = __dsub_rn(1.0, shoot);
  f = (f < 0.05) ? 0.05 : f;
  return __dmul_rn(dot, f);
}

__global__ void __launch_bounds__(WAVE_THREADS) match_wave_kernel(
    double* __restrict__ avail, const int* __restrict__ order, int m,
    const double* __restrict__ dem, const double* __restrict__ pri,
    const double* __restrict__ srpt, const int* __restrict__ gidx,
    const int* __restrict__ loc, const bool* __restrict__ taken0, int n,
    double* __restrict__ ema, double* __restrict__ deficit_io,
    const double* __restrict__ share, int G,
    const unsigned char* __restrict__ masks, const double* __restrict__ consts,
    int d, int bundle_limit, int flags, int* __restrict__ rows,
    int* __restrict__ mach, int8_t* __restrict__ overf,
    double* __restrict__ obs, int* __restrict__ count) {
  extern __shared__ unsigned char smem[];
  double* s_def = (double*)smem;                       // (G,)
  unsigned char* s_taken = smem + sizeof(double) * G;  // (n,)
  unsigned char* s_bits = s_taken + n;                 // (n,)

  __shared__ double s_local[WAVE_MAXD], s_row[WAVE_MAXD];
  __shared__ double s_ema[2];
  __shared__ unsigned char s_fd[WAVE_MAXD], s_rd[WAVE_MAXD], s_fg[WAVE_MAXD];
  __shared__ double s_wscore[WAVE_THREADS / 32];
  __shared__ int s_widx[WAVE_THREADS / 32];
  __shared__ int s_stop, s_active, s_cnt;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const double eps = consts[C_EPS];
  const double slack = consts[C_SLACK];
  const double thresh = consts[C_THRESH];
  const double NEG_INF = -INFINITY;

  for (int g = tid; g < G; g += blockDim.x) s_def[g] = deficit_io[g];
  int act = 0;
  for (int c = tid; c < n; c += blockDim.x) {
    s_taken[c] = taken0[c] ? 1 : 0;
    act += taken0[c] ? 0 : 1;
  }
  if (tid < d) {
    s_fd[tid] = masks[tid];
    s_rd[tid] = masks[d + tid];
    s_fg[tid] = masks[2 * d + tid];
  }
  if (tid == 0) {
    s_ema[0] = ema[0];
    s_ema[1] = ema[1];
    s_cnt = 0;
    s_active = 0;
  }
  __syncthreads();
  if (act) atomicAdd(&s_active, act);
  __syncthreads();

  for (int v = 0; v < m; ++v) {
    const int mid = order[v];
    if (mid < 0 || s_active == 0) break;   // -1 pads trail; nothing left to take
    if (tid < d) {
      s_local[tid] = avail[(long long)mid * d + tid];
      s_row[tid] = s_local[tid];
    }
    __syncthreads();
    for (int j = 0; j < bundle_limit; ++j) {
      // -- deficit gating: first argmax of the dense ledger -------------
      int gstar = 0;
      double gbest = s_def[0];
      for (int g = 1; g < G; ++g)
        if (s_def[g] > gbest) { gbest = s_def[g]; gstar = g; }
      // -- pass 1: exact f64 eligibility (masked dims always pass) -----
      int any_forced = 0;
      for (int c = tid; c < n; c += blockDim.x) {
        const double* dc = dem + (long long)c * d;
        bool fits = true, rig = true, fng = true;
        for (int k = 0; k < d; ++k) {
          double thr = __dadd_rn(s_local[k], eps);
          if (s_fd[k]) fits = fits && (dc[k] <= thr);
          if (s_rd[k]) rig = rig && (dc[k] <= thr);
          if (s_fg[k]) {
            double thr_g = __dadd_rn(__dadd_rn(s_local[k], slack), eps);
            fng = fng && (dc[k] <= thr_g);
          }
        }
        bool over = (flags & F_OVERBOOK) ? (!fits && rig && fng) : false;
        bool elig = (fits || over) && !s_taken[c];
        s_bits[c] = (fits ? B_FITS : 0) | (over ? B_OVER : 0) |
                    (elig ? B_ELIG : 0);
        if (elig && gidx[c] == gstar) any_forced = 1;
      }
      const bool use_forced =
          __syncthreads_or(any_forced) && (gbest >= thresh);
      // -- pass 2: the eligible pool ----------------------------------
      int any_elig = 0, any_fit = 0;
      for (int c = tid; c < n; c += blockDim.x) {
        unsigned char b = s_bits[c];
        bool elig = (b & B_ELIG) && (!use_forced || gidx[c] == gstar);
        if (!elig) b &= ~B_ELIG;
        s_bits[c] = b;
        any_elig |= elig;
        any_fit |= elig && (b & B_FITS);
      }
      const int elig_any = __syncthreads_or(any_elig);
      if (!elig_any) break;                 // uniform across the block
      const bool pool_fit = __syncthreads_or(any_fit);
      // -- pass 3: scores and their first-index argmax ----------------
      double eta = 0.0;
      if (flags & F_SRPT) {
        double r = s_ema[1] < consts[C_FLOOR] ? consts[C_FLOOR] : s_ema[1];
        if (isnan(s_ema[1])) r = s_ema[1];
        eta = __ddiv_rn(__dmul_rn(consts[C_ETA_M], s_ema[0]), r);
      }
      double best = NEG_INF;
      int bidx = n;
      for (int c = tid; c < n; c += blockDim.x) {
        unsigned char b = s_bits[c];
        bool fits = b & B_FITS;
        bool in_pool = (b & B_ELIG) && (!pool_fit || fits);
        double score = NEG_INF;
        if (in_pool) {
          double base = cand_base(c, fits, mid, dem, loc, s_local, s_fg, d,
                                  consts, flags);
          score = __dsub_rn(__dmul_rn(pri[c], base), __dmul_rn(eta, srpt[c]));
        }
        if (beats(score, c, best, bidx)) { best = score; bidx = c; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        double os = __shfl_down_sync(0xffffffffu, best, off);
        int oi = __shfl_down_sync(0xffffffffu, bidx, off);
        if (beats(os, oi, best, bidx)) { best = os; bidx = oi; }
      }
      if (lane == 0) { s_wscore[warp] = best; s_widx[warp] = bidx; }
      __syncthreads();
      if (tid == 0) {
        best = s_wscore[0];
        bidx = s_widx[0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
          if (beats(s_wscore[w], s_widx[w], best, bidx)) {
            best = s_wscore[w];
            bidx = s_widx[w];
          }
        // every candidate scores -inf or better, so bidx < n here
        const int i = bidx < n ? bidx : 0;
        const bool ok = isfinite(best) && bidx < n;
        s_stop = ok ? 0 : 1;
        if (ok) {
          unsigned char b = s_bits[i];
          double base = cand_base(i, b & B_FITS, mid, dem, loc, s_local, s_fg,
                                  d, consts, flags);
          double obs_i = __dmul_rn(pri[i], base);
          const double* di = dem + (long long)i * d;
          double w = 1.0;
          if (flags & F_DRF) {
            w = di[0];
            for (int k = 1; k < d; ++k)
              if (isnan(di[k]) || di[k] > w) w = isnan(w) ? w : di[k];
          }
          s_taken[i] = 1;
          double sr = srpt[i] < consts[C_FLOOR] ? consts[C_FLOOR] : srpt[i];
          if (isnan(srpt[i])) sr = srpt[i];
          s_ema[0] = __dadd_rn(__dmul_rn(consts[C_1MA], s_ema[0]),
                               __dmul_rn(consts[C_A], obs_i));
          s_ema[1] = __dadd_rn(__dmul_rn(consts[C_1MA], s_ema[1]),
                               __dmul_rn(consts[C_A], sr));
          for (int g = 0; g < G; ++g)
            s_def[g] = __dadd_rn(s_def[g], __dmul_rn(share[g], w));
          s_def[gidx[i]] = __dadd_rn(s_def[gidx[i]], -w);
          for (int k = 0; k < d; ++k) {
            s_local[k] = clip0(__dsub_rn(s_local[k], di[k]));
            s_row[k] = __dsub_rn(s_row[k], di[k]);
          }
          const int cnt = s_cnt;
          rows[cnt] = i;
          mach[cnt] = mid;
          overf[cnt] = (b & B_OVER) ? 1 : 0;
          obs[cnt] = obs_i;
          s_cnt = cnt + 1;
          s_active -= 1;
        }
      }
      __syncthreads();
      if (s_stop) break;
    }
    if (tid < d) avail[(long long)mid * d + tid] = s_row[tid];
    __syncthreads();
  }
  for (int g = tid; g < G; g += blockDim.x) deficit_io[g] = s_def[g];
  if (tid == 0) {
    ema[0] = s_ema[0];
    ema[1] = s_ema[1];
    count[0] = s_cnt;
  }
}

extern "C" int ps_match_wave(double* avail, const int* order, int m,
                             const double* dem, const double* pri,
                             const double* srpt, const int* gidx,
                             const int* loc, const bool* taken0, int n,
                             double* ema, double* deficit,
                             const double* share, int G,
                             const unsigned char* masks, const double* consts,
                             int d, int bundle_limit, int flags, int* rows,
                             int* mach, int8_t* overf, double* obs,
                             int* count, void* stream) {
  if (d > WAVE_MAXD || d < 1 || G < 1) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(double) * G + 2 * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        match_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  match_wave_kernel<<<1, WAVE_THREADS, smem, (cudaStream_t)stream>>>(
      avail, order, m, dem, pri, srpt, gidx, loc, taken0, n, ema, deficit,
      share, G, masks, consts, d, bundle_limit, flags, rows, mach, overf, obs,
      count);
  return (int)cudaGetLastError();
}
