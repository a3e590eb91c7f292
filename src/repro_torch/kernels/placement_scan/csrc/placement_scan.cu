// Placement-scan kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by kernels/placement_scan/kernel.py.
//
// Three kernels carry the scheduler's main path:
//
//   ps_scan_bitmaps        replaces src/repro/kernels/placement_scan/kernel.py
//                          scan_bitmaps (_scan_kernel): the builder's windowed
//                          feasibility scan; ps_scan_call is the builder's
//                          whole call staged in one C call, ps_scan_resident
//                          the jit backend's scan of a resident grid mirror.
//   ps_heartbeat_eligible  replaces kernel.py heartbeat_eligible (_elig_kernel):
//                          the online matcher's sound-superset machine filter
//                          on operands rounded by the host; ps_eligible_call
//                          is the matcher's whole call staged in one C call,
//                          the rounding done on the card.
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
// refused launch (ps_scan_call and ps_eligible_call, which also synchronize
// their stream, return the first error of the copy, launch or synchronize;
// ps_scan_resident the first of its copy, launch or event record, the
// event made beforehand by ps_event_create).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

// ---------------------------------------------------------------------------
// Kernel 1: windowed feasibility scan
//
// Bound: bytes, and in practice the call around it.  The work a window
// needs is one pass over its live cells per task (d compares each) and one
// run test per start: a few tens of KB (m ~ 4 machines x L ~ 256 ticks x
// d = 4 floats), microseconds of device time.  Design:
//
//   * one warp per (task, machine) row.  Lanes test 32 consecutive ticks
//     at a time (one float4 per lane when d = 4, 512 contiguous bytes per
//     warp) and __ballot_sync packs the results into one 32-bit word of
//     feasible ticks; ticks at or past t_live (or L) read as 0.  The words
//     of a row sit in shared memory.
//   * each lane then decides 32 starts at a time: start w is good iff bits
//     [w, w + k) are all set, which is at most ceil(k / 32) + 1 masked word
//     tests, and a run that would reach past the live ticks is never good.
//
// That is the plain version's test (a start is good iff every tick of
// [w, w + k) is below t_live and fits on every dim; demands are ceil32
// float32 values compared with >=), run over O(g m t_live) cells instead
// of O(g W m k).  `ps_scan_call` wraps the launch in the builder's whole
// call: the live window, demands and durations packed on the host into one
// pinned buffer and copied to the card at once, the launch writing the
// bitmaps into pinned host memory, one stream synchronize.
//
// The kernel reads machine mm's window at `win + mm * row_stride` (floats):
// row_stride = L * d for a packed window, Tb * d for a window read in place
// out of a resident (m, Tb, d) grid mirror (`ps_scan_resident`, the jit
// placement backend), `win` then pointing at the window's first tick.
// float4 loads need every row's window on a 16-byte boundary: d = 4, `win`
// 16-byte aligned and row_stride a multiple of 4 floats.  A mirror keeps
// that for every first tick (a tick of d = 4 floats is 16 bytes, Tb * 4 is
// a multiple of 4); any other layout takes the scalar loads.
// ---------------------------------------------------------------------------

constexpr int SCAN_WARPS = 4;          // rows per block

__global__ void __launch_bounds__(SCAN_WARPS * 32)
    scan_bitmaps_kernel(const float* __restrict__ win, long long row_stride,
                        const float* __restrict__ Vs,
                        const int* __restrict__ ks, int t_live, int m, int L,
                        int d, int g, int W, int reverse, int vec4,
                        int nwords, int8_t* __restrict__ out) {
  extern __shared__ unsigned scan_words[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * SCAN_WARPS + warp;
  if (row >= g * m) return;            // whole warps only
  const int gg = row / m, mm = row % m;
  unsigned* words = scan_words + warp * nwords;
  const int live = min(t_live, L);
  const float* v = Vs + (size_t)gg * d;
  const float4 v4 = vec4 ? make_float4(v[0], v[1], v[2], v[3])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* cells = win + (size_t)mm * row_stride;
  for (int c = 0; c < nwords; ++c) {
    const int t = c * 32 + lane;
    bool ok = t < live;
    if (ok && vec4) {
      const float4 x = reinterpret_cast<const float4*>(cells)[t];
      ok = x.x >= v4.x && x.y >= v4.y && x.z >= v4.z && x.w >= v4.w;
    } else if (ok) {
      for (int j = 0; j < d; ++j)
        ok = ok && (cells[(size_t)t * d + j] >= v[j]);
    }
    const unsigned word = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) words[c] = word;
  }
  __syncwarp();
  const int k = ks[gg];
  int8_t* o = out + (size_t)gg * W * m + mm;
  for (int w = lane; w < W; w += 32) {
    const int end = w + k;             // the run is [w, end)
    int8_t good = end <= live;
    for (int t = w; good && t < end;) {
      const int b = t & 31;
      const int n = min(32 - b, end - t);
      const unsigned mask = (n == 32 ? 0xffffffffu : ((1u << n) - 1u)) << b;
      good = (words[t >> 5] & mask) == mask;
      t += n;
    }
    o[(size_t)(reverse ? W - 1 - w : w) * m] = good;
  }
}

static int launch_scan(const float* win, long long row_stride,
                       const float* Vs, const int* ks, int t_live, int m,
                       int L, int d, int g, int W, int reverse, int8_t* out,
                       cudaStream_t stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)g * m;
  if (rows <= 0 || W <= 0) return (int)cudaGetLastError();
  const int nwords = (L + 31) / 32;
  const size_t smem = (size_t)SCAN_WARPS * nwords * sizeof(unsigned);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((rows + SCAN_WARPS - 1) / SCAN_WARPS);
  // float4 cells when d = 4 and every row's window is 16-byte aligned
  const int vec4 = d == 4 && (reinterpret_cast<uintptr_t>(win) & 15) == 0 &&
                   row_stride % 4 == 0;
  scan_bitmaps_kernel<<<blocks, SCAN_WARPS * 32, smem, stream>>>(
      win, row_stride, Vs, ks, t_live, m, L, d, g, W, reverse, vec4, nwords,
      out);
  return (int)cudaGetLastError();
}

// win (m, L, d), Vs (g, d), ks (g,) on the card -> out (g, W, m) int8.
extern "C" int ps_scan_bitmaps(const float* win, const float* Vs,
                               const int* ks, int t_live, int m, int L, int d,
                               int g, int W, int8_t* out, void* stream) {
  return launch_scan(win, (long long)L * d, Vs, ks, t_live, m, L, d, g, W, 0,
                     out, (cudaStream_t)stream);
}

// The whole scan call from host arrays.  The live window
// avail[:, plo:plo + L, :] of the grid (m rows of `row` floats, the window
// at float offset `first` of each), the demands Vs (g, d) f32 and the
// durations ks (g,) i32 are packed into host_in (pinned: the window at
// byte 0, Vs at off_vs, ks at off_ks) and copied to dev_in in one
// transfer; the kernel scans with t_live = L and writes the bitmaps
// (g, W, m), starts descending when reverse, straight into host_out
// (pinned; host_out_dev is the card's address of it), which the host may
// read once this returns: no copy back is queued.
extern "C" int ps_scan_call(const float* avail, long long row,
                            long long first, int m, int L, int d,
                            const float* Vs, const int* ks, int g, int W,
                            int reverse, void* host_in, void* dev_in,
                            long long off_vs, long long off_ks,
                            void* host_out_dev, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  char* h = static_cast<char*>(host_in);
  const size_t cells = (size_t)L * d * sizeof(float);
  for (int mm = 0; mm < m; ++mm)
    memcpy(h + (size_t)mm * cells, avail + (size_t)mm * row + first, cells);
  memcpy(h + off_vs, Vs, (size_t)g * d * sizeof(float));
  memcpy(h + off_ks, ks, (size_t)g * sizeof(int));
  cudaError_t e = cudaMemcpyAsync(dev_in, host_in,
                                  (size_t)off_ks + (size_t)g * sizeof(int),
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const char* base = static_cast<const char*>(dev_in);
  const int err = launch_scan(reinterpret_cast<const float*>(base),
                              (long long)L * d,
                              reinterpret_cast<const float*>(base + off_vs),
                              reinterpret_cast<const int*>(base + off_ks), L,
                              m, L, d, g, W, reverse,
                              static_cast<int8_t*>(host_out_dev), s);
  if (err != 0) return err;
  return (int)cudaStreamSynchronize(s);
}

// The scan of a window read in place from a resident grid mirror (the jit
// placement backend).  mirror (m, Tb, d) f32 on the card; the window is
// ticks [first, first + L) of every machine's row, all of them live.  Vs
// (g, d) f32 and ks (g,) i32 are packed into host_in (pinned; Vs at
// off_vs, ks at off_ks) and copied up on `stream` into dev_in at the same
// offsets; the kernel writes the bitmaps (g, W, m), starts descending
// when reverse, into host_out (pinned; host_out_dev is the card's address
// of it); `event` (when not null) is recorded after the launch and nothing
// is waited on: the host reads host_out once the event has completed.
// The mirror's slab uploads (`ps_copy_slab`) go on the same stream, so a
// scan reads the grid as it was when the scan was issued.
extern "C" int ps_scan_resident(const float* mirror, long long Tb,
                                long long first, int m, int L, int d,
                                const float* Vs, const int* ks, int g, int W,
                                int reverse, void* host_in, void* dev_in,
                                long long off_vs, long long off_ks,
                                void* host_out_dev, void* event,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  char* h = static_cast<char*>(host_in);
  memcpy(h + off_vs, Vs, (size_t)g * d * sizeof(float));
  memcpy(h + off_ks, ks, (size_t)g * sizeof(int));
  char* dv = static_cast<char*>(dev_in);
  cudaError_t e = cudaMemcpyAsync(
      dv + off_vs, h + off_vs,
      (size_t)(off_ks - off_vs) + (size_t)g * sizeof(int),
      cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int err = launch_scan(
      mirror + (size_t)first * d, Tb * d,
      reinterpret_cast<const float*>(dv + off_vs),
      reinterpret_cast<const int*>(dv + off_ks), L, m, L, d, g, W, reverse,
      static_cast<int8_t*>(host_out_dev), s);
  if (err != 0) return err;
  return event ? (int)cudaEventRecord((cudaEvent_t)event, s) : 0;
}

// One slab of a resident mirror from pinned host memory: ticks
// [first, first + S) of every machine's row of mirror (m, Tb, d) f32, from
// host (m, S, d) f32, in one strided copy on `stream`.
extern "C" int ps_copy_slab(float* mirror, long long Tb, long long first,
                            int m, int S, int d, const void* host,
                            void* stream) {
  const size_t width = (size_t)S * d * sizeof(float);
  return (int)cudaMemcpy2DAsync(mirror + (size_t)first * d,
                                (size_t)Tb * d * sizeof(float), host, width,
                                width, (size_t)m, cudaMemcpyHostToDevice,
                                (cudaStream_t)stream);
}

// Events of the resident scans (no timing): create, wait for.  A slot keeps
// its event for the life of its thread's stage.
extern "C" int ps_event_create(void** event) {
  return (int)cudaEventCreateWithFlags(
      reinterpret_cast<cudaEvent_t*>(event), cudaEventDisableTiming);
}

extern "C" int ps_event_sync(void* event) {
  return (int)cudaEventSynchronize((cudaEvent_t)event);
}

// The address under which the card sees pinned host memory (the same
// pointer under unified addressing); fails for memory that is not pinned.
extern "C" int ps_host_device_ptr(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
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
// Kernel 2, staged: the matcher's whole eligibility call
//
// On the main path the kernel above is the least of the call's cost: its
// operands were rounded on the host, uploaded by six pageable copies into
// a fresh allocation, and the (n, m) result read back and reduced on the
// host.  `ps_eligible_call` is the whole call in one C call, the way
// `ps_scan_call` stages the scan: the shard's float64 avail rows (m, d) and
// the candidates' float64 demands (n, d) are packed into one pinned buffer
// and copied up at once on the caller's stream; one launch does the
// directed rounding itself and writes `eligible` (machine-major, (m, n))
// and `machine_any` (m) straight into pinned host memory; one stream
// synchronize.  Nothing is allocated and nothing is left for the host but
// the copy out.
//
// Rounding on the card.  The sound superset rounds each demand down and
// each float64 threshold up to float32, exactly as the host's
// _round_down32 / _round_up32 do (core/engine/kernels.py): the largest
// float <= x is __double2float_rd(x) and the smallest float >= x is
// __double2float_ru(x), for every double (+-inf, NaN, values beyond
// FLT_MAX, float32 subnormals: the file is built without -ftz, so the
// conversions keep subnormals).  The thresholds are formed in the host's
// float64 order: avail + eps, and (avail + slack) + eps.
//
// Bound: the call's latency (one copy, one launch, one synchronize); the
// device work is m*n compares over a few tens of KB.  Design: a block owns
// `rows` consecutive machines (the host picks rows so that a block has
// about 512 (machine, candidate) pairs: 16 machines at the path's 32
// candidates, 1 at s13's 512, so there are blocks enough for every SM)
// and all the candidates.  It rounds its machines' thresholds and the
// candidates' demands (512 candidates at a time, dim-major so that
// neighbour threads read neighbour words) into shared memory once, then
// its threads walk the block's pairs
// in machine-major order, neighbour threads on neighbour pairs: the
// (rows, n) slab of `eligible` the block owns is one contiguous range, so
// the byte stores into host memory coalesce for any n.  machine_any is
// the OR of a machine's row, gathered in shared memory (threads only ever
// write 1 there) and stored once.
// ---------------------------------------------------------------------------

constexpr int ELIG_THREADS = 256;
constexpr int ELIG_CHUNK = 512;                // candidates staged at a time
constexpr int ELIG_MAX_ROWS = 128;             // machines per block
constexpr int ELIG_MAX_D = 8;

__global__ void __launch_bounds__(ELIG_THREADS) eligible_call_kernel(
    const double* __restrict__ avail, const double* __restrict__ dem, int m,
    int n, int d, int rows_per_block, double slack, double eps,
    unsigned fd_bits, unsigned rd_bits, unsigned gd_bits,
    int8_t* __restrict__ elig, int8_t* __restrict__ any_out) {
  __shared__ float s_dem[ELIG_MAX_D * ELIG_CHUNK];   // [dim][candidate]
  // per machine row and dim: fit threshold (fit dims), fit threshold
  // (rigid dims), overbooked threshold (fungible dims); +inf elsewhere
  __shared__ float s_thr[ELIG_MAX_ROWS][3][ELIG_MAX_D];
  __shared__ int s_any[ELIG_MAX_ROWS];
  const int mm0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, m - mm0);
  const float inf = __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < rows * d; i += ELIG_THREADS) {
    const int r = i / d, j = i - r * d;
    const double av = avail[(size_t)mm0 * d + i];
    const float fit = __double2float_ru(__dadd_rn(av, eps));
    const float fung = __double2float_ru(__dadd_rn(__dadd_rn(av, slack),
                                                   eps));
    s_thr[r][0][j] = ((fd_bits >> j) & 1u) ? fit : inf;
    s_thr[r][1][j] = ((rd_bits >> j) & 1u) ? fit : inf;
    s_thr[r][2][j] = ((gd_bits >> j) & 1u) ? fung : inf;
  }
  for (int r = threadIdx.x; r < rows; r += ELIG_THREADS) s_any[r] = 0;
  for (int c0 = 0; c0 < n; c0 += ELIG_CHUNK) {
    const int cw = min(ELIG_CHUNK, n - c0);
    __syncthreads();                   // the previous chunk is done
    for (int i = threadIdx.x; i < cw * d; i += ELIG_THREADS) {
      const int k = i / d, j = i - k * d;
      s_dem[j * ELIG_CHUNK + k] = __double2float_rd(dem[(size_t)c0 * d + i]);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < rows * cw; p += ELIG_THREADS) {
      const int r = p / cw, k = p - r * cw;
      bool fits = true, rigid = true, fung = true;
#pragma unroll
      for (int j = 0; j < ELIG_MAX_D; ++j) {
        if (j < d) {
          const float x = s_dem[j * ELIG_CHUNK + k];
          fits = fits & (x <= s_thr[r][0][j]);
          rigid = rigid & (x <= s_thr[r][1][j]);
          fung = fung & (x <= s_thr[r][2][j]);
        }
      }
      const bool e = fits | (rigid & fung);
      elig[(size_t)(mm0 + r) * n + c0 + k] = (int8_t)e;
      if (e) s_any[r] = 1;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += ELIG_THREADS)
    any_out[mm0 + r] = (int8_t)s_any[r];
}

static int launch_eligible(const double* avail, const double* dem, int m,
                           int n, int d, double slack, double eps,
                           unsigned fd, unsigned rd, unsigned gd,
                           int8_t* elig, int8_t* any_out, cudaStream_t s) {
  if (d < 1 || d > ELIG_MAX_D || m < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (m > 0) {
    // about 512 pairs a block
    const int rows = max(1, min(ELIG_MAX_ROWS, 512 / max(n, 1)));
    const int blocks = (m + rows - 1) / rows;
    eligible_call_kernel<<<blocks, ELIG_THREADS, 0, s>>>(
        avail, dem, m, n, d, rows, slack, eps, fd, rd, gd, elig, any_out);
  }
  return (int)cudaGetLastError();
}

// The kernel alone on device operands: avail (m, d) and dem (n, d) float64
// -> elig (m, n) and any_out (m,) int8 (for timing and graph capture).
extern "C" int ps_eligible_launch(const double* avail, const double* dem,
                                  int m, int n, int d, double slack,
                                  double eps, unsigned fd, unsigned rd,
                                  unsigned gd, int8_t* elig, int8_t* any_out,
                                  void* stream) {
  return launch_eligible(avail, dem, m, n, d, slack, eps, fd, rd, gd, elig,
                         any_out, (cudaStream_t)stream);
}

// The whole call from host arrays: avail (m, d) and dem (n, d) float64 are
// packed into host_in (pinned: avail at byte 0, dem at off_dem) and copied
// to dev_in in one transfer; the kernel writes elig (m, n) at byte 0 of
// host_out and machine_any (m) at off_any (pinned; host_out_dev is the
// card's address of it), which the host may read once this returns.
extern "C" int ps_eligible_call(const double* avail, const double* dem,
                                int m, int n, int d, double slack,
                                double eps, unsigned fd, unsigned rd,
                                unsigned gd, void* host_in, void* dev_in,
                                long long off_dem, void* host_out_dev,
                                long long off_any, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  char* h = static_cast<char*>(host_in);
  const size_t a_bytes = (size_t)m * d * sizeof(double);
  const size_t d_bytes = (size_t)n * d * sizeof(double);
  memcpy(h, avail, a_bytes);
  memcpy(h + off_dem, dem, d_bytes);
  const cudaError_t e = cudaMemcpyAsync(
      dev_in, host_in, (size_t)off_dem + d_bytes, cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const char* base = static_cast<const char*>(dev_in);
  int8_t* out = static_cast<int8_t*>(host_out_dev);
  const int err = launch_eligible(
      reinterpret_cast<const double*>(base),
      reinterpret_cast<const double*>(base + off_dem), m, n, d, slack, eps,
      fd, rd, gd, out, out + off_any, s);
  if (err != 0) return err;
  return (int)cudaStreamSynchronize(s);
}

// ---------------------------------------------------------------------------
// Kernel 3: one heartbeat wave
//
// Bound: latency of a sequential chain.  Machines are visited in host order
// and every pick changes the availability the next comparison sees, so the
// visits and the picks within a visit form one chain; the data (2048 x 4
// avail rows, a few hundred candidate rows, a handful of ledger entries) is
// well under a MB.  What bounds the kernel is the cost of each link, and
// the design cuts that cost (one CTA of WAVE_WARPS warps):
//
//   * Every candidate's dem row, pri, srpt, group, locality and taken flag
//     is loaded once per wave: a thread's first candidates (up to
//     WAVE_REG_VALUES demand values, WAVE_REG_SLOTS candidates) into
//     registers, the rest into shared memory (read from global memory,
//     through L1, only when the columns exceed 227 KB).  Nothing is re-read
//     from global memory per pass.  The kernel is instantiated per d, so
//     every loop over the dims is unrolled with nothing to mask.
//   * The walk state (local and row availability, the EMA pair, the
//     ledger's argmax, the counts) is replicated in every thread, and each
//     warp keeps its own copy of the dense deficit ledger (lane l holds
//     entries l, l + 32, ...), so every thread applies a pick itself and no
//     thread waits on another to publish it.
//   * One fused pass per pick iteration.  The four pools the matcher
//     chooses between (eligible, eligible-and-fits, deficit-forced,
//     forced-and-fits) collapse into one lexicographic key: the pick is the
//     maximum of (tier, score), tier = fits + 2 * forced while the deficit
//     gate is open, ties to the smallest index (see tk_beats).  Scores key
//     as order-preserving 64-bit integers, so the warp's argmax is four
//     redux.sync instructions; every test in the pass is a select, never a
//     branch.  With more than one warp the warps' results cross in shared
//     memory behind one named barrier per iteration.
//   * A visit that cannot pick is skipped without a pass: the walk keeps
//     the componentwise minimum of the untaken candidates' demands (NaN
//     ignored, as a NaN demand fails every comparison; recomputed after a
//     visit that picked, so it only grows stale downward) and skips a
//     machine on which that minimum exceeds local + eps on some fit dim
//     while overbooking is off or impossible too (a rigid dim above
//     local + eps, or a fungible dim above local + slack + eps).  The
//     machines of the order are loaded and tested 32 at a time, one per
//     lane, and only the survivors are walked, in order.
//
// The order must list each machine at most once (visit_order's argsort
// does): the chunk loads a machine's row before the visits ahead of it.
// ---------------------------------------------------------------------------

// the fastest of 1, 2 and 4 warps at n = 512 (scripts/wave_warps.py)
#define WAVE_WARPS 4
#define WAVE_MAXD 8
#define WAVE_REG_VALUES 16   // demand values a thread keeps in registers
#define WAVE_REG_SLOTS 4     // ... in at most this many candidates
#define WAVE_SMEM_LIMIT (227 * 1024)
#define FULL_MASK 0xffffffffu
#define NO_INDEX 0x7fffffff

enum { C_EPS = 0, C_SLACK, C_RP, C_ETA_M, C_THRESH, C_A, C_1MA, C_FLOOR };
enum { F_PACKING = 1, F_SRPT = 2, F_OVERBOOK = 4, F_DRF = 8 };

__device__ __forceinline__ double clip0(double x) { return x < 0.0 ? 0.0 : x; }

// An unsigned key whose order is the numeric order of x (-0 and +0 equal).
// numpy's argmax takes NaN as the maximum; a wave stops at a best score
// that is not finite, so a NaN score keys as +inf: same stop, same picks.
__device__ __forceinline__ unsigned long long okey(double x) {
  const unsigned long long b =
      (unsigned long long)__double_as_longlong(x + 0.0);  // -0 -> +0
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}
__device__ __forceinline__ double okey_value(unsigned long long k) {
  const unsigned long long b = (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k;
  return __longlong_as_double((long long)b);
}

// The pick of an iteration as one lexicographic maximum.  The matcher's
// pool is the eligible candidates, narrowed to the deficit-forced group
// when the gate is open (the leading group's deficit >= thresh) and that
// group has an eligible member, then to those that fit when one does; the
// pick is the pool's first-index score argmax.  With tier = fits + 2 *
// forced (forced counted only while the gate is open), the maximum of
// (tier, score) over all eligible candidates, ties to the smallest index,
// is that pick: every higher tier present is exactly the narrowing.
// tier in [0, 3]; key = okey(score) > 0, so an empty slot keys (0, 0).
__device__ __forceinline__ bool tk_beats(unsigned t, unsigned long long k,
                                         unsigned bt, unsigned long long bk) {
  return (t > bt) | ((t == bt) & (k > bk));
}

// the warp's largest (tier, key), and the smallest index among the lanes
// that hold it (so the first index when each lane holds its own first):
// four redux instructions, the result in every lane
__device__ __forceinline__ void warp_tkmax(unsigned& tier,
                                           unsigned long long& key, int& idx) {
  const unsigned khi = (unsigned)(key >> 32), klo = (unsigned)key;
  const unsigned t = __reduce_max_sync(FULL_MASK, tier);
  const unsigned hi = __reduce_max_sync(FULL_MASK, tier == t ? khi : 0u);
  const unsigned lo =
      __reduce_max_sync(FULL_MASK, (tier == t) & (khi == hi) ? klo : 0u);
  const unsigned long long k = ((unsigned long long)hi << 32) | lo;
  idx = (int)__reduce_min_sync(
      FULL_MASK, (tier == t) & (key == k) ? (unsigned)idx : (unsigned)NO_INDEX);
  tier = t;
  key = k;
}

// the wave's scalar operands, replicated in every thread
struct WaveParams {
  double eps, slack, rp, eta_m, thresh, a, one_ma, floor;
  unsigned fd, rd, fg;  // fit / rigid / fungible dims as bits
  int d, flags;
};

// what the warps exchange: each warp's best (tier, key, index) with the
// winner's obs and over flag, and the demand minimum or the live count
struct WaveXch {
  unsigned long long key;
  double obs;
  double mn[WAVE_MAXD];
  unsigned tier;
  int idx;
  int over;
  int live;
};

// Every test below is a select over mask bits, never a branch: a runtime
// branch on d, a mask or a flag splits the pass into blocks that the
// compiler cannot overlap, and the chain then pays every latency in full.
template <int DM>
__device__ __forceinline__ void fit_flags(const double* dc, const double* thr,
                                          const double* thr_g,
                                          const WaveParams& p, bool& fits,
                                          bool& over) {
  bool f = true, rig = true, fng = true;
#pragma unroll
  for (int k = 0; k < DM; ++k) {
    const bool le = dc[k] <= thr[k], le_g = dc[k] <= thr_g[k];
    f = f & (le | !((p.fd >> k) & 1u));
    rig = rig & (le | !((p.rd >> k) & 1u));
    fng = fng & (le_g | !((p.fg >> k) & 1u));
  }
  fits = f;
  over = ((p.flags & F_OVERBOOK) != 0) & !f & rig & fng;
}

// score base of a candidate against the machine's local availability:
// seq_dot(dem, clip(local, 0)) * rp, shrunk by the overshoot penalty when
// the candidate only fits by overbooking (wave.py wave_core, step by step).
// The penalty's max over the fungible dims is NaN if any term is NaN, as
// jnp.max is, and is taken as a tree.  It is always computed and applied as
// dot * (fits ? 1 : f): dot * 1 is dot exactly.  The dot product and the
// penalty are pinned (an empty asm that takes and gives each value), so the
// compiler computes them unconditionally instead of putting a branch on the
// packing flag or the fit around them: a branch would split the pass into
// blocks whose candidates' chains no longer overlap.
__device__ __forceinline__ void pin(double& x) { asm volatile("" : "+d"(x)); }

template <int DM>
__device__ __forceinline__ double cand_base(const double* dc, int loc,
                                            bool fits, int mid,
                                            const double* local,
                                            const WaveParams& p) {
  const double rp = ((loc >= 0) & (loc != mid)) ? p.rp : 1.0;
  double acc = __dmul_rn(dc[0], clip0(local[0]));
#pragma unroll
  for (int k = 1; k < DM; ++k)
    acc = __dadd_rn(acc, __dmul_rn(dc[k], clip0(local[k])));
  pin(acc);
  const double dot = __dmul_rn((p.flags & F_PACKING) ? acc : 1.0, rp);
  double xs[DM];
  bool nan_any = false;
#pragma unroll
  for (int k = 0; k < DM; ++k) {
    const double x = __dsub_rn(dc[k], local[k]);
    const bool on = (p.fg >> k) & 1u;
    nan_any = nan_any | (on & isnan(x));
    xs[k] = on ? x : -INFINITY;
  }
#pragma unroll
  for (int w = DM / 2; w > 0; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) xs[k] = fmax(xs[k], xs[k + w]);
  const double shoot = clip0(nan_any ? __longlong_as_double(0x7ff8000000000000ll)
                                     : xs[0]);
  double f = __dsub_rn(1.0, shoot);
  f = (f < 0.05) ? 0.05 : f;
  pin(f);
  return __dmul_rn(dot, fits ? 1.0 : f);
}

// The gate's ledger argmax, as the sequential scan `g* = 0; for g: if
// (def[g] > def[g*]) g* = g` computes it: the first maximum over the
// non-NaN entries, or entry 0 when entry 0 is NaN.  Lane l scans its own
// entries l, l + 32, ... of this warp's copy; the result lands in every lane.
__device__ __forceinline__ void ledger_argmax(const double* def, int G,
                                              int lane, int& gstar,
                                              double& gbest) {
  unsigned long long k = 0ull;  // below every key: no entry yet
  int bi = NO_INDEX;
  for (int g = lane; g < G; g += 32) {
    const double x = def[g];
    const unsigned long long kg = isnan(x) ? 0ull : okey(x);
    if (kg > k) {
      k = kg;
      bi = g;
    }
  }
  unsigned t = 0u;
  warp_tkmax(t, k, bi);
  const double d0 = __shfl_sync(FULL_MASK, lane == 0 ? def[0] : 0.0, 0);
  if (isnan(d0) || k == 0ull) {
    gstar = 0;
    gbest = d0;
  } else {
    gstar = bi;
    gbest = okey_value(k);
  }
}

// row c of a (n, DM) array
template <int DM>
__device__ __forceinline__ void load_row(double* out, const double* a, int c) {
#pragma unroll
  for (int k = 0; k < DM; ++k) out[k] = a[(size_t)c * DM + k];
}

template <int NW>
__device__ __forceinline__ void wave_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(NW * 32) : "memory");
}

template <int NW, int DM>
__global__ void __launch_bounds__(NW * 32) match_wave_kernel(
    double* __restrict__ avail, const int* __restrict__ order, int m,
    const double* __restrict__ dem_g, const double* __restrict__ pri_g,
    const double* __restrict__ srpt_g, const int* __restrict__ gidx_g,
    const int* __restrict__ loc_g, const bool* __restrict__ taken0, int n,
    double* __restrict__ ema, double* __restrict__ deficit_io,
    const double* __restrict__ share, int G,
    const unsigned char* __restrict__ masks, const double* __restrict__ consts,
    int d, int bundle_limit, int flags, int* __restrict__ rows,
    int* __restrict__ mach, int8_t* __restrict__ overf,
    double* __restrict__ obs, int* __restrict__ count, int cand_in_smem) {
  constexpr int T = NW * 32;
  // register slots per thread
  constexpr int RS = WAVE_REG_VALUES / DM < 1 ? 1
                     : WAVE_REG_VALUES / DM > WAVE_REG_SLOTS ? WAVE_REG_SLOTS
                                                             : WAVE_REG_VALUES / DM;
  extern __shared__ __align__(16) unsigned char smem[];
  WaveXch* xbuf = reinterpret_cast<WaveXch*>(smem);            // [2][NW]
  double* s_share = reinterpret_cast<double*>(xbuf + 2 * NW);  // (G,)
  double* s_def = s_share + G;                                 // (NW, G)
  unsigned char* s_taken =
      reinterpret_cast<unsigned char*>(s_def + (size_t)NW * G);  // (n,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double* dem = dem_g;
  const double* pri = pri_g;
  const double* srpt = srpt_g;
  const int* gidx = gidx_g;
  const int* loc = loc_g;
  if (cand_in_smem) {  // the candidate columns, copied once
    const size_t off = ((size_t)(s_taken + n - smem) + 15) & ~(size_t)15;
    double* c_dem = reinterpret_cast<double*>(smem + off);
    double* c_pri = c_dem + (size_t)n * d;
    double* c_srpt = c_pri + n;
    int* c_gidx = reinterpret_cast<int*>(c_srpt + n);
    int* c_loc = c_gidx + n;
    for (int e = tid; e < n * d; e += T) c_dem[e] = dem_g[e];
    for (int c = tid; c < n; c += T) {
      c_pri[c] = pri_g[c];
      c_srpt[c] = srpt_g[c];
      c_gidx[c] = gidx_g[c];
      c_loc[c] = loc_g[c];
    }
    dem = c_dem;
    pri = c_pri;
    srpt = c_srpt;
    gidx = c_gidx;
    loc = c_loc;
  }
  for (int g = tid; g < G; g += T) {
    s_share[g] = share[g];
    const double x = deficit_io[g];
    for (int w = 0; w < NW; ++w) s_def[(size_t)w * G + g] = x;
  }
  for (int c = tid; c < n; c += T) s_taken[c] = taken0[c] ? 1 : 0;

  WaveParams p;
  p.eps = consts[C_EPS];
  p.slack = consts[C_SLACK];
  p.rp = consts[C_RP];
  p.eta_m = consts[C_ETA_M];
  p.thresh = consts[C_THRESH];
  p.a = consts[C_A];
  p.one_ma = consts[C_1MA];
  p.floor = consts[C_FLOOR];
  p.fd = p.rd = p.fg = 0u;
  for (int k = 0; k < d; ++k) {
    p.fd |= masks[k] ? 1u << k : 0u;
    p.rd |= masks[d + k] ? 1u << k : 0u;
    p.fg |= masks[2 * d + k] ? 1u << k : 0u;
  }
  p.d = d;
  p.flags = flags;
  double ema0 = ema[0], ema1 = ema[1];
  __syncthreads();

  // this thread's candidates c = r * T + tid: slots r < RS in registers
  const int nslots = (n + T - 1) / T;
  double rdem[RS][DM], rpri[RS], rsrpt[RS];
  int rgidx[RS], rloc[RS];
  unsigned rtaken = 0u;  // bit r: slot r taken or past n
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int c = r * T + tid;
    const bool in = c < n;
#pragma unroll
    for (int k = 0; k < DM; ++k) rdem[r][k] = in ? dem[(size_t)c * DM + k] : 0.0;
    rpri[r] = in ? pri[c] : 0.0;
    rsrpt[r] = in ? srpt[c] : 0.0;
    rgidx[r] = in ? gidx[c] : 0;
    rloc[r] = in ? loc[c] : -1;
    if (!in || s_taken[c]) rtaken |= 1u << r;
  }

  // fn(c, live, dem row, pri, srpt, gidx, loc) over this thread's slots in
  // increasing c; `live`: a real candidate not yet taken
  auto for_each = [&](auto&& fn) {
#pragma unroll
    for (int r = 0; r < RS; ++r)
      fn(r * T + tid, !((rtaken >> r) & 1u), rdem[r], rpri[r], rsrpt[r],
         rgidx[r], rloc[r]);
    for (int r = RS; r < nslots; ++r) {
      const int c = r * T + tid;
      const int cc = c < n ? c : n - 1;
      double dc[DM];
      load_row<DM>(dc, dem, cc);
      fn(c, c < n && !s_taken[cc], dc, pri[cc], srpt[cc], gidx[cc], loc[cc]);
    }
  };

  int xpar = 0;  // which exchange buffer the next crossing writes
  // componentwise NaN-ignoring minimum of the untaken candidates' demands
  double mn[DM];
  auto recompute_min = [&]() {
#pragma unroll
    for (int k = 0; k < DM; ++k) mn[k] = INFINITY;
    for_each([&](int, bool live, const double* dc, double, double, int, int) {
#pragma unroll
      for (int k = 0; k < DM; ++k) mn[k] = live ? fmin(mn[k], dc[k]) : mn[k];
    });
#pragma unroll
    for (int k = 0; k < DM; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mn[k] = fmin(mn[k], __shfl_xor_sync(FULL_MASK, mn[k], off));
    if constexpr (NW > 1) {
      WaveXch* xb = xbuf + xpar * NW;
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < DM; ++k) xb[warp].mn[k] = mn[k];
      wave_barrier<NW>();
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int k = 0; k < DM; ++k) mn[k] = fmin(mn[k], xb[w].mn[k]);
      xpar ^= 1;
    }
  };
  // may a machine with this availability row pick anything?  false only
  // when no untaken candidate can be eligible on it
  auto may_pick = [&](const double* vrow) {
    bool nofit = false, norig = false, nofung = false;
#pragma unroll
    for (int k = 0; k < DM; ++k) {
      const bool above = mn[k] > __dadd_rn(vrow[k], p.eps);
      const bool above_g =
          mn[k] > __dadd_rn(__dadd_rn(vrow[k], p.slack), p.eps);
      nofit = nofit | (((p.fd >> k) & 1u) & above);
      norig = norig | (((p.rd >> k) & 1u) & above);
      nofung = nofung | (((p.fg >> k) & 1u) & above_g);
    }
    return !(nofit & (!(flags & F_OVERBOOK) | norig | nofung));
  };
  // the SRPT weight of the next pick's score
  auto srpt_eta = [&]() {
    if (!(flags & F_SRPT)) return 0.0;
    double r = ema1 < p.floor ? p.floor : ema1;
    if (isnan(ema1)) r = ema1;
    return __ddiv_rn(__dmul_rn(p.eta_m, ema0), r);
  };

  // set-up: live count, demand minimum, the ledger's argmax
  int live = 0;
  for_each([&](int, bool lv, const double*, double, double, int, int) {
    live += lv ? 1 : 0;
  });
  live = (int)__reduce_add_sync(FULL_MASK, (unsigned)live);
  if constexpr (NW > 1) {
    if (lane == 0) xbuf[xpar * NW + warp].live = live;
    wave_barrier<NW>();
    live = 0;
    for (int w = 0; w < NW; ++w) live += xbuf[xpar * NW + w].live;
    xpar ^= 1;
  }
  recompute_min();
  double* my_def = s_def + (size_t)warp * G;
  int gstar;
  double gbest;
  ledger_argmax(my_def, G, lane, gstar, gbest);
  double eta = srpt_eta();

  int cnt = 0;
  for (int v0 = 0; v0 < m && live > 0; v0 += 32) {
    // one lane per upcoming visit: its machine and row
    const int v = v0 + lane;
    const int vmid = v < m ? order[v] : -1;
    const unsigned pads = __ballot_sync(FULL_MASK, vmid < 0);
    const int nvalid = pads ? __ffs(pads) - 1 : 32;  // -1 pads trail
    double vrow[DM];
#pragma unroll
    for (int k = 0; k < DM; ++k)
      vrow[k] = lane < nvalid ? avail[(size_t)vmid * DM + k] : 0.0;
    unsigned todo = __ballot_sync(FULL_MASK, lane < nvalid && may_pick(vrow));
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int mid = __shfl_sync(FULL_MASK, vmid, l);
      double local[DM], row[DM];
#pragma unroll
      for (int k = 0; k < DM; ++k)
        local[k] = row[k] = __shfl_sync(FULL_MASK, vrow[k], l);
      int picked = 0;
      for (int j = 0; j < bundle_limit; ++j) {
        double thr[DM], thr_g[DM];
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          thr[k] = __dadd_rn(local[k], p.eps);
          thr_g[k] = __dadd_rn(__dadd_rn(local[k], p.slack), p.eps);
        }
        // -- the fused pass: every candidate's tier and score --------------
        const bool gate = gbest >= p.thresh;
        unsigned bt = 0u;        // this thread's best: tier ...
        unsigned long long bk = 0ull;  // ... score key ...
        int bi = NO_INDEX;       // ... index ...
        double bobs = 0.0;       // ... pri * base ...
        bool bover = false;      // ... and whether it only overbooks
        for_each([&](int c, bool lv, const double* dc, double pr, double sp,
                     int gi, int lc) {
          bool fits, over;
          fit_flags<DM>(dc, thr, thr_g, p, fits, over);
          const bool elig = lv & (fits | over);
          const double ob =
              __dmul_rn(pr, cand_base<DM>(dc, lc, fits, mid, local, p));
          const double score = __dsub_rn(ob, __dmul_rn(eta, sp));
          const unsigned long long key = okey(isnan(score) ? INFINITY : score);
          const unsigned tier =
              (fits ? 1u : 0u) + ((gate & (gi == gstar)) ? 2u : 0u);
          const bool upd = elig & tk_beats(tier, key, bt, bk);  // ties: first c
          bt = upd ? tier : bt;
          bk = upd ? key : bk;
          bi = upd ? c : bi;
          bobs = upd ? ob : bobs;
          bover = upd ? over : bover;
        });
        warp_tkmax(bt, bk, bi);
        // the winning lane holds the winner's obs and over flag
        bobs = __shfl_sync(FULL_MASK, bobs, bi & 31);
        bover = __shfl_sync(FULL_MASK, bover ? 1 : 0, bi & 31) != 0;
        if constexpr (NW > 1) {
          WaveXch* xb = xbuf + xpar * NW;
          if (lane == 0) {
            xb[warp].tier = bt;
            xb[warp].key = bk;
            xb[warp].idx = bi;
            xb[warp].obs = bobs;
            xb[warp].over = bover ? 1 : 0;
          }
          wave_barrier<NW>();
          for (int w = 0; w < NW; ++w) {
            const unsigned t = xb[w].tier;
            const unsigned long long k = xb[w].key;
            const int ix = xb[w].idx;
            const bool upd = tk_beats(t, k, bt, bk) |
                             ((t == bt) & (k == bk) & (ix < bi));
            bt = upd ? t : bt;
            bk = upd ? k : bk;
            bi = upd ? ix : bi;
            bobs = upd ? xb[w].obs : bobs;
            bover = upd ? xb[w].over != 0 : bover;
          }
          xpar ^= 1;
        }
        if (bk == 0ull) break;  // nothing eligible
        // a best score of -inf, +inf or NaN ends the visit
        if (!isfinite(okey_value(bk))) break;
        const int i = bi;
        const double obs_i = bobs;
        const bool over_i = bover;
        // -- the pick, applied by every thread ----------------------------
        double di[DM];
        load_row<DM>(di, dem, i);
        double w = 1.0;
        if (flags & F_DRF) {
          w = di[0];
#pragma unroll
          for (int k = 1; k < DM; ++k) {
            const bool take = isnan(di[k]) | (di[k] > w);
            w = take ? (isnan(w) ? w : di[k]) : w;
          }
        }
        if (i % T == tid) {
          const int r = i / T;
          if (r < RS)
            rtaken |= 1u << r;
          else
            s_taken[i] = 1;
        }
        const double sr_i = srpt[i];
        double sr = sr_i < p.floor ? p.floor : sr_i;
        if (isnan(sr_i)) sr = sr_i;
        ema0 = __dadd_rn(__dmul_rn(p.one_ma, ema0), __dmul_rn(p.a, obs_i));
        ema1 = __dadd_rn(__dmul_rn(p.one_ma, ema1), __dmul_rn(p.a, sr));
        eta = srpt_eta();
        const int gi = gidx[i];
        for (int g = lane; g < G; g += 32) {
          double x = __dadd_rn(my_def[g], __dmul_rn(s_share[g], w));
          if (g == gi) x = __dadd_rn(x, -w);
          my_def[g] = x;
        }
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          local[k] = clip0(__dsub_rn(local[k], di[k]));
          row[k] = __dsub_rn(row[k], di[k]);
        }
        if (tid == 0) {
          rows[cnt] = i;
          mach[cnt] = mid;
          overf[cnt] = over_i ? 1 : 0;
          obs[cnt] = obs_i;
        }
        ++cnt;
        ++picked;
        --live;
        ledger_argmax(my_def, G, lane, gstar, gbest);
        if (live == 0) break;
      }
      if (picked) {
        if (tid == 0)
#pragma unroll
          for (int k = 0; k < DM; ++k) avail[(size_t)mid * DM + k] = row[k];
        if (live == 0) break;
        // fewer candidates: the minimum only grows, so skips only grow
        recompute_min();
        todo &= __ballot_sync(FULL_MASK, may_pick(vrow));
      }
    }
    if (nvalid < 32) break;
  }
  if (warp == 0)
    for (int g = lane; g < G; g += 32) deficit_io[g] = my_def[g];
  if (tid == 0) {
    ema[0] = ema0;
    ema[1] = ema1;
    count[0] = cnt;
  }
}

template <int NW, int DM>
static int launch_wave(double* avail, const int* order, int m,
                       const double* dem, const double* pri,
                       const double* srpt, const int* gidx, const int* loc,
                       const bool* taken0, int n, double* ema,
                       double* deficit, const double* share, int G,
                       const unsigned char* masks, const double* consts,
                       int d, int bundle_limit, int flags, int* rows,
                       int* mach, int8_t* overf, double* obs, int* count,
                       cudaStream_t stream) {
  const size_t base = sizeof(WaveXch) * 2 * NW +
                      sizeof(double) * (size_t)G * (1 + NW) + (size_t)n;
  const size_t cand = 16 + (size_t)n * (sizeof(double) * (d + 2) +
                                        2 * sizeof(int));
  if (base > WAVE_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int in_smem = base + cand <= WAVE_SMEM_LIMIT;
  const size_t smem = base + (in_smem ? cand : 0);
  auto kern = match_wave_kernel<NW, DM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, NW * 32, smem, stream>>>(
      avail, order, m, dem, pri, srpt, gidx, loc, taken0, n, ema, deficit,
      share, G, masks, consts, d, bundle_limit, flags, rows, mach, overf, obs,
      count, in_smem);
  return (int)cudaGetLastError();
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
  // one instantiation per d: the dims are compile-time in every chain
  decltype(&launch_wave<WAVE_WARPS, 1>) launches[WAVE_MAXD] = {
      launch_wave<WAVE_WARPS, 1>, launch_wave<WAVE_WARPS, 2>,
      launch_wave<WAVE_WARPS, 3>, launch_wave<WAVE_WARPS, 4>,
      launch_wave<WAVE_WARPS, 5>, launch_wave<WAVE_WARPS, 6>,
      launch_wave<WAVE_WARPS, 7>, launch_wave<WAVE_WARPS, 8>};
  return launches[d - 1](avail, order, m, dem, pri, srpt, gidx, loc, taken0, n, ema,
                deficit, share, G, masks, consts, d, bundle_limit, flags, rows,
                mach, overf, obs, count, (cudaStream_t)stream);
}
