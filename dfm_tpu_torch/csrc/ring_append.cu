// K13: ring eviction and ragged append, in place.
//
// Replaces dfm_tpu/serve/batched.py:ring_evict (line 72) together with the
// append that follows it in dfm_tpu/serve/session.py (lines 151-155):
//   t_keep = t_cur - n_evict
//   buf    = where(t < t_keep, roll(buf, -n_evict, axis=0), 0)
//   buf[t_keep + j] = src[j]     for j < r_max, dropped at t_keep + j >= T_cap
// on Ybuf with the new rows and on Wbuf with their mask, both (T_cap, N) in
// the compute dtype.  The kernel moves values and does no arithmetic, so it
// equals its plain twin (serve/batched.py:ring_evict_append_plain) bit for
// bit.
//
// K13b, the fleet's batched form, is the same column walk over B lanes
// (blockIdx.z), each lane's (T_cap, N) buffers and (r_max, N) rows at a
// lane stride, with the lane's n_evict and t_cur read from two (B,) int32
// arrays in device memory (the tick builds them; no host integer per
// lane).  It replaces dfm_tpu/serve/batched.py:batched_ring_evict (line
// 97) together with dfm_tpu/estim/batched.py:batched_ragged_append (line
// 564), one launch a tick; its plain twin is
// dfm_tpu_torch/serve/batched.py:batched_ring_evict_append_plain.  A lane
// with n_evict = 0 and all-zero rows writes zeros on zeros only, and a
// free lane at t_cur = T_cap writes nothing, so both come through bit for
// bit.  At B = 8, T_cap = 1,000, N = 10,000 in f32 a non-ring tick moves
// the append rows only (~1.3 MB); a ring tick at T_cap = 480, e = 2
// shifts every lane: ~6 x 77 MB for six ring lanes.
//
// Precondition (the session's buffer invariant): every row at and past
// t_cur is exactly zero on entry.  The kernel therefore zeroes only the
// vacated rows [t_keep + r_max, t_cur) that the append does not overwrite;
// every other row past the append already is zero.  With n_evict = 0 the
// live rows [0, t_cur) are not touched at all: only the r_max append rows
// are written (a non-ring query moves ~2 r_max N values, not the buffer).
//
// Design.  One thread owns one column of one buffer (blockIdx.y picks
// Ybuf/rows or Wbuf/rmask) and walks t in ascending order.  The shift reads
// row t + n_evict and writes row t of the same column; since n_evict >= 0,
// every row a thread reads later lies at or past every row it has written,
// and no other thread touches its column, so the in-place shift cannot
// race.  (Splitting a column's rows across threads would: a thread writing
// rows [a, b) could overwrite rows another thread still has to read.)  To
// keep several loads in flight, a thread loads a batch of U = RING_BATCH
// rows into registers before it stores them; the batch reads rows
// [t + e, t + e + U) and writes rows [t, t + U), all reads of the batch
// happen before its writes, and later batches read only rows >= t + U + e.
// Adjacent threads take adjacent columns, so every row access is coalesced.
//
// Bound on the H100: bytes.  A ring query at T_cap = 480, e = 2,
// N = 10,000 in f32 reads and writes both buffers: ~77 MB, a ~23 us
// bound at the H100 data sheet's 3.35 TB/s.  A non-ring query moves the
// append rows only (~1.3 MB) and is launch-bound.  Measured times are in
// the repository's PERF.md, with the card they were taken on.
#include "common.cuh"

constexpr int RING_BATCH = 16;

// One column of one buffer: the shift, the append and the re-zeroing of
// the vacated rows, in ascending t (see above).
template <typename T>
__device__ __forceinline__ void ring_column(T* buf, const T* src, int n,
                                            int T_cap, int N, int r_max,
                                            int n_evict, int t_cur) {
  const size_t ld = (size_t)N;
  const int t_keep = t_cur - n_evict;
  if (n_evict > 0) {
    int t = 0;
    for (; t + RING_BATCH <= t_keep; t += RING_BATCH) {
      T v[RING_BATCH];
#pragma unroll
      for (int u = 0; u < RING_BATCH; ++u)
        v[u] = buf[(size_t)(t + u + n_evict) * ld + n];
#pragma unroll
      for (int u = 0; u < RING_BATCH; ++u)
        buf[(size_t)(t + u) * ld + n] = v[u];
    }
    for (; t < t_keep; ++t)
      buf[(size_t)t * ld + n] = buf[(size_t)(t + n_evict) * ld + n];
  }
  const int t_end = min(t_keep + r_max, T_cap);
  for (int t = t_keep; t < t_end; ++t)
    buf[(size_t)t * ld + n] = src[(size_t)(t - t_keep) * ld + n];
  for (int t = t_end; t < t_cur; ++t) buf[(size_t)t * ld + n] = T(0);
}

template <typename T>
__global__ void ring_append_kernel(T* Ybuf, T* Wbuf, const T* rows,
                                   const T* rmask, int T_cap, int N,
                                   int r_max, int n_evict, int t_cur) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  ring_column(blockIdx.y == 0 ? Ybuf : Wbuf,
              blockIdx.y == 0 ? rows : rmask, n, T_cap, N, r_max, n_evict,
              t_cur);
}

// K13b: the same per lane (blockIdx.z), with the lane's counts read from
// device memory.  The host validated them; a lane whose counts are out of
// range is left untouched rather than written out of bounds.
template <typename T>
__global__ void batched_ring_append_kernel(T* Ybuf, T* Wbuf, const T* rows,
                                           const T* rmask,
                                           const int* __restrict__ n_evict,
                                           const int* __restrict__ t_cur,
                                           int T_cap, int N, int r_max) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t lane = blockIdx.z;
  const int e = n_evict[lane], tc = t_cur[lane];
  if (e < 0 || e > tc || tc > T_cap) return;
  const size_t boff = lane * (size_t)T_cap * N, roff = lane * (size_t)r_max * N;
  ring_column((blockIdx.y == 0 ? Ybuf : Wbuf) + boff,
              (blockIdx.y == 0 ? rows : rmask) + roff, n, T_cap, N, r_max, e,
              tc);
}

template <typename T>
static int launch(T* Ybuf, T* Wbuf, const T* rows, const T* rmask, int T_cap,
                  int N, int r_max, int n_evict, int t_cur,
                  cudaStream_t stream) {
  if (T_cap < 0 || N < 0 || r_max < 0 || n_evict < 0 || n_evict > t_cur ||
      t_cur > T_cap)
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    // 64-thread blocks spread the ~2N threads over every SM.
    const dim3 grid((N + 63) / 64, 2);
    ring_append_kernel<T><<<grid, 64, 0, stream>>>(Ybuf, Wbuf, rows, rmask,
                                                   T_cap, N, r_max, n_evict,
                                                   t_cur);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_batched(T* Ybuf, T* Wbuf, const T* rows, const T* rmask,
                          const int* n_evict, const int* t_cur, int B,
                          int T_cap, int N, int r_max, cudaStream_t stream) {
  if (B < 0 || T_cap < 0 || N < 0 || r_max < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0) {
    const dim3 grid((N + 63) / 64, 2, B);
    batched_ring_append_kernel<T><<<grid, 64, 0, stream>>>(
        Ybuf, Wbuf, rows, rmask, n_evict, t_cur, T_cap, N, r_max);
  }
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_RING_ENTRIES(SFX, T)                                               \
  int ring_append_##SFX(T* Ybuf, T* Wbuf, const T* rows, const T* rmask,     \
                        int T_cap, int N, int r_max, int n_evict, int t_cur, \
                        void* stream) {                                      \
    return launch<T>(Ybuf, Wbuf, rows, rmask, T_cap, N, r_max, n_evict,      \
                     t_cur, (cudaStream_t)stream);                           \
  }                                                                          \
  int batched_ring_append_##SFX(T* Ybuf, T* Wbuf, const T* rows,             \
                                const T* rmask, const int* n_evict,          \
                                const int* t_cur, int B, int T_cap, int N,   \
                                int r_max, void* stream) {                   \
    return launch_batched<T>(Ybuf, Wbuf, rows, rmask, n_evict, t_cur, B,     \
                             T_cap, N, r_max, (cudaStream_t)stream);         \
  }
#if DFM_WANT_F32
DFM_RING_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_RING_ENTRIES(f64, double)
#endif
}
