// K13, single-session form: ring eviction and ragged append, in place.
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

template <typename T>
__global__ void ring_append_kernel(T* Ybuf, T* Wbuf, const T* rows,
                                   const T* rmask, int T_cap, int N,
                                   int r_max, int n_evict, int t_cur) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  T* buf = blockIdx.y == 0 ? Ybuf : Wbuf;
  const T* src = blockIdx.y == 0 ? rows : rmask;
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

extern "C" {
#if DFM_WANT_F32
int ring_append_f32(float* Ybuf, float* Wbuf, const float* rows,
                    const float* rmask, int T_cap, int N, int r_max,
                    int n_evict, int t_cur, void* stream) {
  return launch<float>(Ybuf, Wbuf, rows, rmask, T_cap, N, r_max, n_evict,
                       t_cur, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int ring_append_f64(double* Ybuf, double* Wbuf, const double* rows,
                    const double* rmask, int T_cap, int N, int r_max,
                    int n_evict, int t_cur, void* stream) {
  return launch<double>(Ybuf, Wbuf, rows, rmask, T_cap, N, r_max, n_evict,
                        t_cur, (cudaStream_t)stream);
}
#endif
}
