// K2: masked observation statistics of the information-form filter.
//
// Replaces the masked branch of dfm_tpu/ssm/info_filter.py:obs_stats
// (lines 93-100).  For every step t, over the series n:
//   b_t   = sum_n w y lam_n / R_n          (k,)
//   C_t   = sum_n w lam_n lam_n' / R_n     (k, k), k(k+1)/2 sums, mirrored
//   n_t   = sum_n w
//   ldR_t = sum_n w log R_n
// with y = nan_to_num(y) so a NaN at a missing entry cannot poison b.
// The unmasked branch is a plain GEMM and stays torch.matmul.
//
// Bound on the H100: bytes.  The kernel reads Y and the mask once (40 MB
// in f32 at T = 500, N = 10,000) and does ~k(k+3) flops per entry, below
// the card's flops-per-byte balance at k = 10.
//
// K2b-m, the fleet's batched twin, is the same kernel over B lanes (grid
// (T, B), every tensor of a lane batch-major at a lane stride): it replaces
// dfm_tpu/estim/batched.py:_batched_obs_stats_masked (line 593), the masked
// statistics of a fleet tick over each lane's capacity buffer.  Bound:
// bytes, Y and W read once, 640 MB at B = 8, T = 1,000, N = 10,000 in f32
// (~0.19 ms at 3.35 TB/s); every block also re-reads its lane's loadings
// (400 KB, from L2).  Its n_t and ldR_t are summed and written in double,
// as the JAX function sums them in the accumulation dtype (log R_n is taken
// in the compute dtype, then widened); the lone K2 keeps them in T, as its
// JAX branch does.
//
// K2-tv, the time-varying-loadings twin, is the same kernel with the
// loadings read at a time stride (Lam_t (T, N, k), a row of N k values a
// step) and the mask optional: it replaces
// dfm_tpu/models/tv_loadings.py:obs_stats_tv (line 81), both branches.
// Unmasked (no mask pointer) it sums y lam / R with w = 1, so n_t = N and
// ldR_t = sum_n log R_n; n_t and ldR_t are summed and written in double, as
// K2b-m's.  The unmasked statistics of a static Lam are a GEMM, but over
// per-step loadings they are not one: this kernel serves both branches.
// Bound: bytes, Y and the loadings read once, 30 MB in f32 at T = 300,
// N = 5,000, k = 4 (~9 us at 3.35 TB/s).
//
// K12 = K2-wide (obs_stats_wide_kernel below): the lone masked K2 at any k
// <= DFM_WIDE_KMAX = 32, which the lone wrapper takes for 16 < k <= 32.  It
// replaces the masked obs_stats where dfm_tpu/models/mixed_freq.py:
// mf_em_core runs it on the augmented loadings (line 154; the m = L k
// columns of ``augment``, lines 110-114: m = 25 at S3, 2,000 series x 300
// steps).  At m = 25 a step has m + m(m+1)/2 = 350 sums, too many partials
// for a thread's registers, so the design turns around: one block of 256
// threads a step stages a tile of 64 series (w/R, w y/R and the m loadings)
// in shared memory, and each thread owns at most three of the sums and
// loops over the tile.  n_t and ldR_t are summed in T, as the lone K2's.
// Bound: operations at S3, 2 T N 350 = 420 MFLOP (~6 us at 67 TFLOP/s),
// beside Y and the mask, 4.8 MB in f32 (~1.4 us).
//
// K2b-m-wide (batched_obs_stats_wide): K2-wide with blockIdx.y a lane, every
// tensor of a lane batch-major at a lane stride, as K2b-m is K2 over a
// (T, B) grid: the fleet's masked statistics at 16 < k <= 32 (a bucket
// padded past k = 16, and a lowrank bucket's statistics there).  It
// replaces dfm_tpu/estim/batched.py:_batched_obs_stats_masked (line 593) at
// wide k; n_t and ldR_t are summed and written in double, as K2b-m's.
// Bound: bytes, Y and W read once (480 MB at B = 6, T = 1,000, N = 10,000
// in f32, ~0.14 ms) against 2 B T N (k + k(k+1)/2) = 42 GFLOP at k = 25
// (~0.63 ms at 67 TFLOP/s): operations.
//
// K2-gen (obs_stats_gen_kernel below): the lone masked K2 at 32 < k <=
// DFM_GEN_KMAX = 128, which the lone wrapper takes there (the masked info
// and lowrank fits past 32, and the mixed-frequency seq route at m > 32):
// it replaces the masked branch of dfm_tpu/ssm/info_filter.py:obs_stats
// (line 69, lines 93-100) at those widths.  At k = 100 a step has 5,150
// sums, so a step's C_t is a weighted GEMM, Lam' diag(w_t / R) Lam, and
// the grid runs over (step, 32 x 32 tile of C_t's lower triangle): a block
// stages 64-series slices of its two 32-column strips of Lam (zero past k)
// and of w / R in shared memory, each of its 256 threads holds a 2 x 2
// register block of the tile (summed a slice at a time, then into the
// totals: two-level sums over the series), and the tile is written with
// its mirror (the diagonal tiles through shared memory, from their lower
// half, so C_t is exactly symmetric).  The diagonal tiles also sum their rows of b_t, and
// tile (0, 0) n_t and ldR_t (in T, as the lone K2).  Bound: operations, 2
// T N (k + k(k+1)/2) = 5.1e10 flops at T = 500, N = 10,000, k = 100 (~0.75
// ms at 67 TFLOP/s in f32), against 40 MB of Y and the mask; each block
// re-reads its two strips of Lam from L2.
//
// K2b-m-gen (batched_obs_stats_gen): K2-gen with blockIdx.z a lane (grid
// (T, tiles, B), every tensor of a lane batch-major at a lane stride; the
// lone entry launches B = 1), the fleet's masked statistics at 32 < k <=
// 128 (a bucket padded past k = 32, and a lowrank bucket's statistics
// there).  It replaces dfm_tpu/estim/batched.py:_batched_obs_stats_masked
// (line 593) at those widths; n_t and ldR_t are summed and written in
// double, as K2b-m's, and the sums stay two-level.  A fully masked step
// gives exact zeros.  Bound: operations, 2 B T N (k + k(k+1)/2) = 5.1e10
// flops at B = 2, T = 1,000, N = 10,000, k = 50 (~0.76 ms at 67 TFLOP/s
// in f32), against 160 MB of Y and W (~0.048 ms).
//
// K2-tv-wide and K2-tv-gen (tvl_obs_stats_wide, tvl_obs_stats_gen): K2-wide
// and K2-gen with the loadings read at a time stride (Lam_t (T, N, k), N k
// values a step) and the mask optional, as K2-tv is K2: the time-varying-
// loadings family's statistics at 16 < k <= 32 and 32 < k <= 128.  They
// replace dfm_tpu/models/tv_loadings.py:obs_stats_tv (line 81), both
// branches, there; unmasked (no mask pointer) w = 1, so n_t = N and ldR_t
// = sum_n log R_n; n_t and ldR_t are summed and written in double, as
// K2-tv's.  Bound: at S4 (T = 300, N = 5,000) bytes at k = 25 (the per-step
// loadings read once, 150 MB in f32, ~0.045 ms) against 2 T N (k +
// k(k+1)/2) = 1.1e9 flops (~0.017 ms); operations past k ~ 40.
//
// Design: one block per t (and lane).  Each thread walks series with a stride of
// blockDim.x, keeps its partials of all k + k(k+1)/2 + 2 outputs in
// registers (k is a template constant so the partials stay in registers;
// n and ldR in the accumulation type TA),
// then every warp reduces its partials with shuffles and the block adds the
// warps' sums through shared memory.
#include "common.cuh"

constexpr int kThreads = 256;

template <typename T, typename TA, int K>
__global__ void __launch_bounds__(kThreads)
obs_stats_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                 const T* __restrict__ R, const T* __restrict__ mask,
                 T* __restrict__ b, T* __restrict__ C, TA* __restrict__ nobs,
                 TA* __restrict__ ldR, int N, size_t lam_tstride) {
  constexpr int NC = K * (K + 1) / 2;
  constexpr int NV = K + NC;
  __shared__ T part[kThreads / 32][NV];
  __shared__ TA part_a[kThreads / 32][2];
  const int t = blockIdx.x, T_ = gridDim.x;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  if (mask) mask += pb * tn;
  Lam += pb * (size_t)N * K + t * lam_tstride;
  R += pb * N;
  b += pb * (size_t)T_ * K;
  C += pb * (size_t)T_ * K * K;
  nobs += pb * T_;
  ldR += pb * T_;
  const T* y = Y + (size_t)t * N;
  const T* w = mask ? mask + (size_t)t * N : nullptr;
  T acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = T(0);
  TA acc_n = TA(0), acc_l = TA(0);
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const T wn = w ? w[n] : T(1);
    const T rinv = T(1) / R[n];
    const T yw = w ? wn * nan_to_num(y[n]) : y[n];
    const T wr = w ? wn * rinv : rinv;
    T lam[K];
#pragma unroll
    for (int j = 0; j < K; ++j) lam[j] = Lam[(size_t)n * K + j];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += yw * (lam[j] * rinv);
    int e = K;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[e++] += wr * lam[i] * lam[j];
    acc_n += TA(wn);
    acc_l += TA(wn) * TA(dfm_log(R[n]));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    T v = acc[e];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[wid][e] = v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    acc_n += __shfl_down_sync(0xffffffffu, acc_n, o);
    acc_l += __shfl_down_sync(0xffffffffu, acc_l, o);
  }
  if (lane == 0) {
    part_a[wid][0] = acc_n;
    part_a[wid][1] = acc_l;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NV; e += kThreads) {
    T s = T(0);
    for (int q = 0; q < kThreads / 32; ++q) s += part[q][e];
    if (e < K) {
      b[(size_t)t * K + e] = s;
    } else if (e < K + NC) {
      int r = e - K, i = 0;
      while (r > i) { r -= i + 1; ++i; }          // packed (i, j), j <= i
      T* Ct = C + (size_t)t * K * K;
      Ct[i * K + r] = s;
      Ct[r * K + i] = s;
    }
  }
  if (threadIdx.x < 2) {
    TA s = TA(0);
    for (int q = 0; q < kThreads / 32; ++q) s += part_a[q][threadIdx.x];
    (threadIdx.x == 0 ? nobs : ldR)[t] = s;
  }
}

constexpr int kWideTile = 64;
// The most sums a thread owns (3: 560 sums at k = 32 over 256 threads).
constexpr int kWideSums =
    DFM_WIDE_KMAX + DFM_WIDE_KMAX * (DFM_WIDE_KMAX + 1) / 2;
constexpr int kWideOwn = (kWideSums + kThreads - 1) / kThreads;

// n_t and ldR_t in TA (T for the lone K2-wide, double for K2b-m-wide);
// blockIdx.y is the lane.
template <typename T, typename TA>
__global__ void __launch_bounds__(kThreads)
obs_stats_wide_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                      const T* __restrict__ R, const T* __restrict__ mask,
                      T* __restrict__ b, T* __restrict__ C,
                      TA* __restrict__ nobs, TA* __restrict__ ldR, int N,
                      int k, size_t lam_tstride) {
  __shared__ T lam[kWideTile][DFM_WIDE_KMAX + 1];
  __shared__ T wr[kWideTile], yr[kWideTile];
  __shared__ TA red[32];
  const int t = blockIdx.x, tid = threadIdx.x, T_ = gridDim.x;
  const int nv = k + k * (k + 1) / 2;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  if (mask) mask += pb * tn;
  Lam += pb * (size_t)N * k + t * lam_tstride;
  R += pb * N;
  b += pb * (size_t)T_ * k;
  C += pb * (size_t)T_ * k * k;
  nobs += pb * T_;
  ldR += pb * T_;
  const T* y = Y + (size_t)t * N;
  const T* w = mask ? mask + (size_t)t * N : nullptr;
  // The sums this thread owns: e < k is b[e]; else the packed (i, j), j <= i.
  int oi[kWideOwn], oj[kWideOwn];
  T acc[kWideOwn];
#pragma unroll
  for (int q = 0; q < kWideOwn; ++q) {
    const int e = tid + q * kThreads;
    oi[q] = -1;
    oj[q] = -1;
    acc[q] = T(0);
    if (e < k) {
      oi[q] = e;
    } else if (e < nv) {
      int r = e - k, i = 0;
      while (r > i) { r -= i + 1; ++i; }
      oi[q] = i;
      oj[q] = r;
    }
  }
  TA acc_n = TA(0), acc_l = TA(0);
  for (int n0 = 0; n0 < N; n0 += kWideTile) {
    const int nt = min(kWideTile, N - n0);
    __syncthreads();                       // the previous tile is consumed
    for (int e = tid; e < nt * k; e += kThreads)
      lam[e / k][e % k] = Lam[(size_t)n0 * k + e];
    if (tid < nt) {
      const int n = n0 + tid;
      const T wn = w ? w[n] : T(1);
      const T rinv = T(1) / R[n];
      wr[tid] = w ? wn * rinv : rinv;
      yr[tid] = (w ? wn * nan_to_num(y[n]) : y[n]) * rinv;
      acc_n += TA(wn);
      acc_l += TA(wn) * TA(dfm_log(R[n]));
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kWideOwn; ++q) {
      const int i = oi[q], j = oj[q];
      if (i < 0) continue;
      T s = acc[q];
      if (j < 0) {
        for (int n = 0; n < nt; ++n) s += yr[n] * lam[n][i];
      } else {
        for (int n = 0; n < nt; ++n) s += wr[n] * lam[n][i] * lam[n][j];
      }
      acc[q] = s;
    }
  }
  T* Ct = C + (size_t)t * k * k;
#pragma unroll
  for (int q = 0; q < kWideOwn; ++q) {
    const int i = oi[q], j = oj[q];
    if (i < 0) continue;
    if (j < 0) {
      b[(size_t)t * k + i] = acc[q];
    } else {
      Ct[i * k + j] = acc[q];
      Ct[j * k + i] = acc[q];
    }
  }
  acc_n = block_reduce_sum(acc_n, red);
  if (tid == 0) nobs[t] = acc_n;
  __syncthreads();
  acc_l = block_reduce_sum(acc_l, red);
  if (tid == 0) ldR[t] = acc_l;
}

constexpr int kGenSlice = 64;     // series a staged slice
constexpr int kGenTile = 32;      // side of a tile of C_t

// Grid (T, ntiles (ntiles + 1) / 2, B), ntiles = ceil(k / 32): blockIdx.y
// is the packed lower-triangle tile (I, J), J <= I, blockIdx.z the lane
// (B = 1 for the lone K2-gen); n_t and ldR_t in TA (T for the lone K2-gen,
// double for K2b-m-gen).
template <typename T, typename TA>
__global__ void __launch_bounds__(kThreads)
obs_stats_gen_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                     const T* __restrict__ R, const T* __restrict__ mask,
                     T* __restrict__ b, T* __restrict__ C,
                     TA* __restrict__ nobs, TA* __restrict__ ldR, int N,
                     int k, size_t lam_tstride) {
  __shared__ T li[kGenSlice][kGenTile + 1], lj[kGenSlice][kGenTile + 1];
  __shared__ T wr[kGenSlice], yr[kGenSlice];
  __shared__ T ct[kGenTile][kGenTile + 1];
  __shared__ TA red[32];
  const int t = blockIdx.x, tid = threadIdx.x, T_ = gridDim.x;
  // This block's problem lane.
  const size_t pb = blockIdx.z, tn = (size_t)T_ * N;
  Y += pb * tn;
  if (mask) mask += pb * tn;
  Lam += pb * (size_t)N * k + t * lam_tstride;
  R += pb * N;
  b += pb * (size_t)T_ * k;
  C += pb * (size_t)T_ * k * k;
  nobs += pb * T_;
  ldR += pb * T_;
  int I = 0, r = blockIdx.y;
  while (r > I) { r -= I + 1; ++I; }
  const int J = r, diag = I == J;
  const int i0 = I * kGenTile, j0 = J * kGenTile;
  const int ni = min(kGenTile, k - i0), nj = min(kGenTile, k - j0);
  const T* y = Y + (size_t)t * N;
  const T* w = mask ? mask + (size_t)t * N : nullptr;
  const int tx = tid & 15, ty = tid >> 4;
  // Two-level sums: each slice's partials, then the running totals, so an
  // f32 sum over N = 10,000 series rounds like ~N / 64 + 64 terms, not N.
  T acc00 = T(0), acc01 = T(0), acc10 = T(0), acc11 = T(0), bacc = T(0);
  TA acc_n = TA(0), acc_l = TA(0);
  constexpr int kStage = kGenSlice * kGenTile / kThreads;   // 8 a thread
  for (int n0 = 0; n0 < N; n0 += kGenSlice) {
    const int nt = min(kGenSlice, N - n0);
    __syncthreads();                       // the previous slice is consumed
    // Every load of the slice issues before the stores to shared memory.
    T vi[kStage], vj[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = tid + u * kThreads, n = e / kGenTile, c = e % kGenTile;
      const size_t row = (size_t)(n0 + min(n, nt - 1)) * k;
      vi[u] = Lam[row + i0 + min(c, ni - 1)];
      vj[u] = Lam[row + j0 + min(c, nj - 1)];
    }
    T wn = T(0), rn = T(1), yn = T(0);
    if (tid < nt) {
      wn = w ? w[n0 + tid] : T(1);
      rn = R[n0 + tid];
      yn = y[n0 + tid];
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = tid + u * kThreads, n = e / kGenTile, c = e % kGenTile;
      li[n][c] = n < nt && c < ni ? vi[u] : T(0);
      lj[n][c] = n < nt && c < nj ? vj[u] : T(0);
    }
    if (tid < nt) {
      const T rinv = T(1) / rn;
      wr[tid] = w ? wn * rinv : rinv;
      yr[tid] = (w ? wn * nan_to_num(yn) : yn) * rinv;
      if (blockIdx.y == 0) {
        acc_n += TA(wn);
        acc_l += TA(wn) * TA(dfm_log(rn));
      }
    }
    __syncthreads();
    T p00 = T(0), p01 = T(0), p10 = T(0), p11 = T(0);
    for (int n = 0; n < nt; ++n) {
      const T a0 = wr[n] * li[n][ty], a1 = wr[n] * li[n][ty + 16];
      const T b0 = lj[n][tx], b1 = lj[n][tx + 16];
      p00 += a0 * b0;
      p01 += a0 * b1;
      p10 += a1 * b0;
      p11 += a1 * b1;
    }
    acc00 += p00;
    acc01 += p01;
    acc10 += p10;
    acc11 += p11;
    if (diag && tid < ni) {
      T pb = T(0);
      for (int n = 0; n < nt; ++n) pb += yr[n] * li[n][tid];
      bacc += pb;
    }
  }
  ct[ty][tx] = acc00;
  ct[ty][tx + 16] = acc01;
  ct[ty + 16][tx] = acc10;
  ct[ty + 16][tx + 16] = acc11;
  __syncthreads();
  T* Ct = C + (size_t)t * k * k;
  for (int e = tid; e < kGenTile * kGenTile; e += kThreads) {
    const int rr = e / kGenTile, cc = e % kGenTile;
    if (rr >= ni || cc >= nj || (diag && cc > rr)) continue;
    const T v = ct[rr][cc];
    Ct[(size_t)(i0 + rr) * k + j0 + cc] = v;
    Ct[(size_t)(j0 + cc) * k + i0 + rr] = v;
  }
  if (diag && tid < ni) b[(size_t)t * k + i0 + tid] = bacc;
  if (blockIdx.y != 0) return;
  acc_n = block_reduce_sum(acc_n, red);
  if (tid == 0) nobs[t] = acc_n;
  __syncthreads();
  acc_l = block_reduce_sum(acc_l, red);
  if (tid == 0) ldR[t] = acc_l;
}

template <typename T, typename TA>
static int launch_gen(const T* Y, const T* Lam, const T* R, const T* mask,
                      T* b, T* C, TA* nobs, TA* ldR, int B, int T_, int N,
                      int k, size_t lam_tstride, cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  const int nt = (k + kGenTile - 1) / kGenTile;
  if (B > 0 && T_ > 0)
    obs_stats_gen_kernel<T, TA><<<dim3(T_, nt * (nt + 1) / 2, B), kThreads,
                                  0, stream>>>(Y, Lam, R, mask, b, C, nobs,
                                               ldR, N, k, lam_tstride);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
static int launch_wide(const T* Y, const T* Lam, const T* R, const T* mask,
                       T* b, T* C, TA* nobs, TA* ldR, int B, int T_, int N,
                       int k, size_t lam_tstride, cudaStream_t stream) {
  if (k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  if (B > 0 && T_ > 0)
    obs_stats_wide_kernel<T, TA><<<dim3(T_, B), kThreads, 0, stream>>>(
        Y, Lam, R, mask, b, C, nobs, ldR, N, k, lam_tstride);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
static int launch(const T* Y, const T* Lam, const T* R, const T* mask, T* b,
                  T* C, TA* nobs, TA* ldR, int B, int T_, int N, int k,
                  size_t lam_tstride, cudaStream_t stream) {
  if (B <= 0 || T_ <= 0) return (int)cudaGetLastError();
  DFM_DISPATCH_K(k, obs_stats_kernel<T, TA, K><<<dim3(T_, B), kThreads, 0,
                                             stream>>>(
                        Y, Lam, R, mask, b, C, nobs, ldR, N, lam_tstride))
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_OBS_ENTRIES(SFX, T)                                                \
  int obs_stats_##SFX(const T* Y, const T* Lam, const T* R, const T* mask,   \
                      T* b, T* C, T* nobs, T* ldR, int T_, int N, int k,     \
                      void* stream) {                                        \
    return launch<T, T>(Y, Lam, R, mask, b, C, nobs, ldR, 1, T_, N, k, 0,    \
                        (cudaStream_t)stream);                               \
  }                                                                          \
  int tvl_obs_stats_##SFX(const T* Y, const T* Lam_t, const T* R,            \
                          const T* mask, T* b, T* C, double* nobs,           \
                          double* ldR, int T_, int N, int k, void* stream) { \
    return launch<T, double>(Y, Lam_t, R, mask, b, C, nobs, ldR, 1, T_, N,   \
                             k, (size_t)N * k, (cudaStream_t)stream);        \
  }                                                                          \
  int batched_obs_stats_##SFX(const T* Y, const T* Lam, const T* R,          \
                              const T* mask, T* b, T* C, double* nobs,       \
                              double* ldR, int B, int T_, int N, int k,      \
                              void* stream) {                                \
    return launch<T, double>(Y, Lam, R, mask, b, C, nobs, ldR, B, T_, N, k,  \
                             0, (cudaStream_t)stream);                       \
  }                                                                          \
  int obs_stats_wide_##SFX(const T* Y, const T* Lam, const T* R,             \
                           const T* mask, T* b, T* C, T* nobs, T* ldR,       \
                           int T_, int N, int k, void* stream) {             \
    return launch_wide<T, T>(Y, Lam, R, mask, b, C, nobs, ldR, 1, T_, N, k,  \
                             0, (cudaStream_t)stream);                       \
  }                                                                          \
  int batched_obs_stats_wide_##SFX(const T* Y, const T* Lam, const T* R,     \
                                   const T* mask, T* b, T* C, double* nobs,  \
                                   double* ldR, int B, int T_, int N, int k, \
                                   void* stream) {                           \
    return launch_wide<T, double>(Y, Lam, R, mask, b, C, nobs, ldR, B, T_,   \
                                  N, k, 0, (cudaStream_t)stream);            \
  }                                                                          \
  int obs_stats_gen_##SFX(const T* Y, const T* Lam, const T* R,              \
                          const T* mask, T* b, T* C, T* nobs, T* ldR,        \
                          int T_, int N, int k, void* stream) {              \
    return launch_gen<T, T>(Y, Lam, R, mask, b, C, nobs, ldR, 1, T_, N, k,   \
                            0, (cudaStream_t)stream);                        \
  }                                                                          \
  int batched_obs_stats_gen_##SFX(const T* Y, const T* Lam, const T* R,      \
                                  const T* mask, T* b, T* C, double* nobs,   \
                                  double* ldR, int B, int T_, int N, int k,  \
                                  void* stream) {                            \
    return launch_gen<T, double>(Y, Lam, R, mask, b, C, nobs, ldR, B, T_, N, \
                                 k, 0, (cudaStream_t)stream);                \
  }                                                                          \
  int tvl_obs_stats_wide_##SFX(const T* Y, const T* Lam_t, const T* R,       \
                               const T* mask, T* b, T* C, double* nobs,      \
                               double* ldR, int T_, int N, int k,            \
                               void* stream) {                               \
    return launch_wide<T, double>(Y, Lam_t, R, mask, b, C, nobs, ldR, 1, T_, \
                                  N, k, (size_t)N * k, (cudaStream_t)stream);\
  }                                                                          \
  int tvl_obs_stats_gen_##SFX(const T* Y, const T* Lam_t, const T* R,        \
                              const T* mask, T* b, T* C, double* nobs,       \
                              double* ldR, int T_, int N, int k,             \
                              void* stream) {                                \
    return launch_gen<T, double>(Y, Lam_t, R, mask, b, C, nobs, ldR, 1, T_,  \
                                 N, k, (size_t)N * k, (cudaStream_t)stream); \
  }
#if DFM_WANT_F32
DFM_OBS_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_OBS_ENTRIES(f64, double)
#endif
}
