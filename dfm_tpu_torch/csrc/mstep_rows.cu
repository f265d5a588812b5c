// K3: masked per-series M-step rows.
//
// Replaces the masked branch of dfm_tpu/estim/em.py:mstep_rows (lines
// 197-213).  For every series i, over the steps t with w = mask[t, i] and
// yz = w > 0 ? nan_to_num(y) : 0:
//   S_yf,i = sum_t yz E[f_t]                       (k,)
//   S_ff,i = sum_t w E[f_t f_t']                   (k, k); I when the series
//            is never observed; plus lam_ridge * I
//   Lam_i  = chol-solve of (S_ff,i + jitter I) against S_yf,i
//   R_i    = max((sum_t w (yz - E[f_t] . Lam_i)^2
//                 + Lam_i' (sum_t w P_sm,t) Lam_i) / max(count, 1), r_floor)
//
// Bound on the H100: bytes.  The kernel must read Y and the mask once (40
// MB in f32 at T = 500, N = 10,000); the moments E[f], E[ff'] and P_sm are
// (T, k, k)-sized and every series reads all of them.
//
// K3b-m, the fleet's batched twin, is the same kernel over B lanes (grid
// (ceil(N / 64), B), every tensor of a lane batch-major at a lane stride,
// no ridge): it replaces the observation rows of
// dfm_tpu/estim/batched.py:batched_m_step_masked (lines 701-713).  A
// never-observed series (an N-pad series of a fleet bucket) gets S_ff = I
// and S_yf = 0, so exact-zero loadings.  Bound: bytes, Y and W read once,
// 640 MB at B = 8, T = 1,000, N = 10,000 in f32.
//
// Design: one thread per series, so each step's read of Y and of the mask
// is coalesced across the block.  Two passes over T: the first accumulates
// S_yf and the packed lower triangle of S_ff in registers (k is a template
// constant) and solves the k x k system in place; the second accumulates
// the residual sum and the packed P_sm sum for the smear.  The block stages
// chunks of kTC steps of the moments in shared memory, because every series
// of the block reads them.  k <= DFM_KMAX.
//
// K3-wide (mstep_rows_wide): the same rows at k <= DFM_WIDE_KMAX = 32, which
// the lone wrapper takes for 16 < k <= 32 (the masked info, pit and lowrank
// fits at wide k).  A thread a series would keep the k (k + 1) / 2 = 528
// packed sums of S_ff in registers at k = 32 and spill, so the sums of a
// series are split over the warps of a block: a block owns a tile of 32
// series (a lane a series, so the reads of Y and the mask stay coalesced)
// and 8 warps; warp w accumulates the entries e = w + 8 j of the NE = k (k +
// 1) / 2 + k sums (packed S_ff, then S_yf) in registers, JB of them, JB a
// template bucket (24, 40, 56, 72) of the runtime k.  The moments of a chunk
// of 8 steps are staged packed in shared memory (a warp reads one value a
// sum, broadcast), with the chunk's weights and zero-filled values (a warp a
// step).  Between the passes the sums go to shared memory ([NE][32], 143 KB
// in f64 at k = 32, opted in) and warp 0 factors and solves a series a lane;
// the second pass accumulates the packed P_sm sums the same way while each
// thread owns one (step, series) residual of the chunk.  Bound: operations
// at k = 25 (the sums are NE x T x N multiply-adds a pass, ~3.5 GFLOP a
// pass at the headline panel, against 40 MB of Y and the mask in f32).
//
// K3b-m-wide (batched_mstep_rows_wide): K3-wide with blockIdx.y a lane
// (grid (ceil(N / 32), B), every tensor of a lane batch-major at a lane
// stride) and no ridge, the fleet M-step's rows at 16 < k <= 32: it
// replaces the observation rows of dfm_tpu/estim/batched.py:
// batched_m_step_masked (lines 701-713) at wide k, as K3b-m is K3 with a
// lane dimension.  A never-observed series (an N-pad series) gets S_ff = I
// and S_yf = 0: exact-zero loadings and R at the floor.  The lone and the
// batched entry run one kernel, so the shared-memory opt-in (143 KB in f64
// at k = 32: one block an SM) covers both.  Bound: operations, ~7 GFLOP a
// pass a lane at T = 1,000, N = 10,000, k = 25, against 480 MB of Y and W
// at B = 6 in f32.
//
// K3-gen (mstep_rows_gen): the lone masked rows at 32 < k <= DFM_GEN_KMAX =
// 128, which the lone wrapper takes there (the masked info and lowrank fits
// past 32): it replaces the masked branch of dfm_tpu/estim/em.py:mstep_rows
// (line 163, lines 199-214) at those widths.  K3-wide keeps a 32-series
// tile's packed sums in shared memory, 659 KB in f32 at k = 100; the
// (N, k, k) S_ff,i is never formed either (400 MB at N = 10,000, k = 100
// in f32).  Design: a block of 256 threads owns S series (4 in f32, 2 in
// f64), and thread q owns the entries e = q + 256 j of the NE = k(k+1)/2 +
// k sums (the packed lower triangle of S_ff, then S_yf) of all S series in
// registers (33 a series at k = 128), so each load of a moment entry feeds
// S series.  The sums then go to shared memory (134 KB at k = 128 in either
// dtype, opted in) and warp s factors series s there (a right-looking
// column Cholesky, the lanes over the rows) and solves for Lam_s.  The
// second pass sums w P_sm,t into the same registers and forms the smear
// Lam' PV Lam from them at once (never stored), while each thread takes a
// stride of the steps for the residual sum; the block then reduces both.
// Bound: operations, 2 T N (k(k+1)/2 + k) a pass, ~1e11 flops at T = 500,
// N = 10,000, k = 100 (~1.5 ms at 67 TFLOP/s in f32), against 40 MB of Y
// and the mask; each block re-reads the moments from L2.
//
// K3b-m-gen (batched_mstep_rows_gen): K3-gen with blockIdx.y a lane (grid
// (ceil(N / S), B), every tensor of a lane batch-major at a lane stride;
// the lone entry launches B = 1) and no ridge, the fleet M-step's rows at
// 32 < k <= 128: it replaces the observation rows of
// dfm_tpu/estim/batched.py:batched_m_step_masked (lines 701-713) at those
// widths.  The (B, N, k, k) S_ff is never formed.  A never-observed series
// (an N-pad series) gets S_ff = I and S_yf = 0: exact-zero loadings and R
// at the floor.  Bound: operations, 2 B T N (k(k+1)/2 + k) a pass, ~1.1e11
// flops over both passes at B = 2, T = 1,000, N = 10,000, k = 50 (~1.6 ms
// at 67 TFLOP/s in f32), against 160 MB of Y and W.
#include "common.cuh"

constexpr int kThreads = 64;
constexpr int kTC = 16;

__host__ __device__ constexpr int tri(int a, int c) { return a * (a + 1) / 2 + c; }

// Stage steps [t0, t0 + nt) of Ef (T, K) and of a (T, K, K) moment.
template <typename T, int K>
__device__ void stage(T (*sE)[K], T (*sM)[K * K], const T* Ef, const T* M,
                      int t0, int nt) {
  for (int q = threadIdx.x; q < nt * K; q += kThreads)
    sE[q / K][q % K] = Ef[(size_t)t0 * K + q];
  for (int q = threadIdx.x; q < nt * K * K; q += kThreads)
    sM[q / (K * K)][q % (K * K)] = M[(size_t)t0 * K * K + q];
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
mstep_rows_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                  const T* __restrict__ Ef, const T* __restrict__ EffT,
                  const T* __restrict__ Psm, T* __restrict__ Lam,
                  T* __restrict__ R, int T_, int N, T r_floor, T lam_ridge) {
  constexpr int NC = K * (K + 1) / 2;
  __shared__ T sE[kTC][K];
  __shared__ T sM[kTC][K * K];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < N;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  mask += pb * tn;
  Ef += pb * (size_t)T_ * K;
  EffT += pb * (size_t)T_ * K * K;
  Psm += pb * (size_t)T_ * K * K;
  Lam += pb * (size_t)N * K;
  R += pb * N;

  T syf[K], S[NC], cnt = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) syf[j] = T(0);
#pragma unroll
  for (int e = 0; e < NC; ++e) S[e] = T(0);
  for (int t0 = 0; t0 < T_; t0 += kTC) {
    const int nt = min(kTC, T_ - t0);
    __syncthreads();
    stage<T, K>(sE, sM, Ef, EffT, t0, nt);
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = (size_t)(t0 + tt) * N + i;
      const T w = mask[off];
      const T yz = w > T(0) ? nan_to_num(Y[off]) : T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) syf[j] += yz * sE[tt][j];
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) S[tri(a, c)] += w * sM[tt][a * K + c];
      cnt += w;
    }
  }

  // Never observed: S_ff,i = I.  Then the ridge, then psd_cholesky's
  // jitter (S is symmetric by construction, so sym() is exact).
  const T jit = dfm_jitter<T>();
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      if (cnt == T(0)) S[tri(a, c)] = a == c ? T(1) : T(0);
      if (a == c) S[tri(a, a)] = (S[tri(a, a)] + lam_ridge) + jit;
    }
  // Cholesky in place (row by row, no clamp: an indefinite S gives NaN).
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      T s = S[tri(a, c)];
#pragma unroll
      for (int m = 0; m < c; ++m) s -= S[tri(a, m)] * S[tri(c, m)];
      S[tri(a, c)] = a == c ? dfm_sqrt(s) : s / S[tri(c, c)];
    }
  T lam[K];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T s = syf[a];
#pragma unroll
    for (int m = 0; m < a; ++m) s -= S[tri(a, m)] * lam[m];
    lam[a] = s / S[tri(a, a)];
  }
#pragma unroll
  for (int a = K - 1; a >= 0; --a) {
    T s = lam[a];
#pragma unroll
    for (int m = a + 1; m < K; ++m) s -= S[tri(m, a)] * lam[m];
    lam[a] = s / S[tri(a, a)];
  }

  // Second pass: residual sum and sum_t w P_sm,t (packed, reusing S).
  T rs = T(0);
#pragma unroll
  for (int e = 0; e < NC; ++e) S[e] = T(0);
  for (int t0 = 0; t0 < T_; t0 += kTC) {
    const int nt = min(kTC, T_ - t0);
    __syncthreads();
    stage<T, K>(sE, sM, Ef, Psm, t0, nt);
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const size_t off = (size_t)(t0 + tt) * N + i;
      const T w = mask[off];
      const T yz = w > T(0) ? nan_to_num(Y[off]) : T(0);
      T fit = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) fit += sE[tt][j] * lam[j];
      const T v = yz - fit;
      rs += w * (v * v);
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) S[tri(a, c)] += w * sM[tt][a * K + c];
    }
  }
  if (!live) return;
  T smear = T(0);
#pragma unroll
  for (int a = 0; a < K; ++a) {
    T row = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c)
      row += (c <= a ? S[tri(a, c)] : S[tri(c, a)]) * lam[c];
    smear += lam[a] * row;
  }
  const T counts = cnt > T(1) ? cnt : T(1);
  const T r = (rs + smear) / counts;
#pragma unroll
  for (int a = 0; a < K; ++a) Lam[(size_t)i * K + a] = lam[a];
  R[i] = r > r_floor ? r : r_floor;
}

constexpr int kWideWarps = 8;               // = steps of a staged chunk
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideTile = 32;               // series a block, a lane a series

template <typename T>
static size_t wide_smem(int k) {
  const int ne = k * (k + 1) / 2 + k;
  return sizeof(T) * ((size_t)ne * kWideTile + (size_t)kWideWarps * ne +
                      3 * (size_t)kWideWarps * kWideTile);
}

template <typename T, int JB>
__global__ void __launch_bounds__(kWideThreads)
mstep_rows_wide_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                       const T* __restrict__ Ef, const T* __restrict__ EffT,
                       const T* __restrict__ Psm, T* __restrict__ Lam,
                       T* __restrict__ R, int T_, int N, int k, T r_floor,
                       T lam_ridge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = k * (k + 1) / 2, ne = nc + k, kk = k * k;
  T* sS = reinterpret_cast<T*>(smem_raw);       // [ne][32] sums, factor, lam
  T* sZ = sS + (size_t)ne * kWideTile;          // [8][ne] staged moments
  T* sW = sZ + (size_t)kWideWarps * ne;         // [8][32] weights
  T* sYz = sW + kWideWarps * kWideTile;         // [8][32] zero-filled values
  T* sRed = sYz + kWideWarps * kWideTile;       // [8][32] residual partials
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWideTile + lane;
  const bool live = i < N;
  // This block's problem lane.
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  mask += pb * tn;
  Ef += pb * (size_t)T_ * k;
  EffT += pb * (size_t)T_ * kk;
  Psm += pb * (size_t)T_ * kk;
  Lam += pb * (size_t)N * k;
  R += pb * N;

  // Stage steps [t0, t0 + nt): the packed lower triangle of M_t and Ef_t,
  // and (a warp a step) the tile's weights and zero-filled values.
  auto stage = [&](const T* M, int t0, int nt) {
    for (int q = threadIdx.x; q < nt * kk; q += kWideThreads) {
      const int tt = q / kk, r = q % kk, a = r / k, c = r % k;
      if (c <= a) sZ[tt * ne + tri(a, c)] = M[(size_t)t0 * kk + q];
    }
    for (int q = threadIdx.x; q < nt * k; q += kWideThreads)
      sZ[(q / k) * ne + nc + q % k] = Ef[(size_t)t0 * k + q];
    if (warp < nt) {
      const size_t off = (size_t)(t0 + warp) * N + i;
      const T w = live ? mask[off] : T(0);
      sW[warp * kWideTile + lane] = w;
      sYz[warp * kWideTile + lane] =
          w > T(0) ? nan_to_num(Y[off]) : T(0);
    }
  };

  T acc[JB];
#pragma unroll
  for (int j = 0; j < JB; ++j) acc[j] = T(0);
  T cnt = T(0);
  for (int t0 = 0; t0 < T_; t0 += kWideWarps) {
    const int nt = min(kWideWarps, T_ - t0);
    __syncthreads();
    stage(EffT, t0, nt);
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const T w = sW[tt * kWideTile + lane];
      const T yz = sYz[tt * kWideTile + lane];
      const T* z = sZ + tt * ne;
      cnt += w;
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int e = warp + kWideWarps * j;
        if (e < ne) acc[j] += (e < nc ? w : yz) * z[e];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < JB; ++j) {
    const int e = warp + kWideWarps * j;
    if (e < ne) sS[e * kWideTile + lane] = acc[j];
  }
  __syncthreads();

  // Warp 0, a series a lane: never observed -> S_ff = I; the ridge, then
  // psd_cholesky's jitter; Cholesky in place (no clamp); the two solves
  // turn S_yf (at [nc, ne)) into the loadings in place.
  if (warp == 0) {
    T* S = sS + lane;                       // entry e at S[e * 32]
    const T jit = dfm_jitter<T>();
    for (int a = 0; a < k; ++a)
      for (int c = 0; c <= a; ++c) {
        T& v = S[tri(a, c) * kWideTile];
        if (cnt == T(0)) v = a == c ? T(1) : T(0);
        if (a == c) v = (v + lam_ridge) + jit;
      }
    for (int a = 0; a < k; ++a)
      for (int c = 0; c <= a; ++c) {
        T s = S[tri(a, c) * kWideTile];
        for (int m = 0; m < c; ++m)
          s -= S[tri(a, m) * kWideTile] * S[tri(c, m) * kWideTile];
        S[tri(a, c) * kWideTile] =
            a == c ? dfm_sqrt(s) : s / S[tri(c, c) * kWideTile];
      }
    T* lam = S + nc * kWideTile;
    for (int a = 0; a < k; ++a) {
      T s = lam[a * kWideTile];
      for (int m = 0; m < a; ++m)
        s -= S[tri(a, m) * kWideTile] * lam[m * kWideTile];
      lam[a * kWideTile] = s / S[tri(a, a) * kWideTile];
    }
    for (int a = k - 1; a >= 0; --a) {
      T s = lam[a * kWideTile];
      for (int m = a + 1; m < k; ++m)
        s -= S[tri(m, a) * kWideTile] * lam[m * kWideTile];
      lam[a * kWideTile] = s / S[tri(a, a) * kWideTile];
    }
  }
  __syncthreads();

  // Second pass: the packed sum_t w P_sm,t (registers, as above) and the
  // residual sum, thread (warp, lane) owning step t0 + warp of each chunk.
  const T* lam = sS + (size_t)nc * kWideTile + lane;
  T rs = T(0);
#pragma unroll
  for (int j = 0; j < JB; ++j) acc[j] = T(0);
  for (int t0 = 0; t0 < T_; t0 += kWideWarps) {
    const int nt = min(kWideWarps, T_ - t0);
    __syncthreads();
    stage(Psm, t0, nt);
    __syncthreads();
    if (warp < nt) {
      const T* z = sZ + warp * ne + nc;
      T fit = T(0);
      for (int j = 0; j < k; ++j) fit += z[j] * lam[j * kWideTile];
      const T v = sYz[warp * kWideTile + lane] - fit;
      rs += sW[warp * kWideTile + lane] * (v * v);
    }
    for (int tt = 0; tt < nt; ++tt) {
      const T w = sW[tt * kWideTile + lane];
      const T* z = sZ + tt * ne;
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int e = warp + kWideWarps * j;
        if (e < nc) acc[j] += w * z[e];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < JB; ++j) {
    const int e = warp + kWideWarps * j;
    if (e < nc) sS[e * kWideTile + lane] = acc[j];
  }
  sRed[warp * kWideTile + lane] = rs;
  __syncthreads();
  if (warp != 0 || !live) return;
  rs = T(0);
  for (int w = 0; w < kWideWarps; ++w) rs += sRed[w * kWideTile + lane];
  const T* S = sS + lane;
  T smear = T(0);
  for (int a = 0; a < k; ++a) {
    T row = T(0);
    for (int c = 0; c < k; ++c)
      row += S[(c <= a ? tri(a, c) : tri(c, a)) * kWideTile] *
             lam[c * kWideTile];
    smear += lam[a * kWideTile] * row;
  }
  const T counts = cnt > T(1) ? cnt : T(1);
  const T r = (rs + smear) / counts;
  for (int a = 0; a < k; ++a) Lam[(size_t)i * k + a] = lam[a * kWideTile];
  R[i] = r > r_floor ? r : r_floor;
}

// The wide launch: JB, the accumulators a thread, covers ceil(ne / 8).
template <typename T, int JB>
static int launch_wide_jb(const T* Y, const T* mask, const T* Ef,
                          const T* EffT, const T* Psm, T* Lam, T* R, int B,
                          int T_, int N, int k, double r_floor,
                          double lam_ridge, cudaStream_t stream) {
  const size_t bytes = wide_smem<T>(k);
  const cudaError_t e = dfm_smem_optin(mstep_rows_wide_kernel<T, JB>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kWideTile - 1) / kWideTile, B);
  mstep_rows_wide_kernel<T, JB><<<grid, kWideThreads, bytes, stream>>>(
      Y, mask, Ef, EffT, Psm, Lam, R, T_, N, k, (T)r_floor, (T)lam_ridge);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_wide(const T* Y, const T* mask, const T* Ef, const T* EffT,
                       const T* Psm, T* Lam, T* R, int B, int T_, int N,
                       int k, double r_floor, double lam_ridge,
                       cudaStream_t stream) {
  if (k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  const int need = (k * (k + 1) / 2 + k + kWideWarps - 1) / kWideWarps;
  if (need <= 24)
    return launch_wide_jb<T, 24>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k,
                                 r_floor, lam_ridge, stream);
  if (need <= 40)
    return launch_wide_jb<T, 40>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k,
                                 r_floor, lam_ridge, stream);
  if (need <= 56)
    return launch_wide_jb<T, 56>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k,
                                 r_floor, lam_ridge, stream);
  return launch_wide_jb<T, 72>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k,
                               r_floor, lam_ridge, stream);
}

constexpr int kGenThreads = 256;
// Entries a thread owns at DFM_GEN_KMAX: ceil((k (k + 1) / 2 + k) / 256).
constexpr int kGenOwn =
    (DFM_GEN_KMAX * (DFM_GEN_KMAX + 1) / 2 + DFM_GEN_KMAX + kGenThreads - 1) /
    kGenThreads;

template <typename T>
__host__ __device__ constexpr int gen_series() { return sizeof(T) == 4 ? 4 : 2; }

template <typename T>
static size_t gen_smem(int k) {
  const int ne = k * (k + 1) / 2 + k;
  return sizeof(T) * (size_t)gen_series<T>() * ne;
}

template <typename T>
__global__ void __launch_bounds__(kGenThreads)
mstep_rows_gen_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                      const T* __restrict__ Ef, const T* __restrict__ EffT,
                      const T* __restrict__ Psm, T* __restrict__ Lam,
                      T* __restrict__ R, int T_, int N, int k, T r_floor,
                      T lam_ridge) {
  constexpr int S = gen_series<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  const int nc = k * (k + 1) / 2, ne = nc + k, kk = k * k;
  T* sS = reinterpret_cast<T*>(smem_raw);       // [S][ne]: sums, factor, Lam
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * S;
  // This block's problem lane (B = 1 for the lone K3-gen).
  const size_t pb = blockIdx.y, tn = (size_t)T_ * N;
  Y += pb * tn;
  mask += pb * tn;
  Ef += pb * (size_t)T_ * k;
  EffT += pb * (size_t)T_ * kk;
  Psm += pb * (size_t)T_ * kk;
  Lam += pb * (size_t)N * k;
  R += pb * N;
  // Entry e of the packed sums: (a, c), c <= a, at a (a + 1) / 2 + c for
  // e < nc, S_yf[e - nc] after; off = a k + c, -1 - j for S_yf[j], and 0
  // past ne, where bit q of ``own`` is clear.  The loops below load every
  // entry unconditionally (a pointer select, never a branch), so the
  // compiler issues a step's loads together: a load behind a branch waits
  // out its own L2 round trip.
  int off[kGenOwn];
  unsigned long long own = 0;
#pragma unroll
  for (int q = 0; q < kGenOwn; ++q) {
    const int e = tid + q * kGenThreads;
    if (e >= ne) {
      off[q] = 0;
    } else if (e >= nc) {
      off[q] = -1 - (e - nc);
      own |= 1ull << q;
    } else {
      int a = (int)((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
      while (a * (a + 1) / 2 > e) --a;
      while ((a + 1) * (a + 2) / 2 <= e) ++a;
      off[q] = a * k + (e - a * (a + 1) / 2);
      own |= 1ull << q;
    }
  }
  // This step's weights and zero-filled values of the block's series
  // (a series past N reads series N - 1 with weight 0).
  auto weights = [&](int t, T* w, T* yz) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = i0 + s;
      const size_t o = (size_t)t * N + min(i, N - 1);
      const T wv = mask[o], yv = Y[o];
      w[s] = i < N ? wv : T(0);
      yz[s] = w[s] > T(0) ? nan_to_num(yv) : T(0);
    }
  };
  T acc[S][kGenOwn];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < kGenOwn; ++q) acc[s][q] = T(0);
  T cnt[S];
#pragma unroll
  for (int s = 0; s < S; ++s) cnt[s] = T(0);
  for (int t = 0; t < T_; ++t) {
    T w[S], yz[S];
    weights(t, w, yz);
    const T* M = EffT + (size_t)t * kk;
    const T* E = Ef + (size_t)t * k;
#pragma unroll
    for (int s = 0; s < S; ++s) cnt[s] += w[s];
#pragma unroll
    for (int q = 0; q < kGenOwn; ++q) {
      const int o = off[q];
      const bool ff = o >= 0;
      const T z = *(ff ? M + o : E + (-1 - o));
      const T on = (own >> q) & 1 ? T(1) : T(0);
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s][q] += (on * (ff ? w[s] : yz[s])) * z;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < kGenOwn; ++q) {
      const int e = tid + q * kGenThreads;
      if (e < ne) sS[(size_t)s * ne + e] = acc[s][q];
    }
  __syncthreads();

  // Warp s, series s: never observed -> S_ff = I; the ridge, then
  // psd_cholesky's jitter; Cholesky in place (no clamp), column by column
  // with the lanes over the rows; then the two solves turn S_yf (at [nc,
  // ne)) into the loadings in place.
  if (warp < S) {
    T* P = sS + (size_t)warp * ne;
    auto at = [&](int a, int c) -> T& { return P[a * (a + 1) / 2 + c]; };
    const T jit = dfm_jitter<T>();
    for (int a = lane; a < k; a += 32) {
      if (cnt[warp] == T(0))
        for (int c = 0; c <= a; ++c) at(a, c) = a == c ? T(1) : T(0);
      at(a, a) = (at(a, a) + lam_ridge) + jit;
    }
    __syncwarp();
    for (int p = 0; p < k; ++p) {
      const T d = dfm_sqrt(at(p, p));
      __syncwarp();
      if (lane == 0) at(p, p) = d;
      for (int i = p + 1 + lane; i < k; i += 32) at(i, p) /= d;
      __syncwarp();
      for (int i = p + 1; i < k; ++i) {
        const T lip = at(i, p);
        for (int j = p + 1 + lane; j <= i; j += 32) at(i, j) -= lip * at(j, p);
      }
      __syncwarp();
    }
    T* lam = P + nc;
    for (int a = 0; a < k; ++a) {
      T s = T(0);
      for (int m = lane; m < a; m += 32) s += at(a, m) * lam[m];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) lam[a] = (lam[a] - s) / at(a, a);
      __syncwarp();
    }
    for (int a = k - 1; a >= 0; --a) {
      T s = T(0);
      for (int m = a + 1 + lane; m < k; m += 32) s += at(m, a) * lam[m];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) lam[a] = (lam[a] - s) / at(a, a);
      __syncwarp();
    }
  }
  __syncthreads();

  // Second pass: sum_t w P_sm,t into the registers, and the residual sum
  // over a stride of the steps.
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < kGenOwn; ++q) acc[s][q] = T(0);
  T rs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) rs[s] = T(0);
  for (int t = 0; t < T_; ++t) {
    T w[S], yz[S];
    weights(t, w, yz);
    const T* M = Psm + (size_t)t * kk;
#pragma unroll
    for (int q = 0; q < kGenOwn; ++q) {
      const int o = off[q];
      const T z = M[o > 0 ? o : 0];
      const T on = o >= 0 && ((own >> q) & 1) ? T(1) : T(0);
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s][q] += (on * w[s]) * z;
    }
    if (t % kGenThreads == tid) {
      const T* E = Ef + (size_t)t * k;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const T* lam = sS + (size_t)s * ne + nc;
        T fit = T(0);
        for (int j = 0; j < k; ++j) fit += E[j] * lam[j];
        const T v = yz[s] - fit;
        rs[s] += w[s] * (v * v);
      }
    }
  }
  // The smear Lam' PV Lam from this thread's entries of PV (the strict
  // lower triangle twice).
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T* lam = sS + (size_t)s * ne + nc;
    T sm = T(0);
#pragma unroll
    for (int q = 0; q < kGenOwn; ++q) {
      const int o = off[q];
      if (o < 0 || !((own >> q) & 1)) continue;
      const int a = o / k, c = o % k;
      const T v = acc[s][q] * lam[a] * lam[c];
      sm += a == c ? v : T(2) * v;
    }
    T tot = block_reduce_sum(sm, red);
    __syncthreads();
    const T res = block_reduce_sum(rs[s], red);
    __syncthreads();
    const int i = i0 + s;
    if (tid == 0 && i < N) {
      const T counts = cnt[s] > T(1) ? cnt[s] : T(1);
      const T r = (res + tot) / counts;
      R[i] = r > r_floor ? r : r_floor;
    }
  }
  for (int e = tid; e < S * k; e += kGenThreads) {
    const int s = e / k, a = e % k, i = i0 + s;
    if (i < N) Lam[(size_t)i * k + a] = sS[(size_t)s * ne + nc + a];
  }
}

template <typename T>
static int launch_gen(const T* Y, const T* mask, const T* Ef, const T* EffT,
                      const T* Psm, T* Lam, T* R, int B, int T_, int N,
                      int k, double r_floor, double lam_ridge,
                      cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  const size_t bytes = gen_smem<T>(k);
  const cudaError_t e = dfm_smem_optin(mstep_rows_gen_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  const int S = gen_series<T>();
  const dim3 grid((N + S - 1) / S, B);
  mstep_rows_gen_kernel<T><<<grid, kGenThreads, bytes, stream>>>(
      Y, mask, Ef, EffT, Psm, Lam, R, T_, N, k, (T)r_floor, (T)lam_ridge);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* Y, const T* mask, const T* Ef, const T* EffT,
                  const T* Psm, T* Lam, T* R, int B, int T_, int N, int k,
                  double r_floor, double lam_ridge, cudaStream_t stream) {
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  DFM_DISPATCH_K(k, mstep_rows_kernel<T, K><<<grid, kThreads, 0, stream>>>(
                        Y, mask, Ef, EffT, Psm, Lam, R, T_, N, (T)r_floor,
                        (T)lam_ridge))
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_MSTEP_ENTRIES(SFX, T)                                              \
  int mstep_rows_##SFX(const T* Y, const T* mask, const T* Ef,               \
                       const T* EffT, const T* Psm, T* Lam, T* R, int T_,    \
                       int N, int k, double r_floor, double lam_ridge,       \
                       void* stream) {                                       \
    return launch<T>(Y, mask, Ef, EffT, Psm, Lam, R, 1, T_, N, k, r_floor,   \
                     lam_ridge, (cudaStream_t)stream);                       \
  }                                                                          \
  int batched_mstep_rows_##SFX(const T* Y, const T* mask, const T* Ef,       \
                               const T* EffT, const T* Psm, T* Lam, T* R,    \
                               int B, int T_, int N, int k, double r_floor,  \
                               void* stream) {                               \
    return launch<T>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k, r_floor,   \
                     0.0, (cudaStream_t)stream);                             \
  }                                                                          \
  int mstep_rows_wide_##SFX(const T* Y, const T* mask, const T* Ef,          \
                            const T* EffT, const T* Psm, T* Lam, T* R,       \
                            int T_, int N, int k, double r_floor,            \
                            double lam_ridge, void* stream) {                \
    return launch_wide<T>(Y, mask, Ef, EffT, Psm, Lam, R, 1, T_, N, k,       \
                          r_floor, lam_ridge, (cudaStream_t)stream);         \
  }                                                                          \
  int batched_mstep_rows_wide_##SFX(const T* Y, const T* mask, const T* Ef,  \
                                    const T* EffT, const T* Psm, T* Lam,     \
                                    T* R, int B, int T_, int N, int k,       \
                                    double r_floor, void* stream) {          \
    return launch_wide<T>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k,       \
                          r_floor, 0.0, (cudaStream_t)stream);               \
  }                                                                          \
  int mstep_rows_gen_##SFX(const T* Y, const T* mask, const T* Ef,           \
                           const T* EffT, const T* Psm, T* Lam, T* R,        \
                           int T_, int N, int k, double r_floor,             \
                           double lam_ridge, void* stream) {                 \
    return launch_gen<T>(Y, mask, Ef, EffT, Psm, Lam, R, 1, T_, N, k,        \
                         r_floor, lam_ridge, (cudaStream_t)stream);          \
  }                                                                          \
  int batched_mstep_rows_gen_##SFX(const T* Y, const T* mask, const T* Ef,   \
                                   const T* EffT, const T* Psm, T* Lam,      \
                                   T* R, int B, int T_, int N, int k,        \
                                   double r_floor, void* stream) {           \
    return launch_gen<T>(Y, mask, Ef, EffT, Psm, Lam, R, B, T_, N, k,        \
                         r_floor, 0.0, (cudaStream_t)stream);                \
  }
#if DFM_WANT_F32
DFM_MSTEP_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_MSTEP_ENTRIES(f64, double)
#endif
}
