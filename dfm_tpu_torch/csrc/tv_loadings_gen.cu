// K11-fwd-gen and K11-bwd-gen, the generic kernels of K11 (tv_loadings.cu
// holds K11 at k <= 16; the formulas are there).
//
// Past k = 16 (loading_filter_gen, loading_smoother_gen: one kernel each
// for every 16 < k <= DFM_GEN_KMAX = 128, k a runtime value, which the
// wrappers take past DFM_KMAX) a series' k x k state no longer fits a
// thread's registers, so the work of a series spreads over threads:
//
// K11-fwd-gen: a block of 32 ceil(k / 32) threads a series, thread i
// owning row i of P in shared memory (the block's P, k x (k | 1): 64 KB
// at k = 128 in f32, 129 KB in f64) and lam_i.  Its row update needs Pf_j
// and K_j of the other rows only, which the block shares in shared memory:
// no transpose is staged (see the kernel).  The step's P is written as k
// contiguous rows, threads over the columns.  Bound: bytes, (k + k^2) T N
// values written: 3.9 GB in f32 at S4 (T = 300, N = 5,000) and k = 25
// (~1.2 ms at 3.35 TB/s), 15.6 GB at k = 50 (~4.6 ms), against 5 k^2 + 8 k
// flops a series and step.
//
// K11-bwd-gen: a block of 32 ceil(k / 32) threads a series, thread j
// owning column j of four k x k matrices at a leading dimension of k | 1
// in shared memory (f32 to k = 119, f64 to k = 83; past that a global
// workspace and a persistent grid), the smoothed P_n kept there from one
// step to the next: a Cholesky-Crout a column a step (a thread a row, dot
// products whose loads pipeline; one barrier a column), the two
// triangular solves a thread a column, and the two products a thread a
// column over four rows at once.  It runs the reference's arithmetic past UNROLL_K_MAX
// (jnp.linalg.cholesky and cho_solve, lines 189-190).  Bound: 19/3 k^3 +
// 10.5 k^2 flops a series and step, T - 1 steps (the Cholesky k^3 / 3, two
// triangular solves 2 k^3, two full k x k products 4 k^3; the solves'
// divisions, lam_s, P_n - P_pred with tr(P_n J') and the sym 10.5 k^2):
// 1.58e11 at S4 and k = 25 (~2.4 ms at 67 TFLOP/s in f32) against 7.8 GB
// of reads and writes (~2.3 ms); past k ~ 25 operations.  A block a series keeps the N independent chains in flight
// at once; one block a series on cta_linalg.cuh's block-wide routines
// (global-memory matrices, 256 threads whatever k) would wait on each
// routine's barriers and L2 round trips instead.
#include "common.cuh"

// ---------------------------------------------------------------------------
// K11 past DFM_KMAX (loading_filter_gen, loading_smoother_gen): one kernel
// each for every 16 < k <= DFM_GEN_KMAX, k a runtime value.
// ---------------------------------------------------------------------------

// The leading dimension of a series' k x k matrices in shared memory: odd,
// so the lanes of a warp reading one column (k | 1 apart) hit 32 banks.
__host__ __device__ constexpr int tvl_ld(int k) { return k | 1; }

// Bytes of a block's largest dynamic shared memory (H100: 227 KB).
constexpr size_t kTvlSmemMax = 232448;
// Series of loading_smoother_gen's global workspace an SM, where a block's
// shared memory cannot hold a series' four matrices.
constexpr int kTvlSlotsPerSm = 8;

// K11-fwd past DFM_KMAX: one block a series, 32 ceil(k / 32) threads,
// thread i owning row i of P (in shared memory at tvl_ld(k)) and lam_i.
// A step: Pf_i = sum_j P_pred[i][j] f_j with P_pred = P + tau2 I; S and
// lam'f by two block sums; K_i = w Pf_i / S; and the row update
//   P[i][j] = 0.5 ((P_pred[i][j] - K_i Pf_j) + (P_pred[i][j] - K_j Pf_i)),
// sym(P_pred - K Pf') written from row i alone: P_pred is exactly
// symmetric (the previous step's sym), so M[j][i] = P_pred[i][j] - K_j
// Pf_i, with the same float operations a thread j would use, and the new
// P is exactly symmetric too.  The block then writes the step's k^2
// values of P as k contiguous rows, threads over a row's columns.
template <typename T>
__global__ void __launch_bounds__(DFM_GEN_KMAX)
loading_filter_gen_kernel(const T* __restrict__ Y, const T* __restrict__ mask,
                          const T* __restrict__ F, const T* __restrict__ Lam0,
                          const T* __restrict__ tau2,
                          const T* __restrict__ R, T* __restrict__ lam_f,
                          T* __restrict__ P_f, int T_, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[2][DFM_GEN_KMAX / 32];
  const int ld = tvl_ld(k);
  T* P = reinterpret_cast<T*>(smem_raw);              // k x ld
  T* fs = P + (size_t)k * ld;                           // f_t (k)
  T* pfs = fs + DFM_GEN_KMAX;                           // Pf (k)
  T* kgs = pfs + DFM_GEN_KMAX;                          // K (k)
  const int n = blockIdx.x, i = threadIdx.x;
  const int lane = i & 31, wid = i >> 5, nw = blockDim.x >> 5;
  const bool row = i < k;
  const T t2 = tau2[n], r = R[n];
  T lam = row ? Lam0[(size_t)n * k + i] : T(0);
  if (row)
    for (int j = 0; j < k; ++j) P[i * ld + j] = i == j ? T(1e-2) + t2 : T(0);
  for (int t = 0; t < T_; ++t) {
    const size_t tn = (size_t)t * N + n;
    T y = nan_to_num(Y[tn]);
    T w = T(1);
    if (mask) {
      w = mask[tn];
      y *= w;
    }
    if (row) fs[i] = __ldg(F + (size_t)t * k + i);
    __syncthreads();                  // f_t; the last step's rows stored
    T pf = T(0), sp = T(0), fit = T(0);
    if (row) {
      const T* Pi = P + i * ld;
#pragma unroll 4
      for (int j = 0; j < k; ++j)
        pf += (j == i ? Pi[j] + t2 : Pi[j]) * fs[j];
      pfs[i] = pf;
      sp = pf * fs[i];
      fit = lam * fs[i];
    }
    for (int o = 16; o > 0; o >>= 1) {
      sp += __shfl_xor_sync(0xffffffffu, sp, o);
      fit += __shfl_xor_sync(0xffffffffu, fit, o);
    }
    if (lane == 0) {
      red[0][wid] = sp;
      red[1][wid] = fit;
    }
    __syncthreads();
    T S = T(0), f_l = T(0);
    for (int q = 0; q < nw; ++q) {
      S += red[0][q];
      f_l += red[1][q];
    }
    S += r;
    const T v = y - f_l;
    const T kg = w * pf / S;
    if (row) {
      kgs[i] = kg;
      lam += kg * v;
      lam_f[tn * k + i] = lam;
    }
    __syncthreads();                  // K
    if (row) {
      T* Pi = P + i * ld;
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        const T pp = j == i ? Pi[j] + t2 : Pi[j];
        Pi[j] = T(0.5) * ((pp - kg * pfs[j]) + (pp - kgs[j] * pf));
      }
    }
    __syncthreads();                  // the new P
    T* Po = P_f + tn * k * k;
    for (int rr = 0; rr < k; ++rr)
      for (int c = i; c < k; c += blockDim.x) Po[rr * k + c] = P[rr * ld + c];
  }
}

// C[i][j] = (D ? D[i][j] : 0) + sum_l op(A)(i, l) B[l][j] for the column j
// = threadIdx.x < k, over four rows at once; op(A)(i, l) = TA ? A[l][i] :
// A[i][l]; every matrix k x k at leading dimension ld.  C may be D (each
// element is read, then written, by its column's thread); it shares
// nothing with A or B.  The row operand is a broadcast, the column one a
// conflict-free read.
template <typename T, bool TA>
__device__ __forceinline__ void col_gemm(T* C, const T* A, const T* B,
                                         const T* D, int ld, int k) {
  const int j = threadIdx.x;
  if (j >= k) return;
  int i = 0;
  for (; i + 4 <= k; i += 4) {
    T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll 4
    for (int l = 0; l < k; ++l) {
      const T b = B[l * ld + j];
      const T* a = TA ? A + l * ld + i : A + i * ld + l;
      const int st = TA ? 1 : ld;
      s0 += a[0] * b;
      s1 += a[st] * b;
      s2 += a[2 * st] * b;
      s3 += a[3 * st] * b;
    }
    if (D) {
      s0 = D[i * ld + j] + s0;
      s1 = D[(i + 1) * ld + j] + s1;
      s2 = D[(i + 2) * ld + j] + s2;
      s3 = D[(i + 3) * ld + j] + s3;
    }
    C[i * ld + j] = s0;
    C[(i + 1) * ld + j] = s1;
    C[(i + 2) * ld + j] = s2;
    C[(i + 3) * ld + j] = s3;
  }
  for (; i < k; ++i) {
    T s = T(0);
#pragma unroll 4
    for (int l = 0; l < k; ++l)
      s += (TA ? A[l * ld + i] : A[i * ld + l]) * B[l * ld + j];
    C[i * ld + j] = D ? D[i * ld + j] + s : s;
  }
}

// K11-bwd past DFM_KMAX: one block of 32 ceil(k / 32) threads a series,
// thread j owning column j of four k x k matrices at tvl_ld(k) (in shared
// memory where a block's four fit: f32 to k = 119, f64 to k = 83; else a
// global workspace of ``slots`` series, the grid looping over the series)
// and row j of the k-vectors.  A step, from the smoothed (lam_n, P_n) of
// t + 1, P_n kept in shared memory from the step before:
//   F = P_f[t] (staged once, loads batched)
//   A, dg = L with L L' = F + tau2 I, a column a step, a thread a row
//   B = J' = (L L')^{-1} F, forward then back, a thread a column
//   lam_s = lam_f + J (lam_n - lam_f), a thread a row
//   P = P_n - (F + tau2 I), with the traces of P_n and of P_n J' (P_n is
//       exactly symmetric: the sum of P_n[i][j] J'[i][j])
//   A = G = J P;  F = F + G J';  P = sym(F), also into P_sm[t]
template <typename T>
__global__ void __launch_bounds__(DFM_GEN_KMAX)
loading_smoother_gen_kernel(const T* __restrict__ lam_f,
                            const T* __restrict__ P_f,
                            const T* __restrict__ tau2,
                            T* __restrict__ lam_sm, T* __restrict__ P_sm,
                            T* __restrict__ incr_out, T* work, int T_, int N,
                            int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[4][DFM_GEN_KMAX / 32];
  const int ld = tvl_ld(k), j = threadIdx.x;
  const int lane = j & 31, wid = j >> 5, nw = blockDim.x >> 5;
  const bool col = j < k;
  const size_t mat = (size_t)k * ld, kk = (size_t)k * k;
  T* vn = reinterpret_cast<T*>(smem_raw);               // lam_n (k)
  T* vf = vn + DFM_GEN_KMAX;                            // lam_f[t] (k)
  T* vd = vf + DFM_GEN_KMAX;                            // lam_n - lam_f[t]
  T* dg = vd + DFM_GEN_KMAX;                            // diag of L
  T* A = work ? work + blockIdx.x * 4 * mat : dg + DFM_GEN_KMAX;
  T* B = A + mat;
  T* F = B + mat;
  T* P = F + mat;
  // M[i][j] = g[i k + j] for this thread's column, eight loads in flight.
  auto stage = [&](T* M, const T* g) {
    if (!col) return;
    for (int i0 = 0; i0 < k; i0 += 8) {
      T v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < k) v[u] = g[(size_t)(i0 + u) * k + j];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < k) M[(i0 + u) * ld + j] = v[u];
    }
  };
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const T t2 = tau2[n];
    {
      const size_t o = (size_t)(T_ - 1) * N + n;
      stage(P, P_f + o * kk);
      if (col) {
        const T v = lam_f[o * k + j];
        vn[j] = v;
        lam_sm[o * k + j] = v;
        for (int i = 0; i < k; ++i) P_sm[o * kk + i * k + j] = P[i * ld + j];
      }
    }
    T incr = T(0);
    for (int t = T_ - 2; t >= 0; --t) {
      const size_t o = (size_t)t * N + n;
      __syncthreads();                // the last step's reads of F are done
      stage(F, P_f + o * kk);
      if (col) vf[j] = lam_f[o * k + j];
      __syncthreads();
      // L L' = F + tau2 I, a column a step, thread j forming row j's entry
      // by the dot products of rows (Cholesky-Crout; no jitter, no clamp:
      // an indefinite pivot gives NaN, as jnp.linalg.cholesky).  Every
      // thread forms the pivot with the same operations, so the column's
      // entries need no second barrier; the diagonal goes to dg, the
      // strict lower triangle to A.  Two partial sums a dot product.
      for (int c = 0; c < k; ++c) {
        if (col && j >= c) {
          T d0 = F[c * ld + c] + t2, d1 = T(0);
          T s0 = F[j * ld + c], s1 = T(0);
          int m = 0;
#pragma unroll 4
          for (; m + 2 <= c; m += 2) {
            const T a0 = A[c * ld + m], a1 = A[c * ld + m + 1];
            d0 -= a0 * a0;
            d1 -= a1 * a1;
            s0 -= A[j * ld + m] * a0;
            s1 -= A[j * ld + m + 1] * a1;
          }
          if (m < c) {
            const T a0 = A[c * ld + m];
            d0 -= a0 * a0;
            s0 -= A[j * ld + m] * a0;
          }
          const T d = dfm_sqrt(d0 + d1);
          if (j == c)
            dg[c] = d;
          else
            A[j * ld + c] = (s0 + s1) / d;
        }
        __syncthreads();
      }
      // B = J' = (L L')^{-1} F, column j, forward then back.
      if (col) {
        for (int i = 0; i < k; ++i) {
          T s0 = F[i * ld + j], s1 = T(0);
          int m = 0;
#pragma unroll 4
          for (; m + 2 <= i; m += 2) {
            s0 -= A[i * ld + m] * B[m * ld + j];
            s1 -= A[i * ld + m + 1] * B[(m + 1) * ld + j];
          }
          if (m < i) s0 -= A[i * ld + m] * B[m * ld + j];
          B[i * ld + j] = (s0 + s1) / dg[i];
        }
        for (int i = k - 1; i >= 0; --i) {
          T s0 = B[i * ld + j], s1 = T(0);
          int m = i + 1;
#pragma unroll 4
          for (; m + 2 <= k; m += 2) {
            s0 -= A[m * ld + i] * B[m * ld + j];
            s1 -= A[(m + 1) * ld + i] * B[(m + 1) * ld + j];
          }
          if (m < k) s0 -= A[m * ld + i] * B[m * ld + j];
          B[i * ld + j] = (s0 + s1) / dg[i];
        }
        vd[j] = vn[j] - vf[j];
      }
      __syncthreads();
      // lam_s = lam_f + J (lam_n - lam_f);  P = P_n - P_pred[t + 1].
      T dd = T(0), tr_n = T(0), tr_lag = T(0), tr_s = T(0);
      if (col) {
        T s = T(0);
#pragma unroll 4
        for (int l = 0; l < k; ++l) s += B[l * ld + j] * vd[l];
        const T ls = vf[j] + s;
        const T d = vn[j] - ls;
        dd = d * d;
        vn[j] = ls;
        lam_sm[o * k + j] = ls;
        // Four rows' loads before their stores (a store to P could alias
        // a later load, and would wait for it).
        for (int i0 = 0; i0 < k; i0 += 4) {
          T pn[4], bb[4], ff[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u < k) {
              pn[u] = P[(i0 + u) * ld + j];
              bb[u] = B[(i0 + u) * ld + j];
              ff[u] = F[(i0 + u) * ld + j];
            }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u < k) {
              const int i = i0 + u;
              tr_lag += pn[u] * bb[u];
              if (i == j) tr_n += pn[u];
              P[i * ld + j] = pn[u] - (i == j ? ff[u] + t2 : ff[u]);
            }
        }
      }
      __syncthreads();
      col_gemm<T, true>(A, B, P, nullptr, ld, k);           // G = J P
      __syncthreads();
      col_gemm<T, false>(F, A, B, F, ld, k);                // F + G J'
      __syncthreads();
      if (col) {
        T* Ps = P_sm + o * kk;
        for (int i0 = 0; i0 < k; i0 += 4) {
          T v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u < k)
              v[u] = T(0.5) * (F[(i0 + u) * ld + j] + F[j * ld + i0 + u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u < k) {
              const int i = i0 + u;
              P[i * ld + j] = v[u];
              Ps[(size_t)i * k + j] = v[u];
              if (i == j) tr_s += v[u];
            }
        }
      }
      for (int o2 = 16; o2 > 0; o2 >>= 1) {
        dd += __shfl_xor_sync(0xffffffffu, dd, o2);
        tr_n += __shfl_xor_sync(0xffffffffu, tr_n, o2);
        tr_s += __shfl_xor_sync(0xffffffffu, tr_s, o2);
        tr_lag += __shfl_xor_sync(0xffffffffu, tr_lag, o2);
      }
      if (lane == 0) {
        red[0][wid] = dd;
        red[1][wid] = tr_n;
        red[2][wid] = tr_s;
        red[3][wid] = tr_lag;
      }
      __syncthreads();
      T sd = T(0), sn = T(0), ss = T(0), sl = T(0);
      for (int q = 0; q < nw; ++q) {
        sd += red[0][q];
        sn += red[1][q];
        ss += red[2][q];
        sl += red[3][q];
      }
      incr += sd + sn + ss - T(2) * sl;
    }
    if (j == 0) incr_out[n] = incr;
    __syncthreads();                  // P and vn before the next series
  }
}

template <typename T>
static int launch_filter_gen(const T* Y, const T* mask, const T* F,
                             const T* Lam0, const T* tau2, const T* R,
                             T* lam_f, T* P_f, int T_, int N, int k,
                             cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (T_ <= 0 || N <= 0) return (int)cudaGetLastError();
  const size_t bytes =
      sizeof(T) * ((size_t)k * tvl_ld(k) + 3 * DFM_GEN_KMAX);
  const cudaError_t e = dfm_smem_optin(loading_filter_gen_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  loading_filter_gen_kernel<T><<<N, 32 * ((k + 31) / 32), bytes, stream>>>(
      Y, mask, F, Lam0, tau2, R, lam_f, P_f, T_, N, k);
  return (int)cudaGetLastError();
}

// Dynamic shared bytes of loading_smoother_gen_kernel: the four k-vectors
// and, without a workspace, the four k x k matrices.
template <typename T>
static size_t smoother_gen_smem(int k, bool work) {
  return sizeof(T) * 4 *
         (DFM_GEN_KMAX + (work ? 0 : (size_t)k * tvl_ld(k)));
}

// The rule the wrapper asks before it allocates (loading_smoother_gen_slots):
// 0 where a series' matrices fit a block's shared memory (a block a series;
// f32 to k = 119, f64 to k = 83), else the series of the global workspace,
// min(N, kTvlSlotsPerSm x ctas) with ``ctas`` the SMs the grid may fill.
template <typename T>
static int smoother_gen_slots(int k, int N, int ctas) {
  if (smoother_gen_smem<T>(k, false) <= kTvlSmemMax) return 0;
  return N < kTvlSlotsPerSm * ctas ? N : kTvlSlotsPerSm * ctas;
}

// ``work``: null for the matrices in shared memory (a block a series),
// else a (slots, 4, k, tvl_ld(k)) workspace and a grid of ``slots`` (any
// slots >= 1: each block loops over the series n = blockIdx.x + i slots).
template <typename T>
static int launch_smoother_gen(const T* lam_f, const T* P_f, const T* tau2,
                               T* lam_sm, T* P_sm, T* incr, T* work, int T_,
                               int N, int k, int slots, cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (T_ <= 0 || N <= 0) return (int)cudaGetLastError();
  const size_t bytes = smoother_gen_smem<T>(k, work != nullptr);
  if (bytes > kTvlSmemMax || (work && slots < 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      dfm_smem_optin(loading_smoother_gen_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  loading_smoother_gen_kernel<T><<<work ? slots : N, 32 * ((k + 31) / 32),
                                   bytes, stream>>>(
      lam_f, P_f, tau2, lam_sm, P_sm, incr, work, T_, N, k);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_TVL_GEN_ENTRIES(SFX, T)                                            \
  int loading_filter_gen_##SFX(const T* Y, const T* mask, const T* F,        \
                               const T* Lam0, const T* tau2, const T* R,     \
                               T* lam_f, T* P_f, int T_, int N, int k,       \
                               void* stream) {                               \
    return launch_filter_gen<T>(Y, mask, F, Lam0, tau2, R, lam_f, P_f, T_,   \
                                N, k, (cudaStream_t)stream);                 \
  }                                                                          \
  int loading_smoother_gen_##SFX(const T* lam_f, const T* P_f,               \
                                 const T* tau2, T* lam_sm, T* P_sm, T* incr, \
                                 T* work, int T_, int N, int k, int slots,   \
                                 void* stream) {                             \
    return launch_smoother_gen<T>(lam_f, P_f, tau2, lam_sm, P_sm, incr,      \
                                  work, T_, N, k, slots,                     \
                                  (cudaStream_t)stream);                     \
  }                                                                          \
  int loading_smoother_gen_slots_##SFX(int k, int N, int ctas) {             \
    return smoother_gen_slots<T>(k, N, ctas);                                \
  }
#if DFM_WANT_F32
DFM_TVL_GEN_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_TVL_GEN_ENTRIES(f64, double)
#endif
}
