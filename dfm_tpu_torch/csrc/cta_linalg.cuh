// CTA-wide k x k linear algebra in global memory, for the generic K4 pair
// and its batched twin (info_scan.cu), K6b-gen (bsolve_rows.cu), K5a-gen
// (ss_cov_path.cu) and K14-el-gen and K14-scan-gen (pit_elements.cu,
// pit_scan.cu), 32 < k <= DFM_GEN_KMAX = 128.
//
// At k = 100 one matrix is 40 KB in f32 and 80 KB in f64, so the ten
// matrices a step of the one-warp kernels keeps in shared memory no longer
// fit (808 KB in f64).  Here the matrices are rows of the pass's outputs
// (P_pred[t], P_filt[t], P_sm[t], P_lag[t]) and a few workspace matrices
// that the wrapper allocates: all row-major at a leading dimension of k in
// global memory, where the working set (a few hundred KB) stays in L2.
// Every routine is called by all GEN_THREADS threads of one block, stages
// 32-wide tiles or panels through the shared scratch ``sm`` and begins and
// ends with __syncthreads(), so a routine's global writes are visible to
// the next one (a block-scope barrier orders global memory too).  The
// routines are __noinline__: each is compiled once with its own register
// allocation instead of unrolled into every call site (a call is a few
// instructions beside thousands of fmas).  No
// pointer here is __restrict__: the outputs of one routine are the inputs
// of the next within a launch, so loads must not go through the read-only
// cache.
//
// - cta_gemm: C = alpha op(A) op(B) (+ D) (+ I), the whole m x n output at
//   once, a 16 x 16 grid of threads each holding an RB x RB register block
//   (rows ty + 16 i, columns tx + 16 j), over 32-deep slices of A and B
//   staged in shared memory by cp.async, double-buffered (the slices come
//   from L2, and one block cannot hide that latency with other warps).  RB
//   (2, 4 or 8) is picked from m and n at run time, so one instantiation a
//   dtype serves every k.
// - cta_potrf: right-looking blocked Cholesky: a 32-wide panel, its
//   diagonal block factored by one warp in registers (chol32_regs), the
//   rows below solved a thread a row (in registers, right-looking), then
//   the trailing block updated by a cta_gemm.
// - cta_sym: sym(M) (+ jitter) by 32 x 32 tile pairs, a warp a pair.
// - cta_trsm_right: X <- X L^{-T} or X L^{-1} by 32-column blocks: the
//   block's update from the columns already solved is a cta_gemm, then a
//   thread a row substitutes against the 32 x 32 diagonal block, as the
//   panel rows are.
// - cta_getrf / cta_getrs: LU with partial pivoting (LAPACK getrf's pivot
//   rule) by 32-column panels, and the solve against its factors by
//   32-row blocks (the general solves of the pit engine).
// - cta_psd_chol, cta_tria, cta_chol_solve_rows: the generic branches of
//   the square-root engine's K6/K7 functions past QR_UNROLL_K_MAX = 10
//   (ops/linalg.py: psd_cholesky, tria as the Gram's jittered Cholesky,
//   chol_solve), for the square-root engine's generic kernels
//   (qr_elements_gen in pit_elements.cu, qr_scan_gen in pit_scan.cu).
//
// The routines take any 1 <= k <= DFM_GEN_KMAX: below 32 a panel, tile or
// block is one partial 32-wide block (nb = k), the gemm's register block
// is 2 x 2 over a 32 x 32 output and the rows past k are zero-filled.
#pragma once

#include <cuda_pipeline.h>

#include "warp_linalg.cuh"

constexpr int GEN_THREADS = 256;
constexpr int GEN_TB = 32;          // tile, slice and panel width

// The rows (columns) a gemm slice holds at width k: 16 RB, with cta_gemm's
// register block RB = 2, 4 or 8.
__host__ __device__ constexpr int gen_kp(int k) {
  return k > 64 ? 128 : k > 32 ? 64 : 32;
}

__host__ __device__ constexpr int gen_max(int a, int b) { return a > b ? a : b; }

// Elements of shared scratch the routines below need at k: two stages of
// two gemm slices of 32 x (kp + 1), a (32 + k) x 33 panel / diagonal
// block and rows, or a 32 x 33 tile a warp.
__host__ __device__ constexpr int gen_scratch(int k) {
  return gen_max(gen_max(4 * GEN_TB * (gen_kp(k) + 1), (GEN_TB + k) * WIDE_LD),
                 GEN_THREADS / 32 * GEN_TB * WIDE_LD);
}

// For e = threadIdx.x + GEN_THREADS u over [0, n): v = load(e), then
// store(e, v), in batches of 8 whose loads all issue before any of their
// stores.  A load the compiler cannot prove apart from an earlier global
// store waits for it, so a plain loop pays an L2 round trip an element.
template <typename L, typename S>
__device__ __forceinline__ void cta_batched(int n, L load, S store) {
  constexpr int U = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * GEN_THREADS) {
    decltype(load(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * GEN_THREADS;
      if (e < n) v[u] = load(e);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * GEN_THREADS;
      if (e < n) store(e, v[u]);
    }
  }
}

template <typename T, int RBM, int RBN>
__device__ __noinline__ void gemm_core(T* C, int ldc, const T* A, int lda,
                                          bool ta, const T* B, int ldb,
                                          bool tb, int m, int n, int kk,
                                          T alpha, const T* D, int ldd,
                                          bool add_eye, T* sm) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  constexpr int mpa = 16 * RBM, mpb = 16 * RBN;   // rows, columns a slice
  constexpr int lda_s = mpa + 1, ldb_s = mpb + 1;
  constexpr int slice = GEN_TB * (lda_s + ldb_s); // one stage: As then Bs
  // Stage the slice at depth l0 into buffer ``buf`` with cp.async (no
  // registers held, every copy in flight at once; zero-filled past m, n
  // and kk): As[l][i] = op(A)(i, l0 + l), Bs[l][j] = op(B)(l0 + l, j).
  // Consecutive threads read consecutive addresses of A and B.
  auto stage = [&](int l0, int buf) {
    T* As = sm + buf * slice;
    T* Bs = As + GEN_TB * lda_s;
    const int nl = min(GEN_TB, kk - l0);
#pragma unroll 4
    for (int e = tid; e < GEN_TB * mpa; e += GEN_THREADS) {
      int i, l;
      if (ta) { i = e % mpa; l = e / mpa; }
      else    { l = e % GEN_TB; i = e / GEN_TB; }
      const bool ok = i < m && l < nl;
      const T* src = !ok ? A : ta ? A + (size_t)(l0 + l) * lda + i
                                  : A + (size_t)i * lda + l0 + l;
      __pipeline_memcpy_async(As + l * lda_s + i, src, sizeof(T),
                              ok ? 0 : sizeof(T));
    }
#pragma unroll 4
    for (int e = tid; e < GEN_TB * mpb; e += GEN_THREADS) {
      int j, l;
      if (tb) { l = e % GEN_TB; j = e / GEN_TB; }
      else    { j = e % mpb; l = e / mpb; }
      const bool ok = j < n && l < nl;
      const T* src = !ok ? B : tb ? B + (size_t)j * ldb + l0 + l
                                  : B + (size_t)(l0 + l) * ldb + j;
      __pipeline_memcpy_async(Bs + l * ldb_s + j, src, sizeof(T),
                              ok ? 0 : sizeof(T));
    }
    __pipeline_commit();
  };
  T acc[RBM][RBN];
#pragma unroll
  for (int i = 0; i < RBM; ++i)
#pragma unroll
    for (int j = 0; j < RBN; ++j) acc[i][j] = T(0);
  __syncthreads();                        // the caller's writes are visible
  if (kk > 0) stage(0, 0);
  for (int l0 = 0, s = 0; l0 < kk; l0 += GEN_TB, ++s) {
    const int nl = min(GEN_TB, kk - l0);
    // Double buffering: the next slice loads while this one is consumed.
    if (l0 + GEN_TB < kk) {
      stage(l0 + GEN_TB, (s + 1) & 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* As = sm + (s & 1) * slice;
    const T* Bs = As + GEN_TB * lda_s;
    for (int l = 0; l < nl; ++l) {
      T a[RBM], b[RBN];
#pragma unroll
      for (int i = 0; i < RBM; ++i) a[i] = As[l * lda_s + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RBN; ++j) b[j] = Bs[l * ldb_s + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RBM; ++i)
#pragma unroll
        for (int j = 0; j < RBN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();                      // this buffer may be restaged
  }
  // Every D load before the first store to C.
#pragma unroll
  for (int i = 0; i < RBM; ++i)
#pragma unroll
    for (int j = 0; j < RBN; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      T v = alpha * acc[i][j];
      if (D && r < m && c < n) v += D[(size_t)r * ldd + c];
      if (add_eye && r == c) v += T(1);
      acc[i][j] = v;
    }
#pragma unroll
  for (int i = 0; i < RBM; ++i)
#pragma unroll
    for (int j = 0; j < RBN; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < m && c < n) C[(size_t)r * ldc + c] = acc[i][j];
    }
  __syncthreads();
}

// C (m x n, ldc) = alpha op(A) op(B) + D (when given) + I (when add_eye),
// with op(A)(i, l) = ta ? A[l][i] : A[i][l] and op(B)(l, j) = tb ? B[j][l]
// : B[l][j] over l < kk; m, n <= DFM_GEN_KMAX.  C may be D (each element is
// read and written by one thread); it shares no element with A or B.
template <typename T>
__device__ void cta_gemm(T* C, int ldc, const T* A, int lda, bool ta,
                         const T* B, int ldb, bool tb, int m, int n, int kk,
                         T alpha, const T* D, int ldd, bool add_eye, T* sm) {
  // Register blocks as gen_kp: square, or 2 columns wide for the n <= 32
  // updates of the panels and triangular solves.
  const int rm = gen_kp(m) / 16, rn = gen_kp(n) / 16;
  if (rn == 2 && rm == 8)
    gemm_core<T, 8, 2>(C, ldc, A, lda, ta, B, ldb, tb, m, n, kk, alpha, D,
                       ldd, add_eye, sm);
  else if (rn == 2 && rm == 4)
    gemm_core<T, 4, 2>(C, ldc, A, lda, ta, B, ldb, tb, m, n, kk, alpha, D,
                       ldd, add_eye, sm);
  else if (max(rm, rn) == 8)
    gemm_core<T, 8, 8>(C, ldc, A, lda, ta, B, ldb, tb, m, n, kk, alpha, D,
                       ldd, add_eye, sm);
  else if (max(rm, rn) == 4)
    gemm_core<T, 4, 4>(C, ldc, A, lda, ta, B, ldb, tb, m, n, kk, alpha, D,
                       ldd, add_eye, sm);
  else
    gemm_core<T, 2, 2>(C, ldc, A, lda, ta, B, ldb, tb, m, n, kk, alpha, D,
                       ldd, add_eye, sm);
}

// W = sym(M) = 0.5 (M + M') (+ the dtype's jitter on the diagonal when
// jit: psd_cholesky's input), k x k at a leading dimension of k, by 32 x
// 32 tile pairs (I, J), I <= J, a warp a pair: tile (J, I) and the mirror
// of the result pass through the warp's 32 x 33 tile of ``sm``, so every
// global access is a coalesced row (a transposed element-wise pass is
// bound by one L2 sector an access).  Each pair's reads precede its
// writes, so W may be M.
template <typename T>
__device__ __noinline__ void cta_sym(T* W, const T* M, int k, bool jit,
                                     T* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (k + GEN_TB - 1) / GEN_TB;
  const T jv = jit ? dfm_jitter<T>() : T(0);
  SMat<T, WIDE_LD> buf =
      reinterpret_cast<SMat<T, WIDE_LD>>(sm + warp * GEN_TB * WIDE_LD);
  __syncthreads();
  for (int q = warp; q < nt * (nt + 1) / 2; q += GEN_THREADS / 32) {
    int I = q, J = 0;                     // q = J (J + 1) / 2 + I, I <= J
    while (I > J) { I -= J + 1; ++J; }
    const int i0 = I * GEN_TB, j0 = J * GEN_TB, c = lane;
    T a[GEN_TB];
#pragma unroll
    for (int r = 0; r < GEN_TB; ++r) {
      buf[r][c] = j0 + r < k && i0 + c < k
                      ? M[(size_t)(j0 + r) * k + i0 + c] : T(0);
      a[r] = i0 + r < k && j0 + c < k ? M[(size_t)(i0 + r) * k + j0 + c]
                                      : T(0);
    }
    __syncwarp();
    // v(i0 + r, j0 + c) = 0.5 (M[i0 + r][j0 + c] + M[j0 + c][i0 + r]).
#pragma unroll
    for (int r = 0; r < GEN_TB; ++r) {
      const T v = T(0.5) * (a[r] + buf[c][r]);
      a[r] = i0 + r == j0 + c ? v + jv : v;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < GEN_TB; ++r) {
      if (i0 + r < k && j0 + c < k) W[(size_t)(i0 + r) * k + j0 + c] = a[r];
      buf[c][r] = a[r];
    }
    __syncwarp();
    if (I != J) {
#pragma unroll
      for (int r = 0; r < GEN_TB; ++r)
        if (j0 + r < k && i0 + c < k)
          W[(size_t)(j0 + r) * k + i0 + c] = buf[r][c];
    }
    __syncwarp();
  }
  __syncthreads();
}

// In-place Cholesky of the nb x nb (nb <= 32) block at the top of the
// shared panel W by one warp, lane i holding row i in registers: column by
// column, right-looking (the arithmetic of warp_linalg.cuh's chol_inplace,
// whose shared read-modify-write loops cost ~39k cycles at nb = 32), the
// pivot and column entries passed by shuffles.  The strict upper triangle
// is zeroed.
template <typename T>
__device__ void chol32_regs(SMat<T, WIDE_LD> W, int nb) {
  const int lane = threadIdx.x & 31;
  T row[GEN_TB];
#pragma unroll
  for (int c = 0; c < GEN_TB; ++c)
    row[c] = lane < nb && c < nb ? W[lane][c] : T(0);
#pragma unroll
  for (int p = 0; p < GEN_TB; ++p) {
    if (p >= nb) break;
    const T d = dfm_sqrt(__shfl_sync(0xffffffffu, row[p], p));
    if (lane == p) row[p] = d;
    else if (lane > p) row[p] /= d;
#pragma unroll
    for (int j = p + 1; j < GEN_TB; ++j) {
      const T ljp = __shfl_sync(0xffffffffu, row[p], j);
      if (j <= lane) row[j] -= row[p] * ljp;
    }
  }
  if (lane < nb) {
#pragma unroll
    for (int c = 0; c < GEN_TB; ++c)
      if (c < nb) W[lane][c] = c <= lane ? row[c] : T(0);
  }
  __syncwarp();
}

// x <- x L^{-T} (trans: solves x L' = b) or x L^{-1} (!trans: x L = b) for
// one row x of nb <= 32 values in registers against the nb x nb lower
// triangular L in shared memory, right-looking: each solved value updates
// the rest at once, so the dependent chain is nb divisions and fmas.
template <typename T, bool TRANS>
__device__ __forceinline__ void row_solve(T (&x)[GEN_TB], SMat<T, WIDE_LD> L,
                                          int nb) {
  if (TRANS) {
#pragma unroll
    for (int c = 0; c < GEN_TB; ++c) {
      if (c >= nb) break;
      x[c] /= L[c][c];
#pragma unroll
      for (int j = c + 1; j < GEN_TB; ++j)
        if (j < nb) x[j] -= x[c] * L[j][c];
    }
  } else {
#pragma unroll
    for (int c = GEN_TB - 1; c >= 0; --c) {
      if (c >= nb) continue;
      x[c] /= L[c][c];
#pragma unroll
      for (int j = 0; j < c; ++j) x[j] -= x[c] * L[c][j];
    }
  }
}

// Row r of the shared rows Xs (nb values) through row_solve in registers.
template <typename T, bool TRANS>
__device__ __forceinline__ void shared_row_solve(SMat<T, WIDE_LD> Xs, int r,
                                                 SMat<T, WIDE_LD> L, int nb) {
  T x[GEN_TB];
#pragma unroll
  for (int c = 0; c < GEN_TB; ++c) x[c] = c < nb ? Xs[r][c] : T(0);
  row_solve<T, TRANS>(x, L, nb);
#pragma unroll
  for (int c = 0; c < GEN_TB; ++c)
    if (c < nb) Xs[r][c] = x[c];
}

// In-place Cholesky of the k x k matrix at A (leading dimension k): the
// lower triangle is read, L is written to it and the strict upper triangle
// is zeroed.  No jitter and no clamp (the caller adds psd_cholesky's
// jitter): a negative pivot gives NaN, as jnp.linalg.cholesky does.
template <typename T>
__device__ __noinline__ void cta_potrf(T* A, int k, T* sm) {
  const int tid = threadIdx.x;
  SMat<T, WIDE_LD> pan = reinterpret_cast<SMat<T, WIDE_LD>>(sm);
  for (int p0 = 0; p0 < k; p0 += GEN_TB) {
    const int nb = min(GEN_TB, k - p0), rows = k - p0;
    __syncthreads();
    cta_batched(
        rows * nb,
        [&](int e) { return A[(size_t)(p0 + e / nb) * k + p0 + e % nb]; },
        [&](int e, T v) { pan[e / nb][e % nb] = v; });
    __syncthreads();
    if (tid < 32) chol32_regs<T>(pan, nb);
    __syncthreads();
    // L21 = A21 L11^{-T}, a thread a row.
    for (int r = nb + tid; r < rows; r += GEN_THREADS)
      shared_row_solve<T, true>(pan, r, pan, nb);
    __syncthreads();
    for (int e = tid; e < rows * nb; e += GEN_THREADS)
      A[(size_t)(p0 + e / nb) * k + p0 + e % nb] = pan[e / nb][e % nb];
    // A22 -= L21 L21' (the whole square; the strict upper half is zeroed
    // at the end).
    const int m2 = rows - nb;
    if (m2 > 0) {
      T* A22 = A + (size_t)(p0 + nb) * k + p0 + nb;
      const T* L21 = A + (size_t)(p0 + nb) * k + p0;
      cta_gemm<T>(A22, k, L21, k, false, L21, k, true, m2, m2, nb, T(-1), A22,
                  k, false, sm);
    }
  }
  __syncthreads();
  for (int e = tid; e < k * k; e += GEN_THREADS)
    if (e % k > e / k) A[e] = T(0);
  __syncthreads();
}

// X (m x k, leading dimension k) <- X L^{-T} (trans: solves X L' = B) or
// X L^{-1} (!trans: X L = B), L k x k lower triangular at a leading
// dimension of k; m <= DFM_GEN_KMAX.
template <typename T>
__device__ __noinline__ void cta_trsm_right(T* X, int m, const T* L, int k,
                                            bool trans, T* sm) {
  const int tid = threadIdx.x;
  const int nblk = (k + GEN_TB - 1) / GEN_TB;
  SMat<T, WIDE_LD> Ld = reinterpret_cast<SMat<T, WIDE_LD>>(sm);
  SMat<T, WIDE_LD> Xs = reinterpret_cast<SMat<T, WIDE_LD>>(sm + GEN_TB * WIDE_LD);
  for (int bi = 0; bi < nblk; ++bi) {
    const int jb = trans ? bi : nblk - 1 - bi;
    const int j0 = jb * GEN_TB, nb = min(GEN_TB, k - j0);
    // The block's right-hand side less the columns already solved.
    if (trans && j0 > 0)
      cta_gemm<T>(X + j0, k, X, k, false, L + (size_t)j0 * k, k, true, m,
                  nb, j0, T(-1), X + j0, k, false, sm);
    if (!trans && j0 + nb < k)
      cta_gemm<T>(X + j0, k, X + j0 + nb, k, false,
                  L + (size_t)(j0 + nb) * k + j0, k, false, m, nb,
                  k - j0 - nb, T(-1), X + j0, k, false, sm);
    __syncthreads();
    cta_batched(
        nb * nb,
        [&](int e) { return L[(size_t)(j0 + e / nb) * k + j0 + e % nb]; },
        [&](int e, T v) { Ld[e / nb][e % nb] = v; });
    cta_batched(
        m * nb, [&](int e) { return X[(size_t)(e / nb) * k + j0 + e % nb]; },
        [&](int e, T v) { Xs[e / nb][e % nb] = v; });
    __syncthreads();
    for (int r = tid; r < m; r += GEN_THREADS) {
      if (trans)
        shared_row_solve<T, true>(Xs, r, Ld, nb);
      else
        shared_row_solve<T, false>(Xs, r, Ld, nb);
    }
    __syncthreads();
    for (int e = tid; e < m * nb; e += GEN_THREADS)
      X[(size_t)(e / nb) * k + j0 + e % nb] = Xs[e / nb][e % nb];
  }
  __syncthreads();
}

// out[i] = base[i] + sign * sum_l M[i][l] v[l] for i < k (base 0 when
// null; M and base in global memory, v and out in shared memory; out is
// not v), a warp a row; g_out (when given) also receives out.  Ends with
// __syncthreads() (before g_out's writes: the caller reads only out).
template <typename T>
__device__ __noinline__ void cta_matvec(T* out, const T* base, T sign,
                                        const T* M, const T* v, int k,
                                        T* g_out) {
  constexpr int W = GEN_THREADS / 32;
  constexpr int RW = DFM_GEN_KMAX / W;    // rows a warp, at most
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Every load of the warp's rows issues before its stores.
  T s[RW], b[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = warp + W * r;
    s[r] = T(0);
    b[r] = T(0);
    if (i < k) {
#pragma unroll
      for (int q = 0; q < DFM_GEN_KMAX / 32; ++q) {
        const int l = lane + 32 * q;
        if (l < k) s[r] += M[(size_t)i * k + l] * v[l];
      }
      if (base) b[r] = base[i];
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    T t = s[r];
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    const int i = warp + W * r;
    if (lane == 0 && i < k) out[i] = b[r] + sign * t;
  }
  __syncthreads();
  if (g_out && threadIdx.x < k) g_out[threadIdx.x] = out[threadIdx.x];
}


// out[i] = base[i] + sign * sum_l M[l][i] v[l] for i < k: M' v (base 0
// when null; M and base in global memory, v in shared memory), a thread a
// row, into g_out (global) and, when given, out (shared; not v).  Begins
// and ends with __syncthreads(); each thread reads its base[i] before it
// writes g_out[i], so g_out may be base.
template <typename T>
__device__ __noinline__ void cta_matvec_t(T* out, const T* base, T sign,
                                          const T* M, const T* v, int k,
                                          T* g_out) {
  __syncthreads();
  const int i = threadIdx.x;
  if (i < k) {
    T s = T(0);
    for (int l = 0; l < k; ++l) s += M[(size_t)l * k + i] * v[l];
    const T r = (base ? base[i] : T(0)) + sign * s;
    if (out) out[i] = r;
    if (g_out) g_out[i] = r;
  }
  __syncthreads();
}

// A CTA's dynamic shared memory beyond the routines' scratch (NV k-vectors,
// the pivots and row permutation of cta_getrf / cta_getrs) and its slice of
// a per-CTA global workspace of MATS k x k matrices: the generic kernels
// on persistent grids (pit_elements.cu, pit_scan.cu).
template <typename T, int NV, int MATS>
struct CtaScratch {
  T* sm;
  T* v[NV];
  int* piv;
  int* perm;
  T* w;
  int k;
  static size_t bytes(int k) {
    return sizeof(T) * ((size_t)gen_scratch(k) + NV * DFM_GEN_KMAX) +
           2 * DFM_GEN_KMAX * sizeof(int);
  }
  __device__ CtaScratch(unsigned char* raw, T* work, int k_) : k(k_) {
    sm = reinterpret_cast<T*>(raw);
    v[0] = sm + gen_scratch(k);
    for (int i = 1; i < NV; ++i) v[i] = v[i - 1] + DFM_GEN_KMAX;
    piv = reinterpret_cast<int*>(v[NV - 1] + DFM_GEN_KMAX);
    perm = piv + DFM_GEN_KMAX;
    w = work + (size_t)blockIdx.x * MATS * k * k;
  }
};

// vs[i] = g[i] for i < k (g global, vs shared), between barriers.
template <typename T>
__device__ __forceinline__ void cta_load_vec(T* vs, const T* g, int k) {
  __syncthreads();
  if (threadIdx.x < k) vs[threadIdx.x] = g[threadIdx.x];
  __syncthreads();
}

// dst[e] = src ? src[e] : 0 for e < n (global), between barriers.
template <typename T>
__device__ __forceinline__ void cta_copy(T* dst, const T* src, int n) {
  __syncthreads();
  if (src)
    cta_batched(
        n, [&](int e) { return src[e]; }, [&](int e, T v) { dst[e] = v; });
  else
    for (int e = threadIdx.x; e < n; e += GEN_THREADS) dst[e] = T(0);
  __syncthreads();
}

// M[i][i] += d for i < k (k x k at a leading dimension of k), between
// barriers.
template <typename T>
__device__ __forceinline__ void cta_add_diag(T* M, int k, T d) {
  __syncthreads();
  if (threadIdx.x < k) M[(size_t)threadIdx.x * k + threadIdx.x] += d;
  __syncthreads();
}

// In-place LU factorization with partial pivoting of the k x k matrix at
// A (leading dimension k), A = P L U (L unit lower below the diagonal, U on
// and above it), by 32-column panels, right-looking, as LAPACK's getrf.
// Each panel (rows p0 .. k-1) is staged in ``sm`` and factored column by
// column: warp 0 picks the pivot row, the first index of the largest
// |value| at or below the diagonal (LAPACK's rule, which jnp.linalg.solve
// and torch.linalg.solve run), swaps the two panel rows and divides the
// column below the pivot by it; then all threads update the panel's
// trailing columns.  The panel's interchanges then reach the columns left
// and right of it (a thread a column, in order), U12 = L11^{-1} A12 is
// solved a thread a column in registers against the panel's unit lower
// block, and the trailing matrix takes A22 -= L21 U12 by cta_gemm.  piv (k
// ints in shared memory) receives the 0-based pivot rows.  No check for a
// zero pivot: a singular A gives inf/NaN, as an unchecked solve does.
template <typename T>
__device__ __noinline__ void cta_getrf(T* A, int k, int* piv, T* sm) {
  const int tid = threadIdx.x, lane = tid & 31;
  SMat<T, WIDE_LD> pan = reinterpret_cast<SMat<T, WIDE_LD>>(sm);
  for (int p0 = 0; p0 < k; p0 += GEN_TB) {
    const int nb = min(GEN_TB, k - p0), rows = k - p0;
    __syncthreads();
    cta_batched(
        rows * nb,
        [&](int e) { return A[(size_t)(p0 + e / nb) * k + p0 + e % nb]; },
        [&](int e, T v) { pan[e / nb][e % nb] = v; });
    __syncthreads();
    for (int c = 0; c < nb; ++c) {
      if (tid < 32) {
        // Each lane scans its rows in order and keeps the first maximum;
        // the reduction breaks ties to the lower row.  A NaN never wins.
        T best = T(-1);
        int idx = rows;
        for (int r = c + lane; r < rows; r += 32) {
          const T a = dfm_abs(pan[r][c]);
          if (a > best) {
            best = a;
            idx = r;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const T ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
          if (ob > best || (ob == best && oi < idx)) {
            best = ob;
            idx = oi;
          }
        }
        idx = __shfl_sync(0xffffffffu, idx, 0);
        if (idx >= rows) idx = c;           // an all-NaN column: no swap
        if (lane == 0) piv[p0 + c] = p0 + idx;
        if (idx != c && lane < nb) {
          const T tmp = pan[c][lane];
          pan[c][lane] = pan[idx][lane];
          pan[idx][lane] = tmp;
        }
        __syncwarp();
        const T d = pan[c][c];
        for (int r = c + 1 + lane; r < rows; r += 32) pan[r][c] /= d;
      }
      __syncthreads();
      const int w = nb - c - 1;
      if (w > 0) {
        const int n_up = (rows - c - 1) * w;
        for (int e = tid; e < n_up; e += GEN_THREADS) {
          const int r = c + 1 + e / w, j = c + 1 + e % w;
          pan[r][j] -= pan[r][c] * pan[c][j];
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < rows * nb; e += GEN_THREADS)
      A[(size_t)(p0 + e / nb) * k + p0 + e % nb] = pan[e / nb][e % nb];
    // The other columns: the panel's interchanges in order, then (right
    // of the panel) U12 = L11^{-1} A12.
    for (int j = tid; j < k - nb; j += GEN_THREADS) {
      const int col = j < p0 ? j : j + nb;
      for (int c = 0; c < nb; ++c) {
        const int r = piv[p0 + c];
        if (r != p0 + c) {
          const T tmp = A[(size_t)(p0 + c) * k + col];
          A[(size_t)(p0 + c) * k + col] = A[(size_t)r * k + col];
          A[(size_t)r * k + col] = tmp;
        }
      }
      if (col >= p0 + nb) {
        T x[GEN_TB];
#pragma unroll
        for (int c = 0; c < GEN_TB; ++c)
          x[c] = c < nb ? A[(size_t)(p0 + c) * k + col] : T(0);
#pragma unroll
        for (int c = 0; c < GEN_TB; ++c) {
          if (c >= nb) break;
#pragma unroll
          for (int r = c + 1; r < GEN_TB; ++r)
            if (r < nb) x[r] -= pan[r][c] * x[c];
        }
#pragma unroll
        for (int c = 0; c < GEN_TB; ++c)
          if (c < nb) A[(size_t)(p0 + c) * k + col] = x[c];
      }
    }
    const int m2 = rows - nb;
    if (m2 > 0) {
      T* A22 = A + (size_t)(p0 + nb) * k + p0 + nb;
      cta_gemm<T>(A22, k, A + (size_t)(p0 + nb) * k + p0, k, false,
                  A + (size_t)p0 * k + p0 + nb, k, false, m2, m2, nb, T(-1),
                  A22, k, false, sm);          // A22 -= L21 U12
    }
  }
  __syncthreads();
}

// X = A^{-1} B with A's factors and pivots from cta_getrf: B (k x n at a
// leading dimension ldb; tb: B is stored transposed, element (i, j) at
// B[j * ldb + i]) gathered through the interchanges into X (k x n at ldx;
// X shares no element with B or LU), then unit-lower forward and upper
// back substitution by 32-row blocks: a block's update from the rows
// already solved is a cta_gemm, then a thread a column substitutes in
// registers against the block's 32 x 32 diagonal block, staged in ``sm``.
// n <= DFM_GEN_KMAX (a vector: n = 1, ldb = ldx = 1); perm holds k ints in
// shared memory.
template <typename T>
__device__ __noinline__ void cta_getrs(const T* LU, const int* piv, int k,
                                       const T* B, int ldb, bool tb, T* X,
                                       int ldx, int n, int* perm, T* sm) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid == 0) {
    // Row i of P B is row perm[i] of B (LAPACK's laswp, in order).
    for (int i = 0; i < k; ++i) perm[i] = i;
    for (int p = 0; p < k; ++p) {
      const int r = piv[p];
      if (r != p) {
        const int tmp = perm[p];
        perm[p] = perm[r];
        perm[r] = tmp;
      }
    }
  }
  __syncthreads();
  cta_batched(
      k * n,
      [&](int e) {
        const int i = e / n, j = e % n;
        return tb ? B[(size_t)j * ldb + perm[i]]
                  : B[(size_t)perm[i] * ldb + j];
      },
      [&](int e, T v) { X[(size_t)(e / n) * ldx + e % n] = v; });
  SMat<T, WIDE_LD> Dg = reinterpret_cast<SMat<T, WIDE_LD>>(sm);
  const int nblk = (k + GEN_TB - 1) / GEN_TB;
  for (int bi = 0; bi < nblk; ++bi) {               // L y = P b
    const int i0 = bi * GEN_TB, nb = min(GEN_TB, k - i0);
    T* Xb = X + (size_t)i0 * ldx;
    if (i0 > 0)
      cta_gemm<T>(Xb, ldx, LU + (size_t)i0 * k, k, false, X, ldx, false, nb,
                  n, i0, T(-1), Xb, ldx, false, sm);
    __syncthreads();
    cta_batched(
        nb * nb,
        [&](int e) { return LU[(size_t)(i0 + e / nb) * k + i0 + e % nb]; },
        [&](int e, T v) { Dg[e / nb][e % nb] = v; });
    __syncthreads();
    for (int j = tid; j < n; j += GEN_THREADS) {
      T x[GEN_TB];
#pragma unroll
      for (int r = 0; r < GEN_TB; ++r)
        x[r] = r < nb ? Xb[(size_t)r * ldx + j] : T(0);
#pragma unroll
      for (int c = 0; c < GEN_TB; ++c) {
        if (c >= nb) break;
#pragma unroll
        for (int r = c + 1; r < GEN_TB; ++r)
          if (r < nb) x[r] -= Dg[r][c] * x[c];
      }
#pragma unroll
      for (int r = 0; r < GEN_TB; ++r)
        if (r < nb) Xb[(size_t)r * ldx + j] = x[r];
    }
  }
  for (int bi = nblk - 1; bi >= 0; --bi) {          // U x = y
    const int i0 = bi * GEN_TB, nb = min(GEN_TB, k - i0);
    T* Xb = X + (size_t)i0 * ldx;
    if (i0 + nb < k)
      cta_gemm<T>(Xb, ldx, LU + (size_t)i0 * k + i0 + nb, k, false,
                  X + (size_t)(i0 + nb) * ldx, ldx, false, nb, n,
                  k - i0 - nb, T(-1), Xb, ldx, false, sm);
    __syncthreads();
    cta_batched(
        nb * nb,
        [&](int e) { return LU[(size_t)(i0 + e / nb) * k + i0 + e % nb]; },
        [&](int e, T v) { Dg[e / nb][e % nb] = v; });
    __syncthreads();
    for (int j = tid; j < n; j += GEN_THREADS) {
      T x[GEN_TB];
#pragma unroll
      for (int r = 0; r < GEN_TB; ++r)
        x[r] = r < nb ? Xb[(size_t)r * ldx + j] : T(0);
#pragma unroll
      for (int c = GEN_TB - 1; c >= 0; --c) {
        if (c >= nb) continue;
        x[c] /= Dg[c][c];
#pragma unroll
        for (int r = 0; r < c; ++r) x[r] -= Dg[r][c] * x[c];
      }
#pragma unroll
      for (int r = 0; r < GEN_TB; ++r)
        if (r < nb) Xb[(size_t)r * ldx + j] = x[r];
    }
  }
  __syncthreads();
}

// 2 sum_i log L[i][i] into *out (thread 0), L k x k at a leading dimension
// of k; the caller's barrier follows.
template <typename T>
__device__ __forceinline__ void cta_logdet(const T* L, int k, T* out) {
  if (threadIdx.x < 32) {
    T s = T(0);
    for (int i = threadIdx.x; i < k; i += 32)
      s += dfm_log(L[(size_t)i * k + i]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) *out = T(2) * s;
  }
}

// psd_cholesky(M, jitter) of ops/linalg.py: L = chol(sym(M) (+ the dtype's
// jitter on the diagonal when jit; none: psd_cholesky(M, jitter=0.0))), L
// may be M.  A non-positive pivot gives NaN (no clamp).
template <typename T>
__device__ __forceinline__ void cta_psd_chol(T* L, const T* M, int k,
                                             bool jit, T* sm) {
  cta_sym<T>(L, M, k, jit, sm);
  cta_potrf<T>(L, k, sm);
}

// tria([op(X1) | X2]) past QR_UNROLL_K_MAX: the jittered Cholesky of the
// Gram matrix op(X1) op(X1)' + X2 X2' (op(X1) = X1' when t1; X2 = I when
// null), summed by two products into L (no concatenation).  L shares no
// element with X1 or X2.
template <typename T>
__device__ void cta_tria(T* L, const T* X1, bool t1, const T* X2, int k,
                         T* sm) {
  cta_gemm<T>(L, k, X1, k, t1, X1, k, !t1, k, k, k, T(1), nullptr, 0,
              X2 == nullptr, sm);
  if (X2)
    cta_gemm<T>(L, k, X2, k, false, X2, k, true, k, k, k, T(1), L, k, false,
                sm);
  cta_psd_chol<T>(L, L, k, true, sm);
}

// X (m x k, leading dimension k) <- X L^{-T} L^{-1}: each row x' becomes
// ((L L')^{-1} x)', so X' <- chol_solve(L, X') (a vector: m = 1).
template <typename T>
__device__ __forceinline__ void cta_chol_solve_rows(T* X, int m, const T* L,
                                                    int k, T* sm) {
  cta_trsm_right<T>(X, m, L, k, true, sm);      // rows of L^{-1} X'
  cta_trsm_right<T>(X, m, L, k, false, sm);     // rows of L^{-T} (.)
}

// dst = src' (k x k at a leading dimension of k; dst is not src), between
// barriers.
template <typename T>
__device__ __forceinline__ void cta_transpose(T* dst, const T* src, int k) {
  __syncthreads();
  for (int e = threadIdx.x; e < k * k; e += GEN_THREADS)
    dst[(size_t)(e % k) * k + e / k] = src[e];
  __syncthreads();
}

