// K14-scan: the blocked associative scans of the covariance-form
// parallel-in-time engine (pit), one warp a combine, four launches a pass.
//
// Replaces dfm_tpu/ops/scan.py:blocked_scan (line 73) driven by
// dfm_tpu/ssm/parallel_filter.py:_combine_filter (109; the filter's
// inclusive prefix in pit_from_stats, 159) and _combine_smoother (217; the
// smoother's inclusive suffix in pit_smoother, 241).  The decomposition is
// the JAX one, so the kernel and the plain twin associate identically: S =
// min(max(1, floor(sqrt(T))), T) elements a block, B = T // S blocks, T0 =
// B S, and
//   phase 1  each block's inclusive prefix: a CTA a block, S - 1 combines
//            in sequence;
//   phase 2  the inclusive prefix of the first B - 1 block totals: one
//            CTA, B - 2 combines in sequence, into the scratch buffer;
//   phase 3  every element of blocks 1 .. B-1 combined with the total of
//            the blocks before it: a CTA an element, (B - 1) S combines;
//   tail     the T - T0 remaining elements in sequence from element T0 - 1.
// Each phase is its own launch (all four always launch; an empty one
// returns at once), so a pass is four launches whatever T is.  The
// smoother runs the same scan over the reversed sequence with
// combine(carry, element) = _combine_smoother(later, earlier).
//
// A filter combine (ei earlier, ej later) with C_i and J_j symmetrized on
// entry:  E = (1 + jitter) I + J_j C_i, factored once by LU with partial
// pivoting; D' = (1 + jitter) I + J_j' C_i' is E itself for the symmetric
// C_i and J_j, so A_j D^{-1} = (E^{-1} A_j')';  A = A_j D^{-1} A_i;  b =
// A_j D^{-1} (b_i + C_i eta_j) + b_j;  C = sym(A_j D^{-1} C_i A_j' + C_j);
// eta = A_i' E^{-1} (eta_j - J_j b_i) + eta_i;  J = sym(A_i' E^{-1} J_j A_i
// + J_i).  A smoother combine:  E = E_e E_l;  g = E_e g_l + g_e;  L =
// sym(E_e L_l E_e' + L_e).
//
// Bound on the H100: the combines in sequence (S - 1 + B - 2 + 1 + T - T0,
// ~2 sqrt(T)), each a chain of dependent warp-level k x k factorizations,
// solves and products (a lane owns a column: ~k^2 dependent FMAs a
// product, ~12 products and one LU a filter combine); the operations (~14
// k^3 a filter combine, ~2T combines) and the bytes (~3 T k^2 values in
// and out) are far below.  Design: the working set of a combine (ten k x k
// matrices for the filter, six for the smoother) in one CTA's dynamic
// shared memory at a leading dimension of 17 (k <= 16) or 33 (k <= 32; 86
// KB in f64 at k = 32, opted in above 48 KB), so a CTA is one warp and the
// phases that are parallel spread over the grid; elements are read from
// and written to the global arrays in place.
//
// K14-scan-gen (pit_scan_gen): the same blocked scans at 32 < k <=
// DFM_GEN_KMAX = 128, with the same decomposition (S, B, T0, the tail) and
// the same four phases, so kernel and twin still associate identically.
// A combine's ten k x k matrices no longer fit a warp's shared memory (80
// KB a matrix in f64 at k = 100), so a combine runs on a CTA of
// GEN_THREADS threads with cta_linalg.cuh's block-wide routines (one LU
// with partial pivoting, cta_getrf, three solves against it, cta_getrs,
// and ~7 products a filter combine), the operands read from and the
// result written to the element arrays in global memory (L2), the
// temporaries in a per-CTA workspace of six k x k matrices.  The
// grids are persistent: phases 1 and 3 run on at most ``ctas`` CTAs (a CTA
// an SM, from the wrapper), each looping over blocks or elements, so the
// workspace scales with the card.  The running prefix of phases 1, 2 and
// the tail is the result the previous combine stored.  Bound: the ~2
// sqrt(T) combines in sequence, each a chain of ~15 block-wide routines.
// The combine bodies (and K8-gen's below) live in pit_combine.cuh, shared
// with the log-depth scans of pit_assoc.cu.
#include "pit_combine.cuh"

__device__ __forceinline__ size_t at(int i, int n, int reverse) {
  return (size_t)(reverse ? n - 1 - i : i);
}

template <typename Ops, typename T>
__global__ void __launch_bounds__(32)
phase1_kernel(Arrays<T> el, int n, int S, int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ops w(reinterpret_cast<T*>(smem_raw), k);
  const int blk = blockIdx.x;
  if (blk >= n / S || S < 2) return;
  w.load(el, at(blk * S, n, reverse), false);
  for (int s = 1; s < S; ++s) {
    const size_t i = at(blk * S + s, n, reverse);
    w.load(el, i, true);
    w.combine();
    w.store(el, i);
    w.carry();
  }
}

template <typename Ops, typename T>
__global__ void __launch_bounds__(32)
phase2_kernel(Arrays<T> el, Arrays<T> off, int n, int S, int reverse,
              int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ops w(reinterpret_cast<T*>(smem_raw), k);
  const int B = n / S;
  if (B < 2) return;
  // off[0]: block 0's total, copied as it stands.
  const size_t src = at(S - 1, n, reverse), kk = (size_t)k * k;
  for (int a = 0; a < Ops::NARR; ++a) {
    const size_t len = (a % 2 == 0) ? kk : (size_t)k;
    for (size_t e = warp_lane(); e < len; e += 32)
      off.p[a][e] = el.p[a][src * len + e];
  }
  w.load(el, src, false);
  for (int b = 1; b < B - 1; ++b) {
    w.load(el, at(b * S + S - 1, n, reverse), true);
    w.combine();
    w.store(off, (size_t)b);
    w.carry();
  }
}

template <typename Ops, typename T>
__global__ void __launch_bounds__(32)
phase3_kernel(Arrays<T> el, Arrays<T> off, int n, int S, int reverse,
              int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ops w(reinterpret_cast<T*>(smem_raw), k);
  const int B = n / S, i = blockIdx.x;
  if (B < 2 || i >= (B - 1) * S) return;
  const int b = 1 + i / S, s = i % S;
  const size_t idx = at(b * S + s, n, reverse);
  w.load(off, (size_t)(b - 1), false);
  w.load(el, idx, true);
  w.combine();
  w.store(el, idx);
}

template <typename Ops, typename T>
__global__ void __launch_bounds__(32)
tail_kernel(Arrays<T> el, int n, int S, int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ops w(reinterpret_cast<T*>(smem_raw), k);
  const int T0 = (n / S) * S;
  if (T0 >= n) return;
  w.load(el, at(T0 - 1, n, reverse), false);
  for (int i = T0; i < n; ++i) {
    const size_t idx = at(i, n, reverse);
    w.load(el, idx, true);
    w.combine();
    w.store(el, idx);
    w.carry();
  }
}

template <typename Ops, typename T>
static int run(Arrays<T> el, Arrays<T> off, int n, int S, int reverse,
               int k, cudaStream_t s) {
  const size_t bytes = Ops::smem(k);
  cudaError_t err;
  if ((err = dfm_smem_optin(phase1_kernel<Ops, T>, bytes)) != cudaSuccess ||
      (err = dfm_smem_optin(phase2_kernel<Ops, T>, bytes)) != cudaSuccess ||
      (err = dfm_smem_optin(phase3_kernel<Ops, T>, bytes)) != cudaSuccess ||
      (err = dfm_smem_optin(tail_kernel<Ops, T>, bytes)) != cudaSuccess)
    return (int)err;
  const int B = n / S;
  phase1_kernel<Ops, T><<<B, 32, bytes, s>>>(el, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  phase2_kernel<Ops, T><<<1, 32, bytes, s>>>(el, off, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n3 = (B - 1) * S;
  phase3_kernel<Ops, T><<<n3 > 0 ? n3 : 1, 32, bytes, s>>>(el, off, n, S,
                                                          reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tail_kernel<Ops, T><<<1, 32, bytes, s>>>(el, n, S, reverse, k);
  return (int)cudaGetLastError();
}

// ---- K14-scan-gen ----


template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
phase1_gen_kernel(Arrays<T> el, T* work, int n, int S, int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GenCta<T> g(smem_raw, work, k);
  if (S < 2) return;
  for (int blk = blockIdx.x; blk < n / S; blk += gridDim.x) {
    size_t prev = at(blk * S, n, reverse);
    for (int s = 1; s < S; ++s) {
      const size_t i = at(blk * S + s, n, reverse);
      combine_gen<T, SMOOTH>(el, prev, el, i, el, i, g);
      prev = i;
    }
  }
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
phase2_gen_kernel(Arrays<T> el, Arrays<T> off, T* work, int n, int S,
                  int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GenCta<T> g(smem_raw, work, k);
  const int B = n / S;
  if (B < 2) return;
  // off[0]: block 0's total, copied as it stands.
  const size_t src = at(S - 1, n, reverse);
  for (int a = 0; a < (SMOOTH ? 3 : 5); ++a)
    cta_copy<T>(elem(off, a, 0, k), elem(el, a, src, k),
                a % 2 == 0 ? k * k : k);
  for (int b = 1; b < B - 1; ++b)
    combine_gen<T, SMOOTH>(off, (size_t)(b - 1), el,
                           at(b * S + S - 1, n, reverse), off, (size_t)b, g);
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
phase3_gen_kernel(Arrays<T> el, Arrays<T> off, T* work, int n, int S,
                  int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GenCta<T> g(smem_raw, work, k);
  const int B = n / S;
  if (B < 2) return;
  for (int i = blockIdx.x; i < (B - 1) * S; i += gridDim.x) {
    const int b = 1 + i / S, s = i % S;
    const size_t idx = at(b * S + s, n, reverse);
    combine_gen<T, SMOOTH>(off, (size_t)(b - 1), el, idx, el, idx, g);
  }
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
tail_gen_kernel(Arrays<T> el, T* work, int n, int S, int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GenCta<T> g(smem_raw, work, k);
  const int T0 = (n / S) * S;
  if (T0 >= n) return;
  size_t prev = at(T0 - 1, n, reverse);
  for (int i = T0; i < n; ++i) {
    const size_t idx = at(i, n, reverse);
    combine_gen<T, SMOOTH>(el, prev, el, idx, el, idx, g);
    prev = idx;
  }
}

template <typename T, bool SMOOTH>
static int run_gen(Arrays<T> el, Arrays<T> off, T* work, int n, int S,
                   int k, int ctas, cudaStream_t s) {
  const size_t bytes = GenCta<T>::bytes(k);
  cudaError_t err;
  if ((err = dfm_smem_optin(phase1_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess ||
      (err = dfm_smem_optin(phase2_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess ||
      (err = dfm_smem_optin(phase3_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess ||
      (err = dfm_smem_optin(tail_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess)
    return (int)err;
  const int reverse = SMOOTH ? 1 : 0;
  const int B = n / S, n3 = (B - 1) * S;
  const int g1 = B < ctas ? B : ctas, g3 = n3 < ctas ? n3 : ctas;
  phase1_gen_kernel<T, SMOOTH><<<g1 > 0 ? g1 : 1, GEN_THREADS, bytes, s>>>(
      el, work, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  phase2_gen_kernel<T, SMOOTH><<<1, GEN_THREADS, bytes, s>>>(
      el, off, work, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  phase3_gen_kernel<T, SMOOTH><<<g3 > 0 ? g3 : 1, GEN_THREADS, bytes, s>>>(
      el, off, work, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tail_gen_kernel<T, SMOOTH><<<1, GEN_THREADS, bytes, s>>>(el, work, n, S,
                                                           reverse, k);
  return (int)cudaGetLastError();
}

// The off arrays of the scratch buffer: B block totals, laid out as the
// k <= 32 kernel's.
template <typename T>
static Arrays<T> off_arrays(int smoother, T* scratch, int n, int S, int k) {
  const size_t kk = (size_t)k * k, nb = (size_t)(n / S);
  if (smoother)
    return Arrays<T>{{scratch, scratch + nb * kk, scratch + nb * (kk + k),
                      nullptr, nullptr}};
  return Arrays<T>{{scratch, scratch + nb * kk, scratch + nb * (kk + k),
                    scratch + nb * (2 * kk + k),
                    scratch + nb * (2 * kk + 2 * k)}};
}

// 1 <= k <= DFM_GEN_KMAX; ``work`` holds ctas x 6 k x k matrices.
template <typename T>
static int launch_gen(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                      T* scratch, T* work, int n, int S, int k, int ctas,
                      cudaStream_t s) {
  if (n < 1 || S < 1 || S > n || k < 1 || k > DFM_GEN_KMAX || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  Arrays<T> off = off_arrays<T>(smoother, scratch, n, S, k);
  if (smoother) return run_gen<T, true>(el, off, work, n, S, k, ctas, s);
  return run_gen<T, false>(el, off, work, n, S, k, ctas, s);
}

template <typename T, int LDV>
static int run_ld(int smoother, Arrays<T> el, T* scratch, int n, int S,
                  int k, cudaStream_t s) {
  Arrays<T> off = off_arrays<T>(smoother, scratch, n, S, k);
  if (smoother) return run<SmootherOps<T, LDV>, T>(el, off, n, S, 1, k, s);
  return run<FilterOps<T, LDV>, T>(el, off, n, S, 0, k, s);
}

template <typename T>
static int launch(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                  T* scratch, int n, int S, int k, cudaStream_t s) {
  if (n < 1 || S < 1 || S > n || k < 1 || k > DFM_WIDE_KMAX)
    return (int)cudaErrorInvalidValue;
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  if (k <= DFM_KMAX) return run_ld<T, LD>(smoother, el, scratch, n, S, k, s);
  return run_ld<T, WIDE_LD>(smoother, el, scratch, n, S, k, s);
}

// ---- K8-gen scan: qr_scan_gen ----
//
// The blocked associative scans of the square-root parallel-in-time
// engine (pit_qr) past QR_UNROLL_K_MAX = 10 (qr_scan.cu's K8 takes k <=
// 10), replacing dfm_tpu/ops/scan.py:blocked_scan (line 73) driven by
// dfm_tpu/ssm/parallel_filter.py:qr_combine_filter (395) and
// qr_combine_smoother (497).  In this source, beside K14-scan-gen, so
// that the block-wide routines of cta_linalg.cuh compile once a dtype
// for both engines.
//
// The decomposition is qr_scan.cu's (S, B, T0, the tail), so the kernel
// and the twin still associate identically, and each combine takes the
// JAX package's generic branches (tria = the jittered Cholesky of the
// Gram, chol_solve and tri_solve = triangular solves; see
// pit_elements.cu).  A combine runs on a
// CTA of GEN_THREADS threads with cta_linalg.cuh's block-wide routines, in
// four launches as K14-scan-gen: phase 1 (a CTA a block) and phase 3 (a
// CTA an element) on persistent grids of at most ``ctas`` CTAs, phase 2
// and the tail on one CTA; the operands are read from and the result
// written to the element arrays in global memory (L2), the temporaries
// and the result (copied out last, since the output may be the later
// element's slot) in a per-CTA workspace of QR_SCAN_MATS k x k matrices.
// A filter combine is four trias (a Gram of one product for Theta and
// Lam, whose second block is I, of two for U and Z; a sym and a Cholesky
// each), six other k x k products, one chol_solve of k rows and two
// triangular solves of k rows (four triangular solves of k x k blocks in
// all), two chol_solves of vectors and ten matrix-vector products: twelve
// products (24 k^3), four Cholesky factorizations (4/3 k^3) and the
// solves (4 k^3), ~29.3 k^3 flops; a smoother combine two products and a
// tria, ~8.3 k^3 (chip_smoke.qr_gen_flops).
// Bound: the ~2 sqrt(T) combines in sequence (S - 1 in phase 1, B - 2 in
// phase 2, the tail), each a chain of ~40 dependent block-wide routines.



__device__ __forceinline__ size_t qat(int i, int n, int reverse) {
  return (size_t)(reverse ? n - 1 - i : i);
}


template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
qphase1_gen_kernel(Arrays<T> el, T* work, int n, int S, int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QsgCta<T> g(smem_raw, work, k);
  if (S < 2) return;
  for (int blk = blockIdx.x; blk < n / S; blk += gridDim.x) {
    size_t prev = qat(blk * S, n, reverse);
    for (int s = 1; s < S; ++s) {
      const size_t i = qat(blk * S + s, n, reverse);
      qcombine_gen<T, SMOOTH>(el, prev, el, i, el, i, g);
      prev = i;
    }
  }
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
qphase2_gen_kernel(Arrays<T> el, Arrays<T> off, T* work, int n, int S,
                   int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QsgCta<T> g(smem_raw, work, k);
  const int B = n / S;
  if (B < 2) return;
  // off[0]: block 0's total, copied as it stands.
  const size_t src = qat(S - 1, n, reverse);
  for (int a = 0; a < (SMOOTH ? 3 : 5); ++a)
    cta_copy<T>(qelem(off, a, 0, k), qelem(el, a, src, k),
                a % 2 == 0 ? k * k : k);
  for (int b = 1; b < B - 1; ++b)
    qcombine_gen<T, SMOOTH>(off, (size_t)(b - 1), el,
                            qat(b * S + S - 1, n, reverse), off, (size_t)b,
                            g);
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
qphase3_gen_kernel(Arrays<T> el, Arrays<T> off, T* work, int n, int S,
                   int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QsgCta<T> g(smem_raw, work, k);
  const int B = n / S;
  if (B < 2) return;
  for (int i = blockIdx.x; i < (B - 1) * S; i += gridDim.x) {
    const int b = 1 + i / S, s = i % S;
    const size_t idx = qat(b * S + s, n, reverse);
    qcombine_gen<T, SMOOTH>(off, (size_t)(b - 1), el, idx, el, idx, g);
  }
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(GEN_THREADS)
qtail_gen_kernel(Arrays<T> el, T* work, int n, int S, int reverse, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  QsgCta<T> g(smem_raw, work, k);
  const int T0 = (n / S) * S;
  if (T0 >= n) return;
  size_t prev = qat(T0 - 1, n, reverse);
  for (int i = T0; i < n; ++i) {
    const size_t idx = qat(i, n, reverse);
    qcombine_gen<T, SMOOTH>(el, prev, el, idx, el, idx, g);
    prev = idx;
  }
}

template <typename T, bool SMOOTH>
static int run_qr_gen(Arrays<T> el, Arrays<T> off, T* work, int n, int S,
                   int k, int ctas, cudaStream_t s) {
  const size_t bytes = QsgCta<T>::bytes(k);
  cudaError_t err;
  if ((err = dfm_smem_optin(qphase1_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess ||
      (err = dfm_smem_optin(qphase2_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess ||
      (err = dfm_smem_optin(qphase3_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess ||
      (err = dfm_smem_optin(qtail_gen_kernel<T, SMOOTH>, bytes)) !=
          cudaSuccess)
    return (int)err;
  const int reverse = SMOOTH ? 1 : 0;
  const int B = n / S, n3 = (B - 1) * S;
  const int g1 = B < ctas ? B : ctas, g3 = n3 < ctas ? n3 : ctas;
  qphase1_gen_kernel<T, SMOOTH><<<g1 > 0 ? g1 : 1, GEN_THREADS, bytes, s>>>(
      el, work, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  qphase2_gen_kernel<T, SMOOTH><<<1, GEN_THREADS, bytes, s>>>(
      el, off, work, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  qphase3_gen_kernel<T, SMOOTH><<<g3 > 0 ? g3 : 1, GEN_THREADS, bytes, s>>>(
      el, off, work, n, S, reverse, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  qtail_gen_kernel<T, SMOOTH><<<1, GEN_THREADS, bytes, s>>>(el, work, n, S,
                                                            reverse, k);
  return (int)cudaGetLastError();
}

// 4 <= k <= DFM_GEN_KMAX (the row vectors of the last workspace matrix);
// ``work`` holds ctas x QR_SCAN_MATS k x k matrices; the scratch holds the
// B block totals in the element layout, as ``launch``'s.
template <typename T>
static int launch_qr_gen(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                      T* scratch, T* work, int n, int S, int k, int ctas,
                      cudaStream_t s) {
  if (n < 1 || S < 1 || S > n || k < 4 || k > DFM_GEN_KMAX || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const size_t kk = (size_t)k * k, nb = (size_t)(n / S);
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  Arrays<T> off{{scratch, scratch + nb * kk, scratch + nb * (kk + k),
                 scratch + nb * (2 * kk + k),
                 scratch + nb * (2 * kk + 2 * k)}};
  if (smoother) return run_qr_gen<T, true>(el, off, work, n, S, k, ctas, s);
  return run_qr_gen<T, false>(el, off, work, n, S, k, ctas, s);
}

extern "C" {
#if DFM_WANT_F32
int pit_scan_f32(int smoother, float* e0, float* e1, float* e2, float* e3,
                 float* e4, float* scratch, int n, int S, int k,
                 void* stream) {
  return launch<float>(smoother, e0, e1, e2, e3, e4, scratch, n, S, k,
                       (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F32
int pit_scan_gen_f32(int smoother, float* e0, float* e1, float* e2,
                     float* e3, float* e4, float* scratch, float* work,
                     int n, int S, int k, int ctas, void* stream) {
  return launch_gen<float>(smoother, e0, e1, e2, e3, e4, scratch, work, n, S,
                           k, ctas, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int pit_scan_gen_f64(int smoother, double* e0, double* e1, double* e2,
                     double* e3, double* e4, double* scratch, double* work,
                     int n, int S, int k, int ctas, void* stream) {
  return launch_gen<double>(smoother, e0, e1, e2, e3, e4, scratch, work, n,
                            S, k, ctas, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int pit_scan_f64(int smoother, double* e0, double* e1, double* e2,
                 double* e3, double* e4, double* scratch, int n, int S,
                 int k, void* stream) {
  return launch<double>(smoother, e0, e1, e2, e3, e4, scratch, n, S, k,
                        (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F32
int qr_scan_gen_f32(int smoother, float* e0, float* e1, float* e2,
                    float* e3, float* e4, float* scratch, float* work, int n,
                    int S, int k, int ctas, void* stream) {
  return launch_qr_gen<float>(smoother, e0, e1, e2, e3, e4, scratch, work,
                              n, S, k, ctas, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int qr_scan_gen_f64(int smoother, double* e0, double* e1, double* e2,
                    double* e3, double* e4, double* scratch, double* work,
                    int n, int S, int k, int ctas, void* stream) {
  return launch_qr_gen<double>(smoother, e0, e1, e2, e3, e4, scratch, work,
                               n, S, k, ctas, (cudaStream_t)stream);
}
#endif
}
