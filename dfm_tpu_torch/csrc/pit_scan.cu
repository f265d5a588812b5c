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
#include "cta_linalg.cuh"

// Element arrays of a scan: filter (A, b, C, eta, J), smoother (E, g, L).
template <typename T>
struct Arrays {
  T* p[5];
};

template <typename T>
__device__ void copy_v(T* __restrict__ d, const T* __restrict__ s, int k) {
  for (int e = warp_lane(); e < k; e += 32) d[e] = s[e];
}

// Y = sym(X + Y) in place, a pair (i, j), i <= j, a lane.
template <typename T, int LDV>
__device__ void sym_add(SMat<T, LDV> Y, SMat<T, LDV> X, int k) {
  for (int e = warp_lane(); e < k * k; e += 32) {
    const int i = e / k, j = e % k;
    if (i > j) continue;
    const T s = T(0.5) * ((X[i][j] + Y[i][j]) + (X[j][i] + Y[j][i]));
    Y[i][j] = s;
    Y[j][i] = s;
  }
  __syncwarp();
}

// The filter combine's working set.  Matrix slots: 0 A_i, 1 C_i, 2 J_i,
// 3 A_j, 4 C_j, 5 J_j, 6 E (its LU factors), 7 (A_j D^{-1})', 8 the new A,
// 9 scratch; vectors: 0 b_i, 1 eta_i, 2 b_j, 3 eta_j, 4 and 5 scratch.
// The result lands in A: 8, b: vector 2, C: 4, eta: vector 3, J: 2.
template <typename T, int LDV>
struct FilterOps {
  static constexpr int MATS = 10, VECS = 6, NARR = 5;
  T* sm;
  int k;
  int* piv;
  static size_t smem(int k) {
    return sizeof(T) * ((size_t)MATS * k * LDV + 32 * VECS) + 32 * sizeof(int);
  }
  __device__ FilterOps(T* base, int k_) : sm(base), k(k_) {
    piv = reinterpret_cast<int*>(vec(VECS));
  }
  __device__ SMat<T, LDV> m(int i) const { return smem_slot<T, LDV>(sm, i, k); }
  __device__ T* vec(int i) const {
    return sm + (size_t)MATS * k * LDV + 32 * i;
  }

  // Element ``idx`` of ``a`` as the earlier (first) or later operand;
  // C_i and J_j symmetrized.
  __device__ void load(const Arrays<T>& a, size_t idx, bool second) {
    const size_t kk = (size_t)k * k;
    const int o = second ? 3 : 0, vo = second ? 2 : 0;
    warp_load(m(o), a.p[0] + idx * kk, k, false);
    warp_load(m(o + 1), a.p[2] + idx * kk, k, !second);
    warp_load(m(o + 2), a.p[4] + idx * kk, k, second);
    copy_v(vec(vo), a.p[1] + idx * k, k);
    copy_v(vec(vo + 1), a.p[3] + idx * k, k);
    __syncwarp();
  }
  __device__ void store(const Arrays<T>& a, size_t idx) const {
    const size_t kk = (size_t)k * k;
    warp_store(a.p[0] + idx * kk, m(8), k);
    copy_v(a.p[1] + idx * k, vec(2), k);
    warp_store(a.p[2] + idx * kk, m(4), k);
    copy_v(a.p[3] + idx * k, vec(3), k);
    warp_store(a.p[4] + idx * kk, m(2), k);
    __syncwarp();
  }
  // The result becomes the first operand (J is in place already).
  __device__ void carry() {
    warp_copy(m(0), m(8), k);
    warp_copy(m(1), m(4), k);
    copy_v(vec(0), vec(2), k);
    copy_v(vec(1), vec(3), k);
    __syncwarp();
  }
  __device__ void combine() {
    const int lane = warp_lane();
    SMat<T, LDV> Ai = m(0), Ci = m(1), Ji = m(2), Aj = m(3), Cj = m(4),
                 Jj = m(5), E = m(6), Xt = m(7), An = m(8), S = m(9);
    T *bi = vec(0), *etai = vec(1), *bj = vec(2), *etaj = vec(3),
      *v = vec(4), *r = vec(5);
    const T one_jit = T(1.0 + (sizeof(T) == 8 ? 1e-10 : 1e-6));
    mm<T, false, false>(E, Jj, Ci, k);            // J_j C_i
    if (lane < k) E[lane][lane] += one_jit;
    __syncwarp();
    lu_inplace(E, piv, k);
    for (int e = lane; e < k * k; e += 32) Xt[e / k][e % k] = Aj[e % k][e / k];
    __syncwarp();
    lu_solve_cols(E, piv, Xt, k, k);              // (A_j D^{-1})'
    if (lane < k) {
      v[lane] = bi[lane] + row_dot<T, LDV, false>(Ci, etaj, lane, k);
      r[lane] = etaj[lane] - row_dot<T, LDV, false>(Jj, bi, lane, k);
    }
    __syncwarp();
    if (lane < k) bj[lane] = row_dot<T, LDV, true>(Xt, v, lane, k) + bj[lane];
    mm<T, true, false>(An, Xt, Ai, k);            // A_j D^{-1} A_i
    mm<T, true, false>(S, Xt, Ci, k);             // A_j D^{-1} C_i
    mm<T, false, true>(Ci, S, Aj, k);             // (.) A_j'
    sym_add(Cj, Ci, k);
    lu_solve_vec(E, piv, r, k);                   // E^{-1} (eta_j - J_j b_i)
    if (lane < k)
      etaj[lane] = row_dot<T, LDV, true>(Ai, r, lane, k) + etai[lane];
    mm<T, false, false>(S, Jj, Ai, k);            // J_j A_i
    lu_solve_cols(E, piv, S, k, k);               // E^{-1} J_j A_i
    mm<T, true, false>(Ci, Ai, S, k);             // A_i' (.)
    sym_add(Ji, Ci, k);
  }
};

// The smoother combine's working set.  Slots: 0 E_l, 1 L_l, 2 E_e, 3 L_e,
// 4 the new E, 5 scratch; vectors: 0 g_l, 1 g_e.  The first operand is the
// later element.  The result lands in E: 4, g: vector 1, L: 3.
template <typename T, int LDV>
struct SmootherOps {
  static constexpr int MATS = 6, VECS = 2, NARR = 3;
  T* sm;
  int k;
  static size_t smem(int k) {
    return sizeof(T) * ((size_t)MATS * k * LDV + 32 * VECS);
  }
  __device__ SmootherOps(T* base, int k_) : sm(base), k(k_) {}
  __device__ SMat<T, LDV> m(int i) const { return smem_slot<T, LDV>(sm, i, k); }
  __device__ T* vec(int i) const {
    return sm + (size_t)MATS * k * LDV + 32 * i;
  }

  __device__ void load(const Arrays<T>& a, size_t idx, bool second) {
    const size_t kk = (size_t)k * k;
    const int o = second ? 2 : 0;
    warp_load(m(o), a.p[0] + idx * kk, k, false);
    warp_load(m(o + 1), a.p[2] + idx * kk, k, false);
    copy_v(vec(second ? 1 : 0), a.p[1] + idx * k, k);
    __syncwarp();
  }
  __device__ void store(const Arrays<T>& a, size_t idx) const {
    const size_t kk = (size_t)k * k;
    warp_store(a.p[0] + idx * kk, m(4), k);
    copy_v(a.p[1] + idx * k, vec(1), k);
    warp_store(a.p[2] + idx * kk, m(3), k);
    __syncwarp();
  }
  __device__ void carry() {
    warp_copy(m(0), m(4), k);
    warp_copy(m(1), m(3), k);
    copy_v(vec(0), vec(1), k);
    __syncwarp();
  }
  __device__ void combine() {
    const int lane = warp_lane();
    SMat<T, LDV> El = m(0), Ll = m(1), Ee = m(2), Le = m(3), En = m(4),
                 S = m(5);
    T *gl = vec(0), *ge = vec(1);
    mm<T, false, false>(En, Ee, El, k);           // E_e E_l
    if (lane < k) ge[lane] = row_dot<T, LDV, false>(Ee, gl, lane, k) + ge[lane];
    mm<T, false, false>(S, Ee, Ll, k);            // E_e L_l
    mm<T, false, true>(Ll, S, Ee, k);             // (.) E_e'
    sym_add(Le, Ll, k);
  }
};

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

// A CTA's scratch: four shared k-vectors, six k x k workspace matrices
// (the last also holds two k-vectors).
template <typename T>
using GenCta = CtaScratch<T, 4, 6>;

// Element ``i`` of array ``a`` (k x k for the even arrays, a k-vector for
// the odd ones).
template <typename T>
__device__ __forceinline__ T* elem(const Arrays<T>& e, int a, size_t i,
                                   int k) {
  return e.p[a] + i * ((a % 2 == 0) ? (size_t)k * k : (size_t)k);
}

// The filter combine (first ei earlier, second ej later) into element io
// of eo, which may be ej's own slot (never ei's): the k <= 32 kernel's
// algebra, C_i and J_j symmetrized into the workspace first.
template <typename T>
__device__ void filter_combine_gen(const Arrays<T>& ea, size_t ia,
                                   const Arrays<T>& eb, size_t ib,
                                   const Arrays<T>& eo, size_t io,
                                   const GenCta<T>& g) {
  const int k = g.k;
  const size_t kk = (size_t)k * k;
  const T *Ai = elem(ea, 0, ia, k), *bi = elem(ea, 1, ia, k),
          *Ci = elem(ea, 2, ia, k), *etai = elem(ea, 3, ia, k),
          *Ji = elem(ea, 4, ia, k);
  const T *Aj = elem(eb, 0, ib, k), *bj = elem(eb, 1, ib, k),
          *Cj = elem(eb, 2, ib, k), *etaj = elem(eb, 3, ib, k),
          *Jj = elem(eb, 4, ib, k);
  T *Ao = elem(eo, 0, io, k), *bo = elem(eo, 1, io, k),
    *Co = elem(eo, 2, io, k), *etao = elem(eo, 3, io, k),
    *Jo = elem(eo, 4, io, k);
  T *Cs = g.w, *Js = Cs + kk, *E = Js + kk, *Xt = E + kk, *S = Xt + kk,
    *rv = S + kk, *rs = rv + k;
  cta_sym<T>(Cs, Ci, k, false, g.sm);
  cta_sym<T>(Js, Jj, k, false, g.sm);
  cta_gemm<T>(E, k, Js, k, false, Cs, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // J_j C_i
  cta_add_diag<T>(E, k, T(1) + dfm_jitter<T>());
  cta_getrf<T>(E, k, g.piv, g.sm);
  cta_getrs<T>(E, g.piv, k, Aj, k, true, Xt, k, k, g.perm,
               g.sm);                                         // (A_j D^{-1})'
  cta_load_vec(g.v[0], etaj, k);
  cta_load_vec(g.v[1], bi, k);
  cta_matvec<T>(g.v[2], bi, T(1), Cs, g.v[0], k, nullptr);    // b_i + C_i eta_j
  cta_matvec<T>(g.v[3], etaj, T(-1), Js, g.v[1], k, rv);      // eta_j - J_j b_i
  cta_matvec_t<T>(nullptr, bj, T(1), Xt, g.v[2], k, bo);      // b
  cta_gemm<T>(S, k, Xt, k, true, Cs, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // A_j D^-1 C_i
  cta_gemm<T>(Co, k, S, k, false, Aj, k, true, k, k, k, T(1), Cj, k, false,
              g.sm);                                          // (.) A_j' + C_j
  cta_sym<T>(Co, Co, k, false, g.sm);
  cta_gemm<T>(Ao, k, Xt, k, true, Ai, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // A_j D^-1 A_i
  cta_getrs<T>(E, g.piv, k, rv, 1, false, rs, 1, 1, g.perm, g.sm);
  cta_load_vec(g.v[0], rs, k);
  cta_matvec_t<T>(nullptr, etai, T(1), Ai, g.v[0], k, etao);  // eta
  cta_gemm<T>(S, k, Js, k, false, Ai, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // J_j A_i
  cta_getrs<T>(E, g.piv, k, S, k, false, Xt, k, k, g.perm, g.sm);
  cta_gemm<T>(Jo, k, Ai, k, true, Xt, k, false, k, k, k, T(1), Ji, k, false,
              g.sm);                                          // A_i' (.) + J_i
  cta_sym<T>(Jo, Jo, k, false, g.sm);
}

// The smoother combine (first the later element, second the earlier) into
// element io of eo, which may be the earlier element's slot.
template <typename T>
__device__ void smoother_combine_gen(const Arrays<T>& ea, size_t ia,
                                     const Arrays<T>& eb, size_t ib,
                                     const Arrays<T>& eo, size_t io,
                                     const GenCta<T>& g) {
  const int k = g.k;
  const size_t kk = (size_t)k * k;
  const T *El = elem(ea, 0, ia, k), *gl = elem(ea, 1, ia, k),
          *Ll = elem(ea, 2, ia, k);
  const T *Ee = elem(eb, 0, ib, k), *ge = elem(eb, 1, ib, k),
          *Le = elem(eb, 2, ib, k);
  T *Eo = elem(eo, 0, io, k), *go = elem(eo, 1, io, k),
    *Lo = elem(eo, 2, io, k);
  T *En = g.w, *S = En + kk;
  cta_gemm<T>(En, k, Ee, k, false, El, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // E_e E_l
  cta_load_vec(g.v[0], gl, k);
  cta_matvec<T>(g.v[1], ge, T(1), Ee, g.v[0], k, go);         // E_e g_l + g_e
  cta_gemm<T>(S, k, Ee, k, false, Ll, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // E_e L_l
  cta_gemm<T>(Lo, k, S, k, false, Ee, k, true, k, k, k, T(1), Le, k, false,
              g.sm);                                          // (.) E_e' + L_e
  cta_sym<T>(Lo, Lo, k, false, g.sm);
  cta_copy<T>(Eo, En, (int)kk);
}

template <typename T, bool SMOOTH>
__device__ __forceinline__ void combine_gen(const Arrays<T>& ea, size_t ia,
                                            const Arrays<T>& eb, size_t ib,
                                            const Arrays<T>& eo, size_t io,
                                            const GenCta<T>& g) {
  if (SMOOTH)
    smoother_combine_gen<T>(ea, ia, eb, ib, eo, io, g);
  else
    filter_combine_gen<T>(ea, ia, eb, ib, eo, io, g);
}

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


// k x k workspace matrices a CTA (kernels.GEN_MATS["qr_scan_gen"]); the
// last holds row vectors.
constexpr int QR_SCAN_MATS = 10;

template <typename T>
using QsgCta = CtaScratch<T, 4, QR_SCAN_MATS>;

template <typename T>
__device__ __forceinline__ T* qelem(const Arrays<T>& e, int a, size_t i,
                                    int k) {
  return e.p[a] + i * ((a % 2 == 0) ? (size_t)k * k : (size_t)k);
}

__device__ __forceinline__ size_t qat(int i, int n, int reverse) {
  return (size_t)(reverse ? n - 1 - i : i);
}

// qr_combine_filter(ei, ej) (first ei earlier, second ej later) into
// element io of eo, which may be ej's slot (never ei's), with Yf = U_i'
// Z_j, Theta = tria([Yf | I]), Lam = tria([Yf' | I]):
//   A   = A_j (A_i - U_i chol_solve(Theta, Yf Z_j' A_i))
//   b   = A_j Dinv(b_i + U_i U_i' eta_j) + b_j,  Dinv(w) = w - U_i
//         chol_solve(Theta, Yf Z_j' w)
//   U   = tria([A_j U_i Theta^{-T} | U_j])
//   eta = A_i' (v - Z_j chol_solve(Lam, Yf' U_i' v)) + eta_i, v = eta_j -
//         Z_j Z_j' b_i
//   Z   = tria([A_i' Z_j Lam^{-T} | Z_i])
// The matrix chol_solve is taken transposed (its rows through
// cta_chol_solve_rows), the vector ones as one row.  __noinline__: one
// compiled body for the four phase kernels (ptxas time, not speed).
template <typename T>
__device__ __noinline__ void qr_filter_combine_gen(
    const Arrays<T>& ea, size_t ia, const Arrays<T>& eb, size_t ib,
    const Arrays<T>& eo, size_t io, const QsgCta<T>& g) {
  const int k = g.k;
  const size_t kk = (size_t)k * k;
  const T *Ai = qelem(ea, 0, ia, k), *bi = qelem(ea, 1, ia, k),
          *Ui = qelem(ea, 2, ia, k), *etai = qelem(ea, 3, ia, k),
          *Zi = qelem(ea, 4, ia, k);
  const T *Aj = qelem(eb, 0, ib, k), *bj = qelem(eb, 1, ib, k),
          *Uj = qelem(eb, 2, ib, k), *etaj = qelem(eb, 3, ib, k),
          *Zj = qelem(eb, 4, ib, k);
  T *Yf = g.w, *Th = Yf + kk, *Lm = Th + kk, *P = Lm + kk, *X = P + kk,
    *Aw = X + kk, *H = Aw + kk, *Uw = H + kk, *Zw = Uw + kk, *V0 = Zw + kk,
    *V1 = V0 + k, *Vb = V1 + k, *Ve = Vb + k;
  T *s0 = g.v[0], *s1 = g.v[1], *s2 = g.v[2], *s3 = g.v[3];
  cta_gemm<T>(Yf, k, Ui, k, true, Zj, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // U_i' Z_j
  cta_tria<T>(Th, Yf, false, nullptr, k, g.sm);               // Theta
  cta_tria<T>(Lm, Yf, true, nullptr, k, g.sm);                // Lam
  // A: X = (chol_solve(Theta, Yf Z_j' A_i))' = A_i' Z_j Yf' Th^-T Th^-1.
  cta_gemm<T>(P, k, Ai, k, true, Zj, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // A_i' Z_j
  cta_gemm<T>(X, k, P, k, false, Yf, k, true, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // (.) Yf'
  cta_chol_solve_rows<T>(X, k, Th, k, g.sm);
  cta_gemm<T>(H, k, Ui, k, false, X, k, true, k, k, k, T(-1), Ai, k, false,
              g.sm);                                          // Dinv(A_i)
  cta_gemm<T>(Aw, k, Aj, k, false, H, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // A
  // U = tria([A_j U_i Theta^{-T} | U_j]).
  cta_gemm<T>(H, k, Aj, k, false, Ui, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // A_j U_i
  cta_trsm_right<T>(H, k, Th, k, true, g.sm);
  cta_tria<T>(Uw, H, false, Uj, k, g.sm);
  // Z = tria([A_i' Z_j Lam^{-T} | Z_i]).
  cta_trsm_right<T>(P, k, Lm, k, true, g.sm);
  cta_tria<T>(Zw, P, false, Zi, k, g.sm);
  // b.
  cta_load_vec(s0, etaj, k);
  cta_matvec_t<T>(s1, nullptr, T(1), Ui, s0, k, nullptr);    // U_i' eta_j
  cta_matvec<T>(s2, bi, T(1), Ui, s1, k, V1);                // w
  cta_matvec_t<T>(s1, nullptr, T(1), Zj, s2, k, nullptr);    // Z_j' w
  cta_matvec<T>(s3, nullptr, T(1), Yf, s1, k, V0);           // Yf (.)
  cta_chol_solve_rows<T>(V0, 1, Th, k, g.sm);
  cta_load_vec(s1, V0, k);
  cta_matvec<T>(s3, V1, T(-1), Ui, s1, k, nullptr);          // Dinv(w)
  cta_matvec<T>(s0, bj, T(1), Aj, s3, k, Vb);                // b
  // eta.
  cta_load_vec(s0, bi, k);
  cta_matvec_t<T>(s1, nullptr, T(1), Zj, s0, k, nullptr);    // Z_j' b_i
  cta_matvec<T>(s2, etaj, T(-1), Zj, s1, k, V1);             // v
  cta_matvec_t<T>(s1, nullptr, T(1), Ui, s2, k, nullptr);    // U_i' v
  cta_matvec_t<T>(nullptr, nullptr, T(1), Yf, s1, k, V0);    // Yf' (.)
  cta_chol_solve_rows<T>(V0, 1, Lm, k, g.sm);
  cta_load_vec(s1, V0, k);
  cta_matvec<T>(s3, V1, T(-1), Zj, s1, k, nullptr);          // Einv(v)
  cta_matvec_t<T>(nullptr, etai, T(1), Ai, s3, k, Ve);       // eta
  // The result, after every read of e_j.
  cta_copy<T>(qelem(eo, 0, io, k), Aw, (int)kk);
  cta_copy<T>(qelem(eo, 1, io, k), Vb, k);
  cta_copy<T>(qelem(eo, 2, io, k), Uw, (int)kk);
  cta_copy<T>(qelem(eo, 3, io, k), Ve, k);
  cta_copy<T>(qelem(eo, 4, io, k), Zw, (int)kk);
}

// qr_combine_smoother(el, ee) (first the later element, second the
// earlier) into element io of eo, which may be the earlier element's
// slot: E = E_e E_l, g = E_e g_l + g_e, D = tria([E_e D_l | D_e]).
template <typename T>
__device__ __noinline__ void qr_smoother_combine_gen(
    const Arrays<T>& ea, size_t ia, const Arrays<T>& eb, size_t ib,
    const Arrays<T>& eo, size_t io, const QsgCta<T>& g) {
  const int k = g.k;
  const size_t kk = (size_t)k * k;
  const T *El = qelem(ea, 0, ia, k), *gl = qelem(ea, 1, ia, k),
          *Dl = qelem(ea, 2, ia, k);
  const T *Ee = qelem(eb, 0, ib, k), *ge = qelem(eb, 1, ib, k),
          *De = qelem(eb, 2, ib, k);
  T *En = g.w, *X = En + kk, *Dw = X + kk, *Vg = Dw + kk;
  cta_gemm<T>(En, k, Ee, k, false, El, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // E_e E_l
  cta_gemm<T>(X, k, Ee, k, false, Dl, k, false, k, k, k, T(1), nullptr, 0,
              false, g.sm);                                   // E_e D_l
  cta_tria<T>(Dw, X, false, De, k, g.sm);
  cta_load_vec(g.v[0], gl, k);
  cta_matvec<T>(g.v[1], ge, T(1), Ee, g.v[0], k, Vg);        // E_e g_l + g_e
  cta_copy<T>(qelem(eo, 0, io, k), En, (int)kk);
  cta_copy<T>(qelem(eo, 1, io, k), Vg, k);
  cta_copy<T>(qelem(eo, 2, io, k), Dw, (int)kk);
}

template <typename T, bool SMOOTH>
__device__ __forceinline__ void qcombine_gen(const Arrays<T>& ea, size_t ia,
                                             const Arrays<T>& eb, size_t ib,
                                             const Arrays<T>& eo, size_t io,
                                             const QsgCta<T>& g) {
  if (SMOOTH)
    qr_smoother_combine_gen<T>(ea, ia, eb, ib, eo, io, g);
  else
    qr_filter_combine_gen<T>(ea, ia, eb, ib, eo, io, g);
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
