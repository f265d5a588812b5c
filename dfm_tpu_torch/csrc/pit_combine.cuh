// The combine bodies of the parallel-in-time engines' scans, shared by
// the blocked scans (pit_scan.cu: K14-scan, K14-scan-gen and K8-gen's
// qr_scan_gen) and the log-depth associative scans (pit_assoc.cu:
// K14-assoc and K8-assoc past k = 10).  Each body is the JAX package's
// combine (dfm_tpu/ssm/parallel_filter.py: _combine_filter 109,
// _combine_smoother 217, qr_combine_filter 395, qr_combine_smoother 497);
// its operands are addressed by (arrays, index) pairs, so a scan of any
// shape names which elements it combines and where the result goes.
//
// FilterOps and SmootherOps: one warp a combine, the working set in
// shared memory at a leading dimension of 17 (k <= 16) or 33 (k <= 32).
// filter_combine_gen and smoother_combine_gen (32 < k <= DFM_GEN_KMAX)
// and qr_filter_combine_gen and qr_smoother_combine_gen (10 < k <=
// DFM_GEN_KMAX): a CTA of GEN_THREADS threads a combine on cta_linalg.cuh's
// block-wide routines, the operands read from and the result written to
// the element arrays in global memory, the temporaries in a per-CTA
// workspace.
#pragma once

#include "cta_linalg.cuh"

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
