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
#include "warp_linalg.cuh"

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

template <typename T, int LDV>
static int run_ld(int smoother, Arrays<T> el, T* scratch, int n, int S,
                  int k, cudaStream_t s) {
  const size_t kk = (size_t)k * k, nb = (size_t)(n / S);
  if (smoother) {
    Arrays<T> off{{scratch, scratch + nb * kk, scratch + nb * (kk + k),
                   nullptr, nullptr}};
    return run<SmootherOps<T, LDV>, T>(el, off, n, S, 1, k, s);
  }
  Arrays<T> off{{scratch, scratch + nb * kk, scratch + nb * (kk + k),
                 scratch + nb * (2 * kk + k), scratch + nb * (2 * kk + 2 * k)}};
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

extern "C" {
#if DFM_WANT_F32
int pit_scan_f32(int smoother, float* e0, float* e1, float* e2, float* e3,
                 float* e4, float* scratch, int n, int S, int k,
                 void* stream) {
  return launch<float>(smoother, e0, e1, e2, e3, e4, scratch, n, S, k,
                       (cudaStream_t)stream);
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
}
