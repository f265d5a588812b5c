// K14-assoc and K8-assoc: the log-depth associative scans of the two
// parallel-in-time engines (pit and pit_qr), scan_impl="associative".
//
// Replace lax.associative_scan in dfm_tpu/ssm/parallel_filter.py: the
// filter's inclusive prefix of _combine_filter (combine 109, in
// pit_from_stats 161), the smoother's inclusive suffix of _combine_smoother
// (217, in pit_smoother 243), and the square-root engine's of
// qr_combine_filter (395, pit_qr_from_stats 457) and qr_combine_smoother
// (497, pit_qr_smoother 549).  The tree is lax.associative_scan's (jax
// 0.9.0, jax/_src/lax/control_flow/loops.py:2705 _scan), which the plain
// twin ops/scan.py:associative_scan repeats, so kernel and twin associate
// identically.  Level 0 is the n elements, in reverse order for the
// smoother, whose combine takes (later, earlier) as the JAX package's
// reverse scan calls it; level l + 1 holds the m = floor(n_l / 2) pair
// products
//   up:    X_{l+1}[i] = combine(X_l[2i], X_l[2i+1]),            i < m,
// until a level of one element, whose scan is the element itself; then,
// from the top down, X_{l+1} being scanned,
//   down:  X_l[2i+1] = X_{l+1}[i];  X_l[2i+2] = combine(X_{l+1}[i],
//          X_l[2i+2]) where 2i + 2 < n_l,                         i < m,
// in place (X_l[0] is its own prefix).  One launch a level each way: a
// pass is 2L launches, L = floor(log2 n) (18 at n = 500), counted as one
// call; the levels above 0 live in a workspace the wrapper allocates
// (fewer than n elements in all).  The combine bodies are the blocked
// scans' (pit_combine.cuh, qr_combine.cuh), addressed by (arrays, index):
//   pit_assoc      k <= 32: FilterOps / SmootherOps, one warp a combine,
//                  the working set in dynamic shared memory at a leading
//                  dimension of 17 (k <= 16) or 33; a CTA an item;
//   pit_assoc_gen  32 < k <= 128: filter_combine_gen / smoother_combine_gen,
//                  a CTA of GEN_THREADS a combine on a persistent grid of at
//                  most ``ctas`` CTAs, each with GenCta's workspace;
//   qr_assoc       k <= 10: the one-thread combines, a thread an item;
//   qr_assoc_gen   10 < k <= 128: qr_filter_combine_gen /
//                  qr_smoother_combine_gen, as pit_assoc_gen with QsgCta's
//                  workspace.
// Bound on the H100: the 2L levels in sequence, each at least one
// combine's latency chain (a warp's, a CTA's or a thread's); the levels
// near the top hold fewer items than the card has SMs.  The work is ~2n
// combines (the blocked scan's ~2n too, but ~2 sqrt(n) of them in
// sequence); the bytes (each element read and written a few times, mostly
// from L2) and the operations are far below the chain at these shapes.
// Design: no new arithmetic, the JAX tree level by level, each level's
// combines independent.
#include "pit_combine.cuh"
#include "qr_combine.cuh"

constexpr int QA_THREADS = 64;
// Levels of a tree over at most 2^31 elements, level 0 included.
constexpr int MAX_LEVELS = 33;

// Physical slot of element i of a level of n elements (level 0 reversed
// for the smoother; the workspace levels in order).
__device__ __forceinline__ size_t lvl_at(int i, int n, int reverse) {
  return (size_t)(reverse ? n - 1 - i : i);
}

// One step of the tree: the level below (``lo``: n_lo elements, reversed
// if rev_lo) and the level above (``hi``: m = n_lo / 2 elements).
template <typename T>
struct Level {
  Arrays<T> lo, hi;
  int n_lo, rev_lo, m;
};

// Element si of s into slot di of d: ``narr`` arrays (the even ones k x
// k, the odd ones k-vectors), threads ``lane`` of ``nl``.
template <typename T>
__device__ void copy_elem(const Arrays<T>& d, size_t di, const Arrays<T>& s,
                          size_t si, int k, int narr, int lane, int nl) {
  for (int a = 0; a < narr; ++a) {
    const size_t len = (a % 2 == 0) ? (size_t)k * k : (size_t)k;
    for (size_t e = lane; e < len; e += nl)
      d.p[a][di * len + e] = s.p[a][si * len + e];
  }
}

// k <= 32: a warp a combine (a CTA an item of the level).
template <typename Ops, typename T>
__global__ void __launch_bounds__(32)
assoc_warp_kernel(Level<T> lv, int down, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ops w(reinterpret_cast<T*>(smem_raw), k);
  const int i = blockIdx.x;
  if (i >= lv.m) return;
  if (!down) {
    w.load(lv.lo, lvl_at(2 * i, lv.n_lo, lv.rev_lo), false);
    w.load(lv.lo, lvl_at(2 * i + 1, lv.n_lo, lv.rev_lo), true);
    w.combine();
    w.store(lv.hi, (size_t)i);
    return;
  }
  copy_elem(lv.lo, lvl_at(2 * i + 1, lv.n_lo, lv.rev_lo), lv.hi, (size_t)i,
            k, Ops::NARR, warp_lane(), 32);
  if (2 * i + 2 >= lv.n_lo) return;
  const size_t o = lvl_at(2 * i + 2, lv.n_lo, lv.rev_lo);
  w.load(lv.hi, (size_t)i, false);
  w.load(lv.lo, o, true);
  w.combine();
  w.store(lv.lo, o);
}

// The generic combines by workspace type: K14's (GenCta) or K8's (QsgCta).
template <typename T, bool SMOOTH>
__device__ __forceinline__ void gen_combine(const Arrays<T>& ea, size_t ia,
                                            const Arrays<T>& eb, size_t ib,
                                            const Arrays<T>& eo, size_t io,
                                            const GenCta<T>& g) {
  combine_gen<T, SMOOTH>(ea, ia, eb, ib, eo, io, g);
}
template <typename T, bool SMOOTH>
__device__ __forceinline__ void gen_combine(const Arrays<T>& ea, size_t ia,
                                            const Arrays<T>& eb, size_t ib,
                                            const Arrays<T>& eo, size_t io,
                                            const QsgCta<T>& g) {
  qcombine_gen<T, SMOOTH>(ea, ia, eb, ib, eo, io, g);
}

// Past the warp and one-thread tiers: a CTA a combine, each CTA looping
// over the level's items.  The output of a down combine is its second
// operand's slot, which both generic bodies allow.
template <typename T, bool SMOOTH, typename Cta>
__global__ void __launch_bounds__(GEN_THREADS)
assoc_gen_kernel(Level<T> lv, int down, T* work, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cta g(smem_raw, work, k);
  for (int i = blockIdx.x; i < lv.m; i += gridDim.x) {
    if (!down) {
      gen_combine<T, SMOOTH>(lv.lo, lvl_at(2 * i, lv.n_lo, lv.rev_lo), lv.lo,
                             lvl_at(2 * i + 1, lv.n_lo, lv.rev_lo), lv.hi,
                             (size_t)i, g);
      continue;
    }
    copy_elem(lv.lo, lvl_at(2 * i + 1, lv.n_lo, lv.rev_lo), lv.hi,
              (size_t)i, k, SMOOTH ? 3 : 5, (int)threadIdx.x, GEN_THREADS);
    if (2 * i + 2 < lv.n_lo) {
      const size_t o = lvl_at(2 * i + 2, lv.n_lo, lv.rev_lo);
      gen_combine<T, SMOOTH>(lv.hi, (size_t)i, lv.lo, o, lv.lo, o, g);
    }
  }
}

// k <= 10, square-root engine: a thread a combine on its own elements.
template <typename T, int K, typename Elem>
__global__ void __launch_bounds__(QA_THREADS)
assoc_qr_kernel(Level<T> lv, int down) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lv.m) return;
  Elem a, b, o;
  if (!down) {
    load(lv.lo, (int)lvl_at(2 * i, lv.n_lo, lv.rev_lo), a);
    load(lv.lo, (int)lvl_at(2 * i + 1, lv.n_lo, lv.rev_lo), b);
    combine(a, b, o);
    store(lv.hi, i, o);
    return;
  }
  load(lv.hi, i, a);
  store(lv.lo, (int)lvl_at(2 * i + 1, lv.n_lo, lv.rev_lo), a);
  if (2 * i + 2 >= lv.n_lo) return;
  const int oi = (int)lvl_at(2 * i + 2, lv.n_lo, lv.rev_lo);
  load(lv.lo, oi, b);
  combine(a, b, o);
  store(lv.lo, oi, o);
}

// Element arrays of a workspace level of m elements at ``base``, laid out
// as the blocked scans' block totals.
template <typename T>
static Arrays<T> level_arrays(T* base, size_t m, int k, int narr) {
  const size_t kk = (size_t)k * k;
  Arrays<T> a{{base, base + m * kk, base + m * (kk + k), nullptr, nullptr}};
  if (narr == 5) {
    a.p[3] = base + m * (2 * kk + k);
    a.p[4] = base + m * (2 * kk + 2 * k);
  }
  return a;
}

// The whole pass: the tree's levels (n_0 = n, n_{l+1} = n_l / 2 while n_l
// >= 2; the workspace ``levels`` holds levels 1..L back to back, as
// ssm/parallel_filter.py:_assoc_levels sizes it), then ``go(level,
// down)`` for each up step and each down step in order.
template <typename T, typename Go>
static int run_tree(Arrays<T> el, T* levels, int n, int k, int narr,
                    int reverse, Go go) {
  int sizes[MAX_LEVELS];
  Arrays<T> arr[MAX_LEVELS];
  int L = 0;
  sizes[0] = n;
  arr[0] = el;
  const size_t per = narr == 5 ? 3 * (size_t)k * k + 2 * (size_t)k
                               : 2 * (size_t)k * k + (size_t)k;
  T* base = levels;
  while (sizes[L] >= 2) {
    sizes[L + 1] = sizes[L] / 2;
    arr[L + 1] = level_arrays<T>(base, (size_t)sizes[L + 1], k, narr);
    base += per * sizes[L + 1];
    ++L;
  }
  cudaError_t err;
  for (int l = 0; l < L; ++l) {
    const Level<T> lv{arr[l], arr[l + 1], sizes[l], l == 0 ? reverse : 0,
                      sizes[l + 1]};
    if ((err = go(lv, 0)) != cudaSuccess) return (int)err;
  }
  for (int l = L - 1; l >= 0; --l) {
    const Level<T> lv{arr[l], arr[l + 1], sizes[l], l == 0 ? reverse : 0,
                      sizes[l + 1]};
    if ((err = go(lv, 1)) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename Ops, typename T>
static int run_warp(Arrays<T> el, T* levels, int n, int k, int reverse,
                    cudaStream_t s) {
  const size_t bytes = Ops::smem(k);
  cudaError_t err = dfm_smem_optin(assoc_warp_kernel<Ops, T>, bytes);
  if (err != cudaSuccess) return (int)err;
  return run_tree<T>(el, levels, n, k, Ops::NARR, reverse,
                     [&](const Level<T>& lv, int down) -> cudaError_t {
                       assoc_warp_kernel<Ops, T><<<lv.m, 32, bytes, s>>>(
                           lv, down, k);
                       return cudaGetLastError();
                     });
}

template <typename T, int LDV>
static int run_warp_ld(int smoother, Arrays<T> el, T* levels, int n, int k,
                       cudaStream_t s) {
  if (smoother)
    return run_warp<SmootherOps<T, LDV>, T>(el, levels, n, k, 1, s);
  return run_warp<FilterOps<T, LDV>, T>(el, levels, n, k, 0, s);
}

// 1 <= k <= DFM_WIDE_KMAX.
template <typename T>
static int launch_pit(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                      T* levels, int n, int k, cudaStream_t s) {
  if (n < 1 || k < 1 || k > DFM_WIDE_KMAX) return (int)cudaErrorInvalidValue;
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  if (k <= DFM_KMAX) return run_warp_ld<T, LD>(smoother, el, levels, n, k, s);
  return run_warp_ld<T, WIDE_LD>(smoother, el, levels, n, k, s);
}

template <typename T, bool SMOOTH, typename Cta>
static int run_gen(Arrays<T> el, T* levels, T* work, int n, int k, int ctas,
                   cudaStream_t s) {
  const size_t bytes = Cta::bytes(k);
  cudaError_t err = dfm_smem_optin(assoc_gen_kernel<T, SMOOTH, Cta>, bytes);
  if (err != cudaSuccess) return (int)err;
  return run_tree<T>(el, levels, n, k, SMOOTH ? 3 : 5, SMOOTH ? 1 : 0,
                     [&](const Level<T>& lv, int down) -> cudaError_t {
                       const int grid = lv.m < ctas ? lv.m : ctas;
                       assoc_gen_kernel<T, SMOOTH, Cta>
                           <<<grid, GEN_THREADS, bytes, s>>>(lv, down, work,
                                                             k);
                       return cudaGetLastError();
                     });
}

// 1 <= k <= DFM_GEN_KMAX; ``work`` holds ctas x GEN_MATS k x k matrices.
template <typename T>
static int launch_pit_gen(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                          T* levels, T* work, int n, int k, int ctas,
                          cudaStream_t s) {
  if (n < 1 || k < 1 || k > DFM_GEN_KMAX || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  if (smoother)
    return run_gen<T, true, GenCta<T>>(el, levels, work, n, k, ctas, s);
  return run_gen<T, false, GenCta<T>>(el, levels, work, n, k, ctas, s);
}

// 4 <= k <= DFM_GEN_KMAX (the row vectors of the last workspace matrix);
// ``work`` holds ctas x QR_SCAN_MATS k x k matrices.
template <typename T>
static int launch_qr_gen(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                         T* levels, T* work, int n, int k, int ctas,
                         cudaStream_t s) {
  if (n < 1 || k < 4 || k > DFM_GEN_KMAX || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  if (smoother)
    return run_gen<T, true, QsgCta<T>>(el, levels, work, n, k, ctas, s);
  return run_gen<T, false, QsgCta<T>>(el, levels, work, n, k, ctas, s);
}

template <typename T, int K, typename Elem>
static int run_qr(Arrays<T> el, T* levels, int n, int narr, int reverse,
                  cudaStream_t s) {
  return run_tree<T>(el, levels, n, K, narr, reverse,
                     [&](const Level<T>& lv, int down) -> cudaError_t {
                       assoc_qr_kernel<T, K, Elem>
                           <<<(lv.m + QA_THREADS - 1) / QA_THREADS,
                              QA_THREADS, 0, s>>>(lv, down);
                       return cudaGetLastError();
                     });
}

// 1 <= k <= DFM_QR_KMAX.
template <typename T>
static int launch_qr(int smoother, T* e0, T* e1, T* e2, T* e3, T* e4,
                     T* levels, int n, int k, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Arrays<T> el{{e0, e1, e2, e3, e4}};
  if (smoother) {
    DFM_DISPATCH_QR_K(k, return run_qr<T, K, SElem<T, K>>(el, levels, n, 3,
                                                          1, s))
  } else {
    DFM_DISPATCH_QR_K(k, return run_qr<T, K, FElem<T, K>>(el, levels, n, 5,
                                                          0, s))
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {
#if DFM_WANT_F32
int pit_assoc_f32(int smoother, float* e0, float* e1, float* e2, float* e3,
                  float* e4, float* levels, int n, int k, void* stream) {
  return launch_pit<float>(smoother, e0, e1, e2, e3, e4, levels, n, k,
                           (cudaStream_t)stream);
}
int pit_assoc_gen_f32(int smoother, float* e0, float* e1, float* e2,
                      float* e3, float* e4, float* levels, float* work, int n,
                      int k, int ctas, void* stream) {
  return launch_pit_gen<float>(smoother, e0, e1, e2, e3, e4, levels, work, n,
                               k, ctas, (cudaStream_t)stream);
}
int qr_assoc_f32(int smoother, float* e0, float* e1, float* e2, float* e3,
                 float* e4, float* levels, int n, int k, void* stream) {
  return launch_qr<float>(smoother, e0, e1, e2, e3, e4, levels, n, k,
                          (cudaStream_t)stream);
}
int qr_assoc_gen_f32(int smoother, float* e0, float* e1, float* e2,
                     float* e3, float* e4, float* levels, float* work, int n,
                     int k, int ctas, void* stream) {
  return launch_qr_gen<float>(smoother, e0, e1, e2, e3, e4, levels, work, n,
                              k, ctas, (cudaStream_t)stream);
}
#endif
#if DFM_WANT_F64
int pit_assoc_f64(int smoother, double* e0, double* e1, double* e2,
                  double* e3, double* e4, double* levels, int n, int k,
                  void* stream) {
  return launch_pit<double>(smoother, e0, e1, e2, e3, e4, levels, n, k,
                            (cudaStream_t)stream);
}
int pit_assoc_gen_f64(int smoother, double* e0, double* e1, double* e2,
                      double* e3, double* e4, double* levels, double* work,
                      int n, int k, int ctas, void* stream) {
  return launch_pit_gen<double>(smoother, e0, e1, e2, e3, e4, levels, work,
                                n, k, ctas, (cudaStream_t)stream);
}
int qr_assoc_f64(int smoother, double* e0, double* e1, double* e2,
                 double* e3, double* e4, double* levels, int n, int k,
                 void* stream) {
  return launch_qr<double>(smoother, e0, e1, e2, e3, e4, levels, n, k,
                           (cudaStream_t)stream);
}
int qr_assoc_gen_f64(int smoother, double* e0, double* e1, double* e2,
                     double* e3, double* e4, double* levels, double* work,
                     int n, int k, int ctas, void* stream) {
  return launch_qr_gen<double>(smoother, e0, e1, e2, e3, e4, levels, work,
                               n, k, ctas, (cudaStream_t)stream);
}
#endif
}
