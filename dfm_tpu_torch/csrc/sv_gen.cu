// K10 past its own kernels' range: the RBPF pass (sv_rbpf_gen) and the
// backward sampler (sv_ffbs_gen) of the stochastic-volatility family at
// any k <= DFM_GEN_KMAX = 128 and any particle count M, k and M runtime
// values (one instantiation a dtype).  The wrappers take them past k = 16
// and, at any k, past 1,024 particles; below both, sv_rbpf.cu's kernels.
//
// K10-fwd-gen (sv_rbpf_gen) computes what sv_rbpf does
// (dfm_tpu/models/sv.py:_rbpf_scan, line 103, the step :128-206, with
// _systematic_indices :92), in the arithmetic of the JAX batched branch
// past UNROLL_K_MAX (jnp.linalg.cholesky, cho_solve, :144-155):
//   h += sigma_h xi_t;  x_p = A x;  P_p = A P A' + diag(exp h)
//   Lp = chol(sym(P_p) + 1e-6 I);  G = I + Lp' C Lp (symmetrized above
//   k = 8, as jnp.linalg.cholesky's input);  Lg = chol(G)
//   Xs = G^{-1} Lp' (cho_solve);  P_f = sym(Lp Xs);  log|G| = 2 sum log
//   diag Lg;  the residual or expanded quad;  x_f = x_p + P_f u
//   lw = -(log|G| + quad) / 2;  log-sum-exp, ESS, the resampling decision
//   and systematic indices (searchsorted side 'left', clipped) on the
//   device; the gather of (x_f, P_f, h); the weighted means.
// K10-ffbs-gen (sv_ffbs_gen) computes _ffbs_impl (:296-319): Gumbel-max
// backward draws, argmax taking the lowest index on ties.
//
// As sv_rbpf.cu: one C call enqueues a whole pass (one LAUNCHES count), no
// float atomics, every sum in a fixed order, so two runs on the same draws
// agree bit for bit.
//
// Design.  The per-particle k x k chain runs on a grid over particles, a
// block a particle: G groups of 32 ceil(k / 32) threads (at most 128
// threads, svg_groups), thread (g, j) owning column j of three k x k work
// matrices at a leading dimension of k | 1 in shared memory (f32 to k =
// 128, f64 to k = 97; past that a global workspace and a persistent grid
// of ``slots`` blocks, svg_slots), as K11-bwd-gen (tv_loadings.cu):
// Cholesky-Crout a column a barrier and the column solves on group 0, the
// products a thread a column over four rows, the groups splitting the
// rows.  A step t is five kernels:
//   1. (residual form) svg_residual_kernel, a grid over series chunks x
//      tiles of SVG_PT particles: v = y_t - Lam x_p and v / R for a
//      SVG_PT x SVG_NS tile at a time (x_p of the tile and SVG_NS rows of
//      Lam in shared memory), u = Lam' R^{-1} v and c2 = v' R^{-1} v (f64)
//      accumulated over the chunk's series in registers; one partial a
//      chunk, (chunks, M, k) and (chunks, M);
//   2. svg_update_kernel, a block a particle: the partials summed in chunk
//      order (or the expanded u = b_t - C x_p), P_f u, quad, x_f, the
//      weight increment and tot = logW + lw;
//   3. svg_scalar_kernel, one block looping over the particles (O(M)
//      scalar work): log-sum-exp, ESS, the decision, then a scan of W over
//      contiguous segments a thread, the normalized cumsum in the state
//      buffer, a binary search a position;
//   4. svg_means_kernel: W'x_f and W'h of the gathered particles, a lane a
//      column of [x_f | h], the warps over the particles in a fixed order;
//   5. svg_predict_kernel, a block a particle: the gather (x_f, P_f, h of
//      idx_m when the step resampled), h_hist, the walk into t + 1 and the
//      prediction of t + 1 (x_p, P_f, log|G|).  P_f and h are double
//      buffered, so a gather never reads a particle rewritten that step.
// An init launch of svg_predict_kernel draws h_0, walks step 0 and
// predicts it from (mu0, P0).
//
// Bound on the H100 (the operations the step needs, each symmetric result
// counted over one triangle; chip_smoke.k10_flops counts the same): the
// prediction 23/3 k^3 + 10 k^2 a particle and step (A P 2 k^3 and the
// lower half of (A P) A' k^3; two Cholesky factors 2/3 k^3; C Lp over
// Lp's triangle k^3 and the lower half of Lp' (C Lp) k^3 / 3; the two
// triangular solves of G^{-1} Lp' 2 k^3; the lower half of Lp Xs 2/3
// k^3), the update 2 k^2 + 5 k (expanded 4 k^2 + 9 k), the means 4 k, the
// residual stage (4 k + 3) N: at S5's T = 1,000, N = 10,000 and M = 256
// in f32, 4.42 ms at k = 25 and 11.53 ms at k = 50 (PERF.md); the kernel
// itself does 29/3 k^3 in the prediction, the products (A P) A', Lp' (C
// Lp) and Lp Xs whole.  K10-ffbs-gen reads the Gumbels (T S M) and the
// history (T M k) once.
#include "common.cuh"

constexpr int SVG_PT = 64;      // particles of a residual block
constexpr int SVG_NS = 32;      // series of a residual sub-tile, a lane each
constexpr int SVG_RT = 256;     // threads of a residual block: 8 x 8 particles
constexpr int SVG_RBLOCKS = 8;  // residual blocks an SM the chunking aims at
constexpr int SVG_SMALLK = 8;   // to this k a lane a (particle, column) of u
constexpr int SVG_NT = 1024;    // threads of the scalar stage and the means
constexpr int SVG_DRAWS = 4;    // FFBS draws a block
constexpr int SVG_FT = 256;     // threads of an FFBS block
constexpr size_t SVG_SMEM_MAX = 232448;   // a block's dynamic shared bytes
constexpr int SVG_SLOTS_PER_SM = 4;       // workspace particles an SM

__device__ __forceinline__ float svg_exp(float x) { return expf(x); }
__device__ __forceinline__ double svg_exp(double x) { return exp(x); }
__device__ __forceinline__ float svg_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double svg_max(double a, double b) { return fmax(a, b); }

// The particle state between stages, in the wrapper's scratch buffers:
// x_p, x_f (M, k), the two h buffers (2, M, k), log|G|, logW, tot and the
// normalized cumsum (M each) in ``base``; the resampling flag and the
// indices (1 + M ints) in ``ibase``.
template <typename T>
struct SvgState {
  T *xp, *xf, *h, *ldG, *logW, *tot, *cum;
  int *flag, *idx;
};

template <typename T>
static SvgState<T> svg_state(T* base, int* ibase, int M, int k) {
  const size_t mk = (size_t)M * k;
  SvgState<T> s;
  s.xp = base;
  s.xf = s.xp + mk;
  s.h = s.xf + mk;
  s.ldG = s.h + 2 * mk;
  s.logW = s.ldG + M;
  s.tot = s.logW + M;
  s.cum = s.tot + M;
  s.flag = ibase;
  s.idx = ibase + 1;
  return s;
}

// Block-wide sum and max in a fixed order (a butterfly in each warp, every
// thread adding the warps' results in order), the result in every thread.
// red holds blockDim.x / 32 values; every thread must call them.
template <typename A>
__device__ A svg_block_sum(A v, A* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                    // red's last readers are done
  if (lane == 0) red[wid] = v;
  __syncthreads();
  A s = A(0);
  for (int q = 0; q < nw; ++q) s += red[q];
  return s;
}

template <typename A>
__device__ A svg_block_max(A v, A* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = svg_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  A s = red[0];
  for (int q = 1; q < nw; ++q) s = svg_max(s, red[q]);
  return s;
}

// Inclusive prefix sum over the block in thread order; ws holds 32 values.
template <typename A>
__device__ A svg_block_scan(A v, A* ws) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const A n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();
  if (lane == 31) ws[wid] = v;
  __syncthreads();
  if (wid == 0) {
    A w = lane < nw ? ws[lane] : A(0);
    for (int o = 1; o < 32; o <<= 1) {
      const A n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < nw) ws[lane] = w;
  }
  __syncthreads();
  if (wid > 0) v += ws[wid - 1];
  return v;
}

// ---------------------------------------------------------------------------
// Stage 1 (residual form): partial c2 and u over a chunk of nsc series.
// ---------------------------------------------------------------------------

template <typename T>
static size_t svg_residual_smem(int k) {
  return sizeof(T) * ((size_t)(SVG_PT + SVG_NS) * (k | 1) +
                      (size_t)SVG_PT * (SVG_NS + 1) + 2 * SVG_NS);
}

// Block (chunk, particle tile): thread (g, lane) forms v and v / R of
// series lane for the particles 8 g .. 8 g + 7 of the tile, then u for
// those particles at the columns lane + 32 q (to k = SVG_SMALLK, the
// warp's 8 k entries of u a lane each, o = lane + 32 q: particle o / k,
// column o % k, so no lane idles; the same sums in the same order).  c2p
// (chunks, M) in f64, up (chunks, M, k).
template <typename T>
__global__ void __launch_bounds__(SVG_RT)
svg_residual_kernel(const T* __restrict__ Y, const T* __restrict__ Lam,
                    const T* __restrict__ R, const T* __restrict__ xp,
                    double* __restrict__ c2p, T* __restrict__ up, int t,
                    int N, int M, int k, int nsc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = k | 1;
  T* xs = reinterpret_cast<T*>(smem_raw);            // SVG_PT x ldk
  T* ls = xs + (size_t)SVG_PT * ldk;                 // SVG_NS x ldk
  T* vr = ls + (size_t)SVG_NS * ldk;                 // SVG_PT x (SVG_NS + 1)
  T* ys = vr + SVG_PT * (SVG_NS + 1);                // SVG_NS
  T* rs = ys + SVG_NS;                               // SVG_NS
  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int p0 = blockIdx.y * SVG_PT, np = min(SVG_PT, M - p0);
  const int chunk = blockIdx.x;
  const int n0 = chunk * nsc, n1 = min(N, n0 + nsc);
  for (int e = tid; e < SVG_PT * k; e += SVG_RT) {
    const int p = e / k, j = e - p * k;
    xs[p * ldk + j] = p < np ? xp[(size_t)(p0 + p) * k + j] : T(0);
  }
  T u[8][4];
  double c2[8];
#pragma unroll
  for (int pp = 0; pp < 8; ++pp) {
    c2[pp] = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) u[pp][q] = T(0);
  }
  for (int s0 = n0; s0 < n1; s0 += SVG_NS) {
    const int ns = min(SVG_NS, n1 - s0);
    __syncthreads();                  // the last sub-tile's reads are done
    for (int e = tid; e < ns * k; e += SVG_RT) {
      const int n = e / k, j = e - n * k;
      ls[n * ldk + j] = Lam[(size_t)(s0 + n) * k + j];
    }
    if (tid < ns) {
      ys[tid] = Y[(size_t)t * N + s0 + tid];
      rs[tid] = T(1) / R[s0 + tid];
    }
    __syncthreads();
    T fit[8];
#pragma unroll
    for (int pp = 0; pp < 8; ++pp) fit[pp] = T(0);
    if (lane < ns) {
      const T* ln = ls + lane * ldk;
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        const T l = ln[j];
#pragma unroll
        for (int pp = 0; pp < 8; ++pp)
          fit[pp] += xs[(grp * 8 + pp) * ldk + j] * l;
      }
    }
#pragma unroll
    for (int pp = 0; pp < 8; ++pp) {
      T r = T(0);
      if (lane < ns) {
        const T v = ys[lane] - fit[pp];
        r = v * rs[lane];
        c2[pp] += (double)(v * r);
      }
      vr[(grp * 8 + pp) * (SVG_NS + 1) + lane] = r;
    }
    __syncthreads();
    if (k <= SVG_SMALLK) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int o = lane + 32 * q;
        if (o < 8 * k) {
          const int pp = o / k, j = o - pp * k;
          const T* v = vr + (grp * 8 + pp) * (SVG_NS + 1);
#pragma unroll 4
          for (int n = 0; n < ns; ++n) u[0][q] += v[n] * ls[n * ldk + j];
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = lane + 32 * q;
        if (j < k) {
#pragma unroll 4
          for (int n = 0; n < ns; ++n) {
            const T l = ls[n * ldk + j];
#pragma unroll
            for (int pp = 0; pp < 8; ++pp)
              u[pp][q] += vr[(grp * 8 + pp) * (SVG_NS + 1) + n] * l;
          }
        }
      }
    }
  }
#pragma unroll
  for (int pp = 0; pp < 8; ++pp) {
    double s = c2[pp];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int p = grp * 8 + pp;
    if (lane == 0 && p < np) c2p[(size_t)chunk * M + p0 + p] = s;
  }
  if (k <= SVG_SMALLK) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int o = lane + 32 * q;
      const int p = grp * 8 + o / k, j = o % k;
      if (o < 8 * k && p < np)
        up[((size_t)chunk * M + p0 + p) * k + j] = u[0][q];
    }
    return;
  }
#pragma unroll
  for (int pp = 0; pp < 8; ++pp) {
    const int p = grp * 8 + pp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = lane + 32 * q;
      if (p < np && j < k)
        up[((size_t)chunk * M + p0 + p) * k + j] = u[pp][q];
    }
  }
}

// ---------------------------------------------------------------------------
// Stage 2: a block a particle, thread i owning row i.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(DFM_GEN_KMAX)
svg_update_kernel(const T* __restrict__ B, const T* __restrict__ C,
                  const double* __restrict__ c2p, const T* __restrict__ up,
                  int chunks, SvgState<T> st, const T* __restrict__ Pf,
                  int t, int M, int k, int residual) {
  __shared__ T us[DFM_GEN_KMAX];
  __shared__ T red[DFM_GEN_KMAX / 32];
  __shared__ double red2[DFM_GEN_KMAX / 32];
  const int m = blockIdx.x, i = threadIdx.x;
  const bool row = i < k;
  const T* xp = st.xp + (size_t)m * k;
  T xpi = T(0), ui = T(0), cx = T(0), b = T(0);
  if (row) {
    xpi = xp[i];
    if (residual) {
#pragma unroll 8
      for (int ch = 0; ch < chunks; ++ch)
        ui += up[((size_t)ch * M + m) * k + i];
    } else {
      for (int j = 0; j < k; ++j) cx += C[(size_t)i * k + j] * xp[j];
      b = B[(size_t)t * k + i];
      ui = b - cx;
    }
    us[i] = ui;
  }
  double c2 = 0.0;
  if (residual) {
    for (int ch = i; ch < chunks; ch += blockDim.x)
      c2 += c2p[(size_t)ch * M + m];
    c2 = svg_block_sum(c2, red2);
  }
  __syncthreads();                    // u
  T pu = T(0);
  if (row) {
    // P_f is exactly symmetric (a sym), so row i is column i.
    const T* P = Pf + (size_t)m * k * k;
#pragma unroll 8
    for (int j = 0; j < k; ++j) pu += P[(size_t)j * k + i] * us[j];
    st.xf[(size_t)m * k + i] = xpi + pu;
  }
  const T upu = svg_block_sum(pu * ui, red);
  T quad;
  if (residual) {
    quad = (T)(c2 - (double)upu);
  } else {
    const T xb = svg_block_sum(xpi * b, red);
    const T xcx = svg_block_sum(cx * xpi, red);
    quad = T(-2) * xb + xcx - upu;
  }
  if (i == 0) st.tot[m] = st.logW[m] + T(-0.5) * (st.ldG[m] + quad);
}

// ---------------------------------------------------------------------------
// Stage 3: one block, the threads looping over the particles.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(SVG_NT)
svg_scalar_kernel(SvgState<T> st, const T* __restrict__ u_draw,
                  T* __restrict__ ll_out, T* __restrict__ ess_out,
                  int* __restrict__ n_rs, T* __restrict__ logw_hist, int t,
                  int M, T thr, T logW0) {
  __shared__ T red[SVG_NT / 32];
  __shared__ T scan[SVG_NT];
  const int nt = blockDim.x, tid = threadIdx.x;
  T mx = -(T)INFINITY;
  for (int m = tid; m < M; m += nt) mx = svg_max(mx, st.tot[m]);
  mx = svg_block_max(mx, red);
  T se = T(0);
  for (int m = tid; m < M; m += nt) se += svg_exp(st.tot[m] - mx);
  const T ll = mx + dfm_log(svg_block_sum(se, red));
  T e2 = T(0);
  for (int m = tid; m < M; m += nt) {
    const T lw = st.tot[m] - ll;
    st.logW[m] = lw;
    e2 += svg_exp(T(2) * lw);
  }
  const T ess = T(1) / svg_block_sum(e2, red);
  const bool rs = ess < thr;          // block-uniform
  if (tid == 0) {
    ll_out[t] = ll;
    ess_out[t] = ess;
    *st.flag = rs ? 1 : 0;
    if (rs) *n_rs += 1;
  }
  if (rs) {
    // cumsum of W over contiguous segments a thread, normalized by its
    // last entry; then index m = the first i with cum_i >= (m + u_t) / M.
    const int seg = (M + nt - 1) / nt;
    const int a = min(M, tid * seg), e = min(M, a + seg);
    T s = T(0);
    for (int m = a; m < e; ++m) {
      s += svg_exp(st.logW[m]);
      st.cum[m] = s;
    }
    scan[tid] = svg_block_scan(s, red);
    __syncthreads();
    const T off = tid > 0 ? scan[tid - 1] : T(0);
    for (int m = a; m < e; ++m) st.cum[m] = off + st.cum[m];
    __syncthreads();
    const T total = st.cum[M - 1];
    __syncthreads();
    for (int m = a; m < e; ++m) st.cum[m] = st.cum[m] / total;
    __syncthreads();
    const T uu = u_draw[t];
    for (int m = tid; m < M; m += nt) {
      const T pos = (T(m) + uu) / T(M);
      int lo = 0, hi = M;                       // searchsorted, side 'left'
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (st.cum[mid] < pos) lo = mid + 1;
        else hi = mid;
      }
      st.idx[m] = min(lo, M - 1);
      st.logW[m] = logW0;
    }
  }
  if (logw_hist)
    for (int m = tid; m < M; m += nt)
      logw_hist[(size_t)t * M + m] = st.logW[m];
}

// ---------------------------------------------------------------------------
// Stage 4: W'x_f and W'h of the gathered particles, a lane a column of
// [x_f | h] (32 columns a block), warp w summing the particles w + q nw in
// order, then the warps' sums in order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(SVG_NT)
svg_means_kernel(SvgState<T> st, const T* __restrict__ hc,
                 T* __restrict__ f_mean, T* __restrict__ h_mean, int t,
                 int M, int k) {
  __shared__ T part[SVG_NT / 32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool rs = *st.flag != 0;
  T s = T(0);
  if (c < 2 * k) {
    for (int m = w; m < M; m += nw) {
      const int g = rs ? st.idx[m] : m;
      const T v = c < k ? st.xf[(size_t)g * k + c]
                        : hc[(size_t)g * k + c - k];
      s += svg_exp(st.logW[m]) * v;
    }
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < 2 * k) {
    T a = T(0);
    for (int q = 0; q < nw; ++q) a += part[q][lane];
    if (c < k) f_mean[(size_t)t * k + c] = a;
    else h_mean[(size_t)t * k + c - k] = a;
  }
}

// ---------------------------------------------------------------------------
// Stage 5: the gather, the walk and the prediction, a block a particle.
// ---------------------------------------------------------------------------

// C[i][j] = sum_l A[i][l] op(B)(l, j) for the column j < k of thread (g,
// j), op(B)(l, j) = TB ? B[j][l] : B[l][j], four rows at once, the row
// blocks 4 g + 4 G q (G groups); every matrix k x k at ld.  The row
// operand is a broadcast, the column one a conflict-free read (ld odd).
template <typename T, bool TB>
__device__ __forceinline__ void svg_mm(T* Cm, const T* Am, const T* Bm,
                                       int ld, int k, int j, int g, int G) {
  if (j >= k) return;
  for (int i0 = 4 * g; i0 < k; i0 += 4 * G) {
    const int nr = min(4, k - i0);
    T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
    for (int l = 0; l < k; ++l) {
      const T b = TB ? Bm[j * ld + l] : Bm[l * ld + j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < nr) s[r] += Am[(i0 + r) * ld + l] * b;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < nr) Cm[(i0 + r) * ld + j] = s[r];
  }
}

// L L' = S + jit I from the lower triangle of S (k x k at ld), in place:
// L's strict lower triangle over S's, its diagonal in dg.  A column a
// barrier, thread j of group 0 forming row j's entry by dot products of
// rows (Cholesky-Crout): every thread forms the pivot from S[c][c], which
// stays in place, so a column needs one barrier.  No clamp: an indefinite
// pivot gives NaN, as jnp.linalg.cholesky.  Every thread of the block must
// call it; it ends with a barrier.
template <typename T>
__device__ __forceinline__ void svg_crout(T* S, T* dg, T jit, int ld,
                                          int k, int j, int g) {
  for (int c = 0; c < k; ++c) {
    if (g == 0 && j < k && j >= c) {
      T d0 = S[c * ld + c] + jit, d1 = T(0);
      T s0 = S[j * ld + c], s1 = T(0);
      int m = 0;
#pragma unroll 4
      for (; m + 2 <= c; m += 2) {
        const T a0 = S[c * ld + m], a1 = S[c * ld + m + 1];
        d0 -= a0 * a0;
        d1 -= a1 * a1;
        s0 -= S[j * ld + m] * a0;
        s1 -= S[j * ld + m + 1] * a1;
      }
      if (m < c) {
        const T a0 = S[c * ld + m];
        d0 -= a0 * a0;
        s0 -= S[j * ld + m] * a0;
      }
      const T d = dfm_sqrt(d0 + d1);
      if (j == c) dg[c] = d;
      else S[j * ld + c] = (s0 + s1) / d;
    }
    __syncthreads();
  }
}

template <typename T>
static size_t svg_predict_smem(int k, bool work) {
  return sizeof(T) *
         (4 * DFM_GEN_KMAX + (work ? 0 : 3 * (size_t)k * (k | 1)));
}

// Row groups of a prediction block: 32 ceil(k / 32) threads a group, a
// thread a column, at most 128 threads and at least two four-row blocks a
// group (the products, staging and stores split their rows over the
// groups; the Crout factors and the solves run on group 0).
static int svg_groups(int k) {
  const int w = (k + 31) / 32, g = (k + 7) / 8;
  return w >= 4 ? 1 : (4 / w < g ? 4 / w : g);
}

// t = -1: the init (h_0 = h_center + h0s z0, step 0's walk, logW = -log M,
// the prediction of step 0 from (mu0, P0)).  t >= 0: step t's gather (the
// particle idx_m when the step resampled) of x_f, P_f (from Pc) and h
// (from hc), h_hist[t], and for t + 1 < T the walk into t + 1 (into hn)
// and its prediction (x_p, P_f into Pn, log|G|).  kWork: the matrices in
// the global workspace (else in shared memory, where the compiler then
// knows their address space: shared loads, 32-bit addresses; a pointer
// chosen at run time would make every access a generic load).  Thread j
// owns column j of X, Y, Z (k x k at ld = k | 1) and row j of the vectors:
//   Z = A, X = P;  x_p = A x;  Y = A P;  X = Y A' + diag(exp h)
//   Y = sym(X) (lower);  Lp = chol(Y + 1e-6 I) in Y, diagonal dp;  Z = C
//   X = C Lp;  Z = I + Lp' X (symmetrized past k = 8, lower)
//   Lg = chol(Z) in Z, diagonal dq;  log|G| = 2 sum log dq
//   X = Lg'^{-1} Lg^{-1} Lp';  Z = Lp X;  P_f = sym(Z)
template <typename T, bool kWork>
__global__ void __launch_bounds__(DFM_GEN_KMAX)
svg_predict_kernel(const T* __restrict__ A, const T* __restrict__ C,
                   const T* __restrict__ mu0, const T* __restrict__ P0,
                   const T* __restrict__ h_center,
                   const T* __restrict__ sigma, const T* __restrict__ z0,
                   const T* __restrict__ xi, T h0s, T logW0, SvgState<T> st,
                   const T* Pc, T* Pn, const T* hc, T* hn,
                   T* __restrict__ h_hist, T* work, int t, int T_, int M,
                   int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = k | 1, kc = 32 * ((k + 31) / 32);
  const int G = blockDim.x / kc, g = threadIdx.x / kc;
  const int j = threadIdx.x - g * kc;
  const bool col = j < k;
  const size_t mat = (size_t)k * ld;
  T* xv = reinterpret_cast<T*>(smem_raw);              // x (k)
  T* eh = xv + DFM_GEN_KMAX;                           // exp(h) (k)
  T* dp = eh + DFM_GEN_KMAX;                           // diag of Lp
  T* dq = dp + DFM_GEN_KMAX;                           // diag of Lg
  T* X = kWork ? work + (size_t)blockIdx.x * 3 * mat : dq + DFM_GEN_KMAX;
  T* Yw = X + mat;
  T* Z = Yw + mat;
  const bool init = t < 0;
  const bool rs = !init && *st.flag != 0;
  const bool next = init || t + 1 < T_;
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const int g0 = rs ? st.idx[m] : m;
    if (g == 0 && col) {
      T hj;
      if (init) {
        hj = h_center[j] + h0s * z0[(size_t)m * k + j];
        hj = hj + sigma[j] * xi[(size_t)m * k + j];
      } else {
        hj = hc[(size_t)g0 * k + j];
        if (h_hist) h_hist[((size_t)t * M + m) * k + j] = hj;
        if (next) hj = hj + sigma[j] * xi[((size_t)(t + 1) * M + m) * k + j];
      }
      if (next) hn[(size_t)m * k + j] = hj;
      eh[j] = svg_exp(hj);
    }
    if (!next) continue;              // block-uniform
    if (init && threadIdx.x == 0) st.logW[m] = logW0;
    const T* Ps = init ? P0 : Pc + (size_t)g0 * k * k;
    __syncthreads();                  // the last particle's matrices read
    if (col) {
      if (g == 0) xv[j] = init ? mu0[j] : st.xf[(size_t)g0 * k + j];
      for (int i = g; i < k; i += G) {
        X[i * ld + j] = Ps[(size_t)i * k + j];
        Z[i * ld + j] = A[(size_t)i * k + j];
      }
    }
    __syncthreads();
    if (g == 0 && col) {
      T s = T(0);
#pragma unroll 4
      for (int l = 0; l < k; ++l) s += Z[j * ld + l] * xv[l];
      st.xp[(size_t)m * k + j] = s;                    // x_p = A x
    }
    svg_mm<T, false>(Yw, Z, X, ld, k, j, g, G);        // A P
    __syncthreads();
    svg_mm<T, true>(X, Yw, Z, ld, k, j, g, G);         // (A P) A'
    __syncthreads();
    if (col) {
      // Y = sym(X + diag(exp h)), its lower triangle: the diagonal is
      // X[j][j] + exp(h_j) exactly.
      for (int i = j + g; i < k; i += G)
        Yw[i * ld + j] = i == j ? X[j * ld + j] + eh[j]
                                : T(0.5) * (X[i * ld + j] + X[j * ld + i]);
      for (int i = g; i < k; i += G) Z[i * ld + j] = C[(size_t)i * k + j];
    }
    __syncthreads();
    svg_crout(Yw, dp, T(1e-6), ld, k, j, g);           // Lp
    if (col) {                        // X = C Lp, Lp's rows l >= j
      for (int i0 = 4 * g; i0 < k; i0 += 4 * G) {
        const int nr = min(4, k - i0);
        T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
        for (int l = j; l < k; ++l) {
          const T b = l == j ? dp[j] : Yw[l * ld + j];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r < nr) s[r] += Z[(i0 + r) * ld + l] * b;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < nr) X[(i0 + r) * ld + j] = s[r];
      }
    }
    __syncthreads();
    if (col) {                        // Z = I + Lp' X, Lp's rows l >= i
      for (int i0 = 4 * g; i0 < k; i0 += 4 * G) {
        const int nr = min(4, k - i0);
        T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
        for (int l = i0; l < k; ++l) {
          const T b = X[l * ld + j];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            if (r < nr && l >= i)
              s[r] += (l == i ? dp[i] : Yw[l * ld + i]) * b;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < nr)
            Z[(i0 + r) * ld + j] = (i0 + r == j ? T(1) : T(0)) + s[r];
      }
    }
    __syncthreads();
    if (k > 8 && col) {               // jnp.linalg.cholesky's symmetrize
      for (int i = j + 1 + g; i < k; i += G)
        Z[i * ld + j] = T(0.5) * (Z[i * ld + j] + Z[j * ld + i]);
    }
    __syncthreads();
    svg_crout(Z, dq, T(0), ld, k, j, g);               // Lg
    if (threadIdx.x < 32) {
      T s = T(0);
      for (int i = j; i < k; i += 32) s += dfm_log(dq[i]);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (j == 0) st.ldG[m] = T(2) * s;
    }
    if (g == 0 && col) {
      // X = Lg^{-1} Lp' (column j of Lp' is row j of Lp: zero below j),
      // then X = Lg'^{-1} X.
      for (int i = 0; i < k; ++i) {
        T s0 = i < j ? Yw[j * ld + i] : (i == j ? dp[j] : T(0)), s1 = T(0);
        int l = 0;
#pragma unroll 4
        for (; l + 2 <= i; l += 2) {
          s0 -= Z[i * ld + l] * X[l * ld + j];
          s1 -= Z[i * ld + l + 1] * X[(l + 1) * ld + j];
        }
        if (l < i) s0 -= Z[i * ld + l] * X[l * ld + j];
        X[i * ld + j] = (s0 + s1) / dq[i];
      }
      for (int i = k - 1; i >= 0; --i) {
        T s0 = X[i * ld + j], s1 = T(0);
        int l = i + 1;
#pragma unroll 4
        for (; l + 2 <= k; l += 2) {
          s0 -= Z[l * ld + i] * X[l * ld + j];
          s1 -= Z[(l + 1) * ld + i] * X[(l + 1) * ld + j];
        }
        if (l < k) s0 -= Z[l * ld + i] * X[l * ld + j];
        X[i * ld + j] = (s0 + s1) / dq[i];
      }
    }
    __syncthreads();
    if (col) {                        // Z = Lp X, Lp's columns l <= i
      for (int i0 = 4 * g; i0 < k; i0 += 4 * G) {
        const int nr = min(4, k - i0);
        T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
        for (int l = 0; l < i0 + nr; ++l) {
          const T b = X[l * ld + j];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            if (r < nr && l <= i)
              s[r] += (l == i ? dp[i] : Yw[i * ld + l]) * b;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < nr) Z[(i0 + r) * ld + j] = s[r];
      }
    }
    __syncthreads();
    if (col) {
      T* Po = Pn + (size_t)m * k * k;
      for (int i = g; i < k; i += G)
        Po[(size_t)i * k + j] = T(0.5) * (Z[i * ld + j] + Z[j * ld + i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side of K10-fwd-gen.
// ---------------------------------------------------------------------------

// Series of a residual chunk (sv_rbpf_gen_series): the chunks times the
// particle tiles fill SVG_RBLOCKS blocks an SM of ``sms``; a multiple of
// SVG_NS.  The wrapper sizes the partials by ceil(N / series).
static int svg_series(int N, int M, int sms) {
  const int ptiles = (M + SVG_PT - 1) / SVG_PT;
  int want = (SVG_RBLOCKS * (sms > 0 ? sms : 1) + ptiles - 1) / ptiles;
  if (want < 1) want = 1;
  int nsc = (N + want - 1) / want;
  nsc = (nsc + SVG_NS - 1) / SVG_NS * SVG_NS;
  return nsc < SVG_NS ? SVG_NS : nsc;
}

// The prediction's workspace rule (sv_rbpf_gen_slots): 0 where a
// particle's three matrices fit a block's shared memory (f32 to k = 128,
// f64 to k = 97), else the particles of the global workspace, min(M,
// SVG_SLOTS_PER_SM x ctas).
template <typename T>
static int svg_slots(int k, int M, int ctas) {
  if (svg_predict_smem<T>(k, false) <= SVG_SMEM_MAX) return 0;
  const int n = SVG_SLOTS_PER_SM * (ctas > 0 ? ctas : 1);
  return M < n ? M : n;
}

template <typename T>
static int svg_rbpf_run(const T* Y, const T* Lam, const T* R, const T* C,
                        const T* B, const T* A, const T* mu0, const T* P0,
                        const T* h_center, const T* sigma, const T* z0,
                        const T* xi, const T* u, T* ll_rel, T* f_mean,
                        T* h_mean, T* ess, int* n_rs, T* h_hist,
                        T* logw_hist, T* state, T* Pf, int* istate,
                        double* c2p, T* up, T* work, int T_, int N, int k,
                        int M, int residual, int nsc, int slots,
                        double h0_scale, double ess_frac,
                        cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX || M < 1 || T_ < 1 || N < 1 ||
      (residual && nsc < 1))
    return (int)cudaErrorInvalidValue;
  const size_t pbytes = svg_predict_smem<T>(k, work != nullptr);
  if (pbytes > SVG_SMEM_MAX || (work && slots < 1))
    return (int)cudaErrorInvalidValue;
  auto predict = work ? svg_predict_kernel<T, true>
                      : svg_predict_kernel<T, false>;
  cudaError_t err = dfm_smem_optin(predict, pbytes);
  if (err != cudaSuccess) return (int)err;
  const size_t rbytes = svg_residual_smem<T>(k);
  err = dfm_smem_optin(svg_residual_kernel<T>, rbytes);
  if (err != cudaSuccess) return (int)err;
  const SvgState<T> st = svg_state(state, istate, M, k);
  const size_t mk = (size_t)M * k;
  T* hb[2] = {st.h, st.h + mk};
  T* Pb[2] = {Pf, Pf + mk * k};
  const int kt = 32 * ((k + 31) / 32);
  const int pt = kt * svg_groups(k);
  const int pgrid = work ? slots : M;
  const int chunks = residual ? (N + nsc - 1) / nsc : 0;
  const int ptiles = (M + SVG_PT - 1) / SVG_PT;
  const int snt = M < SVG_NT ? 32 * ((M + 31) / 32) : SVG_NT;
  const int mnt = 32 * (M < SVG_NT / 32 ? M : SVG_NT / 32);
  const int mgrid = (2 * k + 31) / 32;
  const T logW0 = T(-log((double)M));
  const T thr = T(ess_frac * M);
  err = cudaMemsetAsync(n_rs, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  predict<<<pgrid, pt, pbytes, stream>>>(
      A, C, mu0, P0, h_center, sigma, z0, xi, T(h0_scale), logW0, st,
      nullptr, Pb[0], nullptr, hb[0], nullptr, work, -1, T_, M, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < T_; ++t) {
    const int c = t & 1;              // step t's P_f and h
    if (residual)
      svg_residual_kernel<T><<<dim3(chunks, ptiles), SVG_RT, rbytes,
                               stream>>>(Y, Lam, R, st.xp, c2p, up, t, N, M,
                                         k, nsc);
    svg_update_kernel<T><<<M, kt, 0, stream>>>(B, C, c2p, up, chunks, st,
                                               Pb[c], t, M, k, residual);
    svg_scalar_kernel<T><<<1, snt, 0, stream>>>(st, u, ll_rel, ess, n_rs,
                                                logw_hist, t, M, thr, logW0);
    svg_means_kernel<T><<<mgrid, mnt, 0, stream>>>(st, hb[c], f_mean,
                                                   h_mean, t, M, k);
    if (t + 1 < T_ || h_hist)
      predict<<<pgrid, pt, pbytes, stream>>>(
          A, C, mu0, P0, h_center, sigma, z0, xi, T(h0_scale), logW0, st,
          Pb[c], Pb[c ^ 1], hb[c], hb[c ^ 1], h_hist, work, t, T_, M, k);
    if (t == 0) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10-ffbs-gen: SVG_DRAWS draws a block of SVG_FT threads, the threads over
// the particles.  At each step every thread scores its particles for the
// block's draws (each h_t row read once for them all), keeping each draw's
// best (score, index), the lowest index on ties (its particles in
// increasing order, a strict >); then a block argmax a draw.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(SVG_FT)
svg_ffbs_kernel(const T* __restrict__ h_hist, const T* __restrict__ logw,
                const T* __restrict__ sigma, const T* __restrict__ g_last,
                const T* __restrict__ g, T* __restrict__ out, int T_, int M,
                int k, int S) {
  __shared__ T hs[SVG_DRAWS][DFM_GEN_KMAX];
  __shared__ T s2[DFM_GEN_KMAX];
  __shared__ T rv[SVG_DRAWS][SVG_FT / 32];
  __shared__ int ri[SVG_DRAWS][SVG_FT / 32];
  __shared__ int best[SVG_DRAWS];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int s0 = blockIdx.x * SVG_DRAWS;
  const int nd = min(SVG_DRAWS, S - s0);
  for (int j = tid; j < k; j += blockDim.x)
    s2[j] = svg_max(sigma[j] * sigma[j], T(1e-20));
  __syncthreads();
  for (int t = T_ - 1; t >= 0; --t) {
    const T* ht = h_hist + (size_t)t * M * k;
    T bv[SVG_DRAWS];
    int bi[SVG_DRAWS];
#pragma unroll
    for (int d = 0; d < SVG_DRAWS; ++d) {
      bv[d] = -(T)INFINITY;
      bi[d] = 0x7fffffff;
    }
    for (int m = tid; m < M; m += blockDim.x) {
      const T lw = logw[(size_t)t * M + m];
      T v[SVG_DRAWS];
      if (t == T_ - 1) {
#pragma unroll
        for (int d = 0; d < SVG_DRAWS; ++d)
          v[d] = d < nd ? lw + g_last[(size_t)(s0 + d) * M + m]
                        : -(T)INFINITY;
      } else {
        T d2[SVG_DRAWS];
#pragma unroll
        for (int d = 0; d < SVG_DRAWS; ++d) d2[d] = T(0);
        const T* hm = ht + (size_t)m * k;
        for (int j = 0; j < k; ++j) {
          const T h = hm[j], sj = s2[j];
#pragma unroll
          for (int d = 0; d < SVG_DRAWS; ++d) {
            const T dd = hs[d][j] - h;
            d2[d] += dd * dd / sj;
          }
        }
#pragma unroll
        for (int d = 0; d < SVG_DRAWS; ++d)
          v[d] = d < nd ? (lw - T(0.5) * d2[d]) +
                              g[((size_t)t * S + s0 + d) * M + m]
                        : -(T)INFINITY;
      }
#pragma unroll
      for (int d = 0; d < SVG_DRAWS; ++d)
        if (m == tid || v[d] > bv[d]) {
          bv[d] = v[d];
          bi[d] = m;
        }
    }
#pragma unroll
    for (int d = 0; d < SVG_DRAWS; ++d) {
      T vv = bv[d];
      int ii = bi[d];
      for (int o = 16; o > 0; o >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, vv, o);
        const int oi = __shfl_down_sync(0xffffffffu, ii, o);
        if (ov > vv || (ov == vv && oi < ii)) {
          vv = ov;
          ii = oi;
        }
      }
      if (lane == 0) {
        rv[d][wid] = vv;
        ri[d][wid] = ii;
      }
    }
    __syncthreads();
    if (tid < nd) {
      T vv = rv[tid][0];
      int ii = ri[tid][0];
      for (int q = 1; q < nw; ++q) {
        const T ov = rv[tid][q];
        const int oi = ri[tid][q];
        if (ov > vv || (ov == vv && oi < ii)) {
          vv = ov;
          ii = oi;
        }
      }
      best[tid] = ii;
    }
    __syncthreads();
    for (int e = tid; e < nd * k; e += blockDim.x) {
      const int d = e / k, j = e - d * k;
      const T h = ht[(size_t)best[d] * k + j];
      hs[d][j] = h;
      out[((size_t)t * S + s0 + d) * k + j] = h;
    }
    __syncthreads();
  }
}

template <typename T>
static int svg_ffbs_run(const T* h_hist, const T* logw, const T* sigma,
                        const T* g_last, const T* g, T* out, int T_, int M,
                        int k, int S, cudaStream_t stream) {
  if (k < 1 || k > DFM_GEN_KMAX || M < 1 || T_ < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  svg_ffbs_kernel<T><<<(S + SVG_DRAWS - 1) / SVG_DRAWS, SVG_FT, 0,
                       stream>>>(h_hist, logw, sigma, g_last, g, out, T_, M,
                                 k, S);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_SVG_ENTRIES(SFX, T)                                              \
  int sv_rbpf_gen_##SFX(                                                     \
      const T* Y, const T* Lam, const T* R, const T* C, const T* B,          \
      const T* A, const T* mu0, const T* P0, const T* h_center,              \
      const T* sigma, const T* z0, const T* xi, const T* u, T* ll_rel,       \
      T* f_mean, T* h_mean, T* ess, int* n_rs, T* h_hist, T* logw_hist,      \
      T* state, T* Pf, int* istate, double* c2p, T* up, T* work, int T_,     \
      int N, int k, int M, int residual, int nsc, int slots,                 \
      double h0_scale, double ess_frac, void* stream) {                      \
    return svg_rbpf_run<T>(Y, Lam, R, C, B, A, mu0, P0, h_center, sigma, z0, \
                           xi, u, ll_rel, f_mean, h_mean, ess, n_rs, h_hist, \
                           logw_hist, state, Pf, istate, c2p, up, work, T_,  \
                           N, k, M, residual, nsc, slots, h0_scale,          \
                           ess_frac, (cudaStream_t)stream);                  \
  }                                                                          \
  int sv_ffbs_gen_##SFX(const T* h_hist, const T* logw, const T* sigma,      \
                        const T* g_last, const T* g, T* out, int T_, int M,  \
                        int k, int S, void* stream) {                        \
    return svg_ffbs_run<T>(h_hist, logw, sigma, g_last, g, out, T_, M, k, S, \
                           (cudaStream_t)stream);                            \
  }                                                                          \
  int sv_rbpf_gen_series_##SFX(int N, int M, int sms) {                      \
    return svg_series(N, M, sms);                                            \
  }                                                                          \
  int sv_rbpf_gen_slots_##SFX(int k, int M, int ctas) {                      \
    return svg_slots<T>(k, M, ctas);                                         \
  }
#if DFM_WANT_F32
DFM_SVG_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_SVG_ENTRIES(f64, double)
#endif
}
