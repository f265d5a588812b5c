// K5b: the steady-state engine's mean recursions, x_t = M_t x_{t-1} + d_t,
// in one launch of one CTA.
//
// Replaces dfm_tpu/ops/scan.py:affine_const_prefix (line 39) together with
// the exact-coefficient head scans of dfm_tpu/ssm/steady.py (lines 183-191
// and 243-245): the JAX engine runs the first tau steps as a sequential
// lax.scan and the frozen tail as log2(T) rounds of shift-doubling.  Here
// one kernel runs the whole recursion over t in [0, T):
//   forward:  x_0 = xb,      x_t = M_t x_{t-1} + d_t   for t = 1 .. T-1
//   reverse:  x_{T-1} = xb,  x_t = M_t x_{t+1} + d_t   for t = T-2 .. 0
// with M_t = Mh[t] for t < h (the exact head) and the constant M after.
// d has T rows; the boundary row of d is not read.
//
// Bound on the H100: neither bytes (~2 T k values) nor operations (2 T k^2
// flops): a plain sequential chain costs T dependent k x k matrix-vector
// products.  Design: a chunked scan.  Each of AF_WARPS warps owns a run of
// ~T/AF_WARPS consecutive steps.  Phase 1: the warp composes its run from
// a zero carry as the k x (k+1) affine map [Phi | z] (lane j keeps column
// j in registers, so no lane waits on another).  Phase 2: warp 0 carries
// the state across the AF_WARPS maps (AF_WARPS matrix-vector steps).
// Phase 3: each warp re-runs its steps from its entry state and writes x.
// The sequential depth is ~2 T / AF_WARPS + AF_WARPS steps instead of T.
// Only the order of additions differs from the sequential recursion; the
// closed-loop M of the filter and smoother has spectral radius < 1, so the
// carried maps stay bounded.  k is a template constant (1 .. DFM_KMAX).
//
// K5b-wide (affine_scan_wide): the same scan at 16 < k <= DFM_WIDE_KMAX =
// 32, which the wrapper takes there (the unmasked auto -> ss fit at wide
// k).  The map [Phi | z] has k + 1 <= 33 columns, one past a warp at k =
// 32, so lane j runs the columns j, j + 32, ... (lane 0 runs z as a second
// column at k = 32).  Two k-vectors a thread in registers hold k = 32 in
// f64 only at 255 registers, so the block has AFW_WARPS = 8 warps (256
// threads), and the maps (8 x 32 x 33 values, 68 KB in f64) sit in
// dynamic shared memory.  The vectors' width is a template bucket KP in
// {20, 24, 28, 32} with zeros past the runtime k (four instantiations
// instead of sixteen: a fully unrolled KP x KP product compiles slowly).
//
// K5b-gen (affine_scan_gen): the recursion at 32 < k <= DFM_GEN_KMAX = 128
// (the unmasked auto -> ss fit past 32).  The chunked design does not
// scale there: one k x (k + 1) map is 132 KB in f64 at k = 128, and
// composing maps costs k^3 a step against the chain's k^2.  Design: one
// CTA runs the T - 1 dependent steps in sequence, two threads a row (each
// half of the row's dot product, joined by a shuffle), the constant M in
// dynamic shared memory at a leading dimension of k + 1, the head's M_t
// read from L2, x_{t-1} double-buffered in shared memory (one barrier a
// step) and d_t prefetched a step ahead.  Bound: T dependent k x k
// matrix-vector steps (a step is ~k/4 dependent fmas a thread).
#include "common.cuh"

constexpr int AF_WARPS = 16;

template <typename T, int K>
__global__ void __launch_bounds__(32 * AF_WARPS)
affine_scan_kernel(const T* __restrict__ d, const T* __restrict__ Mh,
                   const T* __restrict__ M, const T* __restrict__ xb,
                   T* __restrict__ x, int T_, int h, int reverse) {
  __shared__ T Ms[K][K];
  __shared__ T Phi[AF_WARPS][K][K + 1];
  __shared__ T cin[AF_WARPS][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) Ms[e / K][e % K] = M[e];
  const int n = T_ - 1;                       // steps, at positions 1 .. n
  const int L = (n + AF_WARPS - 1) / AF_WARPS;
  const int lo = 1 + warp * L, hi = min(1 + (warp + 1) * L, n + 1);
  __syncthreads();

  // Phase 1: [Phi | z] of this warp's steps; lane j < K holds column j of
  // Phi, lane K holds z.
  if (lane <= K) {
    T col[K];
    for (int r = 0; r < K; ++r) col[r] = (r == lane) ? T(1) : T(0);
    for (int i = lo; i < hi; ++i) {
      const int t = reverse ? T_ - 1 - i : i;
      const T* Mt = t < h ? Mh + (size_t)t * K * K : &Ms[0][0];
      T nw[K];
      for (int r = 0; r < K; ++r) {
        T s = T(0);
        for (int l = 0; l < K; ++l) s += Mt[r * K + l] * col[l];
        nw[r] = s;
      }
      if (lane == K)
        for (int r = 0; r < K; ++r) nw[r] += d[(size_t)t * K + r];
      for (int r = 0; r < K; ++r) col[r] = nw[r];
    }
    for (int r = 0; r < K; ++r) Phi[warp][r][lane] = col[r];
  }
  __syncthreads();

  // Phase 2: the entry state of every warp's run (all lanes of warp 0
  // carry the same vector; lane 0 stores it).
  if (warp == 0) {
    T c[K];
    for (int r = 0; r < K; ++r) c[r] = xb[r];
    for (int w = 0; w < AF_WARPS; ++w) {
      if (lane == 0)
        for (int r = 0; r < K; ++r) cin[w][r] = c[r];
      T nc[K];
      for (int r = 0; r < K; ++r) {
        T s = Phi[w][r][K];
        for (int l = 0; l < K; ++l) s += Phi[w][r][l] * c[l];
        nc[r] = s;
      }
      for (int r = 0; r < K; ++r) c[r] = nc[r];
    }
  }
  __syncthreads();

  // Phase 3: re-run each run from its entry state; lane r writes x_t[r].
  {
    T c[K];
    for (int r = 0; r < K; ++r) c[r] = cin[warp][r];
    for (int i = lo; i < hi; ++i) {
      const int t = reverse ? T_ - 1 - i : i;
      const T* Mt = t < h ? Mh + (size_t)t * K * K : &Ms[0][0];
      T nw[K];
      for (int r = 0; r < K; ++r) {
        T s = T(0);
        for (int l = 0; l < K; ++l) s += Mt[r * K + l] * c[l];
        nw[r] = s + d[(size_t)t * K + r];
      }
      for (int r = 0; r < K; ++r) {
        c[r] = nw[r];
        if (r == lane) x[(size_t)t * K + r] = nw[r];
      }
    }
  }
  if (threadIdx.x < K) {
    const int tb = reverse ? T_ - 1 : 0;
    x[(size_t)tb * K + threadIdx.x] = xb[threadIdx.x];
  }
}

constexpr int AFW_WARPS = 8;

template <typename T>
static size_t afw_smem(int k) {
  return sizeof(T) * ((size_t)k * k + (size_t)AFW_WARPS * k * (k + 1) +
                      (size_t)AFW_WARPS * k);
}

// Row r, column l of the k x k step map at Mt, zero past k: the KP-wide
// vectors carry zeros there, so a bucket KP >= k runs the k-wide scan.
template <typename T>
__device__ __forceinline__ T map_at(const T* Mt, int r, int l, int k) {
  return (r < k && l < k) ? Mt[r * k + l] : T(0);
}

template <typename T, int KP>
__global__ void __launch_bounds__(32 * AFW_WARPS)
affine_scan_wide_kernel(const T* __restrict__ d, const T* __restrict__ Mh,
                        const T* __restrict__ M, const T* __restrict__ xb,
                        T* __restrict__ x, int T_, int h, int k,
                        int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ms = reinterpret_cast<T*>(smem_raw);                 // [k][k]
  T* Phi = Ms + k * k;                                    // [AFW][k][k + 1]
  T* cin = Phi + AFW_WARPS * k * (k + 1);                 // [AFW][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) Ms[e] = M[e];
  const int n = T_ - 1;                       // steps, at positions 1 .. n
  const int L = (n + AFW_WARPS - 1) / AFW_WARPS;
  const int lo = 1 + warp * L, hi = min(1 + (warp + 1) * L, n + 1);
  T* Pw = Phi + (size_t)warp * k * (k + 1);
  __syncthreads();

  // Phase 1: column j of [Phi | z] from a zero carry (e_j for j < k, the
  // zero vector plus the d_t for z = column k).
  for (int j = lane; j <= k; j += 32) {
    T col[KP];
#pragma unroll
    for (int r = 0; r < KP; ++r) col[r] = (r == j && j < k) ? T(1) : T(0);
    for (int i = lo; i < hi; ++i) {
      const int t = reverse ? T_ - 1 - i : i;
      const T* Mt = t < h ? Mh + (size_t)t * k * k : Ms;
      T nw[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < KP; ++l) s += map_at(Mt, r, l, k) * col[l];
        nw[r] = s;
      }
      if (j == k) {
#pragma unroll
        for (int r = 0; r < KP; ++r)
          if (r < k) nw[r] += d[(size_t)t * k + r];
      }
#pragma unroll
      for (int r = 0; r < KP; ++r) col[r] = nw[r];
    }
#pragma unroll
    for (int r = 0; r < KP; ++r)
      if (r < k) Pw[r * (k + 1) + j] = col[r];
  }
  __syncthreads();

  // Phase 2: the entry state of every warp's run (warp 0, lane 0 stores).
  if (warp == 0) {
    T c[KP];
#pragma unroll
    for (int r = 0; r < KP; ++r) c[r] = r < k ? xb[r] : T(0);
    for (int w = 0; w < AFW_WARPS; ++w) {
      const T* P = Phi + (size_t)w * k * (k + 1);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < KP; ++r)
          if (r < k) cin[w * k + r] = c[r];
      }
      T nc[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        T s = r < k ? P[r * (k + 1) + k] : T(0);
#pragma unroll
        for (int l = 0; l < KP; ++l)
          s += (r < k && l < k ? P[r * (k + 1) + l] : T(0)) * c[l];
        nc[r] = s;
      }
#pragma unroll
      for (int r = 0; r < KP; ++r) c[r] = nc[r];
    }
  }
  __syncthreads();

  // Phase 3: re-run each run from its entry state; lane r writes x_t[r].
  {
    T c[KP];
#pragma unroll
    for (int r = 0; r < KP; ++r) c[r] = r < k ? cin[warp * k + r] : T(0);
    for (int i = lo; i < hi; ++i) {
      const int t = reverse ? T_ - 1 - i : i;
      const T* Mt = t < h ? Mh + (size_t)t * k * k : Ms;
      T nw[KP];
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < KP; ++l) s += map_at(Mt, r, l, k) * c[l];
        nw[r] = r < k ? s + d[(size_t)t * k + r] : T(0);
      }
#pragma unroll
      for (int r = 0; r < KP; ++r) {
        c[r] = nw[r];
        if (r == lane && r < k) x[(size_t)t * k + r] = nw[r];
      }
    }
  }
  if (threadIdx.x < k) {
    const int tb = reverse ? T_ - 1 : 0;
    x[(size_t)tb * k + threadIdx.x] = xb[threadIdx.x];
  }
}

template <typename T, int KP>
static int launch_wide_kp(const T* d, const T* Mh, const T* M, const T* xb,
                          T* x, int T_, int h, int k, int reverse,
                          cudaStream_t stream) {
  const size_t bytes = afw_smem<T>(k);
  const cudaError_t e =
      dfm_smem_optin(affine_scan_wide_kernel<T, KP>, bytes);
  if (e != cudaSuccess) return (int)e;
  affine_scan_wide_kernel<T, KP><<<1, 32 * AFW_WARPS, bytes, stream>>>(
      d, Mh, M, xb, x, T_, h, k, reverse);
  return (int)cudaGetLastError();
}

// k in 1 .. DFM_WIDE_KMAX, run at the bucket KP in {20, 24, 28, 32} >= k.
template <typename T>
static int launch_wide(const T* d, const T* Mh, const T* M, const T* xb,
                       T* x, int T_, int h, int k, int reverse,
                       cudaStream_t stream) {
  if (T_ < 1 || h < 0 || k < 1 || k > DFM_WIDE_KMAX)
    return (int)cudaErrorInvalidValue;
  if (k <= 20)
    return launch_wide_kp<T, 20>(d, Mh, M, xb, x, T_, h, k, reverse, stream);
  if (k <= 24)
    return launch_wide_kp<T, 24>(d, Mh, M, xb, x, T_, h, k, reverse, stream);
  if (k <= 28)
    return launch_wide_kp<T, 28>(d, Mh, M, xb, x, T_, h, k, reverse, stream);
  return launch_wide_kp<T, 32>(d, Mh, M, xb, x, T_, h, k, reverse, stream);
}

template <typename T>
static int launch(const T* d, const T* Mh, const T* M, const T* xb, T* x,
                  int T_, int h, int k, int reverse, cudaStream_t stream) {
  if (T_ < 1 || h < 0) return (int)cudaErrorInvalidValue;
  DFM_DISPATCH_K(k, affine_scan_kernel<T, K><<<1, 32 * AF_WARPS, 0, stream>>>(
                        d, Mh, M, xb, x, T_, h, reverse))
  return (int)cudaGetLastError();
}

// ---- K5b-gen ----

constexpr int AFG_THREADS = 2 * DFM_GEN_KMAX;     // two threads a row

template <typename T>
static size_t afg_smem(int k) {
  return sizeof(T) * ((size_t)k * (k + 1) + 2 * DFM_GEN_KMAX);
}

template <typename T>
__global__ void __launch_bounds__(AFG_THREADS)
affine_scan_gen_kernel(const T* __restrict__ d, const T* __restrict__ Mh,
                       const T* __restrict__ M, const T* __restrict__ xb,
                       T* __restrict__ x, int T_, int h, int k,
                       int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ms = reinterpret_cast<T*>(smem_raw);                // [k][k + 1]
  T* xs = Ms + (size_t)k * (k + 1);                      // [2][GEN_KMAX]
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1, ldm = k + 1;
  const bool row = r < k, head_lane = row && half == 0;
  for (int e = tid; e < k * k; e += AFG_THREADS)
    Ms[(e / k) * ldm + e % k] = M[e];
  const int tb = reverse ? T_ - 1 : 0;
  if (tid < k) {
    xs[tid] = xb[tid];
    x[(size_t)tb * k + tid] = xb[tid];
  }
  auto step_t = [&](int i) { return reverse ? T_ - 1 - i : i; };
  T dn = (head_lane && T_ > 1) ? d[(size_t)step_t(1) * k + r] : T(0);
  __syncthreads();
  int cur = 0;
  for (int i = 1; i < T_; ++i) {
    const int t = step_t(i);
    const T* xc = xs + cur * DFM_GEN_KMAX;
    const T dv = dn;
    if (head_lane && i + 1 < T_) dn = d[(size_t)step_t(i + 1) * k + r];
    T s0 = T(0), s1 = T(0);
    if (row) {
      const T* Mr = t < h ? Mh + ((size_t)t * k + r) * k : Ms + r * ldm;
      int l = half;
      for (; l + 2 < k; l += 4) {
        s0 += Mr[l] * xc[l];
        s1 += Mr[l + 2] * xc[l + 2];
      }
      if (l < k) s0 += Mr[l] * xc[l];
    }
    T s = s0 + s1;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (head_lane) {
      const T v = s + dv;
      xs[(cur ^ 1) * DFM_GEN_KMAX + r] = v;
      x[(size_t)t * k + r] = v;
    }
    cur ^= 1;
    __syncthreads();
  }
}

// 1 <= k <= DFM_GEN_KMAX.
template <typename T>
static int launch_gen(const T* d, const T* Mh, const T* M, const T* xb,
                      T* x, int T_, int h, int k, int reverse,
                      cudaStream_t stream) {
  if (T_ < 1 || h < 0 || k < 1 || k > DFM_GEN_KMAX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = afg_smem<T>(k);
  const cudaError_t e = dfm_smem_optin(affine_scan_gen_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  affine_scan_gen_kernel<T><<<1, AFG_THREADS, bytes, stream>>>(
      d, Mh, M, xb, x, T_, h, k, reverse);
  return (int)cudaGetLastError();
}

extern "C" {
#define DFM_AFFINE_ENTRIES(SFX, T)                                             \
  int affine_scan_##SFX(const T* d, const T* Mh, const T* M, const T* xb,    \
                        T* x, int T_, int h, int k, int reverse,             \
                        void* stream) {                                      \
    return launch<T>(d, Mh, M, xb, x, T_, h, k, reverse,                     \
                     (cudaStream_t)stream);                                  \
  }                                                                          \
  int affine_scan_wide_##SFX(const T* d, const T* Mh, const T* M,            \
                             const T* xb, T* x, int T_, int h, int k,        \
                             int reverse, void* stream) {                    \
    return launch_wide<T>(d, Mh, M, xb, x, T_, h, k, reverse,                \
                          (cudaStream_t)stream);                             \
  }                                                                          \
  int affine_scan_gen_##SFX(const T* d, const T* Mh, const T* M,             \
                            const T* xb, T* x, int T_, int h, int k,         \
                            int reverse, void* stream) {                     \
    return launch_gen<T>(d, Mh, M, xb, x, T_, h, k, reverse,                 \
                         (cudaStream_t)stream);                              \
  }
#if DFM_WANT_F32
DFM_AFFINE_ENTRIES(f32, float)
#endif
#if DFM_WANT_F64
DFM_AFFINE_ENTRIES(f64, double)
#endif
}
