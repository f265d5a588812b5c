// Cycles of each block-wide routine of dfm_tpu_torch/csrc/cta_linalg.cuh
// alone: one block of GEN_THREADS threads brackets ``reps`` calls of each
// with clock64() (k x k operands in global memory, as the generic K4 pair
// keeps them).  Built and run by tools/port/cta_bench.py.
#include "../../dfm_tpu_torch/csrc/cta_linalg.cuh"

// The routines in the order of out[]: see ROUTINES in cta_bench.py.
template <typename T>
__global__ void __launch_bounds__(GEN_THREADS)
cta_bench_kernel(const T* A, const T* B, T* C, const T* S, T* W, T* X, int k,
                 long long* out, int reps) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* sm = reinterpret_cast<T*>(raw);
  T* vec = sm + gen_scratch(k);
  SMat<T, WIDE_LD> blk = reinterpret_cast<SMat<T, WIDE_LD>>(sm);
  const int tid = threadIdx.x, kk = k * k;
  if (tid < k) {
    vec[tid] = T(1) / (tid + 1);
    vec[DFM_GEN_KMAX + tid] = T(0);
  }
  auto copy_w = [&]() {
    cta_batched(kk, [&](int e) { return W[e]; },
                [&](int e, T v) { X[e] = v; });
  };
  int slot = 0;
  auto timed = [&](auto body) {
    __syncthreads();
    const long long t0 = clock64();
    for (int r = 0; r < reps; ++r) body();
    __syncthreads();
    const long long t1 = clock64();
    if (tid == 0) out[slot] = (t1 - t0) / reps;
    ++slot;
  };
  timed([&] { cta_gemm<T>(C, k, A, k, false, B, k, false, k, k, k, T(1),
                          nullptr, 0, false, sm); });
  timed([&] { cta_gemm<T>(C, k, A, k, true, B, k, true, k, k, k, T(1), C,
                          k, false, sm); });
  timed([&] { cta_gemm<T>(C, k, A, k, false, B, k, true, k, 32, 64, T(-1),
                          C, k, false, sm); });
  timed([&] { cta_sym<T>(C, C, k, false, sm); });
  timed([&] { cta_sym<T>(W, S, k, true, sm); });
  timed([&] { cta_sym<T>(W, S, k, true, sm); cta_potrf<T>(W, k, sm); });
  timed([&] { copy_w(); });
  timed([&] { copy_w(); cta_trsm_right<T>(X, k, W, k, true, sm); });
  timed([&] { copy_w(); cta_trsm_right<T>(X, k, W, k, false, sm); });
  timed([&] { cta_matvec<T>(vec + DFM_GEN_KMAX, nullptr, T(1), A, vec, k,
                            nullptr); });
  timed([&] { __syncthreads(); });
  timed([&] {
    if (tid < 32) {
      for (int e = tid; e < 32 * 32; e += 32)
        blk[e / 32][e % 32] = S[(size_t)(e / 32) * k + e % 32];
      __syncwarp();
      chol32_regs<T>(blk, 32);
    }
  });
}

template <typename T>
static int launch(const T* A, const T* B, T* C, const T* S, T* W, T* X,
                  int k, long long* out, int reps) {
  const size_t bytes = sizeof(T) * (gen_scratch(k) + 2 * DFM_GEN_KMAX);
  const cudaError_t e = dfm_smem_optin(cta_bench_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  cta_bench_kernel<T><<<1, GEN_THREADS, bytes>>>(A, B, C, S, W, X, k, out,
                                                 reps);
  return (int)cudaGetLastError();
}

extern "C" int cta_bench(int f64, const void* A, const void* B, void* C,
                         const void* S, void* W, void* X, int k,
                         long long* out, int reps) {
  if (k < 33 || k > DFM_GEN_KMAX) return (int)cudaErrorInvalidValue;
  if (f64)
    return launch<double>((const double*)A, (const double*)B, (double*)C,
                          (const double*)S, (double*)W, (double*)X, k, out,
                          reps);
  return launch<float>((const float*)A, (const float*)B, (float*)C,
                       (const float*)S, (float*)W, (float*)X, k, out, reps);
}
