// Ensemble statistics for the CRPS family: CUDA C++ for Hopper (sm_90a).
//
// Replaces, in weatherbenchx_tpu/ops/crps_pairwise.py:
//   * _fused_kernel (via _fused_stats_impl -> pl.pallas_call): one pass
//     over an (M, N) ensemble and an (N) target gives
//       spread_sum = sum_{i != j} |x_i - x_j|,  skill_sum = sum_i |x_i - y|,
//       mean = sum_i x_i / M,                   sq_dev_sum = sum_i (x_i - mean)^2
//     (sq_dev_sum two-pass: the one-pass moment form cancels in float32
//     when |mean| >> std, e.g. temperatures near 288 K);
//   * _spread_kernel / _spread_kernel_sort (via _pairwise_spread_sum_impl):
//     spread_sum alone. Here that is the same kernel with the skill and
//     moment outputs compiled out.
//
// What bounds it on the H100: at the main-path shape (M = 50 members over
// 4 x 721 x 1440 = 4.15 M gridpoints, float32) the kernel reads 830 MB of
// ensemble plus the target once (~0.25 ms at 3.35 TB/s) and does
// M(M-1)/2 = 1,225 |x_i - x_j| pairs per gridpoint (~10 Gop, ~0.15 ms of
// float32 issue). Neither dominates by much, so the design keeps both low:
//   * one thread per gridpoint, so every member row is read from device
//     memory exactly once, coalesced (consecutive threads, consecutive
//     gridpoints);
//   * the block stages its (M, blockDim) tile in dynamic shared memory as
//     float32; each thread reads back only its own column, so the kernel
//     needs no barrier and the ragged last block just returns early;
//   * the pair loop holds kRowGroup members in registers and streams the
//     later members past them, cutting shared-memory reads per pair by
//     kRowGroup.
// The pair form needs no sort, and it propagates NaN by plain arithmetic:
// a NaN member poisons only its own gridpoint (no fminf/fmaxf, which drop
// NaN). Accumulation is float32; bfloat16 input is widened on load and the
// outputs are stored in the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr int kRowGroup = 4;
// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSharedBytes = 232448;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool kFused>
__global__ void ensemble_stats_kernel(const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      T* __restrict__ spread_out,
                                      T* __restrict__ skill_out,
                                      T* __restrict__ mean_out,
                                      T* __restrict__ sq_dev_out, int m,
                                      int64_t n) {
  extern __shared__ float tile[];  // (m, blockDim.x), member-major
  const int stride = blockDim.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * stride + threadIdx.x;
  if (g >= n) return;
  float* col = tile + threadIdx.x;

  float sum = 0.f;
  for (int i = 0; i < m; ++i) {
    const float v = load(x + static_cast<int64_t>(i) * n + g);
    col[i * stride] = v;
    sum += v;
  }

  // sum_{i<j} |x_i - x_j|, kRowGroup members at a time held in registers.
  float acc[kRowGroup];
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) acc[r] = 0.f;
  for (int i0 = 0; i0 < m; i0 += kRowGroup) {
    float xi[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
      xi[r] = (i0 + r < m) ? col[(i0 + r) * stride] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
      for (int r2 = r + 1; r2 < kRowGroup; ++r2) {
        if (i0 + r2 < m) acc[r] += fabsf(xi[r] - xi[r2]);
      }
    }
    for (int j = i0 + kRowGroup; j < m; ++j) {
      const float xj = col[j * stride];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) acc[r] += fabsf(xi[r] - xj);
    }
  }
  float half_spread = 0.f;
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) half_spread += acc[r];
  store(spread_out + g, 2.f * half_spread);

  if constexpr (kFused) {
    const float yv = load(y + g);
    const float mean = sum / static_cast<float>(m);
    float skill = 0.f;
    float sq_dev = 0.f;
    for (int i = 0; i < m; ++i) {
      const float v = col[i * stride];
      skill += fabsf(v - yv);
      const float d = v - mean;
      sq_dev += d * d;
    }
    store(skill_out + g, skill);
    store(mean_out + g, mean);
    store(sq_dev_out + g, sq_dev);
  }
}

template <typename T, bool kFused>
int launch(const void* x, const void* y, void* spread, void* skill,
           void* mean, void* sq_dev, int64_t m, int64_t n, int device,
           void* stream) {
  if (m < 2 || m > (1 << 20) || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int threads = kMaxThreads;
  size_t smem = static_cast<size_t>(m) * threads * sizeof(float);
  while (smem > kMaxSharedBytes && threads > kMinThreads) {
    threads /= 2;
    smem = static_cast<size_t>(m) * threads * sizeof(float);
  }
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = ensemble_stats_kernel<T, kFused>;
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(spread), static_cast<T*>(skill), static_cast<T*>(mean),
      static_cast<T*>(sq_dev), static_cast<int>(m), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers to
// contiguous arrays: x (m, n), y and the outputs (n). Returns a cudaError_t
// (0 on success) after the launch; the launch is asynchronous on `stream`.
extern "C" int wbx_fused_ensemble_stats(const void* x, const void* y,
                                        void* spread, void* skill, void* mean,
                                        void* sq_dev, int64_t m, int64_t n,
                                        int dtype, int device, void* stream) {
  if (dtype == 0)
    return launch<float, true>(x, y, spread, skill, mean, sq_dev, m, n, device,
                               stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, y, spread, skill, mean, sq_dev, m, n,
                                       device, stream);
  return cudaErrorInvalidValue;
}

extern "C" int wbx_pairwise_spread_sum(const void* x, void* spread, int64_t m,
                                       int64_t n, int dtype, int device,
                                       void* stream) {
  if (dtype == 0)
    return launch<float, false>(x, nullptr, spread, nullptr, nullptr, nullptr,
                                m, n, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, nullptr, spread, nullptr, nullptr,
                                        nullptr, m, n, device, stream);
  return cudaErrorInvalidValue;
}
