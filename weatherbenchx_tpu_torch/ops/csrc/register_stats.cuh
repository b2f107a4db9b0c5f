// The fused ensemble-statistics and spread-only kernels with the ensemble
// held in registers: CUDA C++ for Hopper (sm_90a), for 2 <= M <= 64
// members. sorted_stats.cuh (65..256, whose runs this file's networks
// sort), blocksort_stats.cu (257..58,112, whose runs of 32 they sort too)
// and crps_pairwise.cu (past 58,112) take larger ensembles.
//
// Replaces, in weatherbenchx_tpu/ops/crps_pairwise.py:
//   * _fused_kernel (via _fused_stats_impl -> pl.pallas_call): one pass
//     over an (M, N) ensemble and an (N) target gives
//       spread_sum = sum_{i != j} |x_i - x_j|,  skill_sum = sum_i |x_i - y|,
//       mean = sum_i x_i / M,                   sq_dev_sum = sum_i (x_i - mean)^2
//     (sq_dev_sum two-pass: the one-pass moment form cancels in float32
//     when |mean| >> std, e.g. temperatures near 288 K);
//   * _spread_kernel_sort / _spread_kernel (via _pairwise_spread_sum_impl):
//     spread_sum alone, the same kernel with the other outputs compiled out.
//
// What bounds it on the H100: at the main path's shape (M = 50 over
// 4 x 721 x 1440 = 4.15 M gridpoints, float32) the fused kernel moves
// 914 MB once, 0.273 ms at 3.35 TB/s. A pair loop would do 1,225 pairs
// per gridpoint, 2,450 FP32 adds (the difference, then the add of its
// absolute value); FADD runs at 128 per clock per SM and gets no FMA
// pairing, so 10.2 G adds take ~0.30 ms at 1.98 GHz, as long as the memory
// time. The kernel sorts instead: Batcher's odd-even merge network with
// the +inf pad folded away, 403 compare-exchanges (806 min/max) at M = 50,
// then the weighted sum of the order statistics, about 1,000 instructions
// per gridpoint in all. The design:
//   * one thread per gridpoint and M a compile-time constant: the member
//     loop unrolls into M independent coalesced loads straight into
//     registers (no shared tile, no barrier), and every member index is a
//     constant, so the array stays in registers;
//   * spread by the network, straight-line code generated from
//     ops/crps_pairwise.py:sort_network into wbx_sort_networks.cuh;
//   * NaN: fminf/fmaxf drop a NaN operand, so the kernel flags NaN in the
//     loaded values and writes NaN to the spread; sum, skill and mean come
//     from the loaded values before the network permutes them, and sq_dev
//     (mean first) gets a NaN through the mean. A NaN member poisons only
//     its own gridpoint, at every member position;
//   * +-inf: the network sorts them exactly; the shift is the median only
//     where it is finite (else 0) and the median's zero weight at odd M is
//     left out, as in the plain version (pairwise_spread_sum_plain), so
//     that from kJaxSortMembers on the inf and NaN points are those of the
//     JAX sort body; below it the kernel also gives NaN for two members at
//     one infinity, as the JAX pair body's |inf - inf| does.
// Accumulation is float32; bfloat16 input is widened on load and the
// outputs are stored in the input dtype.

#pragma once

#include "common.cuh"

namespace wbx {

// a <- min(a, b), b <- max(a, b).
__device__ __forceinline__ void compare_exchange(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// Sorts v ascending; one specialisation per M in the generated header.
template <int M>
__device__ __forceinline__ void sort_network(float (&v)[M]);

}  // namespace wbx

#include "wbx_sort_networks.cuh"

namespace wbx {

// Threads per block: 128 and 256 measured within 0.3% at M = 10 and 50 on
// the H100 (PERF.md, PR 4).
constexpr int kRegisterThreads = 256;

template <typename T, bool kFused, int M>
__global__ void __launch_bounds__(kRegisterThreads)
    register_stats_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          T* __restrict__ spread_out,
                          T* __restrict__ skill_out,
                          T* __restrict__ mean_out,
                          T* __restrict__ sq_dev_out, int64_t n) {
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kRegisterThreads + threadIdx.x;
  if (g >= n) return;
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = load(x + i * n + g);

  if constexpr (kFused) {
    const float yv = load(y + g);
    float sum = 0.f;
    float skill = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      sum += v[i];
      skill += fabsf(v[i] - yv);
    }
    const float mean = sum / static_cast<float>(M);
    float sq_dev = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float d = v[i] - mean;
      sq_dev += d * d;
    }
    store(skill_out + g, skill);
    store(mean_out + g, mean);
    store(sq_dev_out + g, sq_dev);
  }

  bool nan = false;
#pragma unroll
  for (int i = 0; i < M; ++i) nan |= (v[i] != v[i]);
  sort_network<M>(v);
  // 2 sum_k (2k - M - 1) (x_(k) - c), k = 1..M, shifted by the median
  // c = x_(M/2 + 1): every term is >= 0, so nothing cancels. An infinite
  // median shifts by 0 instead (inf - inf would be NaN).
  const float median = v[M / 2];
  const float c = isfinite(median) ? median : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (2 * k + 1 != M)  // the median's weight at odd M is 0: 0 * inf is NaN
      acc += static_cast<float>(2 * k + 1 - M) * (v[k] - c);
  }
  if constexpr (M < kJaxSortMembers)
    nan = nan || v[1] == -infinity() || v[M - 2] == infinity();
  store(spread_out + g, nan ? quiet_nan() : 2.f * acc);
}

template <typename T, bool kFused, int M>
void launch_typed(const void* x, const void* y, void* spread, void* skill,
                  void* mean, void* sq_dev, int64_t n, unsigned blocks,
                  cudaStream_t stream) {
  register_stats_kernel<T, kFused, M><<<blocks, kRegisterThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(spread), static_cast<T*>(skill), static_cast<T*>(mean),
      static_cast<T*>(sq_dev), n);
}

// dtype: 0 = float32, 1 = bfloat16; fused: 0 writes the spread alone.
// Returns a cudaError_t (0 on success) after the asynchronous launch.
template <int M>
int launch_registers(const void* x, const void* y, void* spread, void* skill,
                     void* mean, void* sq_dev, int64_t n, int dtype,
                     int fused, int device, void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (x == nullptr || spread == nullptr ||
      (fused && (y == nullptr || skill == nullptr || mean == nullptr ||
                 sq_dev == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t count = (n + kRegisterThreads - 1) / kRegisterThreads;
  if (count > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>(count);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && fused)
    launch_typed<float, true, M>(x, y, spread, skill, mean, sq_dev, n, blocks,
                                 s);
  else if (dtype == 0)
    launch_typed<float, false, M>(x, y, spread, skill, mean, sq_dev, n,
                                  blocks, s);
  else if (fused)
    launch_typed<__nv_bfloat16, true, M>(x, y, spread, skill, mean, sq_dev, n,
                                         blocks, s);
  else
    launch_typed<__nv_bfloat16, false, M>(x, y, spread, skill, mean, sq_dev,
                                          n, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wbx

// One C entry point per M: wbx_ensemble_stats_registers_<M>. x (M, n) and
// y, spread, skill, mean, sq_dev (n) are contiguous device arrays of one
// dtype; y and the last three are null for the spread alone.
#define WBX_REGISTER_ENTRY(M)                                                \
  extern "C" int wbx_ensemble_stats_registers_##M(                           \
      const void* x, const void* y, void* spread, void* skill, void* mean,   \
      void* sq_dev, int64_t n, int dtype, int fused, int device,             \
      void* stream) {                                                        \
    return wbx::launch_registers<M>(x, y, spread, skill, mean, sq_dev, n,    \
                                    dtype, fused, device, stream);           \
  }
