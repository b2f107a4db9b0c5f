// The fused ensemble-statistics and spread-only kernels for 65..256
// members, as sorted runs: CUDA C++ for Hopper (sm_90a). register_stats.cuh
// holds the register form for 2..64 members, blocksort_stats.cu the block
// sort for 257..58,112 and mergesort_stats.cu the merge sort past it.
//
// Replaces, in weatherbenchx_tpu/ops/crps_pairwise.py, _fused_kernel (via
// _fused_stats_impl -> pl.pallas_call) and _spread_kernel_sort (via
// _pairwise_spread_sum_impl), which from 20 members on sorts the members
// and weights the order statistics: spread_sum = sum_{i != j} |x_i - x_j|
// = 2 sum_k (2k - M - 1) x_(k); with the target y also skill_sum =
// sum_i |x_i - y|, mean and the two-pass sq_dev_sum = sum_i (x_i - mean)^2.
//
// What bounds it on the H100: at M = 100 over 4 x 721 x 1440 = 4.15 M
// gridpoints, float32, the fused kernel moves 1.74 GB once, 0.52 ms at
// 3.35 TB/s. The pair loop it replaces does M(M-1)/2 = 4,950 pairs per
// gridpoint, two FP32 adds each: 1.23 ms of FP32 issue at 33.5 T/s alone,
// so it could never come near the bytes bound. Sorting is O(M log^2 M):
//   * one thread per gridpoint: every member row is read from device
//     memory once, coalesced (consecutive threads, consecutive gridpoints);
//   * the members are cut into K = ceil(M / 64) runs of R, the smallest
//     compiled run size (crps_pairwise.SORTED_RUN_SIZES: 33, 43, 50, 51,
//     64)
//     that holds ceil(M / K) (R a template constant; the last run is
//     padded with +inf in registers, and a pad never sorts below a real
//     value). Each run is loaded into registers, sorted there by the
//     generated network (sort_network<R>, wbx_sort_networks.cuh) and
//     stored to shared memory member-major, each thread its own column (no
//     barrier, no bank conflict). At M = 100: two full runs of 50, 2 x 403
//     compare-exchanges (a padded run costs its loads' row test and its
//     pads' selects, 12% at 101 members against 100);
//   * the K runs are merged in order by walks over their heads, held in
//     registers at compile-time indices (K = 2, 3 or 4): one up from the
//     smallest members and one down from the largest, two independent
//     chains of M / 2 steps, each step one shared read. They pair rank k
//     with rank M - 1 - k: the weighted sum shifted by the median c,
//     sum_k (2k - M - 1)(x_(k) - c), is sum_{k <= M/2} (2k - M - 1)(x_(k) -
//     x_(M+1-k)) (1-based), the mirror's weight being the negative of its
//     own, so c drops out exactly and needs no walk of its own. Every term
//     is >= 0, so nothing cancels when |mean| >> std. About 1,900
//     operations per point at M = 100 against the pair loop's 9,900;
//   * loads unconditional, all of a run in flight at once (a pad row
//     repeats member M - 1, then is set to +inf).
// 256 members (K = 4 runs of 64) is the end of this form: the runs take
// 1 KB of shared memory a point, 64 KB for a block of 64 threads, and the
// block sort takes over past it (blocksort_stats.cu; 2.4-7x slower than
// these runs at 129..256 on an H100, PERF.md).
//
// NaN: fminf/fmaxf drop a NaN operand, so the kernel flags NaN in the
// loaded values and writes NaN to the spread; sum, skill and mean come from
// the loaded values, and sq_dev gets a NaN through the mean. A NaN member
// poisons only its own gridpoint. +-inf: the network and the merge order
// them exactly (an exhausted run's head is +inf going up and -inf going
// down, equal to any infinity left); a pair of one infinity is NaN (inf -
// inf) and of a finite value or the other infinity +inf, so the inf and NaN
// points are the JAX sort body's (infinite_spread in common.cuh): NaN once
// more than (M + 1) / 2 members share one infinity, which puts it on both
// sides of a pair; the median at odd M pairs with no member. Accumulation is
// float32; bfloat16 input is widened on load and the outputs are stored in
// the input dtype.

#pragma once

#include "register_stats.cuh"

namespace wbx {

constexpr int kSortedThreads = 64;
constexpr int kSortedMaxRuns = 4;
constexpr int kSortedMaxMembers = kSortedMaxRuns * 64;

// A walk over K sorted runs in a thread's shared-memory column, ascending
// (kUp) from their first members or descending from their last: run r
// holds rows [r * run_size, min((r + 1) * run_size, m)); head[r] is the
// row at pos[r], or +inf (ascending) / -inf (descending) once the run is
// exhausted, which orders exactly as any infinity left.
template <int K, bool kUp>
struct RunWalk {
  float head[K];
  int pos[K];
  int stop[K];

  __device__ __forceinline__ RunWalk(const float* col, int stride,
                                     int run_size, int m) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int first = r * run_size;
      const int last = min(first + run_size, m) - 1;  // every run holds one
      pos[r] = kUp ? first : last;
      stop[r] = kUp ? last + 1 : first - 1;
      head[r] = col[pos[r] * stride];
    }
  }

  // The smallest head (kUp) or the largest, the lowest run on a tie; its
  // run advanced, saturating at its end. An exhausted run wins a tie when
  // every head left is its infinity (all members -inf, walking down), and
  // then stays where it is: it reads no row past its end.
  __device__ __forceinline__ float take(const float* col, int stride) {
    int best = 0;
    float v = head[0];
#pragma unroll
    for (int r = 1; r < K; ++r) {
      if (kUp ? head[r] < v : head[r] > v) {
        v = head[r];
        best = r;
      }
    }
    int next = pos[0];
    int end = stop[0];
#pragma unroll
    for (int r = 1; r < K; ++r) {
      if (best == r) {
        next = pos[r];
        end = stop[r];
      }
    }
    next = kUp ? min(next + 1, end) : max(next - 1, end);
    const float h = next != end ? col[next * stride]
                                : (kUp ? infinity() : -infinity());
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (best == r) {
        pos[r] = next;
        head[r] = h;
      }
    }
    return v;
  }
};

// Over the merged runs, 2 sum_{k < m/2} (2k + 1 - m)(x_(k) - x_(m-1-k)):
// the weighted sum of the order statistics shifted by their median, each
// term paired with its mirror, whose weight is the negative of its own,
// so that the shift drops out exactly. Each term is >= 0 (a negative
// weight times x_(k) - x_(m-1-k) <= 0), so nothing cancels. The two
// chains, one walk up from the smallest members and one down from the
// largest, are independent, and each merge step reads one shared value.
// With kSqDev also sq_dev = sum_k (x_(k) - mean)^2 in the same walks.
template <int K, bool kSqDev>
__device__ __forceinline__ float2 ranked_spread(const float* col, int stride,
                                                int run_size, int m,
                                                float mean) {
  RunWalk<K, true> up(col, stride, run_size, m);
  RunWalk<K, false> down(col, stride, run_size, m);
  float acc = 0.f;
  float sq = 0.f;
  float w = static_cast<float>(1 - m);  // 2k + 1 - m at k = 0
  for (int k = 0; k < m / 2; ++k, w += 2.f) {
    const float lo = up.take(col, stride);
    const float hi = down.take(col, stride);
    acc = fmaf(w, lo - hi, acc);
    if constexpr (kSqDev) {
      const float d_lo = lo - mean;
      const float d_hi = hi - mean;
      sq = fmaf(d_lo, d_lo, sq);
      sq = fmaf(d_hi, d_hi, sq);
    }
  }
  if constexpr (kSqDev) {
    if (m % 2) {  // the median, whose weight is 0
      const float d = up.take(col, stride) - mean;
      sq = fmaf(d, d, sq);
    }
  }
  return make_float2(2.f * acc, sq);
}

// Loads the run of members [first, first + count) into v, every load
// unconditional so that all R are in flight at once; with kPadded the rows
// past count read member first + count - 1 again (the same cache lines)
// and are then set to +inf. Adds the NaN flag and, fused, the sum and skill
// in member order.
template <typename T, bool kFused, int R, bool kPadded>
__device__ __forceinline__ void load_run(const T* __restrict__ x, int first,
                                         int count, int64_t n, int64_t g,
                                         float yv, float (&v)[R], float& sum,
                                         float& skill, bool& nan) {
  const T* row = x + static_cast<int64_t>(first) * n + g;
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = load(row + static_cast<int64_t>(kPadded ? min(i, count - 1) : i) *
                          n);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool real = !kPadded || i < count;
    nan |= v[i] != v[i];
    if constexpr (kFused) {
      sum += real ? v[i] : 0.f;
      skill += real ? fabsf(v[i] - yv) : 0.f;
    }
    if constexpr (kPadded) v[i] = real ? v[i] : infinity();
  }
}

template <typename T, bool kFused, int R>
__global__ void __launch_bounds__(kSortedThreads)
    sorted_stats_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        T* __restrict__ spread_out,
                        T* __restrict__ skill_out, T* __restrict__ mean_out,
                        T* __restrict__ sq_dev_out, int m, int runs,
                        int64_t n) {
  extern __shared__ float sorted_runs[];  // (runs * R, threads), member-major
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kSortedThreads + threadIdx.x;
  if (g >= n) return;
  float* col = sorted_runs + threadIdx.x;
  const float yv = kFused ? load(y + g) : 0.f;
  float sum = 0.f;
  float skill = 0.f;
  bool nan = false;
  for (int r = 0; r < runs; ++r) {
    const int first = r * R;
    float v[R];
    if (first + R <= m)  // a full run: no pad to test for
      load_run<T, kFused, R, false>(x, first, R, n, g, yv, v, sum, skill, nan);
    else
      load_run<T, kFused, R, true>(x, first, m - first, n, g, yv, v, sum,
                                   skill, nan);
    sort_network<R>(v);
#pragma unroll
    for (int i = 0; i < R; ++i) col[(first + i) * kSortedThreads] = v[i];
  }

  const float mean = sum / static_cast<float>(m);
  const float2 spread_sq =
      runs == 2   ? ranked_spread<2, kFused>(col, kSortedThreads, R, m, mean)
      : runs == 3 ? ranked_spread<3, kFused>(col, kSortedThreads, R, m, mean)
                  : ranked_spread<4, kFused>(col, kSortedThreads, R, m, mean);
  store(spread_out + g, nan ? quiet_nan() : spread_sq.x);
  if constexpr (kFused) {
    store(skill_out + g, skill);
    store(mean_out + g, mean);
    store(sq_dev_out + g, spread_sq.y);
  }
}

template <typename T, bool kFused, int R>
int launch_sorted_typed(const void* x, const void* y, void* spread,
                        void* skill, void* mean, void* sq_dev, int m,
                        int runs, int64_t n, unsigned blocks, size_t smem,
                        cudaStream_t stream) {
  auto kernel = sorted_stats_kernel<T, kFused, R>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kSortedThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(spread), static_cast<T*>(skill), static_cast<T*>(mean),
      static_cast<T*>(sq_dev), m, runs, n);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; fused: 0 writes the spread alone. m
// must cut into ceil(m / 64) runs of at most R, R >= ceil(m / runs): every
// run but the last is full, and the last holds at least one member. Returns
// a cudaError_t (0 on success) after the asynchronous launch.
template <int R>
int launch_sorted(const void* x, const void* y, void* spread, void* skill,
                  void* mean, void* sq_dev, int64_t m, int64_t n, int dtype,
                  int fused, int device, void* stream) {
  if (m <= 64 || m > kSortedMaxMembers || n < 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int runs = static_cast<int>((m + 63) / 64);
  if ((m + runs - 1) / runs > R) return cudaErrorInvalidValue;
  if (x == nullptr || spread == nullptr ||
      (fused && (y == nullptr || skill == nullptr || mean == nullptr ||
                 sq_dev == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t count = (n + kSortedThreads - 1) / kSortedThreads;
  if (count > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned>(count);
  const size_t smem =
      static_cast<size_t>(runs) * R * kSortedThreads * sizeof(float);
  const auto s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  if (dtype == 0 && fused)
    return launch_sorted_typed<float, true, R>(x, y, spread, skill, mean,
                                               sq_dev, mi, runs, n, blocks,
                                               smem, s);
  if (dtype == 0)
    return launch_sorted_typed<float, false, R>(x, y, spread, skill, mean,
                                                sq_dev, mi, runs, n, blocks,
                                                smem, s);
  if (fused)
    return launch_sorted_typed<__nv_bfloat16, true, R>(
        x, y, spread, skill, mean, sq_dev, mi, runs, n, blocks, smem, s);
  return launch_sorted_typed<__nv_bfloat16, false, R>(
      x, y, spread, skill, mean, sq_dev, mi, runs, n, blocks, smem, s);
}

}  // namespace wbx

// One C entry point per run size R: wbx_ensemble_stats_sorted_<R>, for the
// member counts m whose runs R holds. x (m, n) and y, spread, skill,
// mean, sq_dev (n) are contiguous device arrays of one dtype; y and the
// last three are null for the spread alone.
#define WBX_SORTED_ENTRY(R)                                                  \
  extern "C" int wbx_ensemble_stats_sorted_##R(                              \
      const void* x, const void* y, void* spread, void* skill, void* mean,   \
      void* sq_dev, int64_t m, int64_t n, int dtype, int fused, int device,  \
      void* stream) {                                                        \
    return wbx::launch_sorted<R>(x, y, spread, skill, mean, sq_dev, m, n,    \
                                 dtype, fused, device, stream);              \
  }
