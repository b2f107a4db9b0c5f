// Loads and stores shared by the port's kernels: float32 or bfloat16 in
// device memory, float32 in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wbx {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float infinity() { return __int_as_float(0x7f800000); }

// The member count from which the JAX package's spread kernel takes its sort
// body (weatherbenchx_tpu/ops/crps_pairwise.py:_spread_form); below it, its
// pair body. The two differ on infinite members, and the kernels follow
// whichever the JAX kernel runs at M: a semantic constant, not a speed knob
// (ops/crps_pairwise.py:JAX_SORT_MEMBERS).
constexpr int kJaxSortMembers = 20;

// The spread sum of m members of which n_pos are +inf, n_neg are -inf and
// none is NaN, as the JAX package's kernels give it: inf or NaN. The sort
// body weights rank k (1-based) by 2k - m - 1 and leaves the zero weight
// out; -inf fills ranks 1..n_neg and +inf ranks m - n_pos + 1..m, so terms
// of both signs (NaN) appear once 2 n_neg > m + 1 or 2 n_pos > m + 1. The
// pair body (m < kJaxSortMembers) takes |inf - inf| = NaN for two members
// at one infinity.
__device__ __forceinline__ float infinite_spread(int m, int n_pos, int n_neg) {
  bool nan = 2 * n_pos > m + 1 || 2 * n_neg > m + 1;
  if (m < kJaxSortMembers) nan = nan || n_pos > 1 || n_neg > 1;
  return nan ? quiet_nan() : infinity();
}

// The partial sums of a sorted run past one point's shared memory (the
// block sort's run mode, read by mergesort_stats.cu), a word each: the
// sum, skill, the NaN flag, the +inf count and the -inf count.
constexpr int kRunParts = 5;

// Where the block sort's run mode puts a batch of gridpoints' runs: its
// point q is run q / nb of gridpoint q % nb, member rows [first_row + (q /
// nb) m, first_row + (q / nb + 1) m) of x; the sorted run goes to
// out[(q % nb) m_total + first_row + (q / nb) m, ...), its partials to
// parts[((q % nb) runs_total + first_run + q / nb) kRunParts, ...).
struct RunLayout {
  int64_t nb = 0;         // gridpoints in the batch
  int64_t count = 0;      // runs a gridpoint in this launch
  int64_t first_row = 0;  // the member row of the launch's first run
  int first_run = 0;      // that run's index among a gridpoint's runs
  int runs_total = 0;     // runs a gridpoint
  int64_t m_total = 0;    // members a gridpoint
  float* out = nullptr;   // the sorted columns, (nb, m_total) float32
  float* parts = nullptr; // (nb, runs_total, kRunParts) float32
};

// blocksort_stats.cu: the run mode's launch on `stream`, a cudaError_t.
int launch_blocksort_runs(const void* x, const void* y,
                          const RunLayout& layout, int64_t m, int64_t n,
                          int dtype, bool fused, int points, int threads,
                          int device, void* stream);

}  // namespace wbx
