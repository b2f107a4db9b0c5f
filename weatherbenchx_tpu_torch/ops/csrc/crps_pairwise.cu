// Ensemble statistics for the CRPS family: CUDA C++ for Hopper (sm_90a).
//
// The tiled pair form of the fused and spread-only kernels, for ensembles
// of more than 58,112 members, past one gridpoint's capacity of the block
// sort (register_stats.cuh holds the register form for 2..64 members,
// sorted_stats.cuh the sorted runs for 65..256 and blocksort_stats.cu the
// block sort for 257..58,112, which ops/crps_pairwise.py:spread_form picks
// first). Replaces, in
// weatherbenchx_tpu/ops/crps_pairwise.py, _fused_kernel (via
// _fused_stats_impl -> pl.pallas_call) and _spread_kernel_sort (via
// _pairwise_spread_sum_impl): spread_sum = sum_{i != j} |x_i - x_j|, and
// with the target y skill_sum = sum_i |x_i - y|, mean and the two-pass
// sq_dev_sum = sum_i (x_i - mean)^2.
//
// What bounds it on the H100: the pair loop. At M members it does
// M(M-1)/2 pairs per gridpoint, each two FP32 adds (the difference, then
// the add of its absolute value), and FADD runs at 128 per clock per SM
// with no FMA pairing: past 58,112 members that is more than 3e9 adds per
// gridpoint, so the operations bound it, growing as M^2 (the form is
// kept there as the entry points' last resort, to MAX_MEMBERS). The
// design:
//   * one thread per gridpoint, so every member row is read from device
//     memory exactly once, coalesced (consecutive threads, consecutive
//     gridpoints);
//   * the block stages its (tile_rows, blockDim) tile in dynamic shared
//     memory as float32; each thread reads back only its own column, so
//     the kernel needs no barrier and the ragged last block just returns
//     early;
//   * the pair loop holds kRowGroup members in registers and streams the
//     later members past them, cutting shared-memory reads per pair by
//     kRowGroup;
//   * an ensemble too large for one tile (more than 1,816 members: 227 KB
//     at 32 threads) is walked tile by tile: each tile's members are paired
//     with one another from shared memory, then with every later member,
//     whose rows stream past from device memory kRowGroup at a time. Every
//     pair is met once, in the tile of its earlier member; a row is read
//     once per tile before it;
//   * the pair sum is added in two levels, a short float32 run per group
//     of kRowGroup members (at most one tile's members long) and the runs
//     into the total with Kahan's compensation (add_compensated), so the
//     rounding error does not grow with the M^2 / 8 runs.
// The sum, skill and squared deviations are added in the same two levels
// (runs of kSumRun members). The pair form needs no sort, and it
// propagates NaN by plain arithmetic:
// a NaN member poisons only its own gridpoint (no fminf/fmaxf, which drop
// NaN). Infinite members are counted on load, and the counts, not the pair
// loop's |inf - inf|, give the JAX kernels' inf or NaN (infinite_spread in
// common.cuh). Accumulation is float32; bfloat16 input is widened on load
// and the outputs are stored in the input dtype.
//
// Also replaces _cross_kernel (via _pairwise_cross_sum_impl ->
// pl.pallas_call): out = sum_{i,j} |x_i - y_j| for two ensembles x (Mx, N)
// and y (My, N), the two-ensemble CRPS skill. At its path's shape (50 vs
// 10 members over 4.15 M gridpoints, float32) it reads 1.0 GB once
// (~0.3 ms at 3.35 TB/s) and does 500 pairs per gridpoint (1,000 adds,
// ~0.12 ms of FADD time), so memory bounds it. One thread per gridpoint
// again: the smaller ensemble's column is staged in shared memory, and the
// larger one's rows stream past it from device memory, kRowGroup members
// at a time in registers, each row read exactly once, coalesced. Large
// ensembles (more than 8,192 pairs) take the kernel's tiled form, which
// adds in the same two levels and walks a smaller ensemble past 1,816
// members tile by tile, the larger one read once per tile.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr int kRowGroup = 4;
// The sum, skill and squared deviations are added in runs of kSumRun
// members and the runs into the total, so that past one block's shared
// memory (58,113 members and up) their rounding grows with sqrt(M).
constexpr int kSumRun = 64;
// The cross pairs up to which the cross kernel adds all of a gridpoint's
// pairs in four float32 accumulators (2,048 terms each). Past them the runs
// would cost float32 digits, and its tiled form takes over.
constexpr int64_t kShortCrossPairs = 8192;
// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSharedBytes = 232448;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

using wbx::load;
using wbx::store;

// total += v with Kahan's compensation carried in comp: the pair form's
// group runs take M^2 / 8 additions past 58,112 members, too many for a
// plain float32 sum.
__device__ __forceinline__ void add_compensated(float& total, float& comp,
                                                float v) {
  const float y = v - comp;
  const float t = total + y;
  comp = (t - total) - y;
  total = t;
}

// sum_r acc[r], pairwise.
__device__ __forceinline__ float group_sum(const float (&acc)[kRowGroup]) {
  static_assert(kRowGroup == 4, "group_sum adds four runs");
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Tile by tile, in two levels (above): tile_rows members staged at a time.
template <typename T, bool kFused>
__global__ void ensemble_stats_kernel(const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      T* __restrict__ spread_out,
                                      T* __restrict__ skill_out,
                                      T* __restrict__ mean_out,
                                      T* __restrict__ sq_dev_out, int m,
                                      int tile_rows, int64_t n) {
  extern __shared__ float tile[];  // (tile_rows, blockDim.x), member-major
  const int stride = blockDim.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * stride + threadIdx.x;
  if (g >= n) return;
  float* col = tile + threadIdx.x;

  float sum = 0.f;
  float sum_run = 0.f;  // the sum in runs of kSumRun members
  bool nan = false;
  int n_pos = 0;
  int n_neg = 0;
  float half_spread = 0.f;  // sum_{i<j} |x_i - x_j|
  float half_comp = 0.f;    // its compensation
  float acc[kRowGroup];
  for (int c0 = 0; c0 < m; c0 += tile_rows) {
    const int mc = min(tile_rows, m - c0);
    for (int i = 0; i < mc; ++i) {
      const float v = load(x + static_cast<int64_t>(c0 + i) * n + g);
      col[i * stride] = v;
      sum_run += v;
      if ((c0 + i) % kSumRun == kSumRun - 1) {
        sum += sum_run;
        sum_run = 0.f;
      }
      nan = nan || v != v;
      n_pos += v == wbx::infinity();
      n_neg += v == -wbx::infinity();
    }

    // The tile's own pairs, kRowGroup members at a time held in registers.
    for (int i0 = 0; i0 < mc; i0 += kRowGroup) {
      float xi[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        acc[r] = 0.f;
        xi[r] = (i0 + r < mc) ? col[(i0 + r) * stride] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
#pragma unroll
        for (int r2 = r + 1; r2 < kRowGroup; ++r2) {
          if (i0 + r2 < mc) acc[r] += fabsf(xi[r] - xi[r2]);
        }
      }
      for (int j = i0 + kRowGroup; j < mc; ++j) {
        const float xj = col[j * stride];
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) acc[r] += fabsf(xi[r] - xj);
      }
      add_compensated(half_spread, half_comp, group_sum(acc));
    }
    // The tile's members against every later member, streamed from device
    // memory (no trip when one tile holds the ensemble).
    for (int j0 = c0 + mc; j0 < m; j0 += kRowGroup) {
      float xj[kRowGroup];
      bool live[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        acc[r] = 0.f;
        live[r] = j0 + r < m;
        xj[r] = live[r] ? load(x + static_cast<int64_t>(j0 + r) * n + g) : 0.f;
      }
      for (int i = 0; i < mc; ++i) {
        const float xi = col[i * stride];
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) acc[r] += fabsf(xj[r] - xi);
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r)
        if (!live[r]) acc[r] = 0.f;
      add_compensated(half_spread, half_comp, group_sum(acc));
    }
  }
  // Infinite members: |inf - inf| must not decide the result; the counts
  // give the JAX kernels' inf or NaN. A NaN member keeps the loop's NaN.
  store(spread_out + g,
        !nan && n_pos + n_neg > 0 ? wbx::infinite_spread(m, n_pos, n_neg)
                                  : 2.f * half_spread);

  if constexpr (kFused) {
    const float yv = load(y + g);
    const float mean = (sum + sum_run) / static_cast<float>(m);
    const bool staged = m <= tile_rows;  // else the last tile is in shared
    float skill = 0.f;
    float sq_dev = 0.f;
    float skill_run = 0.f;
    float sq_run = 0.f;
    for (int i = 0; i < m; ++i) {
      const float v = staged ? col[i * stride]
                             : load(x + static_cast<int64_t>(i) * n + g);
      skill_run += fabsf(v - yv);
      const float d = v - mean;
      sq_run += d * d;
      if (i % kSumRun == kSumRun - 1) {
        skill += skill_run;
        sq_dev += sq_run;
        skill_run = sq_run = 0.f;
      }
    }
    skill += skill_run;
    sq_dev += sq_run;
    store(skill_out + g, skill);
    store(mean_out + g, mean);
    store(sq_dev_out + g, sq_dev);
  }
}

// out[g] = sum_{i < ms} sum_{j < ml} |staged[i, g] - streamed[j, g]|.
// kTiled = false: the staged ensemble in one tile (tile_rows == ms) and
// four float32 accumulators over all pairs, for up to kShortCrossPairs
// pairs (the paths' sizes). kTiled = true: the staged ensemble tile by
// tile, the streamed one read once per tile, and each group's run of at
// most tile_rows terms per accumulator added into the total, so the
// rounding error does not grow with ms * ml.
template <typename T, bool kTiled>
__global__ void cross_sum_kernel(const T* __restrict__ staged,
                                 const T* __restrict__ streamed,
                                 T* __restrict__ out, int ms, int ml,
                                 int tile_rows, int64_t n) {
  extern __shared__ float tile[];  // (tile_rows, blockDim.x), member-major
  const int stride = blockDim.x;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * stride + threadIdx.x;
  if (g >= n) return;
  float* col = tile + threadIdx.x;

  float total = 0.f;
  float acc[kRowGroup];
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < ms; c0 += tile_rows) {
    const int mc = kTiled ? min(tile_rows, ms - c0) : ms;
    for (int i = 0; i < mc; ++i)
      col[i * stride] = load(staged + static_cast<int64_t>(c0 + i) * n + g);

    int j = 0;
    for (; j + kRowGroup <= ml; j += kRowGroup) {
      float v[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if constexpr (kTiled) acc[r] = 0.f;
        v[r] = load(streamed + static_cast<int64_t>(j + r) * n + g);
      }
      for (int i = 0; i < mc; ++i) {
        const float s = col[i * stride];
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r) acc[r] += fabsf(v[r] - s);
      }
      if constexpr (kTiled) total += group_sum(acc);
    }
    for (; j < ml; ++j) {  // the last ml % kRowGroup rows
      const float v = load(streamed + static_cast<int64_t>(j) * n + g);
      float run = 0.f;
      for (int i = 0; i < mc; ++i) run += fabsf(v - col[i * stride]);
      if constexpr (kTiled) total += run; else acc[0] += run;
    }
    if constexpr (!kTiled) break;  // tile_rows == ms
  }
  if constexpr (!kTiled) {
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) total += acc[r];
  }
  store(out + g, total);
}

// Threads per block, the members one tile holds and its dynamic shared
// memory, a (tile_rows, threads) float32 array: 128 threads, halved down to
// 32 while the staged rows do not fit 227 KB; at 32 the tile holds at most
// 1,816 rows and the kernels walk a larger ensemble tile by tile.
void tile_config(int64_t staged_rows, int* threads, int* tile_rows,
                 size_t* smem) {
  *threads = kMaxThreads;
  while (static_cast<size_t>(staged_rows) * *threads * sizeof(float) >
             kMaxSharedBytes &&
         *threads > kMinThreads)
    *threads /= 2;
  const int64_t fit = kMaxSharedBytes / (*threads * sizeof(float));
  *tile_rows = static_cast<int>(staged_rows < fit ? staged_rows : fit);
  *smem = static_cast<size_t>(*tile_rows) * *threads * sizeof(float);
}

// Prepares a launch of `kernel` with `smem` bytes of dynamic shared memory
// over n gridpoints; returns a cudaError_t and the block count.
template <typename Kernel>
int prepare_launch(Kernel kernel, size_t smem, int threads, int64_t n,
                   int device, unsigned* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t count = (n + threads - 1) / threads;
  if (count > 0x7fffffff) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(count);
  return cudaSuccess;
}

template <typename T, bool kFused>
int launch(const void* x, const void* y, void* spread, void* skill,
           void* mean, void* sq_dev, int64_t m, int64_t n, int device,
           void* stream) {
  if (m < 2 || m > (1 << 20) || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int threads;
  int tile_rows;
  size_t smem;
  tile_config(m, &threads, &tile_rows, &smem);
  auto kernel = ensemble_stats_kernel<T, kFused>;
  unsigned blocks;
  const int err = prepare_launch(kernel, smem, threads, n, device, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(spread), static_cast<T*>(skill), static_cast<T*>(mean),
      static_cast<T*>(sq_dev), static_cast<int>(m), tile_rows, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTiled>
int launch_cross_staged(const void* staged, const void* streamed, void* out,
                        int64_t ms, int64_t ml, int64_t n, int device,
                        void* stream) {
  int threads;
  int tile_rows;
  size_t smem;
  tile_config(ms, &threads, &tile_rows, &smem);
  auto kernel = cross_sum_kernel<T, kTiled>;
  unsigned blocks;
  const int err = prepare_launch(kernel, smem, threads, n, device, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(staged), static_cast<const T*>(streamed),
      static_cast<T*>(out), static_cast<int>(ms), static_cast<int>(ml),
      tile_rows, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cross(const void* x, const void* y, void* out, int64_t mx,
                 int64_t my, int64_t n, int device, void* stream) {
  if (mx < 1 || my < 1 || mx > (1 << 20) || my > (1 << 20) || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  // |a - b| is symmetric: stage the smaller ensemble, stream the larger.
  const bool x_staged = mx <= my;
  const void* staged = x_staged ? x : y;
  const void* streamed = x_staged ? y : x;
  const int64_t ms = x_staged ? mx : my;
  const int64_t ml = x_staged ? my : mx;
  if (ms * ml <= kShortCrossPairs)
    return launch_cross_staged<T, false>(staged, streamed, out, ms, ml, n,
                                         device, stream);
  return launch_cross_staged<T, true>(staged, streamed, out, ms, ml, n, device,
                                      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; fused: 0 writes the spread alone, and
// y and the last three outputs may then be null. All pointers are device
// pointers to contiguous arrays: x (m, n), y and the outputs (n). Returns a
// cudaError_t (0 on success) after the launch; the launch is asynchronous
// on `stream`.
extern "C" int wbx_ensemble_stats_shared(const void* x, const void* y,
                                         void* spread, void* skill,
                                         void* mean, void* sq_dev, int64_t m,
                                         int64_t n, int dtype, int fused,
                                         int device, void* stream) {
  if (x == nullptr || spread == nullptr ||
      (fused && (y == nullptr || skill == nullptr || mean == nullptr ||
                 sq_dev == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0 && fused)
    return launch<float, true>(x, y, spread, skill, mean, sq_dev, m, n, device,
                               stream);
  if (dtype == 0)
    return launch<float, false>(x, y, spread, skill, mean, sq_dev, m, n,
                                device, stream);
  if (dtype == 1 && fused)
    return launch<__nv_bfloat16, true>(x, y, spread, skill, mean, sq_dev, m, n,
                                       device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, y, spread, skill, mean, sq_dev, m,
                                        n, device, stream);
  return cudaErrorInvalidValue;
}

// x (mx, n), y (my, n) and out (n), contiguous device arrays of one dtype.
extern "C" int wbx_pairwise_cross_sum(const void* x, const void* y, void* out,
                                      int64_t mx, int64_t my, int64_t n,
                                      int dtype, int device, void* stream) {
  if (dtype == 0)
    return launch_cross<float>(x, y, out, mx, my, n, device, stream);
  if (dtype == 1)
    return launch_cross<__nv_bfloat16>(x, y, out, mx, my, n, device, stream);
  return cudaErrorInvalidValue;
}
