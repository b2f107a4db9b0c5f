// Ensemble statistics for the CRPS family: CUDA C++ for Hopper (sm_90a).
//
// The cross kernel. The fused and spread-only kernels live beside it:
// register_stats.cuh (2..64 members), sorted_stats.cuh (65..256),
// blocksort_stats.cu (257..58,112) and mergesort_stats.cu (58,113..2^20),
// which ops/crps_pairwise.py:spread_form picks.
//
// Replaces, in weatherbenchx_tpu/ops/crps_pairwise.py, _cross_kernel (via
// _pairwise_cross_sum_impl -> pl.pallas_call): out = sum_{i,j} |x_i - y_j| for two ensembles x (Mx, N)
// and y (My, N), the two-ensemble CRPS skill. At its path's shape (50 vs
// 10 members over 4.15 M gridpoints, float32) it reads 1.0 GB once
// (~0.3 ms at 3.35 TB/s) and does 500 pairs per gridpoint (1,000 adds,
// ~0.12 ms of FADD time), so memory bounds it. One thread per gridpoint:
// the smaller ensemble's column is staged in shared memory, and the
// larger one's rows stream past it from device memory, kRowGroup members
// at a time in registers, each row read exactly once, coalesced. Large
// ensembles (more than 8,192 pairs) take the kernel's tiled form, which
// adds in two levels (a group's run of terms, then the runs into the
// total) and walks a smaller ensemble past 1,816 members tile by tile, the
// larger one read once per tile.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr int kRowGroup = 4;
// The cross pairs up to which the cross kernel adds all of a gridpoint's
// pairs in four float32 accumulators (2,048 terms each). Past them the runs
// would cost float32 digits, and its tiled form takes over.
constexpr int64_t kShortCrossPairs = 8192;
// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSharedBytes = 232448;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

using wbx::load;
using wbx::store;

// sum_r acc[r], pairwise.
__device__ __forceinline__ float group_sum(const float (&acc)[kRowGroup]) {
  static_assert(kRowGroup == 4, "group_sum adds four runs");
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
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
// 1,816 rows and the kernel walks a larger ensemble tile by tile.
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

// x (mx, n), y (my, n) and out (n), contiguous device arrays of one dtype;
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success)
// after the launch; the launch is asynchronous on `stream`.
extern "C" int wbx_pairwise_cross_sum(const void* x, const void* y, void* out,
                                      int64_t mx, int64_t my, int64_t n,
                                      int dtype, int device, void* stream) {
  if (dtype == 0)
    return launch_cross<float>(x, y, out, mx, my, n, device, stream);
  if (dtype == 1)
    return launch_cross<__nv_bfloat16>(x, y, out, mx, my, n, device, stream);
  return cudaErrorInvalidValue;
}
