// The fused ensemble-statistics and spread-only kernels past 58,112
// members, as sorted runs merged through a device scratch: CUDA C++ for
// Hopper (sm_90a). register_stats.cuh holds the register form (2..64
// members), sorted_stats.cuh the sorted runs (65..256), blocksort_stats.cu
// the block sort (257..58,112) and crps_pairwise.cu the cross sum.
//
// Replaces, in weatherbenchx_tpu/ops/crps_pairwise.py, _fused_kernel (via
// _fused_stats_impl -> pl.pallas_call) and _spread_kernel_sort (via
// _pairwise_spread_sum_impl): spread_sum = sum_{i != j} |x_i - x_j|, and
// with the target y skill_sum = sum_i |x_i - y|, mean and the two-pass
// sq_dev_sum = sum_i (x_i - mean)^2, from 58,113 to 2^20 members.
//
// What bounds it on the H100: one point's column no longer fits a block's
// 227 KB, so it cannot be sorted in shared memory whole. The pair loop it
// replaces did M (M - 1) operations a point (2.1 s a call at 59,392 members
// over 1,024 points); a sort is O(M log M), and at 59,392 members over
// 69,120 points the input alone is 16.4 GB, 4.9 ms at 3.35 TB/s, so the
// sort's issue rate and the scratch's traffic bound it. The design:
//   * each point's members are cut into `runs` runs (a power of two, 2 at
//     59,392 and 32 at 2^20), each sorted by blocksort_stats.cu's run mode
//     (its block sort, the "points" being the runs of a batch of
//     gridpoints) and copied to a device scratch, one float32 column of M
//     words a point, the runs side by side; the run mode also leaves each
//     run's sum, skill, NaN flag and +-inf counts, taken on the loaded
//     members;
//   * pairs of adjacent sorted runs are merged into runs twice as long, a
//     level at a time, between two scratch columns, until two runs are
//     left. A merge is cut into tiles of kTile merged members, one block
//     each: the block finds its tile's ends in both runs by a merge-path
//     binary search (A first on ties), stages both runs' parts in shared
//     memory (coalesced reads), each thread finds its kItems ranks' start
//     there by a second search and merges them in registers, and the tile
//     goes back through shared memory, coalesced;
//   * the last merge writes nothing: each member's gap to the next member
//     in the merged order, weighted by the pairs across it, (k + 1) (M - k
//     - 1) for rank k, sum_{i<j} |x_i - x_j| = sum_k gap_k (k + 1) (M - k -
//     1), every term >= 0, so nothing cancels whatever |mean| / std; in the
//     fused kernel also the two-pass squares (x - mean)^2, the mean the
//     runs' sums added in run order over M;
//   * the sums in two levels in a fixed order with no atomics: a thread's
//     kItems terms, a butterfly over each warp, the warps in order, a word
//     a tile to the scratch; then one warp a point adds its tiles (lane l
//     the tiles l, l + 32, ..., then a butterfly) and the runs' partials in
//     run order, and writes the outputs. Two launches on one input give
//     equal bits;
//   * NaN: the sort's fminf/fmaxf drop a NaN, so the runs' NaN flags, taken
//     on load, give the spread NaN; skill, the sum, the mean and sq_dev
//     carry it by plain arithmetic. +-inf: the runs' counts, summed, give
//     the JAX kernels' inf or NaN (infinite_spread in common.cuh). Ties
//     take run A's member first; ties and -0.0 / +0.0 leave gaps of 0. No
//     search or walk reads past its run's ends, whatever the values: every
//     index is clamped to the run by construction, so members all at one
//     infinity (all ties) stay within it too;
//   * the wrapper (ops/crps_pairwise.py) takes the points in batches, so
//     that the scratch (two columns a point, the partials; its words a
//     point from wbx_mergesort_scratch_words, the layout this file's
//     alone) stays under its SCRATCH_BYTES whatever N; one public call is
//     still one launch in its count.
// Accumulation is float32; bfloat16 input is widened to float32 in the
// scratch, and the outputs are stored in the input dtype.

#include "common.cuh"

namespace {

using wbx::infinity;
using wbx::load;
using wbx::store;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
// Merged members a block.
constexpr int kTile = kThreads * kItems;
// A tile's words in shared memory: a pad word after each 32, so that a
// warp's consecutive words and its threads' kItems-apart words fall in
// distinct banks.
constexpr int kTileWords = kTile + kTile / 32;
// A tile's partials in the last merge: the gaps' sum and the squares'.
constexpr int kTileParts = 2;
constexpr int kMaxMembers = 1 << 20;
constexpr int kMinRunMembers = 33;

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

// How many of the first d members of the merge of sorted A[0, la) and
// B[0, lb) are A's, A first on ties (merge path). Reads only A[0, la) and
// B[0, lb): mid < hi <= la and 0 <= d - mid - 1 < lb.
template <typename GetA, typename GetB>
__device__ __forceinline__ int co_rank(GetA a, int la, GetB b, int lb,
                                       int d) {
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) <= b(d - mid - 1))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The sum of a gridpoint's runs' sums in run order, over m: the fused
// kernel's mean, the same bits in the last merge and in finish_kernel.
__device__ __forceinline__ float column_mean(const float* parts, int runs,
                                             int m) {
  float sum = 0.f;
  for (int r = 0; r < runs; ++r) sum += parts[r * wbx::kRunParts];
  return sum / static_cast<float>(m);
}

// One tile of the merge of adjacent sorted runs A = col[a0, a0 + width)
// and B = col[a0 + width, a0 + 2 width) (cut at m) of a point's column in
// `in`: block (point, pair, tile) merges ranks [tile kTile, (tile + 1)
// kTile) of the pair. kFinal = false writes them to the same place in
// `out`. kFinal = true (one pair, the whole column) writes the tile's
// gap-weighted sum and, kFused, its squares about the mean to tile_parts.
template <bool kFinal, bool kFused>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ in, float* __restrict__ out,
                 float* __restrict__ tile_parts,
                 const float* __restrict__ run_parts, int m, int width,
                 int pairs, int tiles, int runs) {
  __shared__ float s[kTileWords];
  __shared__ int ends[2];
  __shared__ float firsts[kThreads];
  __shared__ float after;  // the member after the tile (kFinal)
  __shared__ float mean_s;
  __shared__ float warp_sums[kWarps][kTileParts];

  const int64_t block = blockIdx.x;
  const int tile = static_cast<int>(block % tiles);
  const int64_t rest = block / tiles;
  const int pair = static_cast<int>(rest % pairs);
  const int64_t point = rest / pairs;
  const int a0 = pair * 2 * width;
  const int la = min(width, m - a0);
  const int lb = max(0, min(width, m - a0 - la));
  const float* a = in + point * m + a0;
  const float* b = a + la;
  const int len = la + lb;
  const int d0 = tile * kTile;
  if (d0 >= len) return;  // the last pair's tiles past its end
  const int d1 = min(d0 + kTile, len);
  auto get_a = [&](int i) { return a[i]; };
  auto get_b = [&](int j) { return b[j]; };
  if (threadIdx.x == 0) {
    ends[0] = co_rank(get_a, la, get_b, lb, d0);
    if constexpr (kFused) mean_s = column_mean(
        run_parts + point * runs * wbx::kRunParts, runs, m);
  } else if (threadIdx.x == 32) {
    const int i1 = co_rank(get_a, la, get_b, lb, d1);
    ends[1] = i1;
    if constexpr (kFinal) {
      // The member of merged rank d1, by the merge's own rule.
      const int j1 = d1 - i1;
      after = d1 < len ? (i1 < la && (j1 >= lb || a[i1] <= b[j1]) ? a[i1]
                                                                  : b[j1])
                       : infinity();
    }
  }
  __syncthreads();
  const int ia0 = ends[0];
  const int jb0 = d0 - ia0;
  const int na = ends[1] - ia0;
  const int nb = (d1 - ends[1]) - jb0;
  for (int k = threadIdx.x; k < na; k += kThreads) s[padded(k)] = a[ia0 + k];
  for (int k = threadIdx.x; k < nb; k += kThreads)
    s[padded(na + k)] = b[jb0 + k];
  __syncthreads();

  // This thread's ranks [dt, dt + count) of the tile, merged in registers.
  const int dt = threadIdx.x * kItems;
  const int count = max(0, min(kItems, d1 - d0 - dt));
  float v[kItems];
  if (count > 0) {
    auto sa = [&](int i) { return s[padded(i)]; };
    auto sb = [&](int j) { return s[padded(na + j)]; };
    int i = co_rank(sa, na, sb, nb, dt);
    int j = dt - i;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      if (e < count) {
        const bool take_a = i < na && (j >= nb || sa(i) <= sb(j));
        v[e] = take_a ? sa(i++) : sb(j++);
      }
    }
  }

  if constexpr (!kFinal) {
    __syncthreads();  // every thread has read its words
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (e < count) s[padded(dt + e)] = v[e];
    __syncthreads();
    float* dst = out + point * m + a0 + d0;
    for (int k = threadIdx.x; k < d1 - d0; k += kThreads)
      dst[k] = s[padded(k)];
  } else {
    if (count > 0) firsts[threadIdx.x] = v[0];
    __syncthreads();
    float part[kTileParts] = {0.f, 0.f};
    if (count > 0) {
      // The member after this thread's last: the next thread's first, or
      // past the tile's last member the one after the tile.
      const float next =
          dt + count < d1 - d0 ? firsts[threadIdx.x + 1] : after;
      const float fm = static_cast<float>(m);
#pragma unroll
      for (int e = 0; e < kItems; ++e) {
        if (e < count) {
          const int k = d0 + dt + e;  // the member's rank in the column
          if (k + 1 < m) {
            const float c = static_cast<float>(k + 1);
            const float hi = e + 1 < count ? v[e + 1] : next;
            part[0] = fmaf(hi - v[e], c * (fm - c), part[0]);
          }
          if constexpr (kFused) {
            const float d = v[e] - mean_s;
            part[1] = fmaf(d, d, part[1]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTileParts; ++k)
      for (int off = 16; off >= 1; off /= 2)
        part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < kTileParts; ++k)
        warp_sums[threadIdx.x >> 5][k] = part[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float* dst = tile_parts + (point * tiles + tile) * kTileParts;
#pragma unroll
      for (int k = 0; k < kTileParts; ++k) {
        float sum = warp_sums[0][k];
        for (int w = 1; w < kWarps; ++w) sum += warp_sums[w][k];
        dst[k] = sum;
      }
    }
  }
}

// One warp a point of the batch: its tiles' sums (lane l the tiles l, l +
// 32, ..., then a butterfly) and its runs' partials in run order, into the
// outputs.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ tile_parts,
                  const float* __restrict__ run_parts, T* __restrict__ spread,
                  T* __restrict__ skill, T* __restrict__ mean,
                  T* __restrict__ sq_dev, int m, int tiles, int runs,
                  int64_t nb) {
  const int64_t point =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= nb) return;  // whole warps
  float part[kTileParts] = {0.f, 0.f};
  const float* tp = tile_parts + point * tiles * kTileParts;
  for (int t = lane; t < tiles; t += 32) {
#pragma unroll
    for (int k = 0; k < kTileParts; ++k) part[k] += tp[t * kTileParts + k];
  }
#pragma unroll
  for (int k = 0; k < kTileParts; ++k)
    for (int off = 16; off >= 1; off /= 2)
      part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
  if (lane != 0) return;
  const float* rp = run_parts + point * runs * wbx::kRunParts;
  float sk = 0.f;
  float nan = 0.f;
  float pos = 0.f;
  float neg = 0.f;
  for (int r = 0; r < runs; ++r) {
    sk += rp[r * wbx::kRunParts + 1];
    nan += rp[r * wbx::kRunParts + 2];
    pos += rp[r * wbx::kRunParts + 3];
    neg += rp[r * wbx::kRunParts + 4];
  }
  const int np = static_cast<int>(pos);
  const int nn = static_cast<int>(neg);
  store(spread + point, nan != 0.f ? wbx::quiet_nan()
                        : np + nn > 0 ? wbx::infinite_spread(m, np, nn)
                                      : 2.f * part[0]);
  if constexpr (kFused) {
    store(skill + point, sk);
    store(mean + point, column_mean(rp, runs, m));
    store(sq_dev + point, part[1]);
  }
}

int check_launch(int64_t blocks) {
  return blocks > 0x7fffffff ? cudaErrorInvalidValue : cudaSuccess;
}

// The merges and the finish of one batch of nb points whose sorted runs
// are in scratch_a; returns a cudaError_t.
template <typename T, bool kFused>
int merge_batch(float* scratch_a, float* scratch_b, float* run_parts,
                float* tile_parts, void* spread, void* skill, void* mean,
                void* sq_dev, int m, int runs, int run_members, int64_t nb,
                cudaStream_t stream) {
  float* src = scratch_a;
  float* dst = scratch_b;
  int width = run_members;
  while (2 * width < m) {  // more than two runs: merge them in pairs
    const int pairs = (m + 2 * width - 1) / (2 * width);
    const int tiles = (2 * width + kTile - 1) / kTile;
    const int64_t blocks = nb * pairs * tiles;
    if (check_launch(blocks) != cudaSuccess) return cudaErrorInvalidValue;
    merge_kernel<false, false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(src, dst, nullptr, nullptr, m,
                                           width, pairs, tiles, runs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    float* t = src;
    src = dst;
    dst = t;
    width *= 2;
  }
  const int tiles = (m + kTile - 1) / kTile;
  const int64_t blocks = nb * tiles;
  if (check_launch(blocks) != cudaSuccess) return cudaErrorInvalidValue;
  merge_kernel<true, kFused><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(src, nullptr, tile_parts, run_parts,
                                         m, width, 1, tiles, runs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<T, kFused><<<static_cast<unsigned>((nb * 32 + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, stream>>>(
      tile_parts, run_parts, static_cast<T*>(spread), static_cast<T*>(skill),
      static_cast<T*>(mean), static_cast<T*>(sq_dev), m, tiles, runs, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 scratch words a point of wbx_ensemble_stats_mergesort takes
// at m members in `runs` runs (two columns of m, the runs' partials and the
// last merge's tiles'); -1 where m or runs is out of range.
extern "C" int64_t wbx_mergesort_scratch_words(int64_t m, int runs) {
  if (m < 2 * kMinRunMembers || m > kMaxMembers || runs < 2) return -1;
  return 2 * m + static_cast<int64_t>(runs) * wbx::kRunParts +
         (m + kTile - 1) / kTile * kTileParts;
}

// dtype: 0 = float32, 1 = bfloat16; fused: 0 writes the spread alone, and
// y and the last three outputs may then be null. x (m, n), y and the
// outputs (n) are contiguous device arrays. The plan (ops/crps_pairwise.py:
// mergesort_plan): `runs` runs a point (a power of two, at least 2), all of
// run_members members but the last, which has the rest; the block sort's
// (points, threads) for a full run and for the last; the points `batch` at
// a time. scratch: min(batch, n) * wbx_mergesort_scratch_words(m, runs)
// float32 device words, cut here into the two columns, the runs' partials
// and the tiles'. m from 66 to 2^20. Returns a cudaError_t (0 on success)
// after the asynchronous launches on `stream`.
extern "C" int wbx_ensemble_stats_mergesort(
    const void* x, const void* y, void* spread, void* skill, void* mean,
    void* sq_dev, void* scratch, int64_t m, int64_t n, int64_t batch,
    int runs, int64_t run_members, int points, int threads, int last_points,
    int last_threads, int dtype, int fused, int device, void* stream) {
  const int64_t last = m - (runs - 1) * run_members;
  if (m > kMaxMembers || n < 0 || batch < 1 || runs < 2 ||
      (runs & (runs - 1)) != 0 || run_members < kMinRunMembers ||
      last < kMinRunMembers || last > run_members ||
      (dtype != 0 && dtype != 1) || x == nullptr || spread == nullptr ||
      scratch == nullptr ||
      (fused && (y == nullptr || skill == nullptr || mean == nullptr ||
                 sq_dev == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return set;
  const int64_t points_max = n < batch ? n : batch;
  float* const scratch_a = static_cast<float*>(scratch);
  float* const scratch_b = scratch_a + points_max * m;
  float* const run_parts = scratch_b + points_max * m;
  float* const tile_parts = run_parts + points_max * runs * wbx::kRunParts;
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  auto at = [](void* p, int64_t offset, size_t size) -> void* {
    return p == nullptr ? nullptr : static_cast<char*>(p) + offset * size;
  };
  for (int64_t b0 = 0; b0 < n; b0 += batch) {
    const int64_t nb = n - b0 < batch ? n - b0 : batch;
    const void* xb = static_cast<const char*>(x) + b0 * item;
    const void* yb = fused ? static_cast<const char*>(y) + b0 * item : nullptr;
    wbx::RunLayout layout;
    layout.nb = nb;
    layout.runs_total = runs;
    layout.m_total = m;
    layout.out = scratch_a;
    layout.parts = run_parts;
    layout.count = last == run_members ? runs : runs - 1;
    int err = wbx::launch_blocksort_runs(xb, yb, layout, run_members, n,
                                         dtype, fused != 0, points, threads,
                                         device, stream);
    if (err != cudaSuccess) return err;
    if (last != run_members) {
      layout.count = 1;
      layout.first_row = (runs - 1) * run_members;
      layout.first_run = runs - 1;
      err = wbx::launch_blocksort_runs(xb, yb, layout, last, n, dtype,
                                       fused != 0, last_points, last_threads,
                                       device, stream);
      if (err != cudaSuccess) return err;
    }
    void* outs[4] = {at(spread, b0, item), at(skill, b0, item),
                     at(mean, b0, item), at(sq_dev, b0, item)};
    const auto merge =
        dtype == 0 ? (fused ? &merge_batch<float, true>
                            : &merge_batch<float, false>)
                   : (fused ? &merge_batch<__nv_bfloat16, true>
                            : &merge_batch<__nv_bfloat16, false>);
    err = merge(scratch_a, scratch_b, run_parts, tile_parts, outs[0], outs[1],
                outs[2], outs[3], static_cast<int>(m), runs,
                static_cast<int>(run_members), nb,
                static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
