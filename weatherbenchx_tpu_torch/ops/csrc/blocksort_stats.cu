// The fused ensemble-statistics and spread-only kernels past 256 members,
// as block sorts: CUDA C++ for Hopper (sm_90a). register_stats.cuh holds
// the register form (2..64 members), sorted_stats.cuh the sorted runs
// (65..256), mergesort_stats.cu the form past one point's shared memory
// (58,113 members and up), whose runs this file's run mode sorts, and
// crps_pairwise.cu the cross sum.
//
// Replaces, in weatherbenchx_tpu/ops/crps_pairwise.py, _fused_kernel (via
// _fused_stats_impl -> pl.pallas_call) and _spread_kernel_sort (via
// _pairwise_spread_sum_impl): spread_sum = sum_{i != j} |x_i - x_j|, and
// with the target y skill_sum = sum_i |x_i - y|, mean and sq_dev_sum =
// sum_i (x_i - mean)^2.
//
// What bounds it on the H100: at HENS's 7,424 members over 721 x 1440
// points, float32, the fused kernel moves 30.8 GB once, 9.2 ms at
// 3.35 TB/s; the pair loop it replaces does M(M-1) = 5.5e7 operations per
// point, 1.7 s at 33.5 T/s. A sort is O(M log^2 M) here, about 200
// instructions per member at 7,424, so the sort's issue rate and its
// shared-memory traffic bound it, not the bytes. The design:
//   * a block owns `points` consecutive gridpoints (a power of two; 2 at
//     7,424 members, 32 at 300) and stages their member columns in shared
//     memory as float32, every member row read from device memory once: a
//     warp's load covers 32 / points rows of `points` consecutive floats
//     (cp.async for float32, so that a thread has all its copies in flight
//     at once). A column's word i lives at i ^ ((i >> 5) & 31): its 32-word
//     row with the column index XORed by the row, so that a run (one row)
//     read down its members and a row read across its runs both hit 32
//     banks; columns are `stride` words apart, stride = roundup(M, 32) +
//     32 / points, so that a load across points does too;
//   * each point is sorted by its own `threads` (a power of two, 8..256,
//     about one a pair of runs) of the block, two 256-thread blocks an SM
//     where their columns fit, in place, by a bitonic sort in its flip
//     form: level L
//     merges sorted blocks of 2^(L-1) by comparing i with its mirror
//     i ^ (2^L - 1), then half-cleaners i with i + 2^b, b = L - 2 .. 0; every
//     compare-exchange puts the minimum at the lower index. The members
//     past M are +inf held nowhere: no compare-exchange moves one (its
//     partner is lower and not larger), so a stage skips them and the
//     column needs M words, not the next power of two;
//   * levels 1..5 are one run of 32 members per thread, sorted in registers
//     by the generated network (sort_network<32>); a level's half-cleaners
//     of stride < 32 are a register pass over each run (80
//     compare-exchanges); its stages of stride >= 32 run over shared memory
//     four at a time: a thread takes the 16 words that four stages of one
//     level pair with each other (a coset of the stages' masks) and runs
//     all four in registers, one read and one write a word per four
//     stages. A run or an item wholly below M takes a copy of the code with
//     no test a member. Every pass ends at a barrier of the block;
//   * the spread by the gaps of the sorted order: sum_{i<j} |x_i - x_j| =
//     sum_{k=1}^{M-1} (x_(k+1) - x_(k)) k (M - k), every term >= 0, so
//     nothing cancels whatever |mean| / std; added in two levels, a run's 32
//     terms and then the runs, in a fixed order (a thread's runs in turn, a
//     butterfly over each warp, the warps in order), with no atomics: two
//     launches on one input give equal bits;
//   * the other outputs from the same staged copy: skill and the sum on the
//     loaded members, in the pass that sorts the runs; the mean = sum / M,
//     the group's sum passed across its warps through a wrapper-allocated
//     device scratch; and in the last pass, on the sorted runs, the
//     two-pass sq_dev = sum (x_i - mean)^2, a run's 32 terms and then the
//     runs in the same fixed order as the gaps;
//   * the last level's register pass sorts each run and stores it, and
//     only after a barrier of the block does a run read its successor's
//     first member for its last gap (a run's successor may belong to
//     another warp's thread, which stores it in the same pass);
//   * NaN: fminf/fmaxf drop a NaN operand, so a NaN flag on the loaded
//     values gives the spread NaN; sum, skill, mean and sq_dev carry NaN by
//     plain arithmetic. +-inf: counted on load, the counts give the JAX
//     kernels' inf or NaN (infinite_spread in common.cuh), as the other
//     forms' do. Ties and -0.0 / +0.0 leave gaps of 0.
// The form holds a point's M float32 members in one block's 227 KB: up to
// 58,112 members (kMaxMembers). Past it, mergesort_stats.cu cuts each
// point's members into runs and sorts them here in the run mode (kRuns):
// the block sort's "points" are then the runs of a batch of gridpoints
// (wbx::RunLayout), each sorted run is copied from shared memory to the
// device scratch, coalesced, and the run's partial sums (the sum, skill,
// the NaN flag and the +-inf counts) go to a word each of the scratch; no
// mean, squares or gaps are taken there. Accumulation is float32; bfloat16
// input is widened on load and the outputs are stored in the input dtype.

#include <algorithm>
#include <type_traits>

#include "register_stats.cuh"

namespace {

using wbx::compare_exchange;
using wbx::infinity;
using wbx::load;
using wbx::store;

constexpr int kRun = 32;
constexpr int kThreads = 256;
// The stages of one level a shared pass runs in registers, 2^kMaxStages
// words an item.
constexpr int kMaxStages = 4;
// Blocks of kThreads an SM is to hold: two leave a thread 128 registers.
constexpr int kMinBlocks = 2;
constexpr int kMinMembers = kRun + 1;
constexpr size_t kMaxSharedBytes = 232448;
constexpr int kMaxMembers = static_cast<int>(kMaxSharedBytes / 4);
// Partial sums a warp hands on at the end (spread, skill, sq_dev, NaN
// flag, +inf and -inf counts), one word each.
constexpr int kPartials = 6;
static_assert(wbx::kRunParts <= kPartials, "a run's partials pass the column");

__device__ __forceinline__ int swizzle(int i) { return i ^ ((i >> 5) & 31); }

// Members [32 b, 32 b + 32) of a staged column into v, the members past m
// +inf.
__device__ __forceinline__ void load_run(const float* col, int b, int m,
                                         float (&v)[kRun]) {
  const int first = b * kRun;
  const float* row = col + first;
  const int key = b & 31;
  if (first + kRun <= m) {  // a full run: no member to test
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = row[i ^ key];
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      v[i] = first + i < m ? row[i ^ key] : infinity();
  }
}

__device__ __forceinline__ void store_run(float* col, int b, int m,
                                          const float (&v)[kRun]) {
  const int first = b * kRun;
  float* row = col + first;
  const int key = b & 31;
  if (first + kRun <= m) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) row[i ^ key] = v[i];
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (first + i < m) row[i ^ key] = v[i];
  }
}

// The half-cleaners of strides 16..1 on a run whose 32 members are a
// bitonic merge's half: sorts it.
__device__ __forceinline__ void merge_run(float (&v)[kRun]) {
#pragma unroll
  for (int s = kRun / 2; s >= 1; s /= 2) {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if ((i & s) == 0) compare_exchange(v[i], v[i + s]);
  }
}

// Items of a shared pass over m members whose G stages have pivot bits
// low + G - 1 .. low: the bases (indices with those bits 0) below m, which
// are the first J + 1 in order.
__device__ __forceinline__ int pass_items(int m, int low, int g) {
  const int hi = (m - 1) >> (low + g);
  const int rem = (m - 1) & ((1 << (low + g)) - 1);
  return (hi << low) + min(rem, (1 << low) - 1) + 1;
}

// The G stages of an item in registers: in stage s the pairs differ in
// bit s of e, and the lower index is the one whose pivot bit is 0, which
// after a flip (stage 0 when kFlip) is bit s of e XOR bit 0 of e.
template <int G, bool kFlip>
__device__ __forceinline__ void item_stages(float (&v)[1 << G]) {
#pragma unroll
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int e = 0; e < (1 << G); ++e) {
      if (e & (1 << s)) continue;
      const int f = e | (1 << s);
      if (s > 0 && kFlip && (e & 1))
        compare_exchange(v[f], v[e]);
      else
        compare_exchange(v[e], v[f]);
    }
  }
}

// G consecutive stages of one level over a staged column of m members:
// pivot bits pivot, pivot - 1, .., pivot - G + 1, the first the level's
// flip (mask 2^(pivot+1) - 1) when kFlip, the rest half-cleaners (mask
// 2^bit). A thread takes the 2^G words of a coset of the masks, skips
// those past m (+inf, never moved), and runs the stages in registers.
// Element e holds base ^ sum over set bits s of e of mask[s]; in stage s
// the lower index of a pair is the one whose pivot bit is 0, which after a
// flip is bit s of e XOR bit 0 of e.
template <int G, bool kFlip>
__device__ __forceinline__ void shared_stages(float* col, int m, int pivot,
                                              int t, int threads) {
  constexpr int E = 1 << G;
  int mask[G];
  mask[0] = kFlip ? (2 << pivot) - 1 : 1 << pivot;
#pragma unroll
  for (int s = 1; s < G; ++s) mask[s] = 1 << (pivot - s);
  const int low = pivot - G + 1;
  const int items = pass_items(m, low, G);
  // The word of base ^ mask is swizzle(base) ^ swizzle(mask): the swizzle
  // is linear over XOR.
  int smask[G];
#pragma unroll
  for (int s = 0; s < G; ++s) smask[s] = swizzle(mask[s]);
  const int span = 2 << pivot;  // an item lies in [base, base + span)
  for (int j = t; j < items; j += threads) {
    const int base = ((j >> low) << (pivot + 1)) | (j & ((1 << low) - 1));
    const int word = swizzle(base);
    int at[E];
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int w = word;
#pragma unroll
      for (int s = 0; s < G; ++s)
        if (e & (1 << s)) w ^= smask[s];
      at[e] = w;
    }
    if (base + span <= m) {  // no member of the item past m
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = col[at[e]];
      item_stages<G, kFlip>(v);
#pragma unroll
      for (int e = 0; e < E; ++e) col[at[e]] = v[e];
    } else {
      int idx[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        int i = base;
#pragma unroll
        for (int s = 0; s < G; ++s)
          if (e & (1 << s)) i ^= mask[s];
        idx[e] = i;
        v[e] = i < m ? col[at[e]] : infinity();
      }
      item_stages<G, kFlip>(v);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (idx[e] < m) col[at[e]] = v[e];
    }
  }
}

template <bool kFlip>
__device__ __forceinline__ void shared_pass(float* col, int m, int pivot,
                                            int g, int t, int threads) {
  if (g == 4)
    shared_stages<4, kFlip>(col, m, pivot, t, threads);
  else if (g == 3)
    shared_stages<3, kFlip>(col, m, pivot, t, threads);
  else if (g == 2)
    shared_stages<2, kFlip>(col, m, pivot, t, threads);
  else
    shared_stages<1, kFlip>(col, m, pivot, t, threads);
}

// Levels 6 .. log2v of the sort of a staged column whose runs of 32 are
// sorted; the last level's register pass is left to the caller (its runs
// end sorted in shared memory but for that pass). Every pass ends at a
// barrier of the block, so every thread of the block calls it.
__device__ __forceinline__ void merge_levels(float* col, int m, int log2v,
                                             int t, int threads) {
  const int runs = (m + kRun - 1) / kRun;
  for (int level = 6; level <= log2v; ++level) {
    int pivot = level - 1;
    bool flip = true;
    while (pivot >= 5) {
      const int g = min(kMaxStages, pivot - 4);
      if (flip)
        shared_pass<true>(col, m, pivot, g, t, threads);
      else
        shared_pass<false>(col, m, pivot, g, t, threads);
      pivot -= g;
      flip = false;
      __syncthreads();
    }
    if (level == log2v) break;
    for (int b = t; b < runs; b += threads) {
      float v[kRun];
      load_run(col, b, m, v);
      merge_run(v);
      store_run(col, b, m, v);
    }
    __syncthreads();
  }
}

// cp.async of one word from device memory into shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// The first member of the block sort's point q in x (rows of n): gridpoint
// q, or in the run mode run q / nb of gridpoint q % nb.
template <bool kRuns>
__device__ __forceinline__ int64_t point_offset(int64_t q, int m, int64_t n,
                                                const wbx::RunLayout& layout) {
  if constexpr (kRuns)
    return (layout.first_row + q / layout.nb * m) * n + q % layout.nb;
  return q;
}

// Stages rows [0, m) of the block's points of x (rows of n) into their
// columns: thread i takes point i % points and rows i / points, i /
// points + blockDim / points, ...; a point past `total` stages zeros.
template <typename T, bool kRuns>
__device__ __forceinline__ void stage_columns(const T* __restrict__ x,
                                              float* columns, int m,
                                              int log2_points, int stride,
                                              int64_t g0, int64_t n,
                                              int64_t total,
                                              const wbx::RunLayout& layout) {
  const int p = threadIdx.x & ((1 << log2_points) - 1);
  const int step = blockDim.x >> log2_points;
  float* col = columns + p * stride;
  int r = threadIdx.x >> log2_points;
  if (g0 + p >= total) {
    for (; r < m; r += step) col[swizzle(r)] = 0.f;
    return;
  }
  const T* src = x + point_offset<kRuns>(g0 + p, m, n, layout);
  if constexpr (std::is_same_v<T, float>) {
    for (; r < m; r += step)
      copy_async(col + swizzle(r), src + static_cast<int64_t>(r) * n);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    constexpr int kDepth = 8;  // loads in flight a thread
    for (; r + (kDepth - 1) * step < m; r += kDepth * step) {
      float v[kDepth];
#pragma unroll
      for (int k = 0; k < kDepth; ++k)
        v[k] = load(src + static_cast<int64_t>(r + k * step) * n);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) col[swizzle(r + k * step)] = v[k];
    }
    for (; r < m; r += step)
      col[swizzle(r)] = load(src + static_cast<int64_t>(r) * n);
  }
}

// Sums K values over a group of `threads` threads in a fixed order, the
// same sums on every thread of the group: a butterfly over each warp (or
// the group's part of one), then, past 32 threads, the warps' sums in warp
// order through `scratch` (K words a warp of the group, free: the group's
// column in shared memory, or its words of the wrapper's device scratch;
// a group with `write` false, a point past n, takes no part in it). Every
// thread of the block calls it: past 32 threads it holds a barrier.
template <int K>
__device__ __forceinline__ void group_sums(float (&v)[K], int t, int threads,
                                           float* scratch, bool write) {
  const int width = threads < 32 ? threads : 32;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = width / 2; off >= 1; off /= 2)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (threads <= 32) return;
  const int warp = t >> 5;
  if (write && (t & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
  if (!write) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = scratch[k];
    for (int w = 1; w < threads / 32; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
}

// The gaps of a sorted run b of a column of m members (v, its members past
// m +inf) to the next member: sum_i (x_(k+1) - x_(k)) k' (m - k'), k =
// 32 b + i, k' = k + 1 the members at or below the gap; `next` is the
// first member of run b + 1 (read where one follows).
__device__ __forceinline__ float run_gaps(const float (&v)[kRun], int b,
                                          int m, float next) {
  const int first = b * kRun;
  const float fm = static_cast<float>(m);
  const float c0 = static_cast<float>(first + 1);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (first + i + 1 < m) {
      const float c = c0 + static_cast<float>(i);
      const float hi = i + 1 < kRun ? v[i + 1] : next;
      acc = fmaf(hi - v[i], c * (fm - c), acc);
    }
  }
  return acc;
}

template <typename T, bool kFused, bool kRuns>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    blocksort_stats_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           T* __restrict__ spread_out,
                           T* __restrict__ skill_out,
                           T* __restrict__ mean_out,
                           T* __restrict__ sq_dev_out,
                           float* __restrict__ sums, int m, int log2v,
                           int log2_points, int log2_threads, int stride,
                           int64_t n, const wbx::RunLayout layout) {
  extern __shared__ float columns[];  // points columns of `stride` words
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) << log2_points;
  const int64_t total = kRuns ? layout.nb * layout.count : n;
  stage_columns<T, kRuns>(x, columns, m, log2_points, stride, g0, n, total,
                          layout);
  __syncthreads();

  const int threads = 1 << log2_threads;
  const int p = threadIdx.x >> log2_threads;
  const int t = threadIdx.x & (threads - 1);
  float* col = columns + p * stride;
  const int64_t g = g0 + p;
  const bool live = g < total;
  const int runs = (m + kRun - 1) / kRun;
  const float yv =
      kFused && live ? load(y + (kRuns ? g % layout.nb : g)) : 0.f;

  // The runs: the NaN flag, the +-inf counts, sum and skill on the loaded
  // members, then each run sorted.
  bool nan = false;
  int n_pos = 0;
  int n_neg = 0;
  float sum = 0.f;
  float skill = 0.f;
#pragma unroll 1
  for (int b = t; b < runs; b += threads) {
    float v[kRun];
    load_run(col, b, m, v);
    const int count = min(kRun, m - b * kRun);
    float s = 0.f;
    float sk = 0.f;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i < count) {
        nan |= v[i] != v[i];
        n_pos += v[i] == infinity();
        n_neg += v[i] == -infinity();
        if constexpr (kFused) {
          s += v[i];
          sk += fabsf(v[i] - yv);
        }
      }
    }
    sum += s;
    skill += sk;
    wbx::sort_network<kRun>(v);
    store_run(col, b, m, v);
  }
  // The mean, for the two-pass squares of the last pass: the group's sum
  // (past one warp through `sums`, a word a warp of each point).
  float mean = 0.f;
  if constexpr (kFused && !kRuns) {
    float whole[1] = {sum};
    group_sums(whole, t, threads, sums + (live ? g : 0) * (threads >> 5),
               live);
    mean = whole[0] / static_cast<float>(m);
  }
  __syncthreads();

  merge_levels(col, m, log2v, t, threads);

  // The last level's register pass: each run sorted and stored, its
  // squares about the mean added.
  float sq_dev = 0.f;
#pragma unroll 1
  for (int b = t; b < runs; b += threads) {
    float v[kRun];
    load_run(col, b, m, v);
    merge_run(v);
    store_run(col, b, m, v);
    if constexpr (kFused && !kRuns) {
      const int count = min(kRun, m - b * kRun);
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (i < count) {
          const float d = v[i] - mean;
          sq = fmaf(d, d, sq);
        }
      }
      sq_dev += sq;
    }
  }
  // Every run sorted in place: only now may a run read the first member of
  // the next, which another warp's thread may have stored above, or the
  // sorted column be copied out.
  __syncthreads();
  if constexpr (kRuns) {
    const int64_t point = g % layout.nb;
    const int64_t run = g / layout.nb;
    if (live) {
      float* dst = layout.out + point * layout.m_total + layout.first_row +
                   run * m;
      for (int i = t; i < m; i += threads) dst[i] = col[swizzle(i)];
    }
    __syncthreads();  // the columns are free: their first words take the sums
    float part[wbx::kRunParts] = {sum, skill, static_cast<float>(nan),
                                  static_cast<float>(n_pos),
                                  static_cast<float>(n_neg)};
    group_sums(part, t, threads, col, true);
    if (t != 0 || !live) return;
    float* out = layout.parts + (point * layout.runs_total +
                                 layout.first_run + run) * wbx::kRunParts;
#pragma unroll
    for (int k = 0; k < wbx::kRunParts; ++k) out[k] = part[k];
    return;
  }
  float spread = 0.f;
#pragma unroll 1
  for (int b = t; b < runs; b += threads) {
    const float next =
        (b + 1) * kRun < m ? col[swizzle((b + 1) * kRun)] : infinity();
    float v[kRun];
    load_run(col, b, m, v);
    spread += run_gaps(v, b, m, next);
  }
  __syncthreads();  // the columns are free: their first words take the sums

  float part[kPartials] = {spread, skill, sq_dev, static_cast<float>(nan),
                           static_cast<float>(n_pos),
                           static_cast<float>(n_neg)};
  group_sums(part, t, threads, col, true);
  if (t != 0 || !live) return;
  const int np = static_cast<int>(part[4]);
  const int nn = static_cast<int>(part[5]);
  store(spread_out + g, part[3] != 0.f ? wbx::quiet_nan()
                        : np + nn > 0  ? wbx::infinite_spread(m, np, nn)
                                       : 2.f * part[0]);
  if constexpr (kFused) {
    store(skill_out + g, part[1]);
    store(mean_out + g, mean);
    store(sq_dev_out + g, part[2]);
  }
}

int log2_exact(int64_t v) {
  int k = 0;
  while ((int64_t{1} << k) < v) ++k;
  return (int64_t{1} << k) == v ? k : -1;
}

int log2_ceil(int64_t v) {
  int k = 0;
  while ((int64_t{1} << k) < v) ++k;
  return k;
}

// The words between two points' columns.
int64_t column_stride(int64_t m, int points) {
  return (m + kRun - 1) / kRun * kRun + (points > 1 ? kRun / points : 0);
}

// Checks a block configuration: points and threads powers of two, 8 <=
// threads, 32 <= points * threads <= kThreads, room in a column for the
// group's sums, the columns within a block's shared memory. Returns the
// shared bytes, or 0 if it does not hold.
size_t block_bytes(int64_t m, int points, int threads) {
  const int lp = log2_exact(points);
  const int lt = log2_exact(threads);
  if (lp < 0 || lt < 3 || points * threads < 32 ||
      points * threads > kThreads)
    return 0;
  // Past one warp the group's sums pass through its column's first words.
  if (column_stride(m, points) < kPartials * (threads / 32)) return 0;
  const size_t bytes =
      static_cast<size_t>(points) * column_stride(m, points) * sizeof(float);
  return bytes <= kMaxSharedBytes ? bytes : 0;
}

template <typename T, bool kFused, bool kRuns = false>
int launch_stats(const void* x, const void* y, void* spread, void* skill,
                 void* mean, void* sq_dev, void* sums, int64_t m, int64_t n,
                 int points, int threads, int device, void* stream,
                 const wbx::RunLayout& layout = wbx::RunLayout{}) {
  const size_t smem = block_bytes(m, points, threads);
  if (smem == 0) return cudaErrorInvalidValue;
  if constexpr (kFused && !kRuns) {
    if (threads > 32 && sums == nullptr) return cudaErrorInvalidValue;
  }
  const int64_t total = kRuns ? layout.nb * layout.count : n;
  if (total == 0) return cudaSuccess;
  const int64_t count = (total + points - 1) / points;
  if (count > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = blocksort_stats_kernel<T, kFused, kRuns>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(count), points * threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(spread), static_cast<T*>(skill), static_cast<T*>(mean),
      static_cast<T*>(sq_dev), static_cast<float*>(sums), static_cast<int>(m),
      log2_ceil(m),
      log2_exact(points), log2_exact(threads),
      static_cast<int>(column_stride(m, points)), n, layout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace wbx {

// The run mode, for mergesort_stats.cu: x and y point at the batch's first
// gridpoint, n is the row stride of x; the sorted runs and their partials
// go where `layout` says. m, points and threads as for the block sort.
int launch_blocksort_runs(const void* x, const void* y,
                          const RunLayout& layout, int64_t m, int64_t n,
                          int dtype, bool fused, int points, int threads,
                          int device, void* stream) {
  if (m < kMinMembers || m > kMaxMembers || n < 0 || layout.nb < 0 ||
      layout.count < 0 || x == nullptr || layout.out == nullptr ||
      layout.parts == nullptr || (fused && y == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0 && fused)
    return launch_stats<float, true, true>(x, y, nullptr, nullptr, nullptr,
                                           nullptr, nullptr, m, n, points,
                                           threads, device, stream, layout);
  if (dtype == 0)
    return launch_stats<float, false, true>(x, y, nullptr, nullptr, nullptr,
                                            nullptr, nullptr, m, n, points,
                                            threads, device, stream, layout);
  if (dtype == 1 && fused)
    return launch_stats<__nv_bfloat16, true, true>(
        x, y, nullptr, nullptr, nullptr, nullptr, nullptr, m, n, points,
        threads, device, stream, layout);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16, false, true>(
        x, y, nullptr, nullptr, nullptr, nullptr, nullptr, m, n, points,
        threads, device, stream, layout);
  return cudaErrorInvalidValue;
}

}  // namespace wbx

// dtype: 0 = float32, 1 = bfloat16; fused: 0 writes the spread alone, and
// y and the last three outputs may then be null. x (m, n) and y and the
// outputs (n) are contiguous device arrays. sums: float32 device scratch
// of n * threads / 32 words for the fused kernel past 32 threads a point,
// else null. points and threads: the block's gridpoints and the threads
// that sort each (ops/crps_pairwise.py: blocksort_config). m from 33 to
// 58,112. Returns a cudaError_t (0 on success) after the asynchronous
// launch on `stream`.
extern "C" int wbx_ensemble_stats_blocksort(const void* x, const void* y,
                                            void* spread, void* skill,
                                            void* mean, void* sq_dev,
                                            void* sums, int64_t m, int64_t n,
                                            int dtype, int fused, int points,
                                            int threads, int device,
                                            void* stream) {
  if (m < kMinMembers || m > kMaxMembers || n < 0 || x == nullptr ||
      spread == nullptr ||
      (fused && (y == nullptr || skill == nullptr || mean == nullptr ||
                 sq_dev == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0 && fused)
    return launch_stats<float, true>(x, y, spread, skill, mean, sq_dev, sums,
                                     m, n, points, threads, device, stream);
  if (dtype == 0)
    return launch_stats<float, false>(x, y, spread, skill, mean, sq_dev, sums,
                                      m, n, points, threads, device, stream);
  if (dtype == 1 && fused)
    return launch_stats<__nv_bfloat16, true>(x, y, spread, skill, mean,
                                             sq_dev, sums, m, n, points,
                                             threads, device, stream);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16, false>(x, y, spread, skill, mean,
                                              sq_dev, sums, m, n, points,
                                              threads, device, stream);
  return cudaErrorInvalidValue;
}
