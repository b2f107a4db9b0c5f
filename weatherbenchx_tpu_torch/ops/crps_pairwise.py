"""Ensemble statistics for the CRPS family: CUDA kernels and plain versions.

The port of ``weatherbenchx_tpu/ops/crps_pairwise.py:404-423, 571-603``.
Each public function routes by the device of its input alone:

* a CPU tensor takes the plain PyTorch version in this module;
* a CUDA tensor launches a hand-written kernel (built at first use by
  ``_build``), or raises.

The kernels flatten the data axes: x is passed as a contiguous (M, N)
array and y as (N) (or (My, N) for the cross sum), N = prod(rest). (The
TPU kernel's rule against reshapes, which retile its memory layout, has no
counterpart here.)

The fused and spread-only kernels take one of four forms, picked from the
member count M alone (``spread_form``), all hand-written CUDA:

* ``network`` (M in ``REGISTER_MEMBERS``, 2..64): one thread per
  gridpoint, the M members in registers, sorted there by the
  compare-exchange list ``sort_network(M)``; the spread is the weighted sum
  of order statistics that ``pairwise_spread_sum_plain`` computes;
* ``sorted`` (M in ``SORTED_MEMBERS``, 65..256): one thread per gridpoint,
  the members cut into ``sorted_runs(M)`` runs of at most 64, each sorted
  in registers by ``sort_network`` and stored to shared memory; two merge
  walks, up from the smallest members and down from the largest, pair rank
  k with rank M − 1 − k for the same weighted sum, shifted by the median
  (which drops out of each pair);
* ``blocksort`` (M in ``BLOCKSORT_MEMBERS``, 257..58,112): a block stages
  the member columns of a few gridpoints in shared memory and sorts each
  with many threads (``blocksort_config``): runs of 32 sorted in registers
  by ``sort_network(32)``, then the levels of a bitonic merge in place; the
  spread is the sum of the sorted order's gaps, each weighted by the pairs
  across it, k (M − k);
* ``mergesort`` (M in ``MERGESORT_MEMBERS``, 58,113..2^20, where one
  gridpoint's members no longer fit a block's shared memory): each
  gridpoint's members cut into ``mergesort_plan(M, N)`` runs, each sorted
  by the block sort's run mode into a device scratch, adjacent runs merged
  in pairs (merge path, a tile of merged members a block) until two are
  left, and the last merge adds the gaps of the merged order, weighted as
  the block sort's, without writing it out; the points go in batches, so
  that the scratch stays under ``SCRATCH_BYTES``.

The cross kernel stages the smaller ensemble and streams the larger one
past it, past ``TILE_MEMBERS`` staged members tile by tile.

``_build`` compiles one network kernel per M of ``REGISTER_MEMBERS`` and
one sorted-runs kernel per run size of ``SORTED_RUN_SIZES``, the networks
written out as straight-line code from ``sort_network``.

``LAUNCHES`` counts kernel launches per kernel, so that a run can show its
main path went through the kernels; the plain versions do not count. Each
public function runs inside a span named ``wbx.<function>``
(``observability.span``), so that a profiler trace names it.
"""

import torch

from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch.ops import _build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The members one shared-memory tile of the cross kernel holds: 227 KB
# (232,448 bytes, what a block may use on Hopper) over 32 gridpoints of 4
# bytes, its smallest block. A larger smaller ensemble is walked tile by
# tile inside the kernel, the later members streamed from device memory: no
# size takes another route on the card.
TILE_MEMBERS = 232448 // (32 * 4)
# The most members the kernels' entry points take.
MAX_MEMBERS = 1 << 20


def member_tiles(m: int) -> int:
  """How many shared-memory tiles the cross kernel walks for m staged
  members."""
  return -(-m // TILE_MEMBERS)


# The member counts whose kernels hold the ensemble in registers and sort
# it. Every one sorts: on an H100 a register pair loop tied the network
# within run-to-run noise from 8 to 24 members (both at 80-85% of the
# memory bound) and fell 8-9% behind at 32 (PERF.md, PR 4).
REGISTER_MAX_MEMBERS = 64
REGISTER_MEMBERS = range(2, REGISTER_MAX_MEMBERS + 1)

# The member counts of the sorted-runs kernels: runs of at most
# REGISTER_MAX_MEMBERS, sorted by the register kernels' networks, and at
# most four of them. 256 members is where shared memory ends the form: the
# runs take 1 KB a gridpoint, 64 KB for a block of 64 threads, so no more
# than three blocks (192 gridpoints) fit an SM's 228 KB, and the merge's
# run heads stay in registers at compile-time indices. Past it, the block
# sort.
SORTED_MAX_MEMBERS = 4 * REGISTER_MAX_MEMBERS
SORTED_MEMBERS = range(REGISTER_MAX_MEMBERS + 1, SORTED_MAX_MEMBERS + 1)


# The run sizes the sorted-runs kernels are compiled for: each is a
# template constant, so that its network unrolls into registers, and each
# costs four kernels to build. A run count's runs take the smallest size
# that holds ceil(M / runs) members, the last run padded with +inf: 33 is
# exact at 65 members (the form's first), 43 at 129 (three runs' first),
# 50 at 100, 150 and 200 (full runs: a padded run's loads cost 12%), 51 at
# 101 (ECMWF's extended-range ensemble) and 64 at 128, 192 and 256. The
# networks then do at most 1.35 times the compare-exchanges of runs cut to
# size (at 67 and 68 members).
SORTED_RUN_SIZES = (33, 43, 50, 51, 64)


def sorted_runs(m: int) -> tuple:
  """(runs, run size) of the sorted-runs kernel for m members: the fewest
  runs of at most 64 members, each of the smallest of ``SORTED_RUN_SIZES``
  that holds them; all but the last full, the last padded."""
  runs = -(-m // REGISTER_MAX_MEMBERS)
  need = -(-m // runs)
  return runs, next(r for r in SORTED_RUN_SIZES if r >= need)

# The block sorts (csrc/blocksort_stats.cu): a gridpoint's members as
# float32 in one block's shared memory (232,448 bytes), sorted by runs of
# BLOCKSORT_RUN; a block of at most BLOCKSORT_THREADS threads, at most
# BLOCKSORT_MAX_POINTS gridpoints, two blocks an SM (228 KB of shared
# memory, 1 KB of it a block's own) where their columns fit.
BLOCKSORT_RUN = 32
BLOCKSORT_THREADS = 256
BLOCKSORT_MAX_POINTS = 32
BLOCKSORT_SHARED_BYTES = 232448
BLOCKSORT_SM_BYTES = 233472
BLOCKSORT_MAX_MEMBERS = BLOCKSORT_SHARED_BYTES // 4
BLOCKSORT_MEMBERS = range(SORTED_MAX_MEMBERS + 1, BLOCKSORT_MAX_MEMBERS + 1)


def blocksort_stride(m: int, points: int) -> int:
  """Words between two gridpoints' columns in a block: m rounded up to a
  row of 32, and 32 / points more, so that a load across the points hits
  every bank."""
  run = BLOCKSORT_RUN
  return -(-m // run) * run + (run // points if points > 1 else 0)


def blocksort_config(m: int) -> tuple:
  """(points, threads) of a block sort of m members: the threads that sort
  a gridpoint (a power of two from 8 to BLOCKSORT_THREADS, one for about
  two runs of 32 members) and the gridpoints a block stages (a power of
  two, at most 32 and BLOCKSORT_THREADS / threads), as many as leave room
  for two blocks an SM, else one. More
  gridpoints a block read more of each 32-byte sector of a member row;
  two blocks an SM overlap one's barriers with the other's work."""
  runs = -(-m // BLOCKSORT_RUN)
  threads = 8
  while threads * 2 < runs and threads < BLOCKSORT_THREADS:
    threads *= 2
  points = min(BLOCKSORT_MAX_POINTS, BLOCKSORT_THREADS // threads)
  two_blocks = BLOCKSORT_SM_BYTES // 2 - 1024
  while points > 1 and (
      points * blocksort_stride(m, points) * 4 > two_blocks):
    points //= 2
  return points, threads


# Past one point's block sort (csrc/mergesort_stats.cu): the members cut
# into a power of two of runs of at most MERGESORT_RUN_MAX, each block
# sorted, then merged. MERGESORT_RUN_MAX is the block sort's count at which
# two blocks still fit an SM (28,928 members), so that one block's barriers
# overlap the other's work.
MERGESORT_RUN_MAX = (BLOCKSORT_SM_BYTES // 2 - 1024) // 4
MERGESORT_MEMBERS = range(BLOCKSORT_MAX_MEMBERS + 1, MAX_MEMBERS + 1)
# The bytes of device scratch a merge sort's call may hold at once: its
# points go in batches under it (two float32 columns a point, and the
# runs' and tiles' partial sums, as the kernel lays them out).
SCRATCH_BYTES = 4 << 30


def merge_runs(m: int, run_max: int = None) -> tuple:
  """(runs, run members) of a merge sort of m members: the fewest runs, a
  power of two from 2, of at most run_max (MERGESORT_RUN_MAX) members, all
  of ceil(m / runs) but the last, which has the rest."""
  run_max = run_max or MERGESORT_RUN_MAX
  runs = 2
  while runs * run_max < m:
    runs *= 2
  run_members = -(-m // runs)
  if m <= (runs - 1) * run_members:
    raise ValueError(f'{runs} runs of {run_members} leave none of {m} '
                     'members to the last')
  return runs, run_members


def scratch_batch(n: int, words: int) -> int:
  """The points of one batch of a merge sort over n points: n in equal
  batches of at most SCRATCH_BYTES, at `words` float32 words of scratch a
  point."""
  cap = max(1, SCRATCH_BYTES // (4 * words))
  batches = max(1, -(-n // cap))
  return max(1, -(-n // batches))


def mergesort_plan(m: int, n: int) -> tuple:
  """(runs, run members, scratch words a point, batch) of the merge sort of
  m members over n points: merge_runs(m), the words the kernel lays out for
  them (its library's wbx_mergesort_scratch_words, so on the card only) and
  scratch_batch."""
  runs, run_members = merge_runs(m)
  words = _build.load_library().wbx_mergesort_scratch_words(m, runs)
  if words <= 0:
    raise ValueError(f'no merge sort of {m} members in {runs} runs')
  return runs, run_members, words, scratch_batch(n, words)


# The member count from which the JAX package's spread kernel takes its sort
# body, below it its pair body (weatherbenchx_tpu/ops/crps_pairwise.py:90).
# The two differ on infinite members, and every form here gives what the
# JAX kernel gives at M: a semantic constant, not a speed knob (the kernels'
# kJaxSortMembers, csrc/common.cuh).
JAX_SORT_MEMBERS = 20

LAUNCHES = {'fused_ensemble_stats': 0, 'pairwise_spread_sum': 0,
            'pairwise_cross_sum': 0}
# The member counts each kernel was launched at: M, or (Mx, My) for the
# cross kernel.
MEMBER_COUNTS = {k: set() for k in LAUNCHES}


def reset_launch_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0
    MEMBER_COUNTS[k].clear()


# -- the kernels' routes ----------------------------------------------------------


def sort_network(m: int) -> list:
  """Compare-exchanges [(lo, hi)] that sort m values ascending in place.

  Batcher's odd-even merge sort on p = 2^k ≥ m wires, with wires m..p−1
  held at +inf and folded away: a compare-exchange never moves a +inf pad
  below a real value (every pad starts above every real value), so those
  touching a pad do nothing and are dropped. Each (lo, hi) leaves min at
  lo and max at hi. 403 compare-exchanges at m = 50.
  """
  if m < 1:
    raise ValueError(f'need at least one wire, got {m}')
  p = 1
  while p < m:
    p *= 2
  ces = []
  length = 1
  while length < p:
    k = length
    while k >= 1:
      for j in range(k % length, p - k, 2 * k):
        for i in range(min(k, p - j - k)):
          lo, hi = i + j, i + j + k
          if lo // (2 * length) == hi // (2 * length) and hi < m:
            ces.append((lo, hi))
      k //= 2
    length *= 2
  return ces


def spread_form(m: int) -> str:
  """The kernel form for m members: 'network', 'sorted', 'blocksort' or
  'mergesort' (past 58,112)."""
  if m in REGISTER_MEMBERS:
    return 'network'
  if m in SORTED_MEMBERS:
    return 'sorted'
  return 'blocksort' if m in BLOCKSORT_MEMBERS else 'mergesort'


# -- plain versions -----------------------------------------------------------


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
  """Half-width inputs are widened to float32, as the kernel does."""
  return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def pairwise_spread_sum_plain(x: torch.Tensor) -> torch.Tensor:
  """Σ_{i≠j}|x_i − x_j| over axis 0 by the sorted-members identity.

  With members sorted ascending, Σ_{i≠j}|x_i − x_j| = 2 Σ_k (2k − M − 1)
  x_(k). The weights sum to zero, so the sorted members are first shifted
  by their median: the weighted terms then stay of the spread's size, not
  of |mean|'s. torch.sort puts NaN last, where the weight M − 1 > 0 keeps
  it in the sum.

  Infinite members give the JAX kernel's inf or NaN at every M: the shift
  is 0 where the median is infinite, and the median's zero weight at odd M
  is left out (its sort body, from ``JAX_SORT_MEMBERS`` members); below
  that, two members at one infinity give NaN (its pair body's
  |inf − inf|).
  """
  m = x.shape[0]
  s = torch.sort(x.to(_compute_dtype(x.dtype)), dim=0).values
  median = s[m // 2]
  s = s - torch.where(torch.isfinite(median), median, 0)
  coeff = (2 * torch.arange(1, m + 1, device=x.device, dtype=s.dtype)
           - m - 1).reshape((m,) + (1,) * (x.dim() - 1))
  terms = coeff * s
  if m % 2:
    terms[m // 2] = 0
  out = 2 * terms.sum(0)
  if 2 <= m < JAX_SORT_MEMBERS:
    out = torch.where((s[1] == -torch.inf) | (s[m - 2] == torch.inf),
                      torch.nan, out)
  return out.to(x.dtype)


def fused_ensemble_stats_plain(x: torch.Tensor, y: torch.Tensor) -> tuple:
  """(spread_sum, skill_sum, mean, sq_dev_sum) by plain tensor code."""
  m = x.shape[0]
  xc = x.to(_compute_dtype(x.dtype))
  yc = y.to(xc.dtype)
  mean = xc.sum(0) / m
  outs = (pairwise_spread_sum_plain(xc), (xc - yc).abs().sum(0), mean,
          ((xc - mean) ** 2).sum(0))  # two-pass: see the kernel source
  return tuple(o.to(x.dtype) for o in outs)


def pairwise_cross_sum_plain(x: torch.Tensor, y: torch.Tensor
                             ) -> torch.Tensor:
  """Σ_{i,j}|x_i − y_j| over both leading axes, one member at a time.

  Loops over the smaller ensemble, so the largest temporary is the other
  ensemble's (M, *rest) difference, never the (Mx, My, *rest) broadcast.
  Not by the union-sort identity ½(S(x∪y) − S(x) − S(y)), which cancels in
  float32.
  """
  dtype = _compute_dtype(x.dtype)
  small, large = (x, y) if x.shape[0] <= y.shape[0] else (y, x)
  large = large.to(dtype)
  acc = torch.zeros(x.shape[1:], dtype=dtype, device=x.device)
  for member in small.to(dtype):
    acc += (large - member).abs_().sum(0)
  return acc.to(x.dtype)


# -- kernel wrappers ------------------------------------------------------------


def _check_kernel_input(x: torch.Tensor, min_members: int = 2) -> None:
  if x.dtype not in KERNEL_DTYPES:
    raise TypeError(f'CUDA kernel takes float32 or bfloat16, got {x.dtype}')
  if not x.is_contiguous():
    raise ValueError('CUDA kernel input must be contiguous')
  m = x.shape[0]
  if m < min_members:
    raise ValueError(f'need at least {min_members} ensemble members, got {m}')
  if m > MAX_MEMBERS:
    raise ValueError(f'CUDA kernel takes at most {MAX_MEMBERS} ensemble '
                     f'members, got {m}')


def _raise_on_error(rc: int, name: str) -> None:
  if rc != 0:
    raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


# The member counts each form's kernel takes, where ``_launch_stats`` is
# asked for a form other than spread_form's (``chip_ab.py`` compares forms).
_FORM_MEMBERS = {
    'network': REGISTER_MEMBERS,
    'sorted': SORTED_MEMBERS,
    'blocksort': range(BLOCKSORT_RUN + 1, BLOCKSORT_MAX_MEMBERS + 1),
    'mergesort': MERGESORT_MEMBERS,
}


def _launch_stats(x: torch.Tensor, y, form: str = None):
  """The fused kernel (y given) or the spread-only kernel (y None).

  x (M, N) and y (N) contiguous on one CUDA device, in the form
  ``spread_form(M)``, or ``form`` where given (``chip_ab.py`` compares
  forms; a ValueError where that form's kernel cannot take M). Returns the
  four fused outputs, or the spread alone.
  """
  _check_kernel_input(x)
  m, n = x.shape
  if form is not None and m not in _FORM_MEMBERS.get(form, ()):
    raise ValueError(f'the {form!r} form does not take {m} members')
  fused = y is not None
  outs = tuple(torch.empty((n,), dtype=x.dtype, device=x.device)
               for _ in range(4 if fused else 1))
  name = 'fused_ensemble_stats' if fused else 'pairwise_spread_sum'
  if n:
    lib = _build.load_library()
    ptrs = (x.data_ptr(), y.data_ptr() if fused else None,
            *(o.data_ptr() for o in outs), *(None,) * (4 - len(outs)))
    dtype = KERNEL_DTYPES[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    form = form or spread_form(m)
    if form == 'mergesort':
      rc = _launch_mergesort(lib, ptrs, x, m, n, dtype, fused, stream)
    elif form == 'blocksort':
      points, threads = blocksort_config(m)
      # The fused kernel's device scratch: a word per warp of each point's
      # group, for its sum past one warp.
      sums = (torch.empty((n * (threads // 32),), dtype=torch.float32,
                          device=x.device) if fused and threads > 32 else None)
      rc = lib.wbx_ensemble_stats_blocksort(
          *ptrs, None if sums is None else sums.data_ptr(), m, n, dtype,
          fused, points, threads, x.device.index, stream)
    elif form == 'sorted':
      rc = getattr(lib, _build.sorted_symbol(sorted_runs(m)[1]))(
          *ptrs, m, n, dtype, fused, x.device.index, stream)
    else:
      rc = getattr(lib, _build.register_symbol(m))(
          *ptrs, n, dtype, fused, x.device.index, stream)
    _raise_on_error(rc, name)
    LAUNCHES[name] += 1
    MEMBER_COUNTS[name].add(m)
  return outs if fused else outs[0]


def _launch_mergesort(lib, ptrs, x, m, n, dtype, fused, stream) -> int:
  """The merge sort's launches (mergesort_plan), its scratch allocated
  here for one batch and cut up by the kernel."""
  runs, run_members, words, batch = mergesort_plan(m, n)
  points, threads = blocksort_config(run_members)
  last_points, last_threads = blocksort_config(m - (runs - 1) * run_members)
  scratch = torch.empty((min(batch, n), words), dtype=torch.float32,
                        device=x.device)
  return lib.wbx_ensemble_stats_mergesort(
      *ptrs, scratch.data_ptr(), m, n, batch, runs, run_members, points,
      threads, last_points, last_threads, dtype, fused, x.device.index,
      stream)


def _launch_cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """x (Mx, N), y (My, N), both contiguous on one CUDA device.

  The kernel stages the smaller ensemble in shared memory and streams the
  larger one past it.
  """
  mx, n = x.shape
  my = y.shape[0]
  _check_kernel_input(x, min_members=1)
  _check_kernel_input(y, min_members=1)
  out = torch.empty((n,), dtype=x.dtype, device=x.device)
  if n:
    rc = _build.load_library().wbx_pairwise_cross_sum(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), mx, my, n,
        KERNEL_DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(rc, 'pairwise_cross_sum')
    LAUNCHES['pairwise_cross_sum'] += 1
    MEMBER_COUNTS['pairwise_cross_sum'].add((mx, my))
  return out


def _route(*tensors: torch.Tensor) -> str:
  """'cpu' or 'cuda' for inputs that all live on one such device."""
  devices = {t.device for t in tensors}
  if len(devices) != 1:
    raise ValueError(f'inputs on different devices: {sorted(map(str, devices))}')
  kind = tensors[0].device.type
  if kind not in ('cpu', 'cuda'):
    raise ValueError(f'unsupported device {tensors[0].device}')
  return kind


def fused_ensemble_stats(x: torch.Tensor, y: torch.Tensor) -> tuple:
  """One ensemble pass → (spread_sum, skill_sum, mean, sq_dev_sum).

  spread_sum = Σ_{i≠j}|x_i − x_j|; skill_sum = Σ_i |x_i − y|;
  mean = (Σ_i x_i)/M; sq_dev_sum = Σ_i (x_i − mean)², each shaped like y,
  in x's dtype. x is (M, *rest) and y is rest-shaped. A NaN member poisons
  only its own gridpoint.
  """
  if x.dim() != y.dim() + 1 or tuple(x.shape[1:]) != tuple(y.shape):
    raise ValueError(f'shape mismatch: x {tuple(x.shape)} vs y '
                     f'{tuple(y.shape)}; want x = (M, *y.shape)')
  if x.dtype != y.dtype:
    raise TypeError(f'dtype mismatch: {x.dtype} vs {y.dtype}')
  with observability.span('wbx.fused_ensemble_stats'):
    if _route(x, y) == 'cpu':
      return fused_ensemble_stats_plain(x, y)
    rest = y.shape
    outs = _launch_stats(x.contiguous().reshape(x.shape[0], -1),
                         y.contiguous().reshape(-1))
    return tuple(o.reshape(rest) for o in outs)


def pairwise_spread_sum(x: torch.Tensor) -> torch.Tensor:
  """Σ_{i≠j} |x[i] − x[j]| over axis 0, elementwise over the rest.

  x is (M, *rest) with any rest rank; returns a rest-shaped sum counting
  both orderings (2·Σ_{i<j}).
  """
  if x.dim() < 1:
    raise ValueError('need an ensemble axis')
  with observability.span('wbx.pairwise_spread_sum'):
    if _route(x) == 'cpu':
      return pairwise_spread_sum_plain(x)
    return _launch_stats(x.contiguous().reshape(x.shape[0], -1),
                         None).reshape(x.shape[1:])


def pairwise_cross_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Σ_{i,j} |x[i] − y[j]| over both leading axes (two-ensemble CRPS skill).

  x is (Mx, *rest) and y (My, *rest) with identical trailing shapes, any
  rest rank (1-D inputs give a 0-d sum); returns a rest-shaped sum in x's
  dtype without materializing the (Mx, My, *rest) broadcast. A NaN member
  poisons only its own gridpoint.
  """
  if x.dim() != y.dim():
    raise ValueError(f'rank mismatch: {tuple(x.shape)} vs {tuple(y.shape)}')
  if x.dim() < 1 or tuple(x.shape[1:]) != tuple(y.shape[1:]):
    raise ValueError(f'mismatched trailing shapes: {tuple(x.shape)} vs '
                     f'{tuple(y.shape)}')
  if x.dtype != y.dtype:
    raise TypeError(f'dtype mismatch: {x.dtype} vs {y.dtype}')
  with observability.span('wbx.pairwise_cross_sum'):
    if _route(x, y) == 'cpu':
      return pairwise_cross_sum_plain(x, y)
    return _launch_cross(x.contiguous().reshape(x.shape[0], -1),
                         y.contiguous().reshape(y.shape[0], -1)).reshape(
                             x.shape[1:])


def spread_sum_along_axis(data: torch.Tensor, axis: int) -> torch.Tensor:
  """Pairwise |diff| sum over ``axis``; the result drops that axis."""
  return pairwise_spread_sum(torch.movedim(data, axis, 0))
