"""The merge sort of the fused and spread-only kernels (58,113..2^20
members), on the CPU.

The CUDA kernels (``ops/csrc/mergesort_stats.cu``, and the block sort's run
mode in ``ops/csrc/blocksort_stats.cu``) run only on the card, so their
arithmetic is emulated here in float32 numpy, step for step, at shrunken
run and tile sizes (runs of at most 32..64 members, tiles of a few threads
of a few members), so that 65..2,000 members make 2 to 64 runs: each run
sorted as the block sort sorts it (``_sorted_columns``: fmin/fmax, which
drop a NaN), its sum, skill, NaN flag and ±inf counts on the loaded members
added in the block sort's order; adjacent runs merged in pairs, a tile at
a time (merge-path searches, A first on ties, then each thread's search in
the tile and its merge in registers) until two are left; the last merge's
gaps weighted by (k + 1) (M − k − 1) and squares about the mean (the runs'
sums in run order over M) added a thread's members in turn, a butterfly
over each warp, the warps in order, then the tiles by 32 lanes and a
butterfly, and the runs' partials in run order. Every word a search or a
merge reads is asserted to lie in its run. The emulation is held to the
port's plain versions and float64 on every edge (NaN, ±inf on both sides
of a run's edge, ties across it, −0.0 against +0.0, members all at one
infinity, bfloat16). The slice at 59,392 members (eight lagged HENS inits
pooled) runs through the port's statistics on the CPU against the JAX
package's. Tolerance: 1e-5 relative, as the JAX package's own
(``BASELINE.md:25``); 1e-2 for bfloat16 outputs, their rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_blocksort import _f64_spread
from test_torch_blocksort import _fma32
from test_torch_blocksort import _group_sum
from test_torch_blocksort import _infinite_spread
from test_torch_blocksort import _sorted_columns
from test_torch_blocksort import _thread_runs
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
BF16_RTOL = 1e-2
RUN = crps_pairwise.BLOCKSORT_RUN
# The kernel's tile: kThreads threads of kItems merged members.
THREADS, ITEMS = 256, 8
# Shrunken: runs of at most 32 or 64 members, tiles of 4 threads of 4.
SMALL = {'run_max': 32, 'threads': 4, 'items': 4}
SMALL64 = {'run_max': 64, 'threads': 8, 'items': 2}
M_LAGGED = 8 * 7424  # eight daily HENS inits valid at one time, pooled


class _Run:
  """A sorted run's words [lo, hi) of a list; a read outside them
  fails."""

  def __init__(self, words, lo, hi):
    self.words, self.lo, self.hi = words, lo, hi

  def __call__(self, i):
    assert 0 <= i < self.hi - self.lo, (
        f'a read at {i} outside a run of {self.hi - self.lo}')
    return self.words[self.lo + i]


def _co_rank(a, la, b, lb, d):
  """mergesort_stats.cu's co_rank: how many of the first d merged members
  are A's, A first on ties."""
  lo, hi = max(0, d - lb), min(d, la)
  while lo < hi:
    mid = (lo + hi) >> 1
    if a(mid) <= b(d - mid - 1):
      lo = mid + 1
    else:
      hi = mid
  return lo


def _merge_tile(a, la, b, lb, d0, d1, threads, items):
  """Ranks [d0, d1) of the merge of runs a and b as one block merges them:
  its ends by two searches, both runs' parts staged, each thread's search
  in the tile and its members merged in turn. Returns (members, the member
  of rank d1 or +inf)."""
  ia0, ia1 = _co_rank(a, la, b, lb, d0), _co_rank(a, la, b, lb, d1)
  jb0, jb1 = d0 - ia0, d1 - ia1
  na, nb = ia1 - ia0, jb1 - jb0
  staged = [a(ia0 + k) for k in range(na)] + [b(jb0 + k) for k in range(nb)]
  sa, sb = _Run(staged, 0, na), _Run(staged, na, na + nb)
  out = []
  for t in range(threads):
    dt = t * items
    count = max(0, min(items, d1 - d0 - dt))
    if not count:
      continue
    i = _co_rank(sa, na, sb, nb, dt)
    j = dt - i
    for _ in range(count):
      if i < na and (j >= nb or sa(i) <= sb(j)):
        out.append(sa(i))
        i += 1
      else:
        out.append(sb(j))
        j += 1
  after = np.inf
  if d1 < la + lb:
    after = a(ia1) if ia1 < la and (jb1 >= lb or a(ia1) <= b(jb1)) else b(jb1)
  assert len(out) == d1 - d0
  return out, after


def _merge_pair(col, a0, width, m, tile, threads, items):
  """The runs at a0 of width (cut at m) of a column (a list), merged tile
  by tile: (members of the pair, the member after each tile)."""
  la = min(width, m - a0)
  lb = max(0, min(width, m - a0 - la))
  a, b = _Run(col, a0, a0 + la), _Run(col, a0 + la, a0 + la + lb)
  merged, afters = [], []
  for d0 in range(0, la + lb, tile):
    out, after = _merge_tile(a, la, b, lb, d0, min(d0 + tile, la + lb),
                             threads, items)
    merged += out
    afters.append(after)
  return merged, afters


def _warp_sum(parts, threads):
  """(threads, k) per-thread values → a tile's sum: a butterfly over each
  warp of min(threads, 32), then the warps in order."""
  return _group_sum(parts, threads)


def _lanes_sum(tile_parts):
  """finish_kernel: lane l adds tiles l, l + 32, ... in turn, then a
  butterfly over the 32 lanes."""
  tiles = tile_parts.shape[0]
  lanes = np.zeros((32,) + tile_parts.shape[1:], np.float32)
  for t in range(tiles):
    lanes[t % 32] = (lanes[t % 32] + tile_parts[t]).astype(np.float32)
  return _group_sum(lanes, 32)


def _run_partials(x, yv, runs, run_members, m):
  """The block sort's run mode on the loaded members of each run: (sum,
  skill, NaN flag, +inf count, -inf count), each (runs, n), added a run of
  32 at a time, a thread's 32-runs in turn and over the run's threads."""
  n = x.shape[1]
  out = np.zeros((runs, 5, n), np.float32)
  for r in range(runs):
    v = x[r * run_members:min((r + 1) * run_members, m)]
    length = v.shape[0]
    threads = crps_pairwise.blocksort_config(length)[1]
    blocks = -(-length // RUN)
    per = np.zeros((5, blocks, n), np.float32)
    for b in range(blocks):
      for w in v[b * RUN:(b + 1) * RUN]:
        if yv is not None:
          per[0, b] = per[0, b] + w
          per[1, b] = per[1, b] + np.abs(w - yv)
      per[2, b] = np.isnan(v[b * RUN:(b + 1) * RUN]).any(0)
      per[3, b] = np.isposinf(v[b * RUN:(b + 1) * RUN]).sum(0)
      per[4, b] = np.isneginf(v[b * RUN:(b + 1) * RUN]).sum(0)
    for k in range(5):
      out[r, k] = _group_sum(_thread_runs(per[k], threads), threads)
  return out


def _emulate_mergesort(x, y=None, run_max=None, threads=THREADS,
                       items=ITEMS):
  """(spread, skill, mean, sq_dev) of the merge sort in float32 over
  x (m, *rest); skill, mean and sq_dev are None without y. run_max,
  threads and items shrink the kernel's runs and tiles."""
  m = x.shape[0]
  rest = x.shape[1:]
  x = np.asarray(x, np.float32).reshape(m, -1)
  n = x.shape[1]
  runs, run_members = crps_pairwise.merge_runs(m, run_max)
  assert runs >= 2 and runs & (runs - 1) == 0
  assert (runs - 1) * run_members < m <= runs * run_members
  tile = threads * items
  fused = y is not None
  yv = np.asarray(y, np.float32).reshape(-1) if fused else None
  with np.errstate(invalid='ignore', over='ignore'):
    parts = _run_partials(x, yv, runs, run_members, m)
    sums = np.zeros(n, np.float32)
    for r in range(runs):
      sums = (sums + parts[r, 0]).astype(np.float32)
    mean = (sums / np.float32(m)).astype(np.float32)
    # The runs, sorted as the block sort sorts them, side by side.
    col = np.empty((m, n), np.float32)
    for r in range(runs):
      lo, hi = r * run_members, min((r + 1) * run_members, m)
      run = x[lo:hi]
      if hi - lo <= RUN // 2:  # a shrunken run: the network's +inf pad
        run = np.concatenate([run, np.full((RUN // 2 + 1 - (hi - lo), n),
                                           np.inf, np.float32)])
      col[lo:hi] = _sorted_columns(run)[:hi - lo]
    spread = np.zeros(n, np.float32)
    sq_dev = np.zeros(n, np.float32)
    fm = np.float32(m)
    for p in range(n):
      words = [float(v) for v in col[:, p]]
      width = run_members
      while 2 * width < m:
        merged = []
        for a0 in range(0, m, 2 * width):
          merged += _merge_pair(words, a0, width, m, tile, threads, items)[0]
        words, width = merged, 2 * width
      merged, afters = _merge_pair(words, 0, width, m, tile, threads, items)
      v = np.asarray(merged, np.float32)
      nxt = np.append(v[1:], np.float32(np.inf))
      ends = np.arange(tile - 1, m, tile)
      nxt[ends] = np.asarray(afters, np.float32)[:len(ends)]
      tiles = -(-m // tile)
      pad = tiles * tile
      vv = np.full(pad, np.float32(0), np.float32)
      vv[:m] = v
      nn = np.zeros(pad, np.float32)
      nn[:m] = nxt
      k = np.arange(pad)
      c = (k + 1).astype(np.float32)
      w = (c * (fm - c)).astype(np.float32)
      gap = (nn - vv).astype(np.float32)
      d = (vv - mean[p]).astype(np.float32)
      acc = np.zeros((tiles, threads, 2), np.float32)
      for e in range(items):
        ke = (np.arange(tiles)[:, None] * tile + np.arange(threads)[None] * items
              + e)
        live_gap = ke + 1 < m
        g = _fma32(gap[ke], w[ke], acc[..., 0])
        acc[..., 0] = np.where(live_gap, g, acc[..., 0])
        if fused:
          q = _fma32(d[ke], d[ke], acc[..., 1])
          acc[..., 1] = np.where(ke < m, q, acc[..., 1])
      tile_parts = np.stack([_warp_sum(acc[t], threads) for t in range(tiles)])
      total = _lanes_sum(tile_parts)
      spread[p], sq_dev[p] = total[0], total[1]
    n_pos = parts[:, 3].sum(0)
    n_neg = parts[:, 4].sum(0)
    nan = parts[:, 2].sum(0) != 0
    out = (2 * spread).astype(np.float32)
    out = np.where(n_pos + n_neg > 0, _infinite_spread(m, n_pos, n_neg), out)
    out[nan] = np.nan
    if not fused:
      return out.reshape(rest), None, None, None
    skill = np.zeros(n, np.float32)
    for r in range(runs):
      skill = (skill + parts[r, 1]).astype(np.float32)
  return tuple(a.reshape(rest) for a in (out, skill, mean, sq_dev))


def _plain(x, y, dtype=torch.float32):
  xt, yt = torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)
  return crps_pairwise.fused_ensemble_stats_plain(xt, yt) + (
      crps_pairwise.pairwise_spread_sum_plain(xt),)


def _assert_matches(got, want, rtol, label):
  """Equal NaN and ±inf patterns, the finite values within rtol of
  max(|want|, 1)."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  for f in (np.isnan, np.isposinf, np.isneginf):
    np.testing.assert_array_equal(f(got), f(want), err_msg=label)
  ok = np.isfinite(want)
  err = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1)
  assert err.size == 0 or err.max() <= rtol, (label, err.max())


def _check(x, y, sizes, dtype=torch.float32):
  """The emulation's five outputs (its spread-only run too) against the
  plain versions and, float32 and finite, float64."""
  fused = _emulate_mergesort(x, y, **sizes)
  spread_only = _emulate_mergesort(x, None, **sizes)[0]
  got = fused + (spread_only,)
  rtol = RTOL if dtype == torch.float32 else BF16_RTOL
  if dtype != torch.float32:
    got = tuple(torch.from_numpy(np.asarray(g)).to(dtype).float().numpy()
                for g in got)
  want = _plain(x, y, dtype)
  names = ('spread', 'skill', 'mean', 'sq_dev', 'spread_only')
  for name, g, w in zip(names, got, want):
    _assert_matches(g, w.float().numpy(), rtol, name)
  if dtype == torch.float32:
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    with np.errstate(invalid='ignore'):
      truth = (_f64_spread(x), np.abs(x64 - y64).sum(0), x64.mean(0),
               ((x64 - x64.mean(0)) ** 2).sum(0), _f64_spread(x))
      for name, g, t in zip(names, got, truth):
        ok = np.isfinite(t)
        np.testing.assert_allclose(g[ok], t[ok], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
  return got


# -- the route and its plan ---------------------------------------------------


def _run_count_edges():
  """Both sides of each change of the merge sort's run count: k
  MERGESORT_RUN_MAX and one more, k = 4, 8, ... (two runs end before
  58,113 at 57,856)."""
  top, k, edges = crps_pairwise.MAX_MEMBERS, 4, []
  while k * crps_pairwise.MERGESORT_RUN_MAX < top:
    edges += [k * crps_pairwise.MERGESORT_RUN_MAX,
              k * crps_pairwise.MERGESORT_RUN_MAX + 1]
    k *= 2
  return edges


@pytest.mark.parametrize('m', [58113, M_LAGGED, 131072, 1 << 20]
                         + _run_count_edges())
def test_mergesort_is_the_form_past_58112(m):
  """Every count past one point's block sort to MAX_MEMBERS takes the merge
  sort: a power of two of runs, the fewest of at most MERGESORT_RUN_MAX
  members, each one the block sort takes (its run mode) with two blocks an
  SM."""
  assert crps_pairwise.spread_form(m) == 'mergesort'
  runs, run_members = crps_pairwise.merge_runs(m)
  last = m - (runs - 1) * run_members
  run_max = crps_pairwise.MERGESORT_RUN_MAX
  assert runs >= 2 and runs & (runs - 1) == 0
  assert (runs // 2) * run_max < m <= runs * run_max
  assert run_members <= run_max
  assert 33 <= last <= run_members
  for length in (run_members, last):
    assert length in crps_pairwise._FORM_MEMBERS['blocksort']
    points, _ = crps_pairwise.blocksort_config(length)
    assert 2 * (points * crps_pairwise.blocksort_stride(length, points) * 4
                + 1024) <= crps_pairwise.BLOCKSORT_SM_BYTES
  if m == M_LAGGED:
    assert (runs, run_members) == (4, 14848)


def test_every_count_leaves_each_run_a_block_sort():
  """Across 58,113..2^20 every run, the last too, has at least the block
  sort's 33 members: ceil(m / runs) stays far above the run count."""
  top = crps_pairwise.MAX_MEMBERS
  for m in list(range(58113, top + 1, 997)) + [top] + _run_count_edges():
    runs, run_members = crps_pairwise.merge_runs(m)
    assert 33 <= m - (runs - 1) * run_members <= run_members, m


@pytest.mark.parametrize('m,n', [(58113, 1024), (M_LAGGED, 69120),
                                 (1 << 20, 1024), (1 << 20, 3)])
def test_mergesort_plan_bounds_the_scratch(m, n):
  """The points go in equal batches under SCRATCH_BYTES of scratch, at the
  words a point the kernel lays out (two columns, five partials a run and
  two a tile of THREADS x ITEMS merged members; its
  wbx_mergesort_scratch_words), and the batches cover the n points."""
  runs, _ = crps_pairwise.merge_runs(m)
  tiles = -(-m // (THREADS * ITEMS))
  words = 2 * m + runs * 5 + tiles * 2
  batch = crps_pairwise.scratch_batch(n, words)
  assert 4 * words * batch <= crps_pairwise.SCRATCH_BYTES
  batches = -(-n // batch)
  last = n - (batches - 1) * batch
  assert 0 < last <= batch and batch - last < batches  # balanced
  if 4 * words * n <= crps_pairwise.SCRATCH_BYTES:
    assert batch == n


def test_mergesort_takes_max_members_and_refuses_one_more():
  """2^20 members are the kernels' bound: one more raises before any
  launch, a forced form raises where it cannot take the count."""
  top = crps_pairwise.MAX_MEMBERS
  assert top == 1 << 20 and crps_pairwise.spread_form(top) == 'mergesort'
  with pytest.raises(ValueError, match='at most'):
    crps_pairwise._launch_stats(torch.zeros((top + 1, 1)), None)
  with pytest.raises(ValueError, match='form does not take'):
    crps_pairwise._launch_stats(torch.zeros((58112, 1)), None,
                                form='mergesort')


# -- the emulation against the plain versions and float64 --------------------


@pytest.mark.parametrize('m,sizes', [
    (65, SMALL), (100, SMALL), (257, SMALL), (1000, SMALL), (2047, SMALL),
    (65, SMALL64), (300, SMALL64), (1000, SMALL64), (2000, SMALL64)],
                         ids=lambda v: f'run{v["run_max"]}'
                         if isinstance(v, dict) else str(v))
@pytest.mark.parametrize('offset,scale', [(0.0, 1.0), (288.0, 3.0)])
def test_mergesort_emulation_matches_plain_and_f64(m, sizes, offset, scale):
  """2 to 64 runs (the last run from 2 members to full), tiles of 16
  members; |mean| >> std included, where the gaps' terms, all >= 0, keep
  the spread within 1e-5 of float64."""
  rng = np.random.default_rng(m)
  x = (offset + scale * rng.standard_normal((m, 5))).astype(np.float32)
  y = (offset + scale * rng.standard_normal(5)).astype(np.float32)
  runs = crps_pairwise.merge_runs(m, sizes['run_max'])[0]
  assert 2 <= runs <= 64
  _check(x, y, sizes)


def _edge_rows(m, run_max):
  """(last member of run 0, first of run 1) of a merge sort's runs."""
  r = crps_pairwise.merge_runs(m, run_max)[1]
  return r - 1, r


@pytest.mark.parametrize('m', [65, 300, 2047])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
def test_mergesort_emulation_edges_at_a_run_boundary(m, dtype):
  """NaN and ±inf members on both sides of a run's edge (one each, both,
  opposite signs), NaN in the last member, ties across the edge, and −0.0
  against +0.0: the plain versions' values and NaN/±inf points."""
  rng = np.random.default_rng(m + 7)
  lo, hi = _edge_rows(m, SMALL['run_max'])
  x = rng.standard_normal((m, 12)).astype(np.float32)
  x[lo, 0] = np.inf
  x[hi, 1] = np.inf
  x[lo, 2], x[hi, 2] = -np.inf, np.inf
  x[lo, 3], x[hi, 3] = np.inf, np.inf
  x[hi, 4] = np.nan
  x[lo, 5] = np.nan
  x[m - 1, 6] = np.nan
  x[lo, 7] = x[hi, 7] = -np.inf
  x[:, 8] = np.round(x[:, 8])  # ties, many across the edge
  x[lo, 8] = x[hi, 8] = 1.0
  x[:, 9] = np.where(rng.random(m) < 0.5, np.float32(-0.0), np.float32(0.0))
  x[:, 10] = np.float32(-0.0)
  x[m // 3, 10] = 1.5
  x[lo, 11], x[hi, 11] = np.inf, np.nan
  y = rng.standard_normal(12).astype(np.float32)
  if dtype != torch.float32:
    x, y = (torch.from_numpy(a).to(dtype).float().numpy() for a in (x, y))
  got = _check(x, y, SMALL, dtype)
  assert got[0][9] == 0 and got[4][9] == 0
  if dtype == torch.float32:
    assert got[4][10] == 2 * 1.5 * (m - 1)
  assert np.isnan(got[0][[4, 5, 6, 11]]).all()
  assert np.isinf(got[1][[0, 1, 3]]).all()


@pytest.mark.parametrize('m', [65, 130, 1000])
@pytest.mark.parametrize('value', [np.inf, -np.inf])
def test_mergesort_emulation_all_members_one_infinity(m, value):
  """Every member at one infinity, or all but one, all ties through every
  merge: no search or merge reads past its run (asserted by each read),
  and the plain versions' NaN/inf."""
  x = np.full((m, 3), value, np.float32)
  x[m // 2, 1] = 0.5
  x[0, 2] = -value
  y = np.zeros(3, np.float32)
  _check(x, y, SMALL)


def test_mergesort_emulation_config_changes_only_rounding():
  """Other run and tile sizes add in another order: the same values
  within 1e-5."""
  rng = np.random.default_rng(11)
  x = rng.standard_normal((700, 6)).astype(np.float32)
  y = rng.standard_normal(6).astype(np.float32)
  a = _emulate_mergesort(x, y, **SMALL)
  b = _emulate_mergesort(x, y, **SMALL64)
  for name, g, h in zip(('spread', 'skill', 'mean', 'sq_dev'), a, b):
    np.testing.assert_allclose(g, h, rtol=RTOL, atol=ATOL, err_msg=name)


# -- the slice at the lagged-HENS count, small width --------------------------


def _stats(prob):
  return {'crps_skill': prob.CRPSSkill(),
          'crps_spread': prob.CRPSSpread(use_sort=True),
          'variance': prob.EnsembleVariance(),
          'unbiased_mse': prob.UnbiasedEnsembleMeanSquaredError()}


def _jax_values(x, y):
  p = {'v': j_darray.DimArray(jnp.asarray(x), ('number', 'point'))}
  t = {'v': j_darray.DimArray(jnp.asarray(y), ('point',))}
  return {k: np.asarray(s.compute(p, t)['v'].values, np.float64)
          for k, s in _stats(j_probabilistic).items()}


def _port_values(x, y):
  p = {'v': darray.DimArray(torch.from_numpy(x), ('number', 'point'))}
  t = {'v': darray.DimArray(torch.from_numpy(y), ('point',))}
  with base.computation_cache():
    return {k: s.compute(p, t)['v'].data.double().numpy()
            for k, s in _stats(probabilistic).items()}


@pytest.fixture(scope='module')
def lagged():
  """59,392 members (8 lagged HENS inits x 7,424) over 8 points, N(0, 1)
  and a N(0.5, 1) target, from a numpy seed."""
  rng = np.random.default_rng(M_LAGGED)
  x = rng.standard_normal((M_LAGGED, 8)).astype(np.float32)
  y = (0.5 + rng.standard_normal(8)).astype(np.float32)
  return x, y


@pytest.mark.parametrize('stats', ['plain', 'mergesort kernel emulated'])
def test_lagged_slice_matches_jax(stats, lagged, monkeypatch):
  """CRPSSkill, CRPSSpread(use_sort=True), EnsembleVariance and
  UnbiasedEnsembleMeanSquaredError at 59,392 members through the port's
  statistics on the CPU against the JAX package's (its jnp forms off the
  TPU: its default pairwise spread would broadcast 59,392^2 a point). 'plain'
  runs the port's CPU route; 'mergesort kernel emulated' swaps in the
  card's arithmetic at the card's own plan (four runs of 14,848, tiles of
  2,048), one fused pass and one spread-only pass."""
  x, y = lagged
  calls = []
  if stats != 'plain':
    def fused(xt, yt):
      calls.append(('fused', xt.shape[0]))
      return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                   _emulate_mergesort(xt.numpy(), yt.numpy()))

    def spread(xt):
      calls.append(('spread', xt.shape[0]))
      return torch.from_numpy(np.ascontiguousarray(
          _emulate_mergesort(xt.numpy())[0]))
    monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', fused)
    monkeypatch.setattr(crps_pairwise, 'pairwise_spread_sum', spread)
  got = _port_values(x, y)
  want = _jax_values(x, y)
  if stats != 'plain':
    assert calls == [('fused', M_LAGGED)]
  assert sorted(got) == sorted(want)
  for k in want:
    assert np.isfinite(got[k]).all(), k
    np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize('value', [np.inf, -np.inf])
def test_lagged_infinities_follow_the_plain_versions(value, lagged):
  """±inf members at 59,392 on both sides of the card's run edges (14,847
  and 14,848, and the middle merge's 29,695 and 29,696), all members at
  one infinity, and NaN beside them: the emulation at the card's plan gives
  the plain versions' values and points (not the JAX jnp.sort form's, which
  gives NaN where the median member is infinite at odd M: ROADMAP §C)."""
  x, y = lagged
  x = x[:, :6].copy()
  y = y[:6].copy()
  runs, r = crps_pairwise.merge_runs(M_LAGGED)
  assert (runs, r) == (4, 14848)
  x[r - 1, 0] = value
  x[r, 1] = value
  x[2 * r - 1, 2], x[2 * r, 2] = value, -value
  x[:, 3] = value
  x[r, 4], x[r - 1, 4] = np.nan, value
  x[:M_LAGGED // 2 + 1, 5] = value
  got = _emulate_mergesort(x, y)
  want = _plain(x, y)
  for name, g, w in zip(('spread', 'skill', 'mean', 'sq_dev'), got, want):
    _assert_matches(g, w.numpy(), RTOL, name)
  assert np.isnan(got[0][[3, 4, 5]]).all()
  assert np.isinf(got[0][[0, 1]]).all()
