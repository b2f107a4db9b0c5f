"""The sorted-runs form of the fused and spread-only kernels (65..256
members), on the CPU.

The CUDA kernel (``ops/csrc/sorted_stats.cuh``) runs only on the card, so
its arithmetic is emulated here in float32 numpy, step for step: the runs
of ``crps_pairwise.sorted_runs(M)`` padded with +inf and sorted by
``sort_network`` with fmin/fmax, the two merge walks over the run heads
(up from the smallest members and down from the largest, the lowest run on
a tie, ±inf past a run's end) adding fma(2k + 1 − M, x_(k) − x_(M−1−k),
acc) (the median-shifted weighted sum with each rank paired with its
mirror), the NaN flag from the loaded values, and sum, skill, mean and the
two-pass sq_dev as the kernel takes them. The emulation is held against the JAX package's sort
body and against the port's plain versions.

The JAX kernel in interpret mode costs 12 s at 65 members and minutes past
100 (the Pallas interpreter traces its whole network), so it runs here at
65 members; at the other counts the JAX side is its kernel body
``_spread_value_sort``, the same jnp arithmetic the interpreter runs,
called on the array. Tolerance: 1e-5 relative, as the JAX package's own
(``BASELINE.md:25``), against JAX, the plain versions and float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_crps_pairwise import _apply_network
from test_torch_crps_pairwise import _assert_same_spread
from test_torch_crps_pairwise import _infinite_members
from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu.ops import crps_pairwise as j_crps
from weatherbenchx_tpu.parallel import evaluator as j_evaluator
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
L = crps_pairwise.SORTED_MAX_MEMBERS
# Both ends of the route, both sides of each change in the number of runs
# (2 runs to 128 members, 3 to 192, 4 to L) and the paths' 100 and 101.
SORTED_CASES = (65, 100, 101, 127, 128, 129, L)


def _fma32(a, b, c):
  """float32 fma(a, b, c): the float64 product is exact, one rounding."""
  with np.errstate(invalid='ignore', over='ignore'):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


class _RunWalk:
  """The kernel's merge walk (``RunWalk`` in sorted_stats.cuh) over the
  sorted runs s (runs * size, n), every point at once: up from the runs'
  first members or down from their last, the lowest run on a tie, an
  exhausted run's head +inf going up and -inf going down. An exhausted run
  that wins a tie (every head left its infinity) is not advanced, and every
  row read is asserted to lie inside its run, as the kernel must keep it."""

  def __init__(self, s, runs, size, m, up):
    self.s, self.runs, self.up = s, runs, up
    self.cols = np.arange(s.shape[1])
    self.first = np.arange(runs) * size
    self.last = np.minimum(self.first + size, m) - 1
    self.pos = np.repeat((self.first if up else self.last)[:, None],
                         s.shape[1], 1)
    self.stop = self.last + 1 if up else self.first - 1
    self.head = s[self.pos, self.cols]

  def take(self):
    best = np.zeros(self.s.shape[1], int)
    v = self.head[0].copy()
    for r in range(1, self.runs):
      better = self.head[r] < v if self.up else self.head[r] > v
      v = np.where(better, self.head[r], v)
      best = np.where(better, r, best)
    end = self.stop[best]
    nxt = self.pos[best, self.cols]
    nxt = np.minimum(nxt + 1, end) if self.up else np.maximum(nxt - 1, end)
    read = nxt != end
    inside = (self.first[best] <= nxt) & (nxt <= self.last[best])
    assert inside[read].all(), 'a walk read a row outside its run'
    h = np.where(read, self.s[np.where(read, nxt, 0), self.cols],
                 np.float32(np.inf if self.up else -np.inf))
    self.pos[best, self.cols] = nxt
    self.head[best, self.cols] = h
    return v


def _emulate_sorted_stats(x, y=None):
  """(spread, skill, mean, sq_dev) of the sorted-runs kernel, float32,
  over x (m, *rest); skill, mean and sq_dev are None without y."""
  m = x.shape[0]
  rest = x.shape[1:]
  runs, size = crps_pairwise.sorted_runs(m)
  x = np.ascontiguousarray(x, np.float32).reshape(m, -1)
  n = x.shape[1]
  nan = np.isnan(x).any(0)
  s = np.empty((runs * size, n), np.float32)
  for r in range(runs):
    run = x[r * size:(r + 1) * size]
    pad = np.full((size - len(run), n), np.inf, np.float32)
    s[r * size:(r + 1) * size] = _apply_network(
        np.concatenate([run, pad]), size)
  total = np.zeros(n, np.float32)
  skill = np.zeros(n, np.float32)
  with np.errstate(invalid='ignore', over='ignore'):
    if y is not None:
      yv = np.asarray(y, np.float32).reshape(-1)
      for i in range(m):  # in member order, as loaded
        total = total + x[i]
        skill = skill + np.abs(x[i] - yv)
    mean = total / np.float32(m)
    up = _RunWalk(s, runs, size, m, up=True)
    down = _RunWalk(s, runs, size, m, up=False)
    acc = np.zeros(n, np.float32)
    sq = np.zeros(n, np.float32)
    for k in range(m // 2):
      lo, hi = up.take(), down.take()
      acc = _fma32(2 * k + 1 - m, lo - hi, acc)
      sq = _fma32(lo - mean, lo - mean, sq)
      sq = _fma32(hi - mean, hi - mean, sq)
    if m % 2:  # the median, whose weight is 0
      d = up.take() - mean
      sq = _fma32(d, d, sq)
  spread = np.float32(2) * acc
  spread[nan] = np.nan
  if y is None:
    return spread.reshape(rest), None, None, None
  return tuple(a.reshape(rest) for a in (spread, skill, mean, sq))


def _f64_spread(x):
  """Σ_{i≠j}|x_i − x_j| per point in float64, by pairs, 64 points at a
  time."""
  x = x.astype(np.float64).reshape(x.shape[0], -1)
  return np.concatenate([
      np.abs(x[:, None, lo:lo + 64] - x[None, :, lo:lo + 64]).sum((0, 1))
      for lo in range(0, x.shape[1], 64)])


def _jax_sort_body(x):
  """The JAX spread kernel's sort body (``_spread_value_sort``), the jnp
  arithmetic its Pallas kernel runs from 20 members on."""
  return np.asarray(j_crps._spread_value_sort(jnp.asarray(x), x.shape[0]))


@pytest.mark.parametrize('m', [65, 96, 100, 101, 127, 128, 129, 192, 193, L])
def test_sorted_runs_cut_into_runs_of_at_most_64(m):
  runs, size = crps_pairwise.sorted_runs(m)
  assert crps_pairwise.spread_form(m) == 'sorted'
  assert runs == -(-m // 64) and size <= 64 and runs <= 4
  assert size in crps_pairwise.SORTED_RUN_SIZES
  # The smallest compiled size that holds the runs: every run but the last
  # full, and the last holding at least one member.
  assert size == min(r for r in crps_pairwise.SORTED_RUN_SIZES
                     if runs * r >= m)
  last = m - (runs - 1) * size
  assert 1 <= last <= size
  if m in (100, 101):
    assert (runs, size) == (2, 50 if m == 100 else 51)


def test_sorted_run_sizes_are_33_to_64():
  """Five compiled run sizes from 33 to 64 serve every count of the route,
  each used by some count, the largest 64 (full runs)."""
  assert crps_pairwise.SORTED_RUN_SIZES == (33, 43, 50, 51, 64)
  assert list(crps_pairwise.SORTED_MEMBERS) == list(range(65, L + 1))
  used = {crps_pairwise.sorted_runs(m)[1] for m in crps_pairwise.SORTED_MEMBERS}
  assert used == set(crps_pairwise.SORTED_RUN_SIZES)


@pytest.mark.parametrize('m', SORTED_CASES)
@pytest.mark.parametrize('offset,scale', [(0.0, 1.0), (288.0, 3.0)])
def test_sorted_emulation_matches_jax_and_plain(m, offset, scale):
  """|mean| >> std included: pairing each rank with its mirror keeps every
  term >= 0, as the median shift does, so the emulation stays within 1e-5
  of float64 where the JAX sort body's unshifted weights lose digits."""
  rng = np.random.default_rng(m)
  x = (offset + scale * rng.standard_normal((m, 4, 96))).astype(np.float32)
  got = _emulate_sorted_stats(x)[0]
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  truth = _f64_spread(x).reshape(x.shape[1:])
  jax_ = _jax_sort_body(x)
  np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(got, truth, rtol=RTOL, atol=ATOL)
  jax_err = np.abs(jax_ - truth).max() / np.abs(truth).max()
  if jax_err <= RTOL:
    np.testing.assert_allclose(got, jax_, rtol=RTOL, atol=ATOL)
  else:
    # JAX's own float32 error passes RTOL (|mean| >> std, or the largest
    # M); the port is held to float64 above, and is the closer of the two.
    assert np.abs(got - truth).max() < np.abs(jax_ - truth).max()
  if offset:
    assert jax_err > RTOL


@pytest.mark.parametrize('m', SORTED_CASES)
def test_sorted_fused_emulation_matches_plain(m):
  """Skill, mean and the two-pass sq_dev, with temperatures near 288 K."""
  rng = np.random.default_rng(m + 1)
  x = (288 + 3 * rng.standard_normal((m, 3, 80))).astype(np.float32)
  y = (288 + 3 * rng.standard_normal((3, 80))).astype(np.float32)
  got = _emulate_sorted_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  x64, y64 = x.astype(np.float64), y.astype(np.float64)
  truth = (_f64_spread(x).reshape(y.shape), np.abs(x64 - y64).sum(0),
           x64.mean(0), ((x64 - x64.mean(0)) ** 2).sum(0))
  for name, g, p, t in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain,
                           truth):
    assert g.dtype == np.float32 and g.shape == y.shape, name
    np.testing.assert_allclose(g, p.numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=name)
    np.testing.assert_allclose(g, t, rtol=RTOL, atol=ATOL, err_msg=name)


def test_sorted_emulation_matches_the_jax_kernel_in_interpret_mode():
  """The JAX fused kernel itself (the Pallas interpreter) at 65 members,
  its sort body, with a NaN member and +-inf members at other points."""
  m = 65
  rng = np.random.default_rng(7)
  x = rng.standard_normal((m, 8, 128)).astype(np.float32)
  y = rng.standard_normal((8, 128)).astype(np.float32)
  x[3, 0, 0] = np.nan
  x[0, 0, 1] = np.inf
  x[m - 1, 0, 2] = -np.inf
  x[:40, 0, 3] = np.inf  # more than half +inf: terms of both signs, NaN
  want = j_crps.fused_ensemble_stats(jnp.asarray(x), jnp.asarray(y),
                                     interpret=True)
  got = _emulate_sorted_stats(x, y)
  for name, g, w in zip(('spread', 'skill', 'mean', 'sq_dev'), got, want):
    _assert_same_spread(g, np.asarray(w), name)
  assert np.isnan(got[0][0, 0]) and np.isposinf(got[0][0, 1:3]).all()
  assert np.isnan(got[0][0, 3])


@pytest.mark.parametrize('m', [65, 101, 129, L])
def test_sorted_emulation_nan_at_every_member_position(m):
  """Point p holds a NaN at member p: the network's fmin/fmax lose it, the
  flag keeps it, and it poisons that point alone, in every output."""
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, m + 40)).astype(np.float32)
  y = rng.standard_normal(m + 40).astype(np.float32)
  for p in range(m):
    x[p, p] = np.nan
  got = _emulate_sorted_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  want_nan = np.arange(m + 40) < m
  for name, g, p in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain):
    np.testing.assert_array_equal(np.isnan(g), want_nan, err_msg=name)
    np.testing.assert_allclose(g[m:], p.numpy()[m:], rtol=RTOL, atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize('m', SORTED_CASES)
def test_sorted_emulation_infinities_follow_jax_and_plain(m):
  """The seven +-inf columns of ``_infinite_members``: the JAX sort body's
  inf and NaN points (inf while the infinite members' weights share one
  sign, a median infinite included at odd m; NaN at m//2 + 2 of +inf)."""
  x = _infinite_members(m)
  got = _emulate_sorted_stats(x)[0]
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  fused = crps_pairwise.fused_ensemble_stats_plain(
      torch.from_numpy(x), torch.zeros(7))[0].numpy()
  jax_ = _jax_sort_body(x)
  _assert_same_spread(got, plain, 'plain')
  _assert_same_spread(got, fused, 'fused plain')
  _assert_same_spread(got, jax_, 'jax')
  # infinite_spread (csrc/common.cuh): NaN once more than (m + 1) / 2
  # members share one infinity, which at even m is already m//2 + 1.
  half = [np.inf if m % 2 else np.nan] * 2
  np.testing.assert_array_equal(got, [np.inf] * 4 + half + [np.nan])


@pytest.mark.parametrize('m', [65, 101, 129, L])
def test_sorted_emulation_infinities_at_a_run_edge(m):
  """+-inf members on either side of the edge between the first two runs,
  at the last member (the tail run, beside its +inf pads), and an
  exhausted run's +inf head against a real +inf: the plain version's
  points."""
  runs, size = crps_pairwise.sorted_runs(m)
  rng = np.random.default_rng(m + 2)
  x = rng.standard_normal((m, 9)).astype(np.float32)
  x[size - 1, 0] = np.inf
  x[size, 1] = np.inf
  x[size - 1, 2] = x[size, 2] = np.inf
  x[size - 1, 3] = -np.inf
  x[size, 4] = -np.inf
  x[m - 1, 5] = np.inf
  x[size - 1, 6], x[m - 1, 6] = -np.inf, np.inf
  x[-(m // 2 - 1):, 7] = np.inf  # the tail run all +inf, as its pads
  x[(runs - 1) * size:, 8] = np.nan
  got = _emulate_sorted_stats(x)[0]
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  _assert_same_spread(got, plain, f'm={m}')
  _assert_same_spread(got, _jax_sort_body(x), f'jax m={m}')
  assert np.isposinf(got[:8]).all() and np.isnan(got[8])


@pytest.mark.parametrize('m', [65, 100, 128, 129, 130, 192, 193, 205, L])
@pytest.mark.parametrize('value', [np.inf, -np.inf])
def test_sorted_emulation_all_members_one_infinity(m, value):
  """Every member of a point one infinity, or all but one: the walk going
  toward it exhausts run 0 and then meets only that infinity, so the used-up
  run keeps winning the tie; it must not be advanced past its end (the
  walk asserts every row it reads lies in its run). Each point is NaN, as
  the plain version and the JAX sort body give."""
  rng = np.random.default_rng(m + 3)
  x = rng.standard_normal((m, 6)).astype(np.float32)
  x[:, :4] = value
  runs, size = crps_pairwise.sorted_runs(m)
  x[0, 1] = 0.0  # one finite member in the first run
  x[m - 1, 2] = 0.0  # in the last run
  x[size, 3] = -value  # one of the other infinity, in the second run
  x[:m // 2 + 2, 4] = value  # more than half
  y = rng.standard_normal(6).astype(np.float32)
  got = _emulate_sorted_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  for name, g, p in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain):
    _assert_same_spread(g, p.numpy(), f'{name} m={m}')
  _assert_same_spread(got[0], _jax_sort_body(x), f'jax m={m}')
  assert np.isnan(got[0][:5]).all() and np.isfinite(got[0][5])


# -- the main path at 101 members, small width -------------------------------------

M101, N_LEAD, N_LAT, N_LON = 101, 2, 19, 36
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-20, 20), (0, 360)),
           'extratropics_north': ((20, 90), (0, 360))}


def _main_pair(mod, x, y, mask):
  lat = np.linspace(90, -90, N_LAT)
  lon = np.linspace(0, 360, N_LON, endpoint=False)
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')]),
      'lead_time': (np.arange(N_LEAD) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
      'mask': mod.Coord(('latitude', 'longitude'), mask)}
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  return ({'t2m': mod.DimArray(x.copy(), ('number',) + dims,
                               dict(coords, number=np.arange(M101)))},
          {'t2m': mod.DimArray(y.copy(), dims, coords)})


def _main_metrics(prob):
  return {'crps': prob.CRPSEnsemble(use_sort=True),
          'spread_skill': prob.UnbiasedSpreadSkillRatio(),
          'unbiased_mean_rmse': prob.UnbiasedEnsembleMeanRMSE()}


def _main_aggregator(agg_mod, bin_mod, w_mod, darray_mod):
  lat = np.linspace(-90, 90, N_LAT)
  lon = np.linspace(0, 360, N_LON, endpoint=False)
  land = (np.cos(np.deg2rad(lat))[:, None]
          * np.sin(3 * np.deg2rad(lon))[None, :]) > 0.3
  return agg_mod.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[w_mod.GridAreaWeighting()],
      bin_by=[bin_mod.Regions(REGIONS, land_sea_mask=darray_mod.DimArray(
          land, ('latitude', 'longitude'),
          {'latitude': lat, 'longitude': lon}))],
      masked=True)


@pytest.mark.parametrize('stats', ['plain', 'sorted kernel emulated'])
def test_main_path_at_101_members_matches_jax(stats, monkeypatch):
  """Phase 4's configuration at 101 members (101 x 1 x 2 x 19 x 36, fair
  CRPS, unbiased spread/skill and ensemble-mean RMSE, area-weighted over
  3 regions and their land parts, masked) through the port's
  ChunkEvaluator on the CPU, against the JAX package's evaluator (its jnp
  reference off the TPU). 'sorted kernel emulated' swaps the port's fused
  statistics for the sorted-runs kernel's arithmetic: the route the card
  takes at 101 members."""
  rng = np.random.default_rng(101)
  x = rng.standard_normal((M101, 1, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  y = rng.standard_normal((1, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  mask = np.ones((N_LAT, N_LON), bool)
  mask[[0, -1]] = False
  assert crps_pairwise.spread_form(M101) == 'sorted'
  if stats != 'plain':
    calls = []

    def emulated(xt, yt):
      calls.append(xt.shape[0])
      return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                   _emulate_sorted_stats(xt.numpy(), yt.numpy()))
    monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', emulated)
  j_metrics = _main_metrics(j_probabilistic)
  want = j_evaluator.ChunkEvaluator(
      j_metrics, _main_aggregator(j_aggregation, j_binning, j_weighting,
                                  j_darray),
  ).eval_chunk(*_main_pair(j_darray, x, y, mask)).metric_values(j_metrics)
  metrics = _main_metrics(probabilistic)
  ev = evaluator.ChunkEvaluator(
      metrics, _main_aggregator(aggregation, binning, weighting, darray),
      device='cpu')
  got = ev.eval_chunk(*_main_pair(darray, x, y, mask)).metric_values(metrics)
  if stats != 'plain':
    assert calls == [M101]  # one fused pass serves the three metrics
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims == ('lead_time', 'region'), k
    w = np.asarray(want[k].values, np.float64)
    g = got[k].values.astype(np.float64)
    assert np.isfinite(g).all(), k
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6, err_msg=k)
