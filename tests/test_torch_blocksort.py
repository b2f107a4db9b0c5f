"""The block sorts of the fused and spread-only kernels (257..58,112
members), on the CPU.

The CUDA kernels (``ops/csrc/blocksort_stats.cu``) run only on the card, so
their arithmetic is emulated here in float32 numpy, step for step: the
runs of 32 members padded with +inf and sorted by ``sort_network(32)``
with fmin/fmax; the flip-form bitonic merge of every level (each
compare-exchange putting the minimum at the lower index, the +inf past M
never moved); the gap-weighted sum in the kernel's two levels (a run's 32
fma terms, a thread's runs in turn, a butterfly over each warp and the
warps in order, ``blocksort_config``); the NaN flag, the ±inf counts,
skill and the sum on the loaded values; the mean from the group's sum, and
the two-pass squares about it over each sorted run. The emulations are
held against the JAX package's sort forms and against the port's plain
versions; the slice at HENS's 7,424 members runs
through the port's ChunkEvaluator against the JAX package's. Tolerance:
1e-5 relative, as the JAX package's own (``BASELINE.md:25``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_crps_pairwise import _apply_network
from test_torch_crps_pairwise import _assert_same_spread
from test_torch_crps_pairwise import _infinite_members
from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu.parallel import evaluator as j_evaluator
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
RUN = crps_pairwise.BLOCKSORT_RUN
# The form's first count, 300 (the wide shape of chip_ab.py), one tile of
# the tiled pair form it replaces and one past it, 4,000 and HENS's 7,424.
BLOCKSORT_CASES = (257, 300, 1816, 1817, 4000, 7424)


def _f32(a):
  return np.asarray(a, np.float32)


def _fma32(a, b, c):
  """float32 fma(a, b, c): the float64 product is exact, one rounding."""
  with np.errstate(invalid='ignore', over='ignore'):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _sorted_columns(x):
  """x (m, n) float32 sorted down axis 0 as the kernel sorts it: runs of 32
  (the last padded with +inf) by the network, then every level of the
  flip-form bitonic merge over the next power of two (the pad +inf, which
  no compare-exchange moves). Returns the (v, n) array, v = 2^ceil(log2
  m), and asserts the pad untouched."""
  m, n = x.shape
  log2v = (m - 1).bit_length()
  v = 1 << log2v
  s = np.full((v, n), np.inf, np.float32)
  s[:m] = x
  runs = s.reshape(v // RUN, RUN, n).transpose(1, 0, 2).reshape(RUN, -1)
  runs = _apply_network(runs, RUN)
  s = runs.reshape(RUN, v // RUN, n).transpose(1, 0, 2).reshape(v, n)
  idx = np.arange(v)
  for level in range(6, log2v + 1):
    masks = [(1 << level) - 1] + [1 << b for b in range(level - 2, -1, -1)]
    for bit, mask in zip(range(level - 1, -1, -1), masks):
      lo = idx[(idx >> bit) & 1 == 0]
      hi = lo ^ mask
      a, b = s[lo], s[hi]
      s[lo], s[hi] = np.fmin(a, b), np.fmax(a, b)
  assert np.isposinf(s[m:]).all(), 'a compare-exchange moved the pad'
  return s


def _group_sum(parts, threads):
  """The kernel's group_sums over per-thread values (threads, n): a
  butterfly over each warp (width min(threads, 32)), then the warps' sums
  in warp order."""
  parts = _f32(parts)
  width = min(threads, 32)
  warps = []
  for w in range(0, threads, width):
    v = parts[w:w + width].copy()
    off = width // 2
    while off:
      v = (v + v[np.arange(width) ^ off]).astype(np.float32)
      off //= 2
    warps.append(v[0])
  total = warps[0]
  for w in warps[1:]:
    total = (total + w).astype(np.float32)
  return total


def _thread_runs(per_run, threads):
  """(threads, n): each thread's runs t, t + threads, ... added in turn
  from 0, as the kernel's loop over its runs does."""
  runs, n = per_run.shape
  out = np.zeros((threads, n), np.float32)
  for q in range(-(-runs // threads)):
    block = per_run[q * threads:(q + 1) * threads]
    out[:len(block)] = (out[:len(block)] + block).astype(np.float32)
  return out


def _infinite_spread(m, n_pos, n_neg):
  """common.cuh's infinite_spread: the JAX sort body's inf or NaN."""
  nan = (2 * n_pos > m + 1) | (2 * n_neg > m + 1)
  return np.where(nan, np.float32(np.nan), np.float32(np.inf))


def _emulate_blocksort_stats(x, y=None, config=None):
  """(spread, skill, mean, sq_dev) of the block-sort kernel in float32 over
  x (m, *rest); skill, mean and sq_dev are None without y."""
  m = x.shape[0]
  rest = x.shape[1:]
  x = _f32(x).reshape(m, -1)
  n = x.shape[1]
  _, threads = config or crps_pairwise.blocksort_config(m)
  runs = -(-m // RUN)
  fused = y is not None
  with np.errstate(invalid='ignore', over='ignore'):
    # The run pass, on the loaded (unsorted) members, run by run: the flag,
    # the counts, and each run's sum and skill in member order.
    nan = np.isnan(x).any(0)
    n_pos = np.isposinf(x).sum(0)
    n_neg = np.isneginf(x).sum(0)
    run_sum = np.zeros((runs, n), np.float32)
    run_skill = np.zeros((runs, n), np.float32)
    if fused:
      yv = _f32(y).reshape(-1)
      for b in range(runs):
        for v in x[b * RUN:(b + 1) * RUN]:
          run_sum[b] = run_sum[b] + v
          run_skill[b] = run_skill[b] + np.abs(v - yv)
      mean = (_group_sum(_thread_runs(run_sum, threads), threads)
              / np.float32(m)).astype(np.float32)
    # The sort; each sorted run's gaps, k' (m - k') the pairs across them,
    # and its squares about the mean.
    s = _sorted_columns(x)
    gaps = np.zeros((runs, n), np.float32)
    sq = np.zeros((runs, n), np.float32)
    fm = np.float32(m)
    for b in range(runs):
      for i in range(RUN):
        k = b * RUN + i
        if k + 1 < m:
          cnt = np.float32(k + 1)
          gaps[b] = _fma32(s[k + 1] - s[k], np.float32(cnt * (fm - cnt)),
                           gaps[b])
        if fused and k < m:
          d = (s[k] - mean).astype(np.float32)
          sq[b] = _fma32(d, d, sq[b])
    spread = _group_sum(_thread_runs(gaps, threads), threads)
    out = (2 * spread).astype(np.float32)
    out = np.where(n_pos + n_neg > 0, _infinite_spread(m, n_pos, n_neg), out)
    out[nan] = np.nan
    if not fused:
      return out.reshape(rest), None, None, None
    skill = _group_sum(_thread_runs(run_skill, threads), threads)
    sq_dev = _group_sum(_thread_runs(sq, threads), threads)
  return tuple(a.reshape(rest) for a in (out, skill, mean, sq_dev))


def _f64_spread(x):
  """Σ_{i≠j}|x_i − x_j| per point in float64 (sorted form, exact
  enough)."""
  s = np.sort(x.astype(np.float64).reshape(x.shape[0], -1), axis=0)
  m = s.shape[0]
  w = np.arange(1, m) * (m - np.arange(1, m))
  return 2 * (np.diff(s, axis=0) * w[:, None]).sum(0)


def _jax_spread(x):
  """The JAX package's CRPSSpread(use_sort=True) off the TPU (its jnp.sort
  form), times m (m - 1): the spread sum."""
  m = x.shape[0]
  p = {'v': j_darray.DimArray(jnp.asarray(x), ('number', 'point'))}
  t = {'v': j_darray.DimArray(jnp.asarray(x[0]), ('point',))}
  got = j_probabilistic.CRPSSpread(use_sort=True).compute(p, t)['v']
  return np.asarray(got.values, np.float64) * m * (m - 1)


def _jax_stats(x, y):
  """The JAX package's standalone statistics off the TPU: (CRPSSkill,
  EnsembleVariance) of x (m, point) against y (point)."""
  p = {'v': j_darray.DimArray(jnp.asarray(x), ('number', 'point'))}
  t = {'v': j_darray.DimArray(jnp.asarray(y), ('point',))}
  stats = (j_probabilistic.CRPSSkill(), j_probabilistic.EnsembleVariance())
  return tuple(np.asarray(s.compute(p, t)['v'].values, np.float64)
               for s in stats)


def _points(m):
  """Points per case: fewer at the largest counts, so that each case takes
  a second or two."""
  return 12 if m > 2000 else 48


@pytest.mark.parametrize('m', BLOCKSORT_CASES)
def test_blocksort_is_the_form_from_257_members(m):
  assert crps_pairwise.spread_form(m) == 'blocksort'
  points, threads = crps_pairwise.blocksort_config(m)
  runs = -(-m // RUN)
  assert points & (points - 1) == 0 and threads & (threads - 1) == 0
  assert 32 <= points * threads <= crps_pairwise.BLOCKSORT_THREADS
  assert runs <= 2 * threads or threads == crps_pairwise.BLOCKSORT_THREADS
  # Two blocks an SM.
  assert 2 * (points * crps_pairwise.blocksort_stride(m, points) * 4
              + 1024) <= crps_pairwise.BLOCKSORT_SM_BYTES
  if m == 7424:  # two points, 8 bytes of each member row's sector
    assert (points, threads) == (2, 128)


@pytest.mark.parametrize('m', [crps_pairwise.SORTED_MAX_MEMBERS,
                               crps_pairwise.SORTED_MAX_MEMBERS + 1,
                               crps_pairwise.BLOCKSORT_MAX_MEMBERS,
                               crps_pairwise.BLOCKSORT_MAX_MEMBERS + 1])
def test_blocksort_route_edges(m):
  """256 is the sorted runs' last count, 257 the block sort's first; one
  point's members fill a block's 227 KB at 58,112, past which the merge
  sort of block-sorted runs takes over."""
  want = {256: 'sorted', 257: 'blocksort', 58112: 'blocksort',
          58113: 'mergesort'}[m]
  assert crps_pairwise.spread_form(m) == want
  assert crps_pairwise.BLOCKSORT_MAX_MEMBERS == 232448 // 4 == 58112
  if want == 'blocksort':
    points, _ = crps_pairwise.blocksort_config(m)
    assert points * crps_pairwise.blocksort_stride(m, points) * 4 <= 232448


@pytest.mark.parametrize('m', [257, 300, 1000, 4001, 58112])
def test_sorted_columns_sort(m):
  """The network runs and the bitonic levels sort, whatever m."""
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, 2)).astype(np.float32)
  np.testing.assert_array_equal(_sorted_columns(x)[:m], np.sort(x, axis=0))


@pytest.mark.parametrize('m', BLOCKSORT_CASES)
@pytest.mark.parametrize('offset,scale', [(0.0, 1.0), (288.0, 3.0)])
def test_blocksort_emulation_matches_jax_and_plain(m, offset, scale):
  """The spread against the port's plain version, float64 and the JAX
  package's jnp.sort form; |mean| >> std included, where the gaps' terms,
  all >= 0, keep the emulation within 1e-5 of float64 and the JAX form's
  unshifted weights may not."""
  rng = np.random.default_rng(m)
  x = (offset + scale * rng.standard_normal((m, _points(m)))).astype(
      np.float32)
  got = _emulate_blocksort_stats(x)[0]
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  truth = _f64_spread(x)
  np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(got, truth, rtol=RTOL, atol=ATOL)
  jax_ = _jax_spread(x)
  jax_err = np.abs(jax_ - truth).max() / np.abs(truth).max()
  if jax_err <= RTOL:
    np.testing.assert_allclose(got, jax_, rtol=RTOL, atol=ATOL)
  else:
    assert np.abs(got - truth).max() < np.abs(jax_ - truth).max()


@pytest.mark.parametrize('m', BLOCKSORT_CASES)
def test_blocksort_fused_emulation_matches_jax_and_plain(m):
  """Skill, mean and the two-pass sq_dev with temperatures near 288 K,
  against the
  plain versions, float64 and the JAX package's CRPSSkill and
  EnsembleVariance."""
  rng = np.random.default_rng(m + 1)
  n = _points(m)
  x = (288 + 3 * rng.standard_normal((m, n))).astype(np.float32)
  y = (288 + 3 * rng.standard_normal(n)).astype(np.float32)
  got = _emulate_blocksort_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  x64, y64 = x.astype(np.float64), y.astype(np.float64)
  truth = (_f64_spread(x), np.abs(x64 - y64).sum(0), x64.mean(0),
           ((x64 - x64.mean(0)) ** 2).sum(0))
  for name, g, p, t in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain,
                           truth):
    assert g.dtype == np.float32 and g.shape == (n,), name
    np.testing.assert_allclose(g, p.numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=name)
    np.testing.assert_allclose(g, t, rtol=RTOL, atol=ATOL, err_msg=name)
  skill, var = _jax_stats(x, y)
  np.testing.assert_allclose(got[1] / m, skill, rtol=RTOL, err_msg='skill')
  np.testing.assert_allclose(got[3] / (m - 1), var, rtol=RTOL, err_msg='var')


def _nan_rows(m):
  """Member rows that take a NaN: the first, the middle, the last, and the
  form's own edges: each side of a run of 32, of the first shared stage's
  half (the largest power of two below m) and of the last run."""
  half = 1 << ((m - 1).bit_length() - 1)
  last = (m - 1) // RUN * RUN
  return sorted({0, m // 2, m - 1, RUN - 1, RUN, half - 1, half, last - 1,
                 last})


@pytest.mark.parametrize('m', [257, 300, 1817, 7424])
def test_blocksort_emulation_nan_positions(m):
  """A NaN at each of _nan_rows(m), one point each: the network's fmin/fmax
  lose it, the flag keeps it, and it poisons that point alone, in every
  output."""
  rows = _nan_rows(m)
  rng = np.random.default_rng(m + 4)
  x = rng.standard_normal((m, len(rows) + 3)).astype(np.float32)
  y = rng.standard_normal(len(rows) + 3).astype(np.float32)
  for p, r in enumerate(rows):
    x[r, p] = np.nan
  got = _emulate_blocksort_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  want_nan = np.arange(len(rows) + 3) < len(rows)
  for name, g, p in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain):
    np.testing.assert_array_equal(np.isnan(g), want_nan, err_msg=name)
    np.testing.assert_allclose(g[~want_nan], p.numpy()[~want_nan], rtol=RTOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize('m', [257, 300, 1816, 1817, 7424])
def test_blocksort_emulation_infinities_follow_jax_and_plain(m):
  """The seven ±inf columns of ``_infinite_members``: the counts give the
  plain version's inf and NaN points, which are the JAX kernels' sort
  body's. The JAX package's jnp.sort form (what it runs past 200 members)
  agrees but where the median member is infinite at odd m: it multiplies
  that member by its zero weight (0 x inf = NaN), where the kernels and the
  plain version leave the zero weight out, as the JAX kernel does."""
  x = _infinite_members(m)
  got = _emulate_blocksort_stats(x)[0]
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  y = np.random.default_rng(m).standard_normal(7).astype(np.float32)
  fused = _emulate_blocksort_stats(x, y)
  want = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                  torch.from_numpy(y))
  _assert_same_spread(got, plain, 'plain')
  jax_ = _jax_spread(x).astype(np.float32)
  median_inf = [4, 5] if m % 2 else []
  agree = [c for c in range(7) if c not in median_inf]
  _assert_same_spread(got[agree], jax_[agree], 'jax')
  assert np.isnan(jax_[median_inf]).all()
  for name, g, w in zip(('spread', 'skill', 'mean', 'sq_dev'), fused, want):
    _assert_same_spread(g, w.numpy(), name)
  half = [np.inf if m % 2 else np.nan] * 2
  np.testing.assert_array_equal(got, [np.inf] * 4 + half + [np.nan])


@pytest.mark.parametrize('m', [257, 300, 4000])
@pytest.mark.parametrize('value', [np.inf, -np.inf])
def test_blocksort_emulation_all_members_one_infinity(m, value):
  """Every member one infinity, all but one (in the first run, in the
  last), one of the other infinity, and more than half: each spread NaN
  (the counts), as the plain version and the JAX sort form give; no
  compare-exchange moves the pad (_sorted_columns asserts it)."""
  rng = np.random.default_rng(m + 3)
  x = rng.standard_normal((m, 6)).astype(np.float32)
  x[:, :4] = value
  x[0, 1] = 0.0
  x[m - 1, 2] = 0.0
  x[RUN, 3] = -value
  x[:m // 2 + 2, 4] = value
  y = rng.standard_normal(6).astype(np.float32)
  got = _emulate_blocksort_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  for name, g, p in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain):
    _assert_same_spread(g, p.numpy(), f'{name} m={m}')
  _assert_same_spread(got[0], _jax_spread(x).astype(np.float32), 'jax')
  assert np.isnan(got[0][:5]).all() and np.isfinite(got[0][5])


@pytest.mark.parametrize('m', [257, 1817])
def test_blocksort_emulation_ties_and_signed_zeros(m):
  """Members quantized to 0.5 (many ties), and columns of +0.0 and -0.0
  mixed: the gaps of equal members are 0, and -0.0 beside +0.0 leaves a
  gap of 0."""
  rng = np.random.default_rng(m + 5)
  x = (np.round(2 * rng.standard_normal((m, 8))) / 2).astype(np.float32)
  x[:, 6] = np.where(rng.random(m) < 0.5, np.float32(-0.0), np.float32(0.0))
  x[:, 7] = np.float32(-0.0)
  x[m // 3, 7] = np.float32(1.5)
  y = rng.standard_normal(8).astype(np.float32)
  got = _emulate_blocksort_stats(x, y)
  plain = crps_pairwise.fused_ensemble_stats_plain(torch.from_numpy(x),
                                                   torch.from_numpy(y))
  for name, g, p in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain):
    np.testing.assert_allclose(g, p.numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=name)
  np.testing.assert_allclose(got[0], _f64_spread(x), rtol=RTOL, atol=ATOL)
  assert got[0][6] == 0 and got[0][7] == 2 * 1.5 * (m - 1)


@pytest.mark.parametrize('m', [300, 1817])
def test_blocksort_emulation_bfloat16(m):
  """bfloat16 members widened on load: the emulation on the widened values
  against the plain versions on the bfloat16 tensors (which widen too),
  each output within one bfloat16 step after rounding."""
  rng = np.random.default_rng(m + 6)
  xb = torch.from_numpy(rng.standard_normal((m, 16)).astype(
      np.float32)).bfloat16()
  yb = torch.from_numpy(rng.standard_normal(16).astype(np.float32)).bfloat16()
  got = _emulate_blocksort_stats(xb.float().numpy(), yb.float().numpy())
  plain = crps_pairwise.fused_ensemble_stats_plain(xb, yb)
  for name, g, p in zip(('spread', 'skill', 'mean', 'sq_dev'), got, plain):
    g16 = torch.from_numpy(g).bfloat16().float().numpy()
    np.testing.assert_allclose(g16, p.float().numpy(), rtol=1e-2, atol=1e-2,
                               err_msg=name)


@pytest.mark.parametrize('m', [257, 1817])
def test_blocksort_emulation_config_changes_only_rounding(m):
  """Another block configuration (fewer threads a point, more runs a
  thread) changes only the order of the float32 sums."""
  rng = np.random.default_rng(m + 7)
  x = rng.standard_normal((m, 6)).astype(np.float32)
  y = rng.standard_normal(6).astype(np.float32)
  a = _emulate_blocksort_stats(x, y)
  points, threads = crps_pairwise.blocksort_config(m)
  b = _emulate_blocksort_stats(x, y, (points, max(8, threads // 2)))
  for name, g, h in zip(('spread', 'skill', 'mean', 'sq_dev'), a, b):
    np.testing.assert_allclose(g, h, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize('form,m', [('sorted', 300), ('blocksort', 58113),
                                    ('blocksort', 32), ('pairs', 300)])
def test_forced_form_refuses_counts_it_cannot_take(form, m):
  """_launch_stats(form=...) (chip_ab.py times the block sort at the
  sorted runs' counts) raises a ValueError before any launch where that
  form's kernel cannot take m members, or the form does not exist."""
  with pytest.raises(ValueError, match='form does not take'):
    crps_pairwise._launch_stats(torch.zeros((m, 3)), None, form=form)


# -- the slice at HENS's member count, small width ------------------------

M_HENS, N_LEAD, N_LAT, N_LON = 7424, 2, 4, 8


def _hens_pair(mod, x, y):
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')]),
      'lead_time': (np.arange(N_LEAD) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': np.linspace(90, -90, N_LAT),
      'longitude': np.linspace(0, 360, N_LON, endpoint=False)}
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  return ({'t2m': mod.DimArray(x.copy(), ('number',) + dims,
                               dict(coords, number=np.arange(M_HENS)))},
          {'t2m': mod.DimArray(y.copy(), dims, coords)})


def _hens_metrics(prob):
  return {'crps': prob.CRPSEnsemble(use_sort=True),
          'spread_skill': prob.UnbiasedSpreadSkillRatio(),
          'unbiased_mean_rmse': prob.UnbiasedEnsembleMeanRMSE()}


def _hens_aggregator(agg_mod, w_mod):
  return agg_mod.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[w_mod.GridAreaWeighting()])


@pytest.mark.parametrize('stats', ['plain', 'blocksort kernel emulated'])
def test_hens_slice_matches_jax(stats, monkeypatch):
  """Phase 4c's configuration at 7,424 members (7,424 x 1 x 2 x 4 x 8,
  fair CRPS, unbiased spread/skill and ensemble-mean RMSE, area-weighted)
  through the port's ChunkEvaluator on the CPU, against the JAX package's
  evaluator (its jnp forms off the TPU). 'blocksort kernel emulated' swaps
  the port's fused statistics for the block sort's arithmetic: the route
  the card takes at 7,424 members; one fused pass serves the three
  metrics."""
  rng = np.random.default_rng(7424)
  x = rng.standard_normal((M_HENS, 1, N_LEAD, N_LAT, N_LON)).astype(
      np.float32)
  y = rng.standard_normal((1, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  assert crps_pairwise.spread_form(M_HENS) == 'blocksort'
  if stats != 'plain':
    calls = []

    def emulated(xt, yt):
      calls.append(xt.shape[0])
      return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                   _emulate_blocksort_stats(xt.numpy(), yt.numpy()))
    monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', emulated)
  j_metrics = _hens_metrics(j_probabilistic)
  want = j_evaluator.ChunkEvaluator(
      j_metrics, _hens_aggregator(j_aggregation, j_weighting),
  ).eval_chunk(*_hens_pair(j_darray, x, y)).metric_values(j_metrics)
  metrics = _hens_metrics(probabilistic)
  ev = evaluator.ChunkEvaluator(
      metrics, _hens_aggregator(aggregation, weighting), device='cpu')
  got = ev.eval_chunk(*_hens_pair(darray, x, y)).metric_values(metrics)
  if stats != 'plain':
    assert calls == [M_HENS]
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims == ('lead_time',), k
    w = np.asarray(want[k].values, np.float64)
    g = got[k].values.astype(np.float64)
    assert np.isfinite(g).all(), k
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6, err_msg=k)
