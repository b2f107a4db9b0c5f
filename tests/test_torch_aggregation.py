"""The rest of the port's ``aggregation`` against the JAX package, on the CPU.

``AggregationState.sum_along_dims`` / ``dot`` / ``map_multi`` and
``Aggregator.aggregation_fn`` / ``aggregate_stat_var`` /
``aggregate_stat_vars`` / ``prepare_operands`` on the same seeded numpy
inputs in both packages: dims, coords and state keys exactly; values to
atol 1e-5 plus rtol 1e-5, since a state holds float32 SUMS over up to 576
terms whose size grows with the terms (their means agree to atol 1e-5).
Then the port's own guarantee: ``prepare_operands`` and the evaluator's
``operands_for`` hand out the same objects from one cache.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as jb
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import weighting as jw
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning as tb
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import weighting as tw
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
N_INIT, N_LEAD, N_LAT, N_LON = 4, 3, 9, 16
LAT = np.linspace(90, -90, N_LAT)
LON = np.linspace(0, 360, N_LON, endpoint=False)
INITS = (np.datetime64('2020-01-01T00', 'ns')
         + np.arange(N_INIT) * np.timedelta64(12, 'h'))
LEADS = (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
DIMS = ('init_time', 'lead_time', 'latitude', 'longitude')
REGIONS = {'global': ((-90, 90), (0, 360)), 'nh': ((20, 90), (0, 360)),
           'dateline': ((-90, 90), (170, -170))}
PKG = {'torch': (td, aggregation, tb, tw), 'jax': (jd, j_aggregation, jb, jw)}


def _stat(mod, seed=0, nan=False, mask=False, dtype=np.float32, dims=DIMS):
  shape = tuple({'init_time': N_INIT, 'lead_time': N_LEAD,
                 'latitude': N_LAT, 'longitude': N_LON}[d] for d in dims)
  rng = np.random.default_rng(seed)
  x = rng.standard_normal(shape)
  if dtype == bool:
    x = x > 0
  else:
    x = x.astype(dtype)
    if nan:
      x.reshape(-1)[::17] = np.nan
  coords = {'init_time': INITS, 'lead_time': LEADS, 'latitude': LAT,
            'longitude': LON}
  coords = {d: coords[d] for d in dims}
  if mask:
    coords['mask'] = mod.Coord(('latitude', 'longitude'),
                               rng.random((N_LAT, N_LON)) > 0.3)
  return mod.DimArray(x, dims, coords)


def _aggregator(which, **kwargs):
  _, agg, b, w = PKG[which]
  return agg.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      bin_by=[b.Regions(REGIONS), b.ByTimeUnit('hour', 'lead_time')],
      weigh_by=[w.GridAreaWeighting()], **kwargs)


def _close(got, want):
  assert got.dims == tuple(want.dims)
  np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=RTOL,
                             atol=ATOL, equal_nan=True)
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    np.testing.assert_array_equal(got.coord_values(name),
                                  np.asarray(c.values), err_msg=name)


def _states_close(got, want):
  assert list(got.to_dataset()) == list(want.to_dataset())
  for part in ('sum_weighted_statistics', 'sum_weights'):
    for name, per_var in getattr(want, part).items():
      for var, da in per_var.items():
        _close(getattr(got, part)[name][var], da)


AGG_KWARGS = {'plain': {}, 'skipna': {'skipna': True},
              'masked': {'masked': True},
              'masked_skipna': {'masked': True, 'skipna': True}}


@pytest.mark.parametrize('kind', sorted(AGG_KWARGS))
@pytest.mark.parametrize('dtype', [np.float32, bool], ids=['f32', 'bool'])
def test_aggregate_stat_var_matches_jax(kind, dtype):
  kw = AGG_KWARGS[kind]
  got = _aggregator('torch', **kw).aggregate_stat_var(
      _stat(td, 1, nan=True, mask=True, dtype=dtype))
  want = _aggregator('jax', **kw).aggregate_stat_var(
      _stat(jd, 1, nan=True, mask=True, dtype=dtype))
  _close(got.sum_weighted_statistics, want.sum_weighted_statistics)
  _close(got.sum_weights, want.sum_weights)
  assert got.sum_weights.dims == ('lead_time', 'region', 'lead_time_hour')


@pytest.mark.parametrize('given', [False, True], ids=['built', 'given'])
def test_aggregation_fn_matches_jax(given):
  t_agg, j_agg = _aggregator('torch'), _aggregator('jax')
  t_stat, j_stat = _stat(td, 2), _stat(jd, 2)
  if given:
    got = t_agg.aggregation_fn(t_stat, t_agg.aggregation_operands(t_stat))
    want = j_agg.aggregation_fn(j_stat, j_agg.aggregation_operands(j_stat))
  else:
    got, want = t_agg.aggregation_fn(t_stat), j_agg.aggregation_fn(j_stat)
  _close(got, want)


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_aggregation_fn_drops_what_cannot_be_reduced(which):
  """None for given operands None, and for a variable that lacks a reduce
  dim: in both packages."""
  mod = PKG[which][0]
  agg = _aggregator(which)
  stat = _stat(mod, 3)
  assert agg.aggregation_fn(stat, None) is None
  assert agg.aggregate_stat_var(stat, None) is None
  no_lat = _stat(mod, 3, dims=('init_time', 'lead_time', 'longitude'))
  flat = PKG[which][1].Aggregator(reduce_dims=['latitude'])
  assert flat.aggregation_fn(no_lat) is None
  assert flat.aggregate_stat_var(no_lat) is None
  out = flat.aggregate_stat_vars({'a': no_lat, 'b': None})
  assert out.sum_weighted_statistics == {} and out.sum_weights == {}


def test_aggregate_stat_vars_matches_jax_with_some_operands_given():
  t_agg, j_agg = _aggregator('torch', skipna=True), _aggregator(
      'jax', skipna=True)
  t_stats = {'a': _stat(td, 4, nan=True), 'b': _stat(td, 5), 'c': None,
             'dropped': _stat(td, 6)}
  j_stats = {'a': _stat(jd, 4, nan=True), 'b': _stat(jd, 5), 'c': None,
             'dropped': _stat(jd, 6)}
  t_ops = {'a': t_agg.aggregation_operands(t_stats['a']), 'dropped': None}
  j_ops = {'a': j_agg.aggregation_operands(j_stats['a']), 'dropped': None}
  got = t_agg.aggregate_stat_vars(t_stats, t_ops)
  want = j_agg.aggregate_stat_vars(j_stats, j_ops)
  assert set(got.sum_weights) == set(want.sum_weights) == {'a', 'b'}
  for var in ('a', 'b'):
    _close(got.sum_weighted_statistics[var],
           want.sum_weighted_statistics[var])
    _close(got.sum_weights[var], want.sum_weights[var])


def _statistics(mod, det):
  p = {'t2m': _stat(mod, 7, mask=True), 'z': _stat(mod, 8)}
  t = {'t2m': _stat(mod, 9, nan=True), 'z': _stat(mod, 10)}
  return {'SquaredError': det.SquaredError().compute(p, t),
          'AbsoluteError': det.AbsoluteError().compute(p, t),
          'Exceeds': {'z': _stat(mod, 11, dtype=bool)}}


@pytest.mark.parametrize('kind', sorted(AGG_KWARGS))
def test_aggregate_statistics_with_prepared_operands_matches_jax(kind):
  kw = AGG_KWARGS[kind]
  t_agg, j_agg = _aggregator('torch', **kw), _aggregator('jax', **kw)
  t_stats = _statistics(td, deterministic)
  j_stats = _statistics(jd, j_deterministic)
  t_ops = t_agg.prepare_operands(t_stats)
  j_ops = j_agg.prepare_operands(j_stats)
  assert ({n: set(v) for n, v in t_ops.items()}
          == {n: set(v) for n, v in j_ops.items()})
  got = t_agg.aggregate_statistics(t_stats, t_ops)
  _states_close(got, j_agg.aggregate_statistics(j_stats, j_ops))
  unprepared = t_agg.aggregate_statistics(t_stats)
  for key, da in got.to_dataset().items():
    np.testing.assert_array_equal(  # the same bits; NaN where NaN
        da.values, unprepared.to_dataset()[key].values, err_msg=key)


def test_prepare_operands_shares_objects_per_layout_as_jax_does():
  t_ops = _aggregator('torch').prepare_operands(_statistics(td, deterministic))
  j_ops = _aggregator('jax').prepare_operands(
      _statistics(jd, j_deterministic))
  for ops in (t_ops, j_ops):
    # z has no mask coord: one layout whatever the statistic, and the bool
    # statistic shares it after its promotion to float32.
    assert ops['SquaredError']['z'] is ops['AbsoluteError']['z']
    assert ops['Exceeds']['z'] is ops['SquaredError']['z']
    assert ops['SquaredError']['t2m'] is ops['AbsoluteError']['t2m']
  for t_op, j_op in zip(t_ops['SquaredError']['z'],
                        j_ops['SquaredError']['z']):
    assert t_op.dims == tuple(j_op.dims)
    np.testing.assert_allclose(t_op.values, np.asarray(j_op.values),
                               rtol=0, atol=1e-7)


def test_evaluator_operands_are_prepare_operands_own_objects():
  """``ChunkEvaluator.operands_for`` is ``prepare_operands`` over the
  evaluator's cache: no second cache, the same objects across chunks."""
  agg = _aggregator('torch')
  ev = evaluator.ChunkEvaluator({'mse': deterministic.MSE()}, agg,
                                device='cpu')
  stats = _statistics(td, deterministic)
  first = ev.operands_for(stats)
  again = agg.prepare_operands(stats, ev._operand_cache, 'cpu')
  second = ev.operands_for(_statistics(td, deterministic))
  for name in stats:
    for var in stats[name]:
      assert first[name][var] is again[name][var] is second[name][var]
  assert len(ev._operand_cache) == 2  # with and without a mask coord


# -- AggregationState: sum_along_dims, dot, map_multi ----------------------------


def _state(which, seed=0):
  mod, agg = PKG[which][:2]
  return agg.Aggregator(reduce_dims=['latitude', 'longitude']).aggregate_statistics({
      'se': {'t2m': _stat(mod, seed), 'z': _stat(mod, seed + 1)},
      'flat': {'t2m': _stat(mod, seed + 2,
                            dims=('lead_time', 'latitude', 'longitude'))}})


@pytest.mark.parametrize('dims', [('init_time',), ('init_time', 'lead_time'),
                                  (), ('nowhere',)], ids=str)
def test_sum_along_dims_matches_jax(dims):
  got = _state('torch').sum_along_dims(dims)
  _states_close(got, _state('jax').sum_along_dims(dims))
  # A variable that lacks a dim is left alone, not fully reduced.
  kept = tuple(d for d in ('lead_time',) if d not in dims)
  assert got.sum_weights['flat']['t2m'].dims == kept


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_zero_state_passes_through(which):
  zero = PKG[which][1].AggregationState.zero()
  assert zero.sum_along_dims(['x']).sum_weighted_statistics is None
  assert zero.map(lambda x: x * 2) is zero
  with pytest.raises(ValueError, match='zero'):
    PKG[which][1].AggregationState.map_multi(lambda a, b: a + b, zero, zero)


def test_sum_along_dims_then_mean_equals_the_direct_reduction():
  stats = {'se': {'t2m': _stat(td, 12)}}
  staged = aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude']).aggregate_statistics(
          stats).sum_along_dims(['init_time', 'lead_time'])
  direct = aggregation.Aggregator(reduce_dims=list(DIMS)).aggregate_statistics(
      stats)
  np.testing.assert_allclose(
      staged.mean_statistics()['se']['t2m'].item(),
      direct.mean_statistics()['se']['t2m'].item(), rtol=1e-5)


@pytest.mark.parametrize('n_replicates', [1, 5])
def test_state_dot_matches_jax(n_replicates):
  """The bootstrap's contraction: every array against a resampling-count
  matrix over init_time."""
  counts = np.random.default_rng(3).multinomial(
      N_INIT, [1 / N_INIT] * N_INIT, size=n_replicates).astype(np.float32)
  coords = {'replicate': np.arange(n_replicates), 'init_time': INITS}
  t_state = aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude']).aggregate_statistics(
          {'se': {'t2m': _stat(td, 20), 'z': _stat(td, 21)}})
  j_state = j_aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude']).aggregate_statistics(
          {'se': {'t2m': _stat(jd, 20), 'z': _stat(jd, 21)}})
  got = t_state.dot(td.DimArray(counts, ('replicate', 'init_time'), coords),
                    dim='init_time')
  want = j_state.dot(jd.DimArray(counts, ('replicate', 'init_time'), coords),
                     dim='init_time')
  _states_close(got, want)
  assert got.sum_weights['se']['z'].dims == ('lead_time', 'replicate')


def test_map_multi_matches_jax():
  fn = lambda a, b, c: a + 2 * b - c  # noqa: E731
  got = aggregation.AggregationState.map_multi(
      fn, _state('torch', 30), _state('torch', 40), _state('torch', 50))
  want = j_aggregation.AggregationState.map_multi(
      fn, _state('jax', 30), _state('jax', 40), _state('jax', 50))
  _states_close(got, want)
  doubled = _state('torch', 30).map(lambda x: x * 2)
  _states_close(doubled, _state('jax', 30).map(lambda x: x * 2))


def test_map_multi_refuses_states_of_different_structure():
  a = _state('torch', 1)
  b = aggregation.AggregationState(
      {'se': {'t2m': a.sum_weighted_statistics['se']['t2m']}},
      {'se': {'t2m': a.sum_weights['se']['t2m']}})
  with pytest.raises((ValueError, KeyError, TypeError)):
    aggregation.AggregationState.map_multi(lambda x, y: x + y, a, b)


def test_read_coords_are_fingerprinted_once_per_object(monkeypatch):
  """A coord that a binning reads enters the layout key by content: two
  objects of equal content share a key, other content gets another, and a
  coord object already seen is not hashed again (on the card that hash is a
  copy to the host)."""
  agg = aggregation.Aggregator(
      reduce_dims=['init_time'],
      bin_by=[tb.ByTimeUnitFromSeconds('hour', 'valid_seconds')])
  hashed = []
  real = aggregation._content_fingerprint

  def counting(v):
    before = len(aggregation._CONTENT_FINGERPRINTS), id(v)
    out = real(v)
    hit = aggregation._CONTENT_FINGERPRINTS.get(id(v))
    hashed.append(before)
    assert hit is not None and hit[0]() is v and hit[1] == out
    return out

  monkeypatch.setattr(aggregation, '_content_fingerprint', counting)

  def stat(seconds):
    return td.DimArray(
        np.zeros((N_INIT, 2), np.float32), ('init_time', 'x'),
        {'valid_seconds': td.Coord(('init_time',), seconds)})
  secs = torch.arange(N_INIT, dtype=torch.int64) * 21600
  a, b = stat(secs), stat(secs)
  key = agg.layout_key(a)
  assert agg.layout_key(b) == key == agg.layout_key(stat(secs.clone()))
  assert agg.layout_key(stat(secs + 3600)) != key
  assert agg.layout_key(stat(secs.numpy())) == key  # the same content
  # The first two calls saw one object: its entry was made once.
  assert hashed[0][1] == hashed[1][1] == id(secs)
  assert hashed[1][0] == hashed[0][0] + 1
  entry = aggregation._CONTENT_FINGERPRINTS[id(secs)]
  del a, b
  assert entry[0]() is secs  # a weak reference: the memo pins no coord
