"""The rest of the port's ``metrics/wrappers`` against the JAX package, on
the CPU.

Every ``InputTransform`` and wrapping statistic of both packages on the
same seeded numpy inputs (an ensemble with NaN members, float32): values to
atol 1e-5, dims and coords exactly, and every ``unique_name_suffix`` and
``unique_name`` byte for byte, since saved state keys depend on them.
Threshold ties between float64 constants and float32 data follow the
float64 comparison on both sides.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import wrappers as j_wrappers
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import wrappers

torch.set_num_threads(1)

ATOL = 1e-5
M, N_INIT, N_LEAD, N_LAT, N_LON = 5, 2, 3, 4, 6
DIMS = ('number', 'init_time', 'lead_time', 'latitude', 'longitude')
INITS = np.array(['2020-02-28T00', '2020-12-31T12'], dtype='datetime64[ns]')
LEADS = (np.arange(N_LEAD) * np.timedelta64(12, 'h')).astype(
    'timedelta64[ns]')
COORDS = {'number': np.arange(M), 'init_time': INITS, 'lead_time': LEADS,
          'latitude': np.linspace(60, -60, N_LAT),
          'longitude': np.arange(N_LON) * 60.0}
PKG = {'torch': (td, wrappers, deterministic, aggregation),
       'jax': (jd, j_wrappers, j_deterministic, j_aggregation)}


def _ensemble(mod, seed=0, nan=True):
  x = np.random.default_rng(seed).standard_normal(
      (M, N_INIT, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  if nan:
    x[1, 0, 1, 2, 3] = np.nan
    x[:, 1, 2, 0, 0] = np.nan
  return mod.DimArray(x, DIMS, COORDS)


def _field(mod, seed=1, nan=True):
  return _ensemble(mod, seed, nan).isel(number=0)


def _same(got, want, atol=ATOL):
  assert got.dims == tuple(want.dims), (got.dims, want.dims)
  w = np.asarray(want.values)
  assert got.values.shape == w.shape
  np.testing.assert_allclose(got.values.astype(np.float64),
                             w.astype(np.float64), rtol=0, atol=atol,
                             equal_nan=True)
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    np.testing.assert_array_equal(got.coord_values(name),
                                  np.asarray(c.values), err_msg=name)


def _thresholds(mod, kind):
  """DimArray thresholds over 'threshold' and a time layout."""
  rng = np.random.default_rng(5)
  t = np.array([-0.5, 0.0, 0.7])
  if kind == 'plain':
    return mod.DimArray(t, ('threshold',), {'threshold': t})
  if kind == 'by_latitude':
    v = t[:, None] + rng.random((3, N_LAT)) * 0.1
    return mod.DimArray(v, ('threshold', 'latitude'),
                        {'threshold': t, 'latitude': COORDS['latitude']})
  if kind == 'valid_time':
    times = np.unique((INITS[:, None] + LEADS[None, :]).reshape(-1))
    times = np.concatenate([times, times[-1:] + np.timedelta64(1, 'D')])
    v = t[:, None] + rng.random((3, len(times))) * 0.1
    return mod.DimArray(v, ('threshold', 'valid_time'),
                        {'threshold': t, 'valid_time': times})
  if kind == 'init_lead':
    inits = np.concatenate([INITS[:1] - np.timedelta64(1, 'D'), INITS])
    v = t[:, None, None] + rng.random((3, 3, N_LEAD)) * 0.1
    return mod.DimArray(v, ('threshold', 'init_time', 'lead_time'),
                        {'threshold': t, 'init_time': inits,
                         'lead_time': LEADS})
  if kind == 'dayofyear_lead':
    v = t[:, None, None] + rng.random((3, 366, N_LEAD)) * 0.1
    return mod.DimArray(v, ('threshold', 'dayofyear', 'lead_time'),
                        {'threshold': t, 'dayofyear': np.arange(1, 367),
                         'lead_time': LEADS})
  raise KeyError(kind)


# name -> transform factory given (wrappers module, darray module)
TRANSFORMS = {
    'ensemble_mean': lambda w, m: w.EnsembleMean('both'),
    'ensemble_mean_skipna': lambda w, m: w.EnsembleMean(
        'predictions', skipna=True),
    'quantiles': lambda w, m: w.EnsembleQuantiles(
        'predictions', [0.0, 0.1, 0.5, 0.9, 1.0]),
    'quantiles_skipna_scalar': lambda w, m: w.EnsembleQuantiles(
        'both', 0.25, quantile_dim='q', skipna=True),
    'to_binary_list': lambda w, m: w.ContinuousToBinary(
        'both', [-0.5, 0.0, 0.7], 'threshold'),
    'to_binary_scalar': lambda w, m: w.ContinuousToBinary(
        'targets', 0.3, 'threshold'),
    'to_binary_dimarray': lambda w, m: w.ContinuousToBinary(
        'both', _thresholds(m, 'by_latitude'), 'threshold', 'by_lat'),
    'to_binary_mapping': lambda w, m: w.ContinuousToBinary(
        'both', {'v': _thresholds(m, 'plain')}, 'threshold', 'per_var'),
    'to_bins': lambda w, m: w.ContinuousToBins(
        'predictions', [-np.inf, -0.5, 0.5, np.inf], 'bin'),
    'to_bins_dimarray': lambda w, m: w.ContinuousToBins(
        'predictions', _thresholds(m, 'by_latitude'), 'threshold', 'b'),
    'to_cdf': lambda w, m: w.ContinuousToCDF(
        'both', [-1.0, 0.0, 1.0], 'threshold'),
    'to_cdf_left_exclusive': lambda w, m: w.ContinuousToCDF(
        'both', [-1.0, 0.0, 1.0], 'threshold', right_inclusive=False),
    'to_cdf_valid_time': lambda w, m: w.ContinuousToCDF(
        'both', _thresholds(m, 'valid_time'), 'threshold', 'vt'),
    'to_cdf_init_lead': lambda w, m: w.ContinuousToCDF(
        'both', _thresholds(m, 'init_lead'), 'threshold', 'il'),
    'to_cdf_dayofyear': lambda w, m: w.ContinuousToCDF(
        'both', {'v': _thresholds(m, 'dayofyear_lead')}, 'threshold', 'doy'),
    'weibull': lambda w, m: w.WeibullEnsembleToProbabilistic('predictions'),
    'weibull_skipna': lambda w, m: w.WeibullEnsembleToProbabilistic(
        'predictions', skipna=True),
    'inline': lambda w, m: w.Inline('both', lambda d: d * 2 + 1, 'affine'),
    'relu': lambda w, m: w.ReLU('both'),
    'shift': lambda w, m: w.ShiftAlongNewDim(
        'predictions', [0.0, 0.1, 10.0], 'shift', 'three_shifts'),
    'shift_scalar': lambda w, m: w.ShiftAlongNewDim(
        'predictions', 2.5, 'shift', 'one_shift'),
    'shift_mapping': lambda w, m: w.ShiftAlongNewDim(
        'predictions', {'v': m.DimArray(
            np.array([1.0, -1.0], np.float32), ('shift',),
            {'shift': np.array([1.0, -1.0])})}, 'shift', 'mapped'),
    'rename': lambda w, m: w.Rename('both', {'number': 'realization',
                                             'latitude': 'lat'}),
    'select_sel': lambda w, m: w.Select('both', sel={'latitude': 20.0}),
    'select_isel_slice': lambda w, m: w.Select(
        'both', isel={'longitude': slice(1, 4), 'number': 0}),
    'select_nearest': lambda w, m: w.Select(
        'both', sel={'latitude': [55.0, -25.0]},
        sel_kwargs={'method': 'nearest'}),
    'stack': lambda w, m: w.StackToNewDimension(
        'both', ['latitude', 'longitude'], 'point'),
    'stack_number_time': lambda w, m: w.StackToNewDimension(
        'both', ('number', 'init_time'), 'sample'),
}


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_matches_jax(name):
  t_tr = TRANSFORMS[name](wrappers, td)
  j_tr = TRANSFORMS[name](j_wrappers, jd)
  assert t_tr.unique_name_suffix == j_tr.unique_name_suffix
  assert t_tr.which == j_tr.which
  _same(t_tr.transform_fn(_ensemble(td, 2), 'v'),
        j_tr.transform_fn(_ensemble(jd, 2), 'v'))


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_wrapped_statistic_name_matches_jax(name):
  got = wrappers.WrappedStatistic(deterministic.SquaredError(),
                                  TRANSFORMS[name](wrappers, td))
  want = j_wrappers.WrappedStatistic(j_deterministic.SquaredError(),
                                     TRANSFORMS[name](j_wrappers, jd))
  assert got.unique_name == want.unique_name


def test_unique_name_oddities_are_kept():
  assert wrappers.EnsembleMean('both').unique_name_suffix.startswith(
      'ensemble_mean_self._ensemble_dim=')
  assert wrappers.Select('both', isel={'x': 1}).unique_name_suffix == (
      "select_self._isel={'x': 1}_self._isel_kwargs={}_self._sel=None"
      '_self._sel_kwargs={}')
  assert wrappers.Rename('both', {'a': 'b'}).unique_name_suffix == (
      "rename_{'a': 'b'}")
  assert wrappers.ContinuousToBinary(
      'both', [0.5, 1], 'threshold').unique_name_suffix == 'threshold=0.5,1'


# -- thresholds -------------------------------------------------------------------


@pytest.mark.parametrize('kind', ['scalar', 'list', 'dimarray', 'mapping'])
def test_thresholds_for_matches_jax(kind):
  def make(m):
    return {'scalar': 0.25, 'list': [0.1, 0.9],
            'dimarray': _thresholds(m, 'by_latitude'),
            'mapping': {'v': _thresholds(m, 'plain')}}[kind]
  got = wrappers._thresholds_for(make(td), 'threshold', 'v')
  want = j_wrappers._thresholds_for(make(jd), 'threshold', 'v')
  _same(got, want, atol=0)
  assert got.values.dtype == np.float64  # constants stay float64


def test_thresholds_for_errors():
  with pytest.raises(KeyError, match='other'):
    wrappers._thresholds_for({'v': _thresholds(td, 'plain')}, 'threshold',
                             'other')
  with pytest.raises(ValueError, match='threshold_dim'):
    wrappers._thresholds_for(_thresholds(td, 'plain'), 'bin', 'v')
  for cls, key in ((wrappers.ContinuousToBinary, 'threshold_value'),
                   (wrappers.ContinuousToCDF, 'threshold_values'),
                   (wrappers.ContinuousToBins, 'bin_values')):
    with pytest.raises(ValueError, match='unique_name_suffix'):
      cls('both', _thresholds(td, 'plain'), 'threshold')
    with pytest.raises(ValueError, match='unique_name_suffix'):
      cls('both', {'v': _thresholds(td, 'plain')}, 'threshold')


def _tie():
  """x is a float32 value; t64 lies strictly above it in float64 and rounds
  to it in float32."""
  x = np.float32(0.3360923)
  up = np.nextafter(x, np.float32(np.inf))
  down = np.nextafter(x, np.float32(-np.inf))
  above = float(x) + 0.25 * (float(up) - float(x))
  below = float(x) - 0.25 * (float(x) - float(down))
  assert np.float32(above) == x and np.float32(below) == x
  return x, above, below


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_threshold_ties_follow_the_float64_comparison(which):
  mod, w = PKG[which][:2]
  x, above, below = _tie()
  da = mod.DimArray(np.array([x, np.float32(0.1), np.nan], np.float32),
                    ('p',), {'p': np.arange(3)})

  def vals(out):
    return np.asarray(out.transpose('p', 'thr').values)[:, 0]

  np.testing.assert_array_equal(  # x > above is False in float64
      vals(w.binarize_thresholds(da, [above], 'thr')), [0.0, 0.0, np.nan])
  np.testing.assert_array_equal(  # x > below is True
      vals(w.binarize_thresholds(da, [below], 'thr')), [1.0, 0.0, np.nan])
  np.testing.assert_array_equal(  # x <= above is True
      vals(w.compute_cdf([above], da, 'thr', False)), [1.0, 1.0, np.nan])
  np.testing.assert_array_equal(  # x < below is False
      vals(w.compute_cdf([below], da, 'thr', False, right_inclusive=False)),
      [0.0, 1.0, np.nan])
  np.testing.assert_array_equal(  # x <= below is False
      vals(w.compute_cdf([below], da, 'thr', False)), [0.0, 1.0, np.nan])


def test_binarize_keeps_nan_and_gives_float32():
  out = wrappers.binarize_thresholds(_field(td), [0.0, 0.5], 'threshold')
  assert out.dtype == torch.float32
  want = j_wrappers.binarize_thresholds(_field(jd), [0.0, 0.5], 'threshold')
  _same(out, want, atol=0)
  assert np.isnan(out.values).sum() == 2 * np.isnan(_field(td).values).sum()


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_compute_cdf_refuses_what_it_must(which):
  mod, w = PKG[which][:2]
  with pytest.raises(ValueError, match='monotonically'):
    w.compute_cdf([0.0, 0.0, 1.0], _field(mod), 'threshold', True)
  with pytest.raises(ValueError, match='Iterable'):
    w.compute_cdf(0.5, _field(mod), 'threshold', True)
  out = w.compute_cdf([0.0, 0.0, 1.0], _field(mod), 'threshold', False)
  assert out.sizes['threshold'] == 3


def test_nan_thresholds_propagate():
  def thr(m):
    t = np.array([-0.5, np.nan, 0.7])
    return m.DimArray(t, ('threshold',), {'threshold': np.arange(3.0)})
  got = wrappers.compute_cdf(thr(td), _field(td), 'threshold', False)
  want = j_wrappers.compute_cdf(thr(jd), _field(jd), 'threshold', False)
  _same(got, want, atol=0)
  assert np.isnan(got.isel(threshold=1).values).all()


# -- select_bin_thresholds_by_time_from_chunk ----------------------------------------


@pytest.mark.parametrize('kind', ['valid_time', 'init_lead',
                                  'dayofyear_lead', 'plain', 'by_latitude'])
def test_select_thresholds_by_init_and_lead_matches_jax(kind):
  got = wrappers.select_bin_thresholds_by_time_from_chunk(
      _thresholds(td, kind), _field(td))
  want = j_wrappers.select_bin_thresholds_by_time_from_chunk(
      _thresholds(jd, kind), _field(jd))
  _same(got, want, atol=0)


def _valid_time_chunk(mod):
  times = np.array(['2019-12-31T00', '2020-02-29T06', '2020-12-31T18'],
                   dtype='datetime64[ns]')
  return mod.DimArray(np.zeros((3, 2), np.float32), ('valid_time', 'x'),
                      {'valid_time': times}), times


@pytest.mark.parametrize('kind', ['valid_time', 'dayofyear', 'none'])
def test_select_thresholds_by_valid_time_matches_jax(kind):
  def make(mod):
    chunk, times = _valid_time_chunk(mod)
    rng = np.random.default_rng(6)
    t = np.array([0.0, 1.0])
    if kind == 'valid_time':
      all_times = np.concatenate([times[::-1], times[:1]
                                  + np.timedelta64(5, 'D')])
      thr = mod.DimArray(rng.random((2, 4)), ('threshold', 'valid_time'),
                         {'threshold': t, 'valid_time': all_times})
    elif kind == 'dayofyear':
      thr = mod.DimArray(rng.random((366, 2)), ('dayofyear', 'threshold'),
                         {'threshold': t, 'dayofyear': np.arange(1, 367)})
    else:
      thr = mod.DimArray(t, ('threshold',), {'threshold': t})
    return thr, chunk
  got = wrappers.select_bin_thresholds_by_time_from_chunk(*make(td))
  want = j_wrappers.select_bin_thresholds_by_time_from_chunk(*make(jd))
  _same(got, want, atol=0)
  if kind == 'dayofyear':  # day 366 of the leap year, by numpy not pandas
    np.testing.assert_array_equal(
        got.values[2], make(td)[0].values[365])


def test_select_thresholds_needs_datetime_coords():
  chunk = td.DimArray(np.zeros((2, 2), np.float32), ('valid_time', 'x'),
                      {'valid_time': np.arange(2)})
  thr = td.DimArray(np.zeros((2, 2)), ('threshold', 'valid_time'),
                    {'valid_time': np.arange(2)})
  with pytest.raises(ValueError, match='datetime'):
    wrappers.select_bin_thresholds_by_time_from_chunk(thr, chunk)


# -- guards, composition, subselection -------------------------------------------------


def test_ensemble_quantiles_dim_guard():
  da = td.DimArray(np.zeros((2, 5), np.float32), ('quantile', 'number'))
  out = wrappers.EnsembleQuantiles('predictions', [0.5],
                                   quantile_dim='q').transform_fn(da)
  assert out.dims == ('q', 'quantile')
  with pytest.raises(ValueError, match="'quantile'"):
    wrappers.EnsembleQuantiles('predictions', [0.5]).transform_fn(da)
  no_ens = td.DimArray(np.zeros(3, np.float32), ('x',))
  assert wrappers.EnsembleQuantiles(
      'predictions', [0.5],
      skip_if_ensemble_dim_missing=True).transform_fn(no_ens) is no_ens


def test_weibull_is_for_predictions_only():
  with pytest.raises(ValueError, match='predictions'):
    wrappers.WeibullEnsembleToProbabilistic('both')


def test_shift_mapping_needs_its_dim():
  tr = wrappers.ShiftAlongNewDim(
      'predictions', {'v': td.DimArray(np.zeros(2, np.float32), ('other',))},
      'shift', 's')
  with pytest.raises(RuntimeError, match='shift_dim'):
    tr.transform_fn(_field(td), 'v')


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_transforms_compose_in_list_order(which):
  mod, w, det, agg = PKG[which]
  m = w.WrappedMetric(det.MSE(), [w.Inline('both', lambda d: d + 1, 'f'),
                                  w.Inline('both', lambda d: d * 2, 'g')])
  stat = list(m.statistics.values())[0]
  out = stat.compute({'v': mod.DimArray(np.array([1.0], np.float32), ('x',))},
                     {'v': mod.DimArray(np.array([0.0], np.float32), ('x',))})
  assert float(np.asarray(out['v'].values)[0]) == pytest.approx(4.0)


def _metric_values(which, metric_of):
  mod, w, det, agg = PKG[which]
  preds = {'v': _ensemble(mod, 7), 'other': _ensemble(mod, 8, nan=False)}
  tgts = {'v': _field(mod, 9), 'other': _field(mod, 10, nan=False)}
  aggregator = agg.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'], skipna=True)
  metrics = {'m': metric_of(w, det, mod)}
  base_mod = base if which == 'torch' else j_base
  state = aggregator.aggregate_statistics(
      base_mod.compute_unique_statistics_for_all_metrics(metrics, preds, tgts))
  return state, state.metric_values(metrics)


COMPOSITIONS = {
    'subselect': lambda w, det, m: w.SubselectVariables(
        w.WrappedMetric(det.MSE(), [w.EnsembleMean('predictions',
                                                   skipna=True)]), ['v']),
    'binary_mse': lambda w, det, m: w.WrappedMetric(det.MSE(), [
        w.EnsembleMean('predictions', skipna=True),
        w.ContinuousToBinary('both', [-0.5, 0.5], 'threshold')]),
    'quantile_error': lambda w, det, m: w.WrappedMetric(det.MAE(), [
        w.EnsembleQuantiles('predictions', [0.1, 0.5, 0.9], skipna=True)]),
    'shifted_relu': lambda w, det, m: w.WrappedMetric(det.MSE(), [
        w.EnsembleMean('predictions', skipna=True),
        w.ShiftAlongNewDim('predictions', [0.0, 1.0], 'shift', 's'),
        w.ReLU('both')]),
    'cdf_of_subset': lambda w, det, m: w.SubselectVariables(
        w.WrappedMetric(det.MSE(), [
            w.Select('predictions', isel={'number': 0}),
            w.ContinuousToCDF('both', [-1.0, 0.0, 1.0], 'threshold')]),
        ['other']),
}


@pytest.mark.parametrize('name', sorted(COMPOSITIONS))
def test_composed_metric_matches_jax(name):
  t_state, got = _metric_values('torch', COMPOSITIONS[name])
  j_state, want = _metric_values('jax', COMPOSITIONS[name])
  assert list(t_state.to_dataset()) == list(j_state.to_dataset())
  assert set(got) == set(want) and got
  for key in want:
    _same(got[key], want[key])


def test_subselect_names_and_variables():
  stat = wrappers.SubselectVariablesForStatistic(
      deterministic.SquaredError(), ['a', 'c'])
  want = j_wrappers.SubselectVariablesForStatistic(
      j_deterministic.SquaredError(), ['a', 'c'])
  assert stat.unique_name == want.unique_name == 'SquaredError_a_c'
  x = td.DimArray(np.ones(2, np.float32), ('x',))
  assert set(stat.compute({'a': x, 'b': x, 'c': x},
                          {'a': x, 'b': x})) == {'a'}
