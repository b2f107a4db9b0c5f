"""The port's deterministic, SEEPS and wrapper metrics against the JAX
package, on the CPU.

The same inputs, made from a numpy seed (2 inits x 3 leads x 2 levels x
8 x 16, float32, with a dayofyear x hour climatology), go through each
statistic and metric of both packages; values agree to rtol 1e-5 /
atol 1e-6. Then the port's own guarantees: ACC and prediction activity
share one SquaredPredictionAnomaly compute, SEEPS's NaN and mask
semantics, its float32 arithmetic bit for bit, and SEEPS construction
touching no device (ADVICE.md round 5, categorical.py:105).
"""

import jax
import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.metrics import categorical as j_categorical
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import wrappers as j_wrappers
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import categorical
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import wrappers

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_INIT, N_LEAD, N_LAT, N_LON = 2, 3, 8, 16
LAT = np.linspace(-90, 90, N_LAT)
LON = np.linspace(0, 360, N_LON, endpoint=False)
INITS = (np.datetime64('2020-01-01T00', 'ns')
         + np.arange(N_INIT) * np.timedelta64(12, 'h'))
LEADS = (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-30, 30), (0, 360)),
           'europe': ((35, 75), (-12.5, 42.5))}
PRECIP = 'total_precipitation_24hr'


def _chunk(mod, seed=0, nan_at=None):
  """(predictions, targets, climatology) of module ``mod``: the demo
  recipe, target = clim + z_c + z_t and prediction = clim + z_c + z_p, and
  a precipitation field with SEEPS climatology."""
  rng = np.random.default_rng(seed)
  valid = INITS[:, None] + LEADS[None, :]
  space = {'latitude': LAT, 'longitude': LON}
  tcoords = {'init_time': INITS, 'lead_time': LEADS,
             'valid_time': mod.Coord(('init_time', 'lead_time'), valid),
             **space}
  pcoords = {'init_time': INITS, 'lead_time': LEADS, **space}
  ccoords = {'dayofyear': np.arange(1, 5), 'hour': np.array([0, 6, 12, 18]),
             **space}
  slot = (np.arange(N_INIT)[:, None] * 2 + np.arange(N_LEAD)[None, :])

  def rand(*shape):
    return rng.standard_normal(shape).astype(np.float32)

  preds, tgts, clim = {}, {}, {}
  for name, levels in (('geopotential', (500, 850)), ('u', (500, 850)),
                       ('v', (500, 850)), ('2m_temperature', ())):
    lshape = (len(levels),) if levels else ()
    ldims = ('level',) if levels else ()
    lcoords = {'level': np.array(levels)} if levels else {}
    c = rand(4, 4, *lshape, N_LAT, N_LON)
    aligned = c.reshape((16,) + c.shape[2:])[slot.reshape(-1)].reshape(
        (N_INIT, N_LEAD) + c.shape[2:])
    zc = rand(N_INIT, N_LEAD, *lshape, N_LAT, N_LON)
    dims = ('init_time', 'lead_time') + ldims + ('latitude', 'longitude')
    tgts[name] = mod.DimArray(aligned + zc + rand(*zc.shape), dims,
                              {**tcoords, **lcoords})
    preds[name] = mod.DimArray(aligned + zc + rand(*zc.shape), dims,
                               {**pcoords, **lcoords})
    clim[name] = mod.DimArray(c, ('dayofyear', 'hour') + ldims + (
        'latitude', 'longitude'), {**ccoords, **lcoords})
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  p = np.abs(rand(N_INIT, N_LEAD, N_LAT, N_LON)) * 2e-3
  t = np.abs(rand(N_INIT, N_LEAD, N_LAT, N_LON)) * 2e-3
  if nan_at is not None:
    p[nan_at] = np.nan
  preds[PRECIP] = mod.DimArray(p, dims, pcoords)
  tgts[PRECIP] = mod.DimArray(t, dims, tcoords)
  cdims = ('dayofyear', 'hour', 'latitude', 'longitude')
  clim[PRECIP] = mod.DimArray(np.abs(rand(4, 4, N_LAT, N_LON)) * 2e-3, cdims,
                              ccoords)
  thr = np.full((4, 4, N_LAT, N_LON), 1.5e-3, np.float32) + rand(
      4, 4, N_LAT, N_LON) * 2e-4
  clim[f'{PRECIP}_seeps_threshold'] = mod.DimArray(thr, cdims, ccoords)
  clim[f'{PRECIP}_seeps_dry_fraction'] = mod.DimArray(
      rng.uniform(0.05, 0.95, (4, 4, N_LAT, N_LON)).astype(np.float32),
      cdims, ccoords)
  return preds, tgts, clim


def _assert_da_close(got, want, name=''):
  assert got.dims == tuple(want.dims), (name, got.dims, want.dims)
  g = got.values.astype(np.float64)
  w = np.asarray(want.values, np.float64)
  np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=str(name))
  for c in ('mask',):
    assert (c in got.coords) == (c in want.coords), name
    if c in got.coords:
      np.testing.assert_array_equal(got.coord_values(c),
                                    np.asarray(want.coords[c].values))


def _statistics(mod, clim):
  det = deterministic if mod is darray else j_deterministic
  return {
      'Error': det.Error(), 'AbsoluteError': det.AbsoluteError(),
      'SquaredError': det.SquaredError(),
      'PredictionPassthrough': det.PredictionPassthrough(),
      'PredictionPassthroughNaN': det.PredictionPassthrough(
          copy_nans_from_targets=True),
      'TargetPassthrough': det.TargetPassthrough(
          copy_nans_from_predictions=True),
      'RelativeIntensity': det.RelativeIntensity(),
      'WindVectorSquaredError': det.WindVectorSquaredError(
          ['u'], ['v'], ['wind']),
      'SquaredPredictionAnomaly': det.SquaredPredictionAnomaly(clim),
      'SquaredTargetAnomaly': det.SquaredTargetAnomaly(clim),
      'AnomalyCovariance': det.AnomalyCovariance(clim),
      'ErrorExceedance': det.ErrorExceedance([0.5, 1.0, 2.0]),
  }


@pytest.mark.parametrize('name', list(_statistics(darray, {})))
@pytest.mark.parametrize('mask', [False, True])
def test_statistic_matches_jax(name, mask):
  p, t, c = _chunk(darray, nan_at=(0, 1, 2, 3))
  jp, jt, jc = _chunk(j_darray, nan_at=(0, 1, 2, 3))
  if mask:
    m = np.random.default_rng(9).random((N_LAT, N_LON)) > 0.3
    t = {k: v.assign_coords(mask=darray.Coord(('latitude', 'longitude'), m))
         for k, v in t.items()}
    jt = {k: v.assign_coords(mask=j_darray.Coord(('latitude', 'longitude'), m))
          for k, v in jt.items()}
  got = _statistics(darray, c)[name].compute(p, t)
  want = _statistics(j_darray, jc)[name].compute(jp, jt)
  assert sorted(got) == sorted(want)
  for var in want:
    _assert_da_close(got[var], want[var], (name, var))


def _metrics(mod, clim):
  det, cat, wrap = ((deterministic, categorical, wrappers) if mod is darray
                    else (j_deterministic, j_categorical, j_wrappers))
  return {
      'rmse': det.RMSE(), 'mse': det.MSE(), 'bias': det.Bias(),
      'mae': det.MAE(), 'acc': det.ACC(climatology=clim),
      'prediction_activity': det.PredictionActivity(climatology=clim),
      'vector_rmse': det.WindVectorRMSE('u', 'v', 'wind'),
      'prediction_average': det.PredictionAverage(),
      'target_average': det.TargetAverage(),
      'seeps': cat.SEEPS(variables=[PRECIP], climatology=clim,
                         dry_threshold_mm=0.25),
      'rmse_of_wrapped': wrap.WrappedMetric(
          det.RMSE(), [wrap.EnsembleMean(which='predictions',
                                         skip_if_ensemble_dim_missing=True)]),
  }


def _aggregator(mod, masked):
  agg, bins, w = ((aggregation, binning, weighting) if mod is darray
                  else (j_aggregation, j_binning, j_weighting))
  return agg.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[w.GridAreaWeighting()], bin_by=[bins.Regions(REGIONS)],
      masked=masked)


@pytest.mark.parametrize('masked', [False, True])
def test_metric_values_match_jax(masked):
  p, t, c = _chunk(darray, seed=3)
  jp, jt, jc = _chunk(j_darray, seed=3)
  got = aggregation.compute_metric_values_for_single_chunk(
      _metrics(darray, c), _aggregator(darray, masked), p, t)
  want = j_aggregation.compute_metric_values_for_single_chunk(
      _metrics(j_darray, jc), _aggregator(j_darray, masked), jp, jt)
  assert sorted(got) == sorted(want)
  assert 'vector_rmse.wind' in got and f'seeps.{PRECIP}' in got
  for k in want:
    _assert_da_close(got[k], want[k], k)
    for d in got[k].dims:
      np.testing.assert_array_equal(got[k].coord_values(d),
                                    np.asarray(want[k].coords[d].values))


def test_acc_and_activity_share_one_anomaly_compute(monkeypatch):
  p, t, c = _chunk(darray)
  calls = []
  inner = deterministic.SquaredPredictionAnomaly.\
      _compute_per_variable_with_aligned_climatology

  def counting(self, *args):
    calls.append(1)
    return inner(self, *args)

  monkeypatch.setattr(deterministic.SquaredPredictionAnomaly,
                      '_compute_per_variable_with_aligned_climatology',
                      counting)
  metrics = {'acc': deterministic.ACC(climatology=c),
             'activity': deterministic.PredictionActivity(climatology=c)}
  stats = base.unique_statistics_for_metrics(metrics)
  assert sorted(stats) == ['AnomalyCovariance', 'SquaredPredictionAnomaly',
                           'SquaredTargetAnomaly']
  out = base.compute_unique_statistics_for_all_metrics(metrics, p, t)
  assert len(calls) == len(p)  # one compute per variable, not two
  assert sorted(out['SquaredPredictionAnomaly']) == sorted(p)
  # A different climatology under the same unique name must not dedup.
  other = {k: v + 1.0 for k, v in c.items()}
  with pytest.raises(ValueError, match='share the unique_name'):
    base.unique_statistics_for_metrics({
        'acc': deterministic.ACC(climatology=c),
        'activity': deterministic.PredictionActivity(climatology=other)})


def _seeps_pair(mod, seed=5):
  p, t, c = _chunk(mod, seed=seed)
  return {PRECIP: p[PRECIP]}, {PRECIP: t[PRECIP]}, c


@pytest.mark.parametrize('case', ['plain', 'nan_data', 'nan_threshold',
                                  'p1_out_of_range', 'target_mask'])
def test_seeps_matches_jax(case):
  def build(mod):
    p, t, c = _seeps_pair(mod)
    thr = f'{PRECIP}_seeps_threshold'
    df = f'{PRECIP}_seeps_dry_fraction'
    if case == 'nan_data':
      x = p[PRECIP].values.copy()
      x[0, 0, :3, :3] = np.nan
      p = {PRECIP: mod.DimArray(x, p[PRECIP].dims, p[PRECIP].coords)}
    elif case == 'nan_threshold':
      x = np.asarray(c[thr].values).copy()
      x[:, :, 2:5] = np.nan
      c = dict(c, **{thr: mod.DimArray(x, c[thr].dims, c[thr].coords)})
    elif case == 'p1_out_of_range':
      x = np.asarray(c[df].values).copy()
      x[:, :, :2] = 0.02
      x[:, :, -2:] = 0.97
      c = dict(c, **{df: mod.DimArray(x, c[df].dims, c[df].coords)})
    elif case == 'target_mask':
      m = np.random.default_rng(4).random((N_LAT, N_LON)) > 0.3
      t = {PRECIP: t[PRECIP].assign_coords(
          mask=mod.Coord(('latitude', 'longitude'), m))}
    cat = categorical if mod is darray else j_categorical
    return cat.SEEPS([PRECIP], c, dry_threshold_mm=0.25).compute(p, t)[PRECIP]

  got, want = build(darray), build(j_darray)
  _assert_da_close(got, want, case)
  if case == 'nan_data':
    assert np.isnan(got.values[0, 0, :3, :3]).all()
    assert np.isfinite(got.values[1]).any()
  if case == 'nan_threshold':
    # No category, no score: not NaN, unless the point is out of p1 range.
    inside = got.coord_values('mask')[:, :, 2:5]
    assert np.isfinite(got.values[:, :, 2:5][inside]).all()
  if case == 'p1_out_of_range':
    assert not got.coord_values('mask')[:, :, :2].any()
    assert np.isnan(got.values[:, :, -2:]).all()


def test_seeps_float32_arithmetic_is_bit_identical_to_jax():
  """With dry fractions on a 1/64 lattice every partial sum is exact, so p1
  is the same float32 in both packages (the port takes the mean in float64
  and rounds once; the JAX package sums in float32), and every score
  matches the JAX package's bit for bit. The JAX side runs with x64 off,
  as on its TPU: under x64 its Python-scalar constants promote to
  float64."""
  def build(mod):
    p, t, c = _seeps_pair(mod, seed=8)
    df = f'{PRECIP}_seeps_dry_fraction'
    x = (np.round(np.asarray(c[df].values) * 64) / 64).astype(np.float32)
    c = dict(c, **{df: mod.DimArray(x, c[df].dims, c[df].coords)})
    cat = categorical if mod is darray else j_categorical
    return cat.SEEPS([PRECIP], c).compute(p, t)[PRECIP]

  got = build(darray)
  with jax.enable_x64(False):
    want = build(j_darray)
    want_values = np.asarray(want.values)
  assert want_values.dtype == np.float32
  np.testing.assert_array_equal(got.values, want_values)
  assert np.isfinite(got.values).sum() > 100


def test_seeps_masks_on_both_sides_raise():
  p, t, c = _seeps_pair(darray)
  m = darray.Coord(('latitude', 'longitude'), np.ones((N_LAT, N_LON), bool))
  p = {PRECIP: p[PRECIP].assign_coords(mask=m)}
  t = {PRECIP: t[PRECIP].assign_coords(mask=m)}
  with pytest.raises(ValueError, match='masks on both'):
    categorical.SEEPS([PRECIP], c).compute(p, t)


def test_seeps_construction_touches_no_device(monkeypatch):
  """ADVICE.md round 5, categorical.py:105: p1 comes from numpy over the
  mapped time axes; no tensor reduction (the JAX package's
  ``DimArray.mean``) runs and p1 stays a numpy-backed CPU tensor."""
  _, _, c = _seeps_pair(darray)

  def forbidden(*args, **kwargs):
    raise AssertionError('SEEPS construction reduced a tensor')

  for name in ('mean', 'sum', 'nanmean'):
    monkeypatch.setattr(darray.DimArray, name, forbidden, raising=False)
    monkeypatch.setattr(torch, name, forbidden)
  monkeypatch.setattr(torch.Tensor, 'mean', forbidden)
  monkeypatch.setattr(torch.Tensor, 'to', forbidden)
  monkeypatch.setattr(torch.Tensor, 'cuda', forbidden)
  seeps = categorical.SEEPS([PRECIP], c)
  monkeypatch.undo()
  p1 = seeps._p1[PRECIP]
  assert p1.dims == ('latitude', 'longitude')
  assert p1.data.device.type == 'cpu' and p1.dtype == torch.float32
  df = c[f'{PRECIP}_seeps_dry_fraction'].values.astype(np.float64)
  np.testing.assert_array_equal(p1.values,
                                df.mean(axis=(0, 1)).astype(np.float32))
  # numpy-backed: a write through numpy shows in the tensor.
  view = p1.data.numpy()
  view[0, 0] = 0.5
  assert p1.data[0, 0].item() == 0.5


def test_ensemble_mean_and_wrapped_metric_match_jax():
  rng = np.random.default_rng(12)
  x = rng.standard_normal((5, N_INIT, N_LAT, N_LON)).astype(np.float32)
  x[1, 0, 0, 0] = np.nan
  y = rng.standard_normal((N_INIT, N_LAT, N_LON)).astype(np.float32)
  coords = {'latitude': LAT, 'longitude': LON}

  def run(mod, skipna):
    det, wrap, agg, w = (
        (deterministic, wrappers, aggregation, weighting) if mod is darray
        else (j_deterministic, j_wrappers, j_aggregation, j_weighting))
    p = {'t': mod.DimArray(x, ('number', 'init_time', 'latitude',
                                'longitude'), coords)}
    t = {'t': mod.DimArray(y, ('init_time', 'latitude', 'longitude'),
                           coords)}
    metric = wrap.WrappedMetric(det.RMSE(), [wrap.EnsembleMean(
        which='predictions', skipna=skipna)])
    names = [s.unique_name for s in metric.statistics.values()]
    renamed = wrap.WrappedMetric(det.RMSE(), [wrap.EnsembleMean(
        which='both', skip_if_ensemble_dim_missing=True)],
                                 unique_name_suffix='ens')
    names += [s.unique_name for s in renamed.statistics.values()]
    values = agg.compute_metric_values_for_single_chunk(
        {'m': metric, 'r': renamed}, agg.Aggregator(
            reduce_dims=['latitude', 'longitude'],
            weigh_by=[w.GridAreaWeighting()], skipna=skipna), p, t)
    return names, values

  for skipna in (False, True):
    names, got = run(darray, skipna)
    j_names, want = run(j_darray, skipna)
    assert names == j_names
    assert names[0] == ("SquaredError_predictions_ensemble_mean_"
                        f"self._ensemble_dim='number'_self._skipna={skipna}")
    assert names[1] == 'SquaredError_ens'
    for k in want:
      _assert_da_close(got[k], want[k], (k, skipna))
  with pytest.raises(ValueError, match='Invalid value'):
    wrappers.EnsembleMean(which='neither')


def test_wrapped_statistic_forwards_the_host_hook_and_resources():
  _, _, c = _chunk(darray)
  inner = deterministic.SquaredPredictionAnomaly(c)
  wrapped = wrappers.WrappedStatistic(inner, wrappers.EnsembleMean(
      'predictions', skip_if_ensemble_dim_missing=True))
  renamed = wrappers.RenamedStatistic(wrapped, 'spa')
  assert renamed.device_resource_arrays().keys() == (
      inner.device_resource_arrays().keys())
  assert renamed.host_gatherable_resource_arrays().keys() == (
      inner.host_gatherable_resource_arrays().keys())
  rid = base.resource_id(c['geopotential'])
  renamed.set_host_gather_resources({rid})
  assert inner._host_gather_ids == {rid}
  p, t, _ = _chunk(darray)
  hp, _ = renamed.prepare_chunk(p, t)
  assert f'{base.CLIM_VALUE_PREFIX}{rid}' in hp['geopotential'].coords
  assert f'{base.CLIM_INDEX_PREFIX}hour' in hp['u'].coords
