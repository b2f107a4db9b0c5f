"""The rest of the port's ``metrics/categorical`` against the JAX package,
on the CPU.

The confusion-matrix statistics and the ten metrics over them, the
CDF-based ranked probability score, ``Reliability`` and the
decision-support family (``Confident``, ``Covered``, ``JaccardDistant``,
``Opportunism``) on the same seeded numpy inputs in both packages: values
to atol 1e-5, dims, unique names and state keys exactly. ``Confident`` and
``JaccardDistant`` read a climatology with a ``quantile`` dim: they go
through the evaluator under both of its climatology plans (resident and
host-gathered), which agree bit for bit.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import categorical as j_categorical
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import convert
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import categorical
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

ATOL = 1e-5
M, N_INIT, N_LEAD, N_LAT, N_LON = 7, 3, 2, 5, 8
INITS = np.array(['2020-01-01T00', '2020-01-01T12', '2020-01-02T00'],
                 dtype='datetime64[ns]')
LEADS = (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
LAT = np.linspace(-60, 60, N_LAT)
LON = np.arange(N_LON) * 45.0
DIMS = ('init_time', 'lead_time', 'latitude', 'longitude')
COORDS = {'init_time': INITS, 'lead_time': LEADS, 'latitude': LAT,
          'longitude': LON}
REDUCE = ['init_time', 'latitude', 'longitude']
PKG = {'torch': (td, categorical, aggregation, base),
       'jax': (jd, j_categorical, j_aggregation, j_base)}


def _binary(mod, seed, nan=False):
  rng = np.random.default_rng(seed)
  x = (rng.random((N_INIT, N_LEAD, N_LAT, N_LON)) > 0.6).astype(np.float32)
  if nan:
    x[0, 1, 2, 3] = np.nan
    x[2, 0, 0, :] = np.nan
  return mod.DimArray(x, DIMS, COORDS)


def _same(got, want, atol=ATOL):
  assert got.dims == tuple(want.dims), (got.dims, want.dims)
  w = np.asarray(want.values)
  np.testing.assert_allclose(got.values.astype(np.float64),
                             w.astype(np.float64), rtol=0, atol=atol,
                             equal_nan=True)
  for name, c in want.coords.items():
    np.testing.assert_array_equal(got.coord_values(name),
                                  np.asarray(c.values), err_msg=name)


CELLS = ['TruePositives', 'TrueNegatives', 'FalsePositives', 'FalseNegatives']


@pytest.mark.parametrize('nan', [False, True])
@pytest.mark.parametrize('name', CELLS)
def test_confusion_cell_matches_jax(name, nan):
  got = getattr(categorical, name)().compute(
      {'v': _binary(td, 1, nan)}, {'v': _binary(td, 2, nan and name[0] == 'T')})
  want = getattr(j_categorical, name)().compute(
      {'v': _binary(jd, 1, nan)}, {'v': _binary(jd, 2, nan and name[0] == 'T')})
  assert getattr(categorical, name)().unique_name == getattr(
      j_categorical, name)().unique_name == name
  _same(got['v'], want['v'], atol=0)
  assert got['v'].dtype == torch.float32


def test_confusion_cells_hand_counts_and_partition():
  p = td.DimArray(np.array([1, 1, 1, 0, 0, 0, 0, 1, np.nan], np.float32),
                  ('x',))
  t = td.DimArray(np.array([1, 1, 0, 1, 0, 0, 0, 0, 1], np.float32), ('x',))
  cells = {n: getattr(categorical, n)().compute({'v': p}, {'v': t})['v'].values
           for n in CELLS}
  assert [np.nansum(cells[n]) for n in CELLS] == [2, 3, 2, 1]
  assert all(np.isnan(c[-1]) for c in cells.values())
  np.testing.assert_array_equal(sum(cells.values())[:-1], np.ones(8))
  mask = categorical._nan_mask_product(p, t)
  np.testing.assert_array_equal(mask.values, [True] * 8 + [False])


METRICS = ['CSI', 'Accuracy', 'Recall', 'FalseAlarmRate', 'Precision',
           'F1Score', 'FrequencyBias', 'HSS', 'ETS', 'SEDI']


def _metric_values(which, metrics_of, preds_of, tgts_of, **agg_kwargs):
  mod, cat, agg, base_mod = PKG[which]
  metrics = metrics_of(cat)
  stats = base_mod.compute_unique_statistics_for_all_metrics(
      metrics, preds_of(mod), tgts_of(mod))
  state = agg.Aggregator(reduce_dims=REDUCE, **agg_kwargs
                         ).aggregate_statistics(stats)
  return state, state.metric_values(metrics)


@pytest.mark.parametrize('skipna', [False, True])
@pytest.mark.parametrize('name', METRICS)
def test_confusion_metric_matches_jax(name, skipna):
  args = (lambda cat: {'m': getattr(cat, name)()},
          lambda mod: {'v': _binary(mod, 3, nan=skipna)},
          lambda mod: {'v': _binary(mod, 4)})
  t_state, got = _metric_values('torch', *args, skipna=skipna)
  j_state, want = _metric_values('jax', *args, skipna=skipna)
  assert list(t_state.to_dataset()) == list(j_state.to_dataset())
  _same(got['m.v'], want['m.v'])
  assert np.isfinite(got['m.v'].values).all()


def test_metric_formulas_by_hand():
  p = td.DimArray(np.array([1, 1, 1, 0, 0, 0, 0, 1], np.float32), ('x',))
  t = td.DimArray(np.array([1, 1, 0, 1, 0, 0, 0, 0], np.float32), ('x',))
  metrics = {n: getattr(categorical, n)() for n in METRICS}
  out = aggregation.compute_metric_values_for_single_chunk(
      metrics, aggregation.Aggregator(reduce_dims=['x']), {'v': p}, {'v': t})
  tp, tn, fp, fn = 2 / 8, 3 / 8, 2 / 8, 1 / 8
  h = np.clip(tp / (tp + fn), 1e-6, 1 - 1e-6)
  f = np.clip(fp / (fp + tn), 1e-6, 1 - 1e-6)
  tpr = (tp + fp) * (tp + fn)
  want = {
      'CSI': tp / (tp + fp + fn), 'Accuracy': tp + tn,
      'Recall': tp / (tp + fn), 'FalseAlarmRate': fp / (tp + fp),
      'Precision': tp / (tp + fp), 'F1Score': 2 * tp / (2 * tp + fp + fn),
      'FrequencyBias': (tp + fp) / (tp + fn),
      'HSS': 2 * (tp * tn - fp * fn) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn)),
      'ETS': (tp - tpr) / (tp + fp + fn - tpr),
      'SEDI': ((np.log(f) - np.log(h) + np.log(1 - h) - np.log(1 - f))
               / (np.log(h) + np.log(f) + np.log(1 - h) + np.log(1 - f))),
  }
  for name, value in want.items():
    assert out[f'{name}.v'].item() == pytest.approx(value, rel=1e-5), name


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_sedi_clips_perfect_rates(which):
  mod, cat, agg, _ = PKG[which]
  p = mod.DimArray(np.array([1, 1, 0, 0], np.float32), ('x',))
  out = agg.compute_metric_values_for_single_chunk(
      {'sedi': cat.SEDI()}, agg.Aggregator(reduce_dims=['x']),
      {'v': p}, {'v': p})
  assert np.isfinite(float(out['sedi.v'].values))
  assert float(out['sedi.v'].values) == pytest.approx(1.0, abs=1e-5)


# -- ranked probability score and reliability --------------------------------------


def _cdf(mod, seed):
  rng = np.random.default_rng(seed)
  x = np.sort(rng.random((N_INIT, N_LAT, 4)).astype(np.float32), axis=-1)
  x[1, 2, :] = np.nan
  return mod.DimArray(x, ('init_time', 'latitude', 'bin'),
                      {'init_time': INITS, 'latitude': LAT,
                       'bin': np.arange(4)})


def test_ranked_probability_score_matches_jax():
  got = categorical.RankedProbabilityScore('bin').compute(
      {'v': _cdf(td, 5)}, {'v': _cdf(td, 6)})['v']
  want = j_categorical.RankedProbabilityScore('bin').compute(
      {'v': _cdf(jd, 5)}, {'v': _cdf(jd, 6)})['v']
  _same(got, want)
  assert got.dims == ('init_time', 'latitude')
  assert (categorical.RankedProbabilityScore('bin').unique_name
          == j_categorical.RankedProbabilityScore('bin').unique_name)


def _prob(mod, seed):
  x = np.random.default_rng(seed).random(
      (N_INIT, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  x[0, 0, 0, 0] = np.nan
  x[1, 1, 1, 1] = 0.3  # on an edge: right-inclusive
  return mod.DimArray(x, DIMS, COORDS)


@pytest.mark.parametrize('kind', ['default', 'custom'])
def test_reliability_matches_jax(kind):
  kwargs = {} if kind == 'default' else {
      'bin_values': [-np.inf, 0.25, 0.5, 1.0], 'bin_dim': 'pbin',
      'statistic_suffix': 'three'}
  args = (lambda cat: {'rel': cat.Reliability(**kwargs)},
          lambda mod: {'v': _prob(mod, 7)}, lambda mod: {'v': _binary(mod, 8)})
  t_state, got = _metric_values('torch', *args, skipna=True)
  j_state, want = _metric_values('jax', *args, skipna=True)
  assert list(t_state.to_dataset()) == list(j_state.to_dataset())
  _same(got['rel.v'], want['rel.v'])
  bin_dim = kwargs.get('bin_dim', 'reliability_bin')
  assert got['rel.v'].coord_values(bin_dim).dtype.kind == 'U'


def test_reliability_of_a_calibrated_forecast():
  rng = np.random.default_rng(0)
  prob = rng.random(20000).astype(np.float32)
  target = (rng.random(20000) < prob).astype(np.float32)
  out = aggregation.compute_metric_values_for_single_chunk(
      {'rel': categorical.Reliability()},
      aggregation.Aggregator(reduce_dims=['x']),
      {'v': td.DimArray(prob, ('x',))}, {'v': td.DimArray(target, ('x',))})
  assert out['rel.v'].sizes['reliability_bin'] == 10
  np.testing.assert_allclose(out['rel.v'].values, np.arange(0.05, 1.0, 0.1),
                             atol=0.03)


# -- decision support -----------------------------------------------------------------


def _ensemble(mod, seed=9):
  x = np.random.default_rng(seed).standard_normal(
      (M, N_INIT, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  return mod.DimArray(x, ('number',) + DIMS,
                      {'number': np.arange(M), **COORDS})


def _truth(mod, seed=10):
  x = np.random.default_rng(seed).standard_normal(
      (N_INIT, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  return mod.DimArray(x, DIMS, COORDS)


def _quantile_climatology(mod, seed=11):
  """dayofyear x hour x quantile x latitude x longitude, quantiles 0.1 and
  0.9 (and 0.5, unused) of a climate of varying width."""
  rng = np.random.default_rng(seed)
  centre = rng.standard_normal((4, 4, 1, N_LAT, N_LON)) * 0.5
  width = rng.uniform(0.2, 3.0, (4, 4, 1, N_LAT, N_LON))
  q = np.array([0.1, 0.5, 0.9])
  z = np.array([-1.2816, 0.0, 1.2816]).reshape(1, 1, 3, 1, 1)
  return {'v': mod.DimArray(
      (centre + width * z).astype(np.float32),
      ('dayofyear', 'hour', 'quantile', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 5), 'hour': np.array([0, 6, 12, 18]),
       'quantile': q, 'latitude': LAT, 'longitude': LON})}


DECISION = {
    'Confident': lambda cat, clim: cat.Confident('number', clim),
    'Confident_custom': lambda cat, clim: cat.Confident(
        'number', clim, spread_quantile_boundaries=(0.1, 0.5),
        confidence_threshold=1.5),
    'Covered': lambda cat, clim: cat.Covered('number'),
    'Covered_narrow': lambda cat, clim: cat.Covered(
        'number', interval_quantile_boundaries=(0.25, 0.75)),
    'JaccardDistant': lambda cat, clim: cat.JaccardDistant('number', clim),
    'JaccardDistant_custom': lambda cat, clim: cat.JaccardDistant(
        'number', clim, threshold=0.5,
        interval_quantile_boundaries=(0.1, 0.5)),
}


@pytest.mark.parametrize('name', sorted(DECISION))
def test_decision_statistic_matches_jax(name):
  t_stat = DECISION[name](categorical, _quantile_climatology(td))
  j_stat = DECISION[name](j_categorical, _quantile_climatology(jd))
  assert t_stat.unique_name == j_stat.unique_name
  got = t_stat.compute({'v': _ensemble(td)}, {'v': _truth(td)})['v']
  want = j_stat.compute({'v': _ensemble(jd)}, {'v': _truth(jd)})['v']
  assert got.dtype == torch.bool
  assert got.dims == tuple(want.dims)
  np.testing.assert_array_equal(got.values, np.asarray(want.values))
  assert 0 < got.values.mean() < 1  # the case tells the two answers apart


OPPORTUNISM = {
    'confident': dict(is_confident=True),
    'all_true': dict(is_confident=True, is_covered=True,
                     is_jaccard_distant=True),
    'all_false': dict(is_confident=False, is_covered=False,
                      is_jaccard_distant=False),
    'mixed_custom': dict(is_confident=False, is_covered=True,
                         coverage_quantile_boundaries=(0.25, 0.75),
                         jaccard_distance_threshold=0.5,
                         is_jaccard_distant=True),
}


@pytest.mark.parametrize('name', sorted(OPPORTUNISM))
def test_opportunism_matches_jax(name):
  def args(which):
    mod = PKG[which][0]
    clim = _quantile_climatology(mod)
    return (lambda cat: {'opp': cat.Opportunism('number', clim,
                                                **OPPORTUNISM[name])},
            lambda m: {'v': _ensemble(m)}, lambda m: {'v': _truth(m)})
  t_state, got = _metric_values('torch', *args('torch'))
  j_state, want = _metric_values('jax', *args('jax'))
  assert list(t_state.to_dataset()) == list(j_state.to_dataset())
  _same(got['opp.v'], want['opp.v'])


def test_decision_support_hand_values():
  lats, lons = np.array([0.0, 10.0]), np.array([0.0])
  coords = {'number': np.arange(5),
            'init_time': np.array(['2020-01-01T00'], dtype='datetime64[ns]'),
            'lead_time': np.array([0], dtype='timedelta64[ns]'),
            'latitude': lats, 'longitude': lons}
  dims = ('number', 'init_time', 'lead_time', 'latitude', 'longitude')
  vals = np.broadcast_to(np.arange(5.0).reshape(5, 1, 1, 1, 1),
                         (5, 1, 1, 2, 1)).astype(np.float32)
  preds = {'v': td.DimArray(vals.copy(), dims, coords)}
  tgts = {'v': td.DimArray(np.array([2.0, 1.0], np.float32).reshape(
      1, 1, 2, 1), dims[1:], {k: coords[k] for k in dims[1:]})}
  edges = np.array([[[0.0], [100.0]], [[10.0], [102.0]]], np.float32)
  clim = {'v': td.DimArray(
      np.broadcast_to(edges, (366, 4, 2, 2, 1)).copy(),
      ('dayofyear', 'hour', 'quantile', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
       'quantile': np.array([0.1, 0.9]), 'latitude': lats,
       'longitude': lons})}
  # Members 0..4: the 0.1 and 0.9 quantiles are 0.4 and 3.6, spread 3.2.
  conf = categorical.Confident('number', clim).compute(preds, tgts)['v']
  np.testing.assert_array_equal(conf.values.ravel(), [True, False])
  cov = categorical.Covered('number').compute(preds, tgts)['v']
  np.testing.assert_array_equal(cov.values.ravel(), [True, True])
  far = categorical.JaccardDistant('number', clim).compute(preds, tgts)['v']
  np.testing.assert_array_equal(far.values.ravel(), [False, True])
  agg = aggregation.Aggregator(reduce_dims=list(dims[1:]))
  for kwargs, want in ((dict(is_confident=True, is_covered=True,
                             is_jaccard_distant=True), 0.25),
                       (dict(is_confident=False, is_covered=False,
                             is_jaccard_distant=False), 0.0),
                       (dict(is_confident=True), 0.5)):
    out = aggregation.compute_metric_values_for_single_chunk(
        {'opp': categorical.Opportunism('number', clim, **kwargs)}, agg,
        preds, tgts)
    assert out['opp.v'].item() == pytest.approx(want)
  # Identical point intervals: union 0, index 1, distance 0.
  flat_p = {'v': preds['v'].copy(data=torch.full((5, 1, 1, 2, 1), 5.0))}
  flat_c = {'v': clim['v'].copy(data=torch.full((366, 4, 2, 2, 1), 5.0))}
  assert not categorical.JaccardDistant('number', flat_c).compute(
      flat_p, tgts)['v'].values.any()


def _decision_metrics(clim):
  return {'opp': categorical.Opportunism(
      'number', clim, is_confident=True, is_covered=True,
      is_jaccard_distant=False)}


@pytest.mark.parametrize('plan', ['resident', 'host_gathered'])
def test_quantile_climatology_under_both_evaluator_plans(plan, monkeypatch):
  """The evaluator aligns the quantile-dim climatology on the device, or
  gathers the chunk's slices on the host past its memory budget: the same
  bits either way, and the JAX package's values."""
  if plan == 'resident':
    monkeypatch.delenv('WBX_RESOURCE_BYTES', raising=False)
  else:
    monkeypatch.setenv('WBX_RESOURCE_BYTES', '1')
  clim = _quantile_climatology(td)
  ev = evaluator.ChunkEvaluator(
      metrics=_decision_metrics(clim),
      aggregator=aggregation.Aggregator(reduce_dims=REDUCE), device='cpu')
  assert bool(ev.host_gather_ids) == (plan == 'host_gathered')
  state = ev.eval_chunk({'v': _ensemble(td)}, {'v': _truth(td)})
  got = state.metric_values(ev.metrics)['opp.v']

  direct = aggregation.Aggregator(reduce_dims=REDUCE).aggregate_statistics(
      base.compute_unique_statistics_for_all_metrics(
          _decision_metrics(_quantile_climatology(td)),
          {'v': _ensemble(td)}, {'v': _truth(td)}))
  for key, da in direct.to_dataset().items():
    assert torch.equal(state.to_dataset()[key].data, da.data), key

  j_clim = _quantile_climatology(jd)
  want = j_aggregation.compute_metric_values_for_single_chunk(
      {'opp': j_categorical.Opportunism(
          'number', j_clim, is_confident=True, is_covered=True,
          is_jaccard_distant=False)},
      j_aggregation.Aggregator(reduce_dims=REDUCE),
      {'v': _ensemble(jd)}, {'v': _truth(jd)})['opp.v']
  _same(got, want)


def test_convert_carries_a_quantile_climatology():
  """A climatology of the JAX package, quantile dim included, converts to
  the port and gives the same statistic."""
  j_clim = _quantile_climatology(jd)
  clim = convert.dataset_from_reference(j_clim)
  assert clim['v'].dims == tuple(j_clim['v'].dims)
  np.testing.assert_array_equal(clim['v'].coord_values('quantile'),
                                [0.1, 0.5, 0.9])
  got = categorical.JaccardDistant('number', clim).compute(
      {'v': _ensemble(td)}, {'v': _truth(td)})['v']
  want = j_categorical.JaccardDistant('number', j_clim).compute(
      {'v': _ensemble(jd)}, {'v': _truth(jd)})['v']
  np.testing.assert_array_equal(got.values, np.asarray(want.values))
