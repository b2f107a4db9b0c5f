"""The port's climatology alignment, resource plan and loaders, on the CPU.

The same inputs, made from a numpy seed, go through the JAX package and
the port; values agree to rtol 1e-5 / atol 1e-6 (index arrays and gathers
exactly). Covered: the darray ops this path needs, alignment keyed by
``time``, by ``dayofyear`` and by ``dayofyear`` and ``hour`` (explicit
valid_time and init + lead, a leap-year day 366), the device and host
gathers, the evaluator's resource plan (the resident and forced
host-gather runs equal by ``torch.equal``; the ``ADVICE.md`` round-5
findings the port must not copy), the four new loaders and
``io.open_dataset_auto``.
"""

import logging

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import categorical
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import evaluator
from weatherbenchx_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_LAT, N_LON = 8, 16
LAT = np.linspace(-90, 90, N_LAT)
LON = np.linspace(0, 360, N_LON, endpoint=False)


# -- darray ops ------------------------------------------------------------------


def test_sortby_matches_jax_on_descending_latitude():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((3, N_LAT, N_LON)).astype(np.float32)
  coords = {'level': np.array([500, 700, 850]), 'latitude': LAT[::-1].copy(),
            'longitude': LON}
  dims = ('level', 'latitude', 'longitude')
  got = darray.DimArray(x, dims, coords).sortby('latitude')
  want = j_darray.DimArray(x, dims, coords).sortby('latitude')
  np.testing.assert_array_equal(got.values, np.asarray(want.values))
  np.testing.assert_array_equal(got.coord_values('latitude'), LAT)
  down = got.sortby('latitude', ascending=False)
  np.testing.assert_array_equal(down.values, x)


def test_expand_dims_zeros_like_and_sel_of_a_level_list():
  x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
  coords = {'level': np.array([500, 700, 850])}
  dims = ('init_time', 'level', 'longitude')
  got = darray.DimArray(x, dims, coords)
  want = j_darray.DimArray(x, dims, coords)
  e, je = got.expand_dims({'lead_time': 5}, axis=1), want.expand_dims(
      {'lead_time': 5}, axis=1)
  assert e.dims == je.dims and e.shape == je.shape
  np.testing.assert_array_equal(e.values, np.asarray(je.values))
  assert got.expand_dims('number').shape == (1, 2, 3, 4)
  z = darray.zeros_like(got)
  assert z.dtype == torch.float32 and not z.data.any()
  assert darray.zeros_like(got, np.float64).dtype == torch.float64
  s, js = got.sel(level=[850, 500]), want.sel(level=[850, 500])
  np.testing.assert_array_equal(s.values, np.asarray(js.values))
  np.testing.assert_array_equal(s.coord_values('level'), [850, 500])
  with pytest.raises(KeyError):
    got.sel(level=[300])


def _tie_case():
  """x exact in float32; t64 strictly above x in float64, but rounding to
  nearest float32 gives exactly x (tests/test_coverage_gaps.py)."""
  x = np.float32(0.3360923)
  up = np.nextafter(x, np.float32(np.inf))
  t64 = float(x) + 0.25 * (float(up) - float(x))
  assert float(x) < t64 and np.float32(t64) == x
  return x, t64


@pytest.mark.parametrize('op', ['<=', '<', '>', '>='])
def test_comparison_safe_threshold_keeps_the_float64_answer(op):
  x, t64 = _tie_case()
  down = np.nextafter(x, np.float32(-np.inf))
  t64b = float(x) - 0.25 * (float(x) - float(down))  # rounds UP to x
  fn = {'<=': np.less_equal, '<': np.less, '>': np.greater,
        '>=': np.greater_equal}[op]
  thr = darray.DimArray(np.array([t64, t64b, 0.5, np.nan]), ('t',))
  adj = darray.comparison_safe_threshold(thr, torch.float32, op)
  assert adj.dtype == torch.float32
  data = torch.tensor([x, x, 0.5, x], dtype=torch.float32)
  got = {'<=': torch.le, '<': torch.lt, '>': torch.gt,
         '>=': torch.ge}[op](data, adj.data)
  want = fn(np.float64(data.numpy()), np.array([t64, t64b, 0.5, np.nan]))
  np.testing.assert_array_equal(got.numpy(), want)
  # The JAX package rounds to the same float32 constants.
  j_adj = j_darray.comparison_safe_threshold(
      j_darray.DimArray(np.array([t64, t64b, 0.5, np.nan]), ('t',)),
      np.float32, op)
  np.testing.assert_array_equal(adj.values, np.asarray(j_adj.values))
  # No-ops: float64 data and non-float data.
  assert darray.comparison_safe_threshold(
      thr, torch.float64, op).data.dtype == torch.float64
  assert darray.comparison_safe_threshold(
      thr, torch.int32, op).data.dtype == torch.float64


def test_error_exceedance_tie():
  x, t64 = _tie_case()
  preds = {'v': darray.DimArray(np.array([x], np.float32), ('p',))}
  targs = {'v': darray.DimArray(np.zeros(1, np.float32), ('p',))}
  out = deterministic.ErrorExceedance(thresholds=[t64]).compute(
      preds, targs)['v']
  # |error| = x < t64 in float64: not exceeded (round-to-nearest would tie
  # and, with >, still say no; with the threshold below x it must say yes).
  np.testing.assert_array_equal(out.values.ravel(), [0.0])
  down = np.nextafter(x, np.float32(-np.inf))
  t64b = float(x) - 0.25 * (float(x) - float(down))
  out = deterministic.ErrorExceedance(thresholds=[t64b]).compute(
      preds, targs)['v']
  np.testing.assert_array_equal(out.values.ravel(), [1.0])


# -- alignment ---------------------------------------------------------------------


def _clim(mod, kind, seed=1, dtype=np.float32):
  """A climatology keyed by ``kind``: 'time', 'dayofyear' or 'doy_hour'."""
  rng = np.random.default_rng(seed)
  space = {'latitude': LAT, 'longitude': LON}
  if kind == 'time':
    t = (np.datetime64('2020-12-30', 'ns')
         + np.arange(12) * np.timedelta64(6, 'h'))
    return mod.DimArray(rng.standard_normal((12, N_LAT, N_LON)).astype(dtype),
                        ('time', 'latitude', 'longitude'), {'time': t, **space})
  if kind == 'dayofyear':
    return mod.DimArray(
        rng.standard_normal((366, N_LAT, N_LON)).astype(dtype),
        ('dayofyear', 'latitude', 'longitude'),
        {'dayofyear': np.arange(1, 367), **space})
  return mod.DimArray(
      rng.standard_normal((366, 4, 2, N_LAT, N_LON)).astype(dtype),
      ('dayofyear', 'hour', 'level', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
       'level': np.array([500, 850]), **space})


# Inits across the end of the leap year 2020: day 366 and then day 1.
INITS = np.array(['2020-12-30T12', '2020-12-31T00'], dtype='datetime64[ns]')
LEADS = np.array([0, 6, 12, 18, 24], dtype='timedelta64[h]').astype(
    'timedelta64[ns]')


def _pred(mod, explicit_valid_time):
  x = np.zeros((len(INITS), len(LEADS), N_LAT, N_LON), np.float32)
  coords = {'init_time': INITS, 'lead_time': LEADS, 'latitude': LAT,
            'longitude': LON}
  if explicit_valid_time:
    vt = INITS[:, None] + LEADS[None, :]
    coords = {'valid_time': mod.Coord(('init_time', 'lead_time'), vt),
              'latitude': LAT, 'longitude': LON}
  return mod.DimArray(x, ('init_time', 'lead_time', 'latitude', 'longitude'),
                      coords)


@pytest.mark.parametrize('kind', ['time', 'dayofyear', 'doy_hour'])
@pytest.mark.parametrize('explicit_valid_time', [False, True])
def test_alignment_indices_and_gathers_match_jax(kind, explicit_valid_time):
  clim, j_clim = _clim(darray, kind), _clim(j_darray, kind)
  pred, j_pred = _pred(darray, explicit_valid_time), _pred(
      j_darray, explicit_valid_time)
  dims, vt = base.valid_time_coord(pred)
  j_dims, j_vt = j_base.valid_time_coord(j_pred)
  assert dims == j_dims == ('init_time', 'lead_time')
  np.testing.assert_array_equal(vt, j_vt)
  idx = base.climatology_alignment_indices(clim, vt)
  j_idx = j_base.climatology_alignment_indices(j_clim, j_vt)
  assert sorted(idx) == sorted(j_idx)
  for d in idx:
    np.testing.assert_array_equal(idx[d], j_idx[d])
  if kind != 'time':
    # 2020-12-31 is day 366 of the leap year, 2021-01-01 day 1.
    assert idx['dayofyear'].max() == 365 and idx['dayofyear'].min() == 0
  want = j_base.align_climatology(j_clim, j_pred)
  for got in (base.aligned_climatology_for(clim, pred),  # notebook path
              base.gather_climatology(clim, idx, dims),
              base.gather_climatology_host(clim, idx, dims)):
    assert got.dims == want.dims
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert sorted(got.coords) == sorted(want.coords)


def test_alignment_raises_for_a_time_outside_the_climatology():
  clim = _clim(darray, 'time')
  with pytest.raises(KeyError, match='not found'):
    base.climatology_alignment_indices(
        clim, np.array(['2021-02-01'], dtype='datetime64[ns]'))


def test_value_path_carries_the_index_paths_coords():
  """ADVICE.md round 5, base.py:586: the host-gathered slice must carry the
  same spatial coords as the device gather of the resident copy."""
  clim = {'t': _clim(darray, 'doy_hour')}
  pred = {'t': _pred(darray, False).expand_dims({'level': 2}, axis=2)}
  stat = deterministic.SquaredPredictionAnomaly(climatology=clim)
  rid = base.resource_id(clim['t'])
  by_index = base.attach_climatology_indices(pred, clim)['t']
  via_index = base.aligned_climatology_for(clim['t'], by_index)
  stat.set_host_gather_resources({rid})
  by_value, _ = stat.prepare_chunk(pred, {})
  assert f'{base.CLIM_VALUE_PREFIX}{rid}' in by_value['t'].coords
  with base.device_resources({}):  # the resident copy is not needed
    via_value = base.aligned_climatology_for(clim['t'], by_value['t'])
  assert via_value.dims == via_index.dims
  assert sorted(via_value.coords) == sorted(via_index.coords) == [
      'latitude', 'level', 'longitude']
  for name in via_index.coords:
    np.testing.assert_array_equal(via_value.coord_values(name),
                                  via_index.coord_values(name))
  assert torch.equal(via_value.data, via_index.data)


def test_resolve_resource_raises_for_a_missing_resource():
  da = _clim(darray, 'dayofyear')
  assert base.resolve_resource(da) is da  # no evaluator active
  with base.device_resources({}):
    with pytest.raises(KeyError, match='not resident'):
      base.resolve_resource(da)
  with base.device_resources({base.resource_id(da): da.data * 2}):
    assert torch.equal(base.resolve_resource(da).data, da.data * 2)


# -- the resource plan ---------------------------------------------------------------


VALID = (np.datetime64('2020-01-01', 'ns')
         + np.arange(12) * np.timedelta64(6, 'h'))
PLAN_LEADS = (np.arange(3) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
PLAN_INITS = VALID[:9]


def _plan_datasets(seed=7):
  rng = np.random.default_rng(seed)
  space = {'latitude': LAT, 'longitude': LON}

  def rand(shape):
    return rng.standard_normal(shape).astype(np.float32)

  tdims = ('valid_time', 'latitude', 'longitude')
  pdims = ('init_time', 'lead_time', 'latitude', 'longitude')
  pshape = (len(PLAN_INITS), len(PLAN_LEADS), N_LAT, N_LON)
  tgt = {'2m_temperature': darray.DimArray(
             rand((12, N_LAT, N_LON)), tdims, {'valid_time': VALID, **space}),
         'precip': darray.DimArray(
             np.abs(rand((12, N_LAT, N_LON))) * 0.01, tdims,
             {'valid_time': VALID, **space})}
  pcoords = {'init_time': PLAN_INITS, 'lead_time': PLAN_LEADS, **space}
  pred = {'2m_temperature': darray.DimArray(rand(pshape), pdims, pcoords),
          'precip': darray.DimArray(np.abs(rand(pshape)) * 0.01, pdims,
                                    pcoords)}
  cdims = ('dayofyear', 'hour', 'latitude', 'longitude')
  ccoords = {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
             **space}
  cshape = (366, 4, N_LAT, N_LON)
  clim = {
      '2m_temperature': darray.DimArray(rand(cshape), cdims, ccoords),
      'precip': darray.DimArray(np.abs(rand(cshape)) * 0.01, cdims, ccoords),
      'precip_seeps_dry_fraction': darray.DimArray(
          rng.uniform(0.05, 0.95, cshape).astype(np.float32), cdims, ccoords),
      'precip_seeps_threshold': darray.DimArray(
          np.abs(rand(cshape)) * 0.005 + 0.002, cdims, ccoords),
  }
  return pred, tgt, clim


def _plan_metrics(clim):
  return {
      'acc': deterministic.ACC(climatology=clim),
      'activity': deterministic.PredictionActivity(climatology=clim),
      'seeps': categorical.SEEPS(variables=['precip'], climatology=clim),
      'rmse': deterministic.RMSE(),
  }


def _plan_run(monkeypatch, budget_bytes):
  if budget_bytes is None:
    monkeypatch.delenv('WBX_RESOURCE_BYTES', raising=False)
  else:
    monkeypatch.setenv('WBX_RESOURCE_BYTES', str(budget_bytes))
  pred, tgt, clim = _plan_datasets()
  pipe = pipeline.EvaluationPipeline(
      metrics=_plan_metrics(clim),
      aggregator=aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'], masked=True),
      predictions_loader=loaders.PredictionsFromDataset(
          ds=pred, rename_dimensions=None),
      targets_loader=loaders.TargetsFromDataset(
          ds=tgt, rename_dimensions=None),
      times=time_chunks.TimeChunks(PLAN_INITS, PLAN_LEADS,
                                   init_time_chunk_size=3,
                                   lead_time_chunk_size=2),
      device='cpu', metrics_registry=observability.Metrics())
  return pipe, pipe.run()


def test_forced_host_gather_equals_resident(monkeypatch):
  resident_pipe, resident = _plan_run(monkeypatch, None)
  gathered_pipe, gathered = _plan_run(monkeypatch, 1)
  assert not resident_pipe._evaluator.host_gather_ids
  # Every eligible array is demoted: the 2 climatologies, the dry
  # fraction and the wet threshold; p1 stays.
  assert len(gathered_pipe._evaluator.host_gather_ids) == 4
  got, want = gathered.to_dataset(), resident.to_dataset()
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims
    assert torch.equal(got[k].data, want[k].data), k


def test_p1_is_never_demoted_taking_seeps_from_the_evaluator(monkeypatch):
  """ADVICE.md round 5, tests/test_host_gather_clim.py:206: the SEEPS
  instance is the one the planner saw, so its p1 resource_id is real."""
  monkeypatch.setenv('WBX_RESOURCE_BYTES', '1')
  _, _, clim = _plan_datasets()
  ev = evaluator.ChunkEvaluator(
      metrics=_plan_metrics(clim),
      aggregator=aggregation.Aggregator(reduce_dims=['latitude', 'longitude']),
      device='cpu')
  seeps = ev.metrics['seeps']
  p1_rid = base.resource_id(seeps._p1['precip'])
  assert p1_rid in seeps.device_resource_arrays()
  thr_rid = base.resource_id(clim['precip_seeps_threshold'])
  assert thr_rid in ev.host_gather_ids
  assert p1_rid not in ev.host_gather_ids
  assert p1_rid in ev.resources()
  assert not set(ev.resources()) & ev.host_gather_ids
  # The raw dry fraction is replaced by p1: registered by no statistic
  # but ACC, which aligns it (it is a climatology entry like any other).
  assert base.resource_id(clim['precip_seeps_dry_fraction']) in (
      ev.host_gather_ids)


class _ReadsDirectly(base.StatisticWithClimatology):
  """Registers one climatology entry and reads it directly in compute, so
  lists nothing as gatherable."""

  def device_resource_arrays(self):
    da = self._climatology['2m_temperature']
    return {base.resource_id(da): da.data}

  def host_gatherable_resource_arrays(self):
    return {}

  def compute(self, predictions, targets):
    clim = base.resolve_resource(self._climatology['2m_temperature'])
    return {'2m_temperature': predictions['2m_temperature'].isel(
        init_time=0, lead_time=0) * 0 + clim.isel(dayofyear=0, hour=0)}


def test_eligibility_is_an_intersection(monkeypatch):
  """ADVICE.md round 5, evaluator.py:252: an entry that one statistic reads
  directly stays resident although another lists it as gatherable."""
  monkeypatch.setenv('WBX_RESOURCE_BYTES', '1')
  _, _, clim = _plan_datasets()
  metrics = {'direct': _ReadsDirectly(clim),
             'activity': deterministic.PredictionActivity(climatology=clim)}
  ev = evaluator.ChunkEvaluator(
      metrics=metrics, aggregator=aggregation.Aggregator(
          reduce_dims=['latitude', 'longitude']), device='cpu')
  t2m = base.resource_id(clim['2m_temperature'])
  assert t2m not in ev.host_gather_ids
  assert t2m in ev.resources()
  # The entries only the activity statistic registers are demoted.
  assert base.resource_id(clim['precip']) in ev.host_gather_ids
  pred, tgt, _ = _plan_datasets()
  p = loaders.PredictionsFromDataset(ds=pred, rename_dimensions=None
                                     ).load_chunk(PLAN_INITS[:2], PLAN_LEADS)
  t = loaders.TargetsFromDataset(ds=tgt, rename_dimensions=None
                                 ).load_chunk(PLAN_INITS[:2], PLAN_LEADS)
  state = ev.eval_chunk(p, t)
  assert set(state.sum_weights) == {'_ReadsDirectly',
                                    'SquaredPredictionAnomaly'}


def test_budget_default_and_override(monkeypatch, caplog):
  monkeypatch.delenv('WBX_RESOURCE_BYTES', raising=False)
  assert evaluator._resource_budget_bytes(torch.device('cpu')) == 8 << 30
  monkeypatch.setenv('WBX_RESOURCE_BYTES', '2.5e3')
  assert evaluator._resource_budget_bytes(torch.device('cpu')) == 2500
  monkeypatch.setattr(torch.cuda, 'mem_get_info',
                      lambda device=None: (10_000, 80_000))
  assert evaluator._resource_budget_bytes(torch.device('cuda')) == 2500
  monkeypatch.delenv('WBX_RESOURCE_BYTES')
  assert evaluator._resource_budget_bytes(torch.device('cuda')) == 4500
  # A plan over budget with nothing eligible is logged, never dropped.
  monkeypatch.setenv('WBX_RESOURCE_BYTES', '1')
  _, _, clim = _plan_datasets()
  with caplog.at_level(logging.WARNING):
    ev = evaluator.ChunkEvaluator(
        metrics={'direct': _ReadsDirectly(clim)},
        aggregator=aggregation.Aggregator(reduce_dims=['latitude']),
        device='cpu')
  assert not ev.host_gather_ids
  assert 'still exceed the budget' in caplog.text


def test_prepare_host_touches_no_device_and_outputs_drop_value_coords(
    monkeypatch):
  monkeypatch.setenv('WBX_RESOURCE_BYTES', '1')
  pred, tgt, clim = _plan_datasets()
  metrics = _plan_metrics(clim)
  ev = evaluator.ChunkEvaluator(
      metrics=metrics, aggregator=aggregation.Aggregator(
          reduce_dims=['latitude', 'longitude'], masked=True), device='cpu')
  p = loaders.PredictionsFromDataset(ds=pred, rename_dimensions=None
                                     ).load_chunk(PLAN_INITS[:2], PLAN_LEADS)
  t = loaders.TargetsFromDataset(ds=tgt, rename_dimensions=None
                                 ).load_chunk(PLAN_INITS[:2], PLAN_LEADS)
  hp, ht = ev.prepare_host(p, t)
  assert ht is t
  names = set(hp['precip'].coords)
  assert {f'{base.CLIM_INDEX_PREFIX}dayofyear',
          f'{base.CLIM_INDEX_PREFIX}hour'} <= names
  vals = [n for n in names if n.startswith(base.CLIM_VALUE_PREFIX)]
  assert len(vals) == 2  # the precip climatology and its wet threshold
  for da in hp.values():
    for c in da.coords.values():
      assert isinstance(c.values, np.ndarray)  # host coords only
  dp, _ = ev.to_device(hp, ht)
  assert all(isinstance(dp['precip'].coords[n].values, torch.Tensor)
             for n in vals)
  with base.device_resources(ev.resources()):
    out = base.compute_unique_statistics_for_all_metrics(metrics, dp, t)
  for per_var in out.values():
    for da in per_var.values():
      assert not any(str(n).startswith(base.CLIM_VALUE_PREFIX)
                     for n in da.coords)


# -- loaders ---------------------------------------------------------------------------


def _target_store(mod, years=(2019, 2020)):
  """Analyses every 6 h over the first days of each year, latitude
  descending (as ERA5 stores it), with a level dim."""
  rng = np.random.default_rng(11)
  valid = np.concatenate([
      np.datetime64(f'{y}-01-01', 'ns') + np.arange(12) * np.timedelta64(
          6, 'h') for y in years])
  x = rng.standard_normal((len(valid), 2, N_LAT, N_LON)).astype(np.float32)
  return {'z': mod.DimArray(
      x, ('time', 'level', 'latitude', 'longitude'),
      {'time': valid, 'level': np.array([500, 850]),
       'latitude': LAT[::-1].copy(), 'longitude': LON})}


LOADER_INITS = np.array(['2020-01-01T00', '2020-01-01T12'],
                        dtype='datetime64[ns]')
LOADER_LEADS = np.array([0, 6, 12], dtype='timedelta64[h]').astype(
    'timedelta64[ns]')


def _assert_loaded_equal(got, want):
  assert list(got) == list(want)
  for k in want:
    g, w = got[k], want[k]
    assert g.dims == w.dims, (g.dims, w.dims)
    np.testing.assert_array_equal(g.values, np.asarray(w.values))
    assert sorted(g.coords) == sorted(w.coords)
    for name in w.coords:
      np.testing.assert_array_equal(g.coord_values(name),
                                    np.asarray(w.coords[name].values))


def test_persistence_loader_matches_jax():
  kwargs = dict(sel_kwargs={'level': [850]})
  got = loaders.PersistenceFromDataset(
      ds=_target_store(darray), **kwargs).load_chunk(LOADER_INITS,
                                                     LOADER_LEADS)
  want = j_loaders.PersistenceFromDataset(
      ds=_target_store(j_darray), **kwargs).load_chunk(LOADER_INITS,
                                                       LOADER_LEADS)
  _assert_loaded_equal(got, want)
  assert got['z'].dims[:2] == ('init_time', 'lead_time')
  with pytest.raises(ValueError, match='Exact lead times'):
    loaders.PersistenceFromDataset(ds=_target_store(darray)).load_chunk(
        LOADER_INITS, None)


def test_probabilistic_climatology_loader_matches_jax():
  kwargs = dict(start_year=2019, end_year=2020)
  got = loaders.ProbabilisticClimatologyFromDataset(
      ds=_target_store(darray), **kwargs).load_chunk(LOADER_INITS,
                                                     LOADER_LEADS)
  want = j_loaders.ProbabilisticClimatologyFromDataset(
      ds=_target_store(j_darray), **kwargs).load_chunk(LOADER_INITS,
                                                       LOADER_LEADS)
  _assert_loaded_equal(got, want)
  assert got['z'].sizes['number'] == 2
  with pytest.raises(KeyError, match='not found'):
    loaders.ProbabilisticClimatologyFromDataset(
        ds=_target_store(darray), start_year=2018, end_year=2020
    ).load_chunk(LOADER_INITS, LOADER_LEADS)


@pytest.mark.parametrize('time_coords,with_leads', [
    (('dayofyear', 'hour'), True), (('dayofyear', 'hour'), False),
    (('dayofyear',), True)])
def test_climatology_loader_matches_jax(time_coords, with_leads):
  def store(mod):
    c = _clim(mod, 'doy_hour', seed=5)
    if time_coords == ('dayofyear',):
      c = c.isel(hour=0)
    return {'z': c}

  leads = LOADER_LEADS if with_leads else None
  got = loaders.ClimatologyFromDataset(
      ds=store(darray), climatology_time_coords=time_coords).load_chunk(
          LOADER_INITS, leads)
  want = j_loaders.ClimatologyFromDataset(
      ds=store(j_darray), climatology_time_coords=time_coords).load_chunk(
          LOADER_INITS, leads)
  _assert_loaded_equal(got, want)


def test_diagonal_take_matches_jax():
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
  dims = ('init_time', 'lead_time', 'hour', 'latitude')
  idx = rng.integers(0, 4, (2, 3))
  got = loaders._diagonal_take(darray.DimArray(x, dims), 'hour', idx,
                               ('init_time', 'lead_time'))
  want = j_loaders._diagonal_take(j_darray.DimArray(x, dims), 'hour', idx,
                                  ('init_time', 'lead_time'))
  assert got.dims == want.dims
  np.testing.assert_array_equal(got.values, np.asarray(want.values))


def test_loaders_read_npz_paths_and_open_dataset_auto(tmp_path):
  """The loaders read each container by path (lazily where it opens so)
  to the chunks of the in-memory store; netCDF reads whole; GRIB needs
  xarray, as in the JAX package without it."""
  want = loaders.PersistenceFromDataset(ds=_target_store(darray)).load_chunk(
      LOADER_INITS, LOADER_LEADS)
  for name, lazy in (('era5.npz', True), ('era5.wbx', True),
                     ('era5.zarr', True), ('era5.nc', False)):
    path = str(tmp_path / name)
    io.save_dataset(path, _target_store(darray))
    got = loaders.PersistenceFromDataset(path=path).load_chunk(
        LOADER_INITS, LOADER_LEADS)
    _assert_loaded_equal(got, want)
    opened = io.open_dataset_auto(path)
    assert sorted(opened) == ['z'] and opened['z'].is_lazy == lazy, name
  with pytest.raises(ImportError, match='xarray'):
    io.open_dataset_auto(str(tmp_path / 'a.grib2'))


def test_scalar_over_tensor_divides_once():
  """torch computes scalar / tensor as reciprocal(tensor) * scalar, two
  roundings; the port's DimArray divides once, as numpy and XLA do (the
  SEEPS matrix entries 3 / (1 - p1) and 3 / (2 + p1) depend on it)."""
  x = np.random.default_rng(0).uniform(0.05, 3.0, 4096).astype(np.float32)
  da = darray.DimArray(x, ('p',))
  for num in (3, 4.0, np.float32(7.0)):
    got = (num / da).values
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.float32(num) / x)
  assert (2 / darray.DimArray(np.arange(1, 5), ('p',))).dtype == (
      torch.float32)
