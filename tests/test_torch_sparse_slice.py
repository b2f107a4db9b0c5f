"""The station and significance slice as a whole, port against JAX, on the
CPU.

METAR-style reports (pandas-written hive-partitioned Parquet: 10 stations
every 3 hours with duplicates, QC flags and a missing elevation) are the
targets; a seeded float32 0.25-degree-like grid forecast (19 x 36 here),
interpolated to the stations with the altitude adjustment and longitude
wrap, is the prediction. Both packages run the same evaluation:
``pad_index_multiple=16``, ``add_nan_mask``, masked aggregation over
``index`` with ``BySets`` (two station networks) and ``ByExactCoord`` of
``lead_time`` and of ``init_time`` (the forecast is interpolated to each
report's position, init and lead, so both are coords over ``index``:
binning by init keeps it); RMSE, Bias and MAE; a
``chunk_stats_sink``. The JAX package runs it in its ``EvaluationPipeline``,
the port in ``pipeline.evaluate(device='cpu')``. Metric values, the sink's
statistics (station names and all) and the kept-init state agree to
relative 1e-5 (float32 statistics; the JAX package promotes the
altitude-adjusted values to float64 under x64, the port keeps float32).
Then significance: IID and HAC-EWC t-tests over the inits on the JAX
package's state, carried across, agree to 1e-9; on each package's own
state, to 1e-5.
"""

import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import interpolations as j_interpolations
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.data import sparse_parquet as j_sparse_parquet
from weatherbenchx_tpu.inference import t_test as j_t_test
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.parallel import pipeline as j_pipeline
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import convert
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import interpolations
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.data import sparse_parquet
from weatherbenchx_tpu_torch.inference import t_test
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

RTOL, RTOL_INFERENCE = 1e-5, 1e-9
N_STATIONS = 10
LAT = np.linspace(-90, 90, 19)
LON = np.arange(36) * 10.0
INIT = np.arange('2020-01-01T00', '2020-01-03T00', np.timedelta64(12, 'h'),
                 dtype='datetime64[ns]')
LEAD = np.array([0, 6, 12], dtype='timedelta64[h]').astype('timedelta64[ns]')
NETWORKS = {'north': [f'ST{i}' for i in range(0, N_STATIONS, 2)],
            'south': [f'ST{i}' for i in range(1, N_STATIONS, 2)]}
PKG = {
    'torch': dict(mod=td, interp=interpolations, loaders=loaders,
                  sparse=sparse_parquet, binning=binning, agg=aggregation,
                  det=deterministic, tc=time_chunks),
    'jax': dict(mod=jd, interp=j_interpolations, loaders=j_loaders,
                sparse=j_sparse_parquet, binning=j_binning,
                agg=j_aggregation, det=j_deterministic, tc=j_time_chunks),
}


def _write_reports(root):
  import pandas as pd

  rng = np.random.default_rng(11)
  times = np.arange('2019-12-31T21', '2020-01-04T00',
                    np.timedelta64(3, 'h'), dtype='datetime64[ns]')
  rows = []
  for t in times:
    for s in range(N_STATIONS):
      if rng.random() < 0.05:
        continue  # a missed report
      row = {'timeNominal': pd.Timestamp(t), 'stationName': f'ST{s}',
             'latitude': -80.0 + 17.0 * s, 'longitude': -175.0 + 37.0 * s,
             'elevation': 9999.0 if s == 6 else 150.0 * s,
             'temperature': 275.0 + 5 * rng.standard_normal(),
             'temperatureDD': 'X' if s == 4 else 'S'}
      rows.append(row)
      if s == 1:  # a later duplicate
        rows.append(dict(row, timeNominal=pd.Timestamp(
            t + np.timedelta64(20, 'm')), temperature=400.0))
  df = pd.DataFrame(rows)
  for (y, m), g in df.groupby([df.timeNominal.dt.year,
                               df.timeNominal.dt.month]):
    fn = os.path.join(root, f'year={y}', f'month={m}', f'{y}-{m:02d}.parquet')
    os.makedirs(os.path.dirname(fn), exist_ok=True)
    g.to_parquet(fn)
  return root


def _evaluate(name: str, reports: str):
  """(metric values, state, sink output) of one package's run."""
  p = PKG[name]
  mod = p['mod']
  rng = np.random.default_rng(12)
  grid = (275 + 5 * rng.standard_normal(
      (len(INIT), len(LEAD), len(LAT), len(LON)))).astype(np.float32)
  elevation = (rng.random((len(LAT), len(LON))) * 800).astype(np.float32)
  space = {'latitude': LAT, 'longitude': LON}
  predictions = p['loaders'].PredictionsFromDataset(
      ds={'2m_temperature': mod.DimArray(
          grid, ('init_time', 'lead_time', 'latitude', 'longitude'),
          {'init_time': INIT, 'lead_time': LEAD, **space})},
      rename_dimensions=None,
      interpolation=p['interp'].GridToSparseWithAltitudeAdjustment(
          'linear', grid_elevation=mod.DimArray(
              elevation, ('latitude', 'longitude'), space),
          wrap_longitude=True))
  targets = p['sparse'].METARFromParquet(
      path=reports, variables=['2m_temperature'], time_dim='timeNominal',
      partitioned_by='month', tolerance=np.timedelta64(30, 'm'),
      remove_duplicates=True, pick_closest_duplicate_by='timeNominal',
      cache_files=2, add_nan_mask=True, pad_index_multiple=16)
  metrics = {'rmse': p['det'].RMSE(), 'bias': p['det'].Bias(),
             'mae': p['det'].MAE()}
  aggregator = p['agg'].Aggregator(
      reduce_dims=['index'], masked=True,
      bin_by=[p['binning'].BySets(NETWORKS, 'stationName',
                                  bin_dim_name='network'),
              p['binning'].ByExactCoord('lead_time'),
              p['binning'].ByExactCoord('init_time')])
  times = p['tc'].TimeChunks(INIT, LEAD, init_time_chunk_size=1)
  emitted = {}

  def sink(i, offsets, flat):
    emitted[i] = flat

  if name == 'torch':
    pipe = pipeline.EvaluationPipeline(
        metrics=metrics, aggregator=aggregator,
        predictions_loader=predictions, targets_loader=targets, times=times,
        device='cpu', chunk_stats_sink=sink)
  else:
    pipe = j_pipeline.EvaluationPipeline(
        metrics=metrics, aggregator=aggregator,
        predictions_loader=predictions, targets_loader=targets, times=times,
        chunk_stats_sink=sink)
  state = pipe.run()
  return metrics, state.metric_values(metrics), state, emitted


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  reports = _write_reports(str(tmp_path_factory.mktemp('metar')))
  return {name: _evaluate(name, reports) for name in PKG}


def _close(got, want, rtol):
  """Relative to each value and, for values near 0 (a bias), to the
  array's largest magnitude."""
  want = np.asarray(want, np.float64)
  np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                             atol=rtol * np.nanmax(np.abs(want)))


def test_metric_values_match_jax(runs):
  _, got, _, _ = runs['torch']
  _, want, _, _ = runs['jax']
  assert sorted(got) == sorted(want) == [
      'bias.2m_temperature', 'mae.2m_temperature', 'rmse.2m_temperature']
  for k in want:
    assert got[k].dims == tuple(want[k].dims)
    assert set(got[k].dims) == {'init_time', 'network', 'lead_time'}
    _close(got[k].values, want[k].values, RTOL)
    np.testing.assert_array_equal(got[k].coord_values('network'),
                                  ['north', 'south'])
    np.testing.assert_array_equal(got[k].coord_values('init_time'), INIT)
    assert np.isfinite(got[k].values).all()


def test_state_matches_jax(runs):
  _, _, state, _ = runs['torch']
  _, _, j_state, _ = runs['jax']
  got, want = state.to_dataset(), j_state.to_dataset()
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == tuple(want[k].dims)
    _close(got[k].values, want[k].values, RTOL)


def test_sink_statistics_match_jax(runs):
  """One emission per chunk, every statistic of the chunk, the station
  coords intact (padded rows' names are '')."""
  _, _, state, emitted = runs['torch']
  _, _, _, j_emitted = runs['jax']
  assert sorted(emitted) == sorted(j_emitted) == list(range(len(INIT)))
  for i, flat in emitted.items():
    want = j_emitted[i]
    assert sorted(flat) == sorted(want) == [
        'AbsoluteError.2m_temperature', 'Error.2m_temperature',
        'SquaredError.2m_temperature']
    for k, da in flat.items():
      assert da.dims == tuple(want[k].dims)
      assert da.sizes['index'] % 16 == 0
      _close(da.values, want[k].values, RTOL)
      names = da.coord_values('stationName')
      np.testing.assert_array_equal(names,
                                    np.asarray(want[k].coords[
                                        'stationName'].values))
      assert set(names) - {''} <= set(NETWORKS['north'] + NETWORKS['south'])
  # The sink's statistics are what the state summed: the masked squared
  # errors of every station of every chunk.
  total = sum(np.nansum(np.where(flat['SquaredError.2m_temperature']
                                 .coord_values('mask'),
                                 flat['SquaredError.2m_temperature'].values,
                                 0.0)) for flat in emitted.values())
  _close(total, state.sum_weighted_statistics['SquaredError'][
      '2m_temperature'].values.sum(), 1e-6)


@pytest.mark.parametrize('method', ['IID', 'LazarusHACEWC'])
def test_t_test_over_inits_matches_jax(runs, method):
  metrics, _, state, _ = runs['torch']
  j_metrics, _, j_state, _ = runs['jax']
  want = getattr(j_t_test, method)(j_metrics, j_state, 'init_time')
  carried = getattr(t_test, method)(
      metrics, convert.state_from_reference(j_state), 'init_time')
  own = getattr(t_test, method)(metrics, state, 'init_time')
  for got, rtol in ((carried, RTOL_INFERENCE), (own, RTOL)):
    for fn in ('point_estimates', 'standard_error_estimates'):
      g, w = getattr(got, fn)(), getattr(want, fn)()
      for m in w:
        assert set(g[m]['2m_temperature'].dims) == {'network', 'lead_time'}
        _close(g[m]['2m_temperature'].values,
               w[m]['2m_temperature'].values, rtol)
    p, jp = got.p_values(), want.p_values()
    _close(p['bias']['2m_temperature'].values,
           jp['bias']['2m_temperature'].values, rtol)
