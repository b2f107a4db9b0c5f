"""``data/latency_wrappers`` of the port against the JAX package's.

The cases of the JAX package's ``tests/test_sparse_and_interp.py``
(``TestLatencyWrappers``) and ``tests/test_apps.py``
(``test_latency_wrapper_forwards_all_pipeline_options``): forecasts whose
values encode their valid time, wrapped with constant latencies, through
both packages' wrappers over their own loaders; the chunks agree exactly,
values and coords. Gridded chunks concatenate along init_time, sparse
ones (a loader of station rows) along index. Then one through the port's
pipeline: each requested init scores the nominal init the wrapper maps it
to.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu.data import base as j_base
from weatherbenchx_tpu.data import latency_wrappers as j_latency
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.data import base
from weatherbenchx_tpu_torch.data import latency_wrappers
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import pipeline

INIT = np.arange('2020-01-01T00', '2020-01-04T00', np.timedelta64(12, 'h'),
                 dtype='datetime64[ns]')
INIT_B = np.arange('2020-01-01T06', '2020-01-04T06', np.timedelta64(12, 'h'),
                   dtype='datetime64[ns]')
LEAD = (np.arange(0, 42) * np.timedelta64(1, 'h')).astype('timedelta64[ns]')


def _hours(*values):
  return np.array(values, 'timedelta64[h]').astype('timedelta64[ns]')


def _times(*values):
  return np.array(values, dtype='datetime64[ns]')


def _forecast(mod, init=INIT, offset=0.0):
  """Values = valid time in hours since the epoch (+ offset)."""
  vt = (init[:, None] + LEAD[None, :]).astype('datetime64[h]').astype(int)
  return {'t': mod.DimArray(vt.astype(np.float64) + offset,
                            ('init_time', 'lead_time'),
                            {'init_time': init, 'lead_time': LEAD})}


def _assert_chunks_equal(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    g, w = got[k], want[k]
    assert g.dims == tuple(w.dims), k
    np.testing.assert_array_equal(g.values, np.asarray(w.values))
    assert sorted(g.coords) == sorted(w.coords), k
    for name in w.coords:
      np.testing.assert_array_equal(g.coord_values(name),
                                    np.asarray(w.coords[name].values))


def _dataset_wrapper(pkg_loaders, pkg_latency, mod, latency_h, **kwargs):
  return pkg_latency.DatasetConstantLatencyWrapper(
      pkg_loaders.PredictionsFromDataset(ds=_forecast(mod),
                                         rename_dimensions=None),
      latency=np.timedelta64(latency_h, 'h'), **kwargs)


@pytest.mark.parametrize('inits,leads', [
    (_times('2020-01-01T18'), _hours(6)),
    (_times('2020-01-01T18', '2020-01-02T03', '2020-01-03T12'),
     _hours(0, 6, 12)),
])
def test_constant_latency_matches_jax(inits, leads):
  got = _dataset_wrapper(loaders, latency_wrappers, darray, 6).load_chunk(
      inits, leads)
  want = _dataset_wrapper(j_loaders, j_latency, j_darray, 6).load_chunk(
      inits, leads)
  _assert_chunks_equal(got, want)
  # Requested coords; data of the most recent issued nominal init.
  np.testing.assert_array_equal(got['t'].coord_values('init_time'), inits)
  if len(inits) == 1:
    assert got['t'].values.item() == np.datetime64(
        '2020-01-02T00', 'h').astype(int)


def test_explicit_nominal_inits_match_jax():
  kwargs = dict(latency=np.timedelta64(9, 'h'), nominal_init_times=INIT[::2])
  got = latency_wrappers.ConstantLatencyWrapper(
      loaders.PredictionsFromDataset(ds=_forecast(darray),
                                     rename_dimensions=None),
      **kwargs).load_chunk(_times('2020-01-02T10', '2020-01-03T09'),
                           _hours(0, 3))
  want = j_latency.ConstantLatencyWrapper(
      j_loaders.PredictionsFromDataset(ds=_forecast(j_darray),
                                       rename_dimensions=None),
      **kwargs).load_chunk(_times('2020-01-02T10', '2020-01-03T09'),
                           _hours(0, 3))
  _assert_chunks_equal(got, want)


def test_no_available_init_raises():
  for pkg_loaders, pkg_latency, mod in ((loaders, latency_wrappers, darray),
                                        (j_loaders, j_latency, j_darray)):
    wrapper = _dataset_wrapper(pkg_loaders, pkg_latency, mod, 6)
    with pytest.raises(ValueError, match='No available init time'):
      wrapper.load_chunk(_times('2019-12-31T00'), _hours(6))


def test_multiple_latency_picks_freshest():
  def multi(pkg_loaders, pkg_latency, mod):
    return pkg_latency.MultipleConstantLatencyWrapper([
        _dataset_wrapper(pkg_loaders, pkg_latency, mod, 6),
        pkg_latency.DatasetConstantLatencyWrapper(
            pkg_loaders.PredictionsFromDataset(
                ds=_forecast(mod, INIT_B, 0.5), rename_dimensions=None),
            latency=np.timedelta64(3, 'h'))])
  inits = _times('2020-01-01T10', '2020-01-02T02', '2020-01-02T16')
  got = multi(loaders, latency_wrappers, darray).load_chunk(inits, _hours(6))
  want = multi(j_loaders, j_latency, j_darray).load_chunk(inits, _hours(6))
  _assert_chunks_equal(got, want)
  # At 10 UTC the 06 UTC run issued at 09 (3 h latency) is the freshest.
  assert got['t'].values[0, 0] % 1 == 0.5


class _Stations:
  """A sparse source: one row per (init, lead, station), values encoding
  the valid time; init_time and lead_time are coords over index."""

  def __init__(self, mod, base_mod):
    class Loader(base_mod.DataLoader):
      def _load_chunk_from_source(self, init_times, lead_times=None):
        it, lt, st = np.meshgrid(init_times, lead_times, np.arange(3),
                                 indexing='ij')
        vt = (it + lt).astype('datetime64[h]').astype(int)
        return {'t': mod.DimArray(
            (vt + 0.01 * st).reshape(-1).astype(np.float64), ('index',),
            {'init_time': mod.Coord(('index',), it.reshape(-1)),
             'lead_time': mod.Coord(('index',), lt.reshape(-1)),
             'station': mod.Coord(('index',), st.reshape(-1))})}
    self.loader = Loader()


def test_sparse_chunks_concatenate_along_index():
  inits, leads = _times('2020-01-01T18', '2020-01-02T20'), _hours(0, 6)
  got = latency_wrappers.ConstantLatencyWrapper(
      _Stations(darray, base).loader, np.timedelta64(6, 'h'), INIT,
      concat_dim='index').load_chunk(inits, leads)
  want = j_latency.ConstantLatencyWrapper(
      _Stations(j_darray, j_base).loader, np.timedelta64(6, 'h'), INIT,
      concat_dim='index').load_chunk(inits, leads)
  _assert_chunks_equal(got, want)
  assert got['t'].dims == ('index',) and got['t'].sizes['index'] == 12
  np.testing.assert_array_equal(np.unique(got['t'].coord_values('init_time')),
                                inits)


def test_latency_wrapper_forwards_all_pipeline_options(tmp_path):
  """Every load_chunk option of the wrapped loader is replayed."""
  rng = np.random.default_rng(0)
  lats, lons = np.linspace(-90, 90, 19), np.linspace(0, 360, 36,
                                                       endpoint=False)
  init = INIT[:4]
  lead = _hours(0, 12)
  path = str(tmp_path / 'pred.npz')
  j_io.save_dataset(path, {'2m_temperature': j_darray.DimArray(
      rng.standard_normal((4, 2, 19, 36)).astype(np.float32),
      ('time', 'prediction_timedelta', 'latitude', 'longitude'),
      {'time': init, 'prediction_timedelta': lead, 'latitude': lats,
       'longitude': lons})})
  kwargs = dict(path=path, variables=['2m_temperature'], add_nan_mask=True,
                pad_index_multiple=64, add_values_to_coords=True)
  wrapper = latency_wrappers.ConstantLatencyWrapper(
      loaders.PredictionsFromDataset(**kwargs),
      latency=np.timedelta64(0, 'h'), nominal_init_times=init)
  assert wrapper._pad_index_multiple == 64
  assert wrapper._add_values_to_coords and wrapper._add_nan_mask
  got = wrapper.load_chunk(init[:1], lead)
  want = j_latency.ConstantLatencyWrapper(
      j_loaders.PredictionsFromDataset(**kwargs),
      latency=np.timedelta64(0, 'h'), nominal_init_times=init).load_chunk(
          init[:1], lead)
  assert got['2m_temperature'].has_coord('values_as_coord')
  assert got['2m_temperature'].has_coord('mask')
  _assert_chunks_equal(got, want)


def test_wrapped_predictions_through_the_pipeline():
  """Requested inits 6 h after each nominal run with a 6 h latency score
  the nominal run 6 h further out: equal to an unwrapped run of the
  nominal inits at the shifted leads."""
  rng = np.random.default_rng(1)
  lat, lon = np.linspace(-90, 90, 7), np.linspace(0, 360, 8, endpoint=False)
  valid = INIT[0] + np.arange(24) * np.timedelta64(6, 'h')
  fc = rng.standard_normal((len(INIT), len(LEAD), 7, 8)).astype(np.float32)
  space = {'latitude': lat, 'longitude': lon}
  pred = {'t': darray.DimArray(fc, ('init_time', 'lead_time', 'latitude',
                                    'longitude'),
                               {'init_time': INIT, 'lead_time': LEAD,
                                **space})}
  tgt = {'t': darray.DimArray(
      rng.standard_normal((24, 7, 8)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'), {'valid_time': valid, **space})}
  metrics = {'rmse': deterministic.RMSE()}

  def run(loader, inits, leads):
    return pipeline.EvaluationPipeline(
        metrics=metrics,
        aggregator=aggregation.Aggregator(reduce_dims=['latitude',
                                                       'longitude']),
        predictions_loader=loader,
        targets_loader=loaders.TargetsFromDataset(ds=tgt,
                                                  rename_dimensions=None),
        times=time_chunks.TimeChunks(inits, leads, init_time_chunk_size=1),
        device='cpu', chunks_per_dispatch=2,
        metrics_registry=observability.Metrics()).run()

  wrapped = run(latency_wrappers.ConstantLatencyWrapper(
      loaders.PredictionsFromDataset(ds=pred, rename_dimensions=None),
      np.timedelta64(6, 'h'), INIT), INIT[:3] + np.timedelta64(6, 'h'),
      _hours(0, 6))
  plain = run(loaders.PredictionsFromDataset(ds=pred, rename_dimensions=None),
              INIT[:3], _hours(6, 12))
  got = wrapped.to_dataset()
  want = plain.to_dataset()
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k].coord_values('init_time'),
                                  want[k].coord_values('init_time')
                                  + np.timedelta64(6, 'h'))
    assert torch.equal(got[k].data, want[k].data), k
