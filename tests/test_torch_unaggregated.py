"""The port's unaggregated statistics against the JAX package's, on the CPU.

The same seeded float32 grids (in-memory datasets, 5 inits x 4 leads x 5 x
8) go through ``parallel/unaggregated`` of both packages: the standalone
``UnaggregatedPipeline`` into zarr v2 (raw, blosc, rechunked to
``zarr_chunks``), zarr v3 (zstd, and sharded) and the ``.wbx``
shard-directory mode, and the aggregated ``EvaluationPipeline`` with
``ZarrStatsStore.write_chunk`` as its ``chunk_stats_sink``. The
statistics are bit-equal in both packages (squared and plain errors of
float32 data), so the stores must be too: every file, byte for byte.
Also: a sparse chunk's station coords reach the sink, chunks skipped under
``RetryPolicy(skip_failed)`` leave NaN cells, ``load_unaggregated`` reads
both modes as the JAX package's does, and the multi-device options raise.
"""

import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.parallel import pipeline as j_pipeline
from weatherbenchx_tpu.parallel import unaggregated as j_unaggregated
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import interpolations
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.data import base as data_base
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import pipeline
from weatherbenchx_tpu_torch.parallel import unaggregated

torch.set_num_threads(1)

INIT = np.arange('2020-01-01T00', '2020-01-03T12', np.timedelta64(12, 'h'),
                 dtype='datetime64[ns]')
LEAD = np.arange(0, 24, 6, dtype='timedelta64[h]').astype('timedelta64[ns]')
VALID = np.arange('2020-01-01T00', '2020-01-04T06', np.timedelta64(6, 'h'),
                  dtype='datetime64[ns]')
LAT = np.linspace(-60, 60, 5)
LON = np.arange(8) * 45.0
VAR = '2m_temperature'
PKG = {
    'torch': dict(mod=td, loaders=loaders, det=deterministic,
                  agg=aggregation, tc=time_chunks, pipe=pipeline,
                  unagg=unaggregated, kw={'device': 'cpu'}),
    'jax': dict(mod=jd, loaders=j_loaders, det=j_deterministic,
                agg=j_aggregation, tc=j_time_chunks, pipe=j_pipeline,
                unagg=j_unaggregated, kw={}),
}


def _loaders(p, fail_chunk=None):
  """(predictions loader, targets loader) of package ``p``; the targets
  loader raises OSError on the chunk starting at ``fail_chunk``."""
  rng = np.random.default_rng(0)
  mod = p['mod']
  space = {'latitude': LAT, 'longitude': LON}
  pred = mod.DimArray(
      rng.standard_normal((len(INIT), len(LEAD), 5, 8)).astype(np.float32),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': INIT, 'lead_time': LEAD, **space})
  tgt = mod.DimArray(
      rng.standard_normal((len(VALID), 5, 8)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'), {'valid_time': VALID, **space})
  targets = p['loaders'].TargetsFromDataset(ds={VAR: tgt},
                                            rename_dimensions=None)
  if fail_chunk is not None:
    inner = targets.load_chunk

    def load_chunk(init_times, lead_times=None, reference=None):
      if init_times[0] == INIT[fail_chunk]:
        raise OSError('unreadable chunk')
      return inner(init_times, lead_times, reference)
    targets.load_chunk = load_chunk
  return (p['loaders'].PredictionsFromDataset(ds={VAR: pred},
                                              rename_dimensions=None),
          targets)


def _metrics(p):
  return {'rmse': p['det'].RMSE(), 'bias': p['det'].Bias()}


def _times(p, init_chunk=2, lead_chunk=3):
  return p['tc'].TimeChunks(INIT, LEAD, init_time_chunk_size=init_chunk,
                            lead_time_chunk_size=lead_chunk)


def _files(root):
  out = {}
  for dirpath, _, names in os.walk(root):
    for n in names:
      path = os.path.join(dirpath, n)
      with open(path, 'rb') as f:
        out[os.path.relpath(path, root)] = f.read()
  return out


def _assert_same_bytes(a, b):
  fa, fb = _files(a), _files(b)
  assert sorted(fa) == sorted(fb)
  for name in fa:
    assert fa[name] == fb[name], name


STORES = {
    'v2': dict(name='s.zarr'),
    'v2_blosc': dict(name='s.zarr', compressor='blosc'),
    'v2_rechunked': dict(name='s.zarr', zarr_chunks={'init_time': 3,
                                                     'lead_time': 4}),
    'v3_zstd': dict(name='s.zarr', compressor='zstd', zarr_format=3),
    'v3_sharded': dict(name='s.zarr', compressor='zstd', zarr_format=3,
                       zarr_shards={'init_time': 4, 'lead_time': 4}),
    'wbx_shards': dict(name='shards'),
}


def _run_standalone(p, out_dir, store, fail_chunk=None):
  kw = dict(STORES[store])
  name = kw.pop('name')
  pl, tl = _loaders(p, fail_chunk)
  retry = None if fail_chunk is None else p['pipe'].RetryPolicy(
      retries=0, skip_failed=True)
  pipe = p['unagg'].UnaggregatedPipeline(
      metrics=_metrics(p), predictions_loader=pl, targets_loader=tl,
      times=_times(p), out_path=str(out_dir / name), retry=retry,
      **p['kw'], **kw)
  return pipe.run(), pipe


@pytest.mark.parametrize('store', list(STORES))
def test_standalone_store_bytes_match_jax(tmp_path, store):
  got, _ = _run_standalone(PKG['torch'], tmp_path / 'torch', store)
  want, _ = _run_standalone(PKG['jax'], tmp_path / 'jax', store)
  _assert_same_bytes(got, want)
  # load_unaggregated reads both modes as the JAX package's does.
  loaded, j_loaded = (unaggregated.load_unaggregated(got),
                      j_unaggregated.load_unaggregated(want))
  assert sorted(loaded) == sorted(j_loaded) == [
      f'Error.{VAR}', f'SquaredError.{VAR}']
  for k, da in loaded.items():
    assert isinstance(da.data, torch.Tensor)
    assert da.dims == tuple(j_loaded[k].dims)
    assert da.sizes['init_time'] == len(INIT)
    np.testing.assert_array_equal(da.values, np.asarray(j_loaded[k].values))
    np.testing.assert_array_equal(da.coord_values('init_time'), INIT)


@pytest.mark.parametrize('store', ['v2', 'v3_sharded', 'wbx_shards'])
def test_skipped_chunk_leaves_nan_cells_as_jax(tmp_path, store):
  """RetryPolicy(skip_failed): the failed chunk's cells keep the fill
  value (NaN) in the zarr stores, and it has no shard in the .wbx mode."""
  got, pipe = _run_standalone(PKG['torch'], tmp_path / 'torch', store,
                              fail_chunk=2)
  want, _ = _run_standalone(PKG['jax'], tmp_path / 'jax', store,
                            fail_chunk=2)
  assert [i for i, _, _ in pipe.failed_chunks] == [2, 3]
  _assert_same_bytes(got, want)
  if store != 'wbx_shards':
    da = unaggregated.load_unaggregated(got)[f'SquaredError.{VAR}']
    bad = np.isnan(da.values).all(axis=(2, 3))
    np.testing.assert_array_equal(bad[:, 0], [0, 0, 1, 1, 0])


@pytest.mark.parametrize('store', ['v2_blosc', 'v3_sharded'])
def test_sink_store_bytes_match_jax(tmp_path, store):
  """The aggregated pipeline's chunk_stats_sink writes the same store as
  the JAX package's sink and as the standalone pipeline."""
  stores, states = {}, {}
  for name, p in PKG.items():
    kw = dict(STORES[store])
    kw.pop('name')
    path = str(tmp_path / name / 'sink.zarr')
    sink = p['unagg'].ZarrStatsStore(_times(p), path, **kw)
    pl, tl = _loaders(p)
    states[name] = p['pipe'].EvaluationPipeline(
        metrics=_metrics(p),
        aggregator=p['agg'].Aggregator(
            reduce_dims=['init_time', 'latitude', 'longitude']),
        predictions_loader=pl, targets_loader=tl, times=_times(p),
        chunk_stats_sink=sink.write_chunk, **p['kw']).run()
    stores[name] = sink.finalize()
  _assert_same_bytes(stores['torch'], stores['jax'])
  solo, _ = _run_standalone(PKG['torch'], tmp_path / 'solo', store)
  _assert_same_bytes(stores['torch'], solo)
  # The state is the sink-free pipeline's, and the stored statistics' sums
  # over the reduced dims are its weighted sums.
  pl, tl = _loaders(PKG['torch'])
  plain = pipeline.EvaluationPipeline(
      metrics=_metrics(PKG['torch']),
      aggregator=aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude']),
      predictions_loader=pl, targets_loader=tl, times=_times(PKG['torch']),
      device='cpu').run()
  got, want = states['torch'].to_dataset(), plain.to_dataset()
  assert all(torch.equal(got[k].data, want[k].data) for k in want)
  se = unaggregated.load_unaggregated(stores['torch'])[f'SquaredError.{VAR}']
  np.testing.assert_allclose(
      se.values.astype(np.float64).sum(axis=(0, 2, 3)),
      states['torch'].sum_weighted_statistics['SquaredError'][VAR].values,
      rtol=1e-6)


def test_sink_keeps_station_coords_of_a_sparse_chunk(tmp_path):
  """The sink's statistics of a grid → station chunk carry the station
  coords (names, positions), padded rows included, as the JAX package's
  test_stats_sink_keeps_station_coords asks of its sink."""
  rng = np.random.default_rng(3)
  n = 7
  stations = {
      'latitude': td.Coord(('index',), rng.uniform(-50, 50, n)),
      'longitude': td.Coord(('index',), rng.uniform(0, 300, n)),
      'stationName': td.Coord(('index',),
                              np.array([f'ST{i}' for i in range(n)]))}

  class Stations(data_base.DataLoader):
    def _load_chunk_from_source(self, init_times, lead_times=None):
      values = rng.standard_normal((len(init_times), len(lead_times), n))
      return {VAR: td.DimArray(
          values.astype(np.float32), ('init_time', 'lead_time', 'index'),
          {'init_time': init_times, 'lead_time': lead_times, **stations})}

  pl, _ = _loaders(PKG['torch'])
  pl = loaders.PredictionsFromDataset(
      ds=pl._ds, rename_dimensions=None,
      interpolation=interpolations.InterpolateToReferenceCoords(
          'linear', dims=['latitude', 'longitude']))
  emitted = []
  pipeline.EvaluationPipeline(
      metrics={'rmse': deterministic.RMSE()},
      aggregator=aggregation.Aggregator(reduce_dims=['index'], masked=True),
      predictions_loader=pl,
      targets_loader=Stations(add_nan_mask=True, pad_index_multiple=4),
      times=_times(PKG['torch'], init_chunk=1, lead_chunk=4),
      chunk_stats_sink=lambda i, offsets, flat: emitted.append(flat),
      device='cpu').run()
  assert len(emitted) == len(INIT)
  for flat in emitted:
    da = flat[f'SquaredError.{VAR}']
    assert da.data.device.type == 'cpu'
    names = da.coord_values('stationName')
    assert names.shape == (da.sizes['index'],) == (8,)
    assert list(names[:n]) == [f'ST{i}' for i in range(n)]
    mask = da.coord_values('mask')
    assert mask[..., :n].all() and not mask[..., n:].any()
    assert da.has_coord('latitude') and da.has_coord('longitude')


def test_refusals(tmp_path):
  pl, tl = _loaders(PKG['torch'])
  for kwargs in ({'mesh': object()}, {'dim_to_axis': {'init_time': 'b'}},
                 {'distributed': True}):
    with pytest.raises(NotImplementedError, match='not ported'):
      unaggregated.UnaggregatedPipeline(
          metrics=_metrics(PKG['torch']), predictions_loader=pl,
          targets_loader=tl, times=_times(PKG['torch']),
          out_path=str(tmp_path / 'x.zarr'), device='cpu', **kwargs)
  with pytest.raises(NotImplementedError, match='not ported'):
    unaggregated.ZarrStatsStore(_times(PKG['torch']), str(tmp_path / 'y'),
                                distributed=True)
  with pytest.raises(ValueError, match='exact lead_times'):
    unaggregated.ZarrStatsStore(
        time_chunks.TimeChunks(INIT, slice(LEAD[0], LEAD[-1])),
        str(tmp_path / 'z.zarr'))
  with pytest.raises(ValueError, match='zarr_format=3'):
    unaggregated.ZarrStatsStore(_times(PKG['torch']), str(tmp_path / 'w'),
                                zarr_shards={'init_time': 4})
  store = unaggregated.ZarrStatsStore(_times(PKG['torch']),
                                      str(tmp_path / 'm.zarr'))
  masked = td.DimArray(np.zeros((1, 1)), ('init_time', 'lead_time'),
                       {'mask': td.Coord(('init_time', 'lead_time'),
                                         np.ones((1, 1), bool))})
  offsets, _ = next(iter(_times(PKG['torch']).iter_with_chunk_offsets()))
  with pytest.raises(ValueError, match='mask coord'):
    store.write_chunk(0, offsets, {'s.v': masked})
