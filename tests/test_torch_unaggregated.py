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
both modes as the JAX package's does, and malformed multi-device settings
raise. Across processes (real gloo ranks on the CPU, ``multichip.run_ranks``
loading ``tests/torch_rank_cases.py``): 2 chunk-parallel ranks write zarr
v2 and v3-sharded stores, standalone and through the sink, byte-identical
to the single-process port's and the JAX package's, and refuse output
chunks, shards or the shard-directory mode that no single rank could
write; a (2, 2) mesh writes the same stores from its first rank.
"""

import os

import numpy as np
import pytest
import torch

import torch_rank_cases as cases

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
from weatherbenchx_tpu_torch import multichip
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.data import base as data_base
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import evaluator
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


@pytest.mark.parametrize('store', ['v2', 'wbx_shards'])
def test_loader_places_each_side_off_a_mesh(tmp_path, store, monkeypatch):
  """Off a mesh each side of a chunk goes to the device in its loader
  thread (``ChunkEvaluator.place``), as in the evaluation pipeline, and
  the store's bytes equal those of a run whose pairs stay on the host
  until the evaluator places them."""
  calls = []
  place = evaluator.ChunkEvaluator.place

  def counted(self, side):
    calls.append(sorted(side))
    return place(self, side)
  monkeypatch.setattr(evaluator.ChunkEvaluator, 'place', counted)
  got, pipe = _run_standalone(PKG['torch'], tmp_path / 'placed', store)
  assert calls == [[VAR]] * (2 * len(pipe.times))
  load = pipeline.load_chunk_pair
  monkeypatch.setattr(
      pipeline, 'load_chunk_pair',
      lambda *args, place=None, **kwargs: load(*args, **kwargs))
  calls.clear()
  host, _ = _run_standalone(PKG['torch'], tmp_path / 'host', store)
  assert not calls
  _assert_same_bytes(got, host)


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
  # A mesh must be a DeviceMesh, dim_to_axis needs one, and distributed
  # needs an initialised process group: none falls back to one process.
  for kwargs, error, match in (
      ({'mesh': object()}, TypeError, 'DeviceMesh'),
      ({'dim_to_axis': {'init_time': 'b'}}, ValueError, 'needs a mesh'),
      ({'distributed': True}, RuntimeError, 'init_process_group')):
    with pytest.raises(error, match=match):
      unaggregated.UnaggregatedPipeline(
          metrics=_metrics(PKG['torch']), predictions_loader=pl,
          targets_loader=tl, times=_times(PKG['torch']),
          out_path=str(tmp_path / 'x.zarr'), device='cpu', **kwargs).run()
  with pytest.raises(RuntimeError, match='init_process_group'):
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


# -- many processes ------------------------------------------------------------

CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'torch_rank_cases.py')


@pytest.fixture(scope='module')
def distributed_stores(tmp_path_factory):
  out = tmp_path_factory.mktemp('distributed_stores')
  refusals = multichip.run_ranks(
      f'{CASES}:case_unagg_distributed', 2, {'out_dir': str(out)},
      timeout_s=240.0, num_threads=1)
  return out, refusals


@pytest.fixture(scope='module')
def mesh_stores(tmp_path_factory):
  out = tmp_path_factory.mktemp('mesh_stores')
  values = multichip.run_ranks(
      f'{CASES}:case_unagg_mesh', 4, {'out_dir': str(out)}, timeout_s=240.0,
      num_threads=1)
  return out, values


def _single_process_stores(p, out_dir, store):
  """The store ``cases.UNAGG_STORES[store]`` written by one process of
  package ``p``: (standalone path, sink path)."""
  kw = cases.UNAGG_STORES[store]
  times = p['tc'].TimeChunks(INIT, LEAD, init_time_chunk_size=2,
                             lead_time_chunk_size=3)
  pl, tl = _loaders(p)
  solo = p['unagg'].UnaggregatedPipeline(
      metrics=_metrics(p), predictions_loader=pl, targets_loader=tl,
      times=times, out_path=str(out_dir / 'solo.zarr'), **p['kw'], **kw).run()
  sink = p['unagg'].ZarrStatsStore(times, str(out_dir / 'sink.zarr'), **kw)
  pl, tl = _loaders(p)
  p['pipe'].EvaluationPipeline(
      metrics=_metrics(p),
      aggregator=p['agg'].Aggregator(reduce_dims=['latitude', 'longitude']),
      predictions_loader=pl, targets_loader=tl, times=times,
      chunk_stats_sink=sink.write_chunk, **p['kw']).run()
  return solo, sink.finalize()


@pytest.mark.parametrize('store', list(cases.UNAGG_STORES))
def test_distributed_ranks_write_the_single_process_store(
    tmp_path, distributed_stores, store):
  """``test_two_process_cells_assemble_to_full``: 2 ranks write disjoint
  cells of one store, rank 0 the metadata after the barrier; the same
  bytes as one process of the port and of the JAX package, standalone and
  through the aggregated pipeline's sink."""
  out, _ = distributed_stores
  solo, sink = _single_process_stores(PKG['torch'], tmp_path / 'torch',
                                      store)
  j_solo, j_sink = _single_process_stores(PKG['jax'], tmp_path / 'jax',
                                          store)
  _assert_same_bytes(solo, j_solo)
  _assert_same_bytes(sink, j_sink)
  _assert_same_bytes(str(out / store / 's.zarr'), solo)
  _assert_same_bytes(str(out / f'sink_{store}' / 's.zarr'), sink)


def test_distributed_refusals(distributed_stores):
  """``test_distributed_requires_dividing_chunks``,
  ``test_distributed_shard_spanning_chunks_rejected`` and
  ``test_shard_mode_distributed_rejected``, on real ranks."""
  _, refusals = distributed_stores
  for r in refusals:
    assert 'divide the compute chunk' in r['chunks']
    assert 'zarr_shards' in r['shards']
    assert 'zarr' in r['shard_mode']


@pytest.mark.parametrize('store', list(cases.UNAGG_STORES))
def test_zarr_on_mesh(tmp_path, mesh_stores, store):
  """``test_zarr_on_virtual_mesh``: ``init_time`` and ``longitude`` sharded
  over a (2, 2) mesh; the statistics are gathered whole and the mesh's first
  rank writes the single-process store, standalone and through the sink,
  while every rank returns the whole state."""
  out, values = mesh_stores
  solo, sink = _single_process_stores(PKG['torch'], tmp_path, store)
  _assert_same_bytes(str(out / store / 's.zarr'), solo)
  _assert_same_bytes(str(out / f'sink_{store}' / 's.zarr'), sink)
  pl, tl = _loaders(PKG['torch'])
  want = pipeline.EvaluationPipeline(
      metrics=_metrics(PKG['torch']),
      aggregator=aggregation.Aggregator(reduce_dims=['latitude', 'longitude']),
      predictions_loader=pl, targets_loader=tl, device='cpu',
      times=time_chunks.TimeChunks(INIT, LEAD, init_time_chunk_size=2,
                                   lead_time_chunk_size=3),
  ).run().metric_values(_metrics(PKG['torch']))
  for got in values:
    for k, da in want.items():
      dims, v = got[k]
      assert dims == da.dims
      np.testing.assert_allclose(v, da.values, atol=1e-5, err_msg=k)
