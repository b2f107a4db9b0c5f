"""A chunk sharded over a ``DeviceMesh``, the port against the JAX package.

Real gloo ranks on the CPU (``multichip.run_ranks``, see
``tests/test_torch_distributed.py``) form a
``torch.distributed.device_mesh.DeviceMesh`` and run the port's
``EvaluationPipeline(mesh=..., dim_to_axis=...)`` on the inputs of the JAX
package's mesh tests (``tests/test_pipeline.py``: ``test_mesh_equivalence``
on ``{'batch': 2, 'space': 4}``, ``test_ensemble_axis_sharding``,
``test_batched_on_mesh``; ``tests/test_host_gather_clim.py``:
``test_forced_host_gather_on_mesh``), made from numpy seeds in
``tests/torch_rank_cases.py``. The parent process runs the JAX package on
its 8-device virtual CPU mesh (``tests/conftest.py``) and on one device;
every rank's values must agree with both to atol 1e-5. Beyond those: the
latitudes sharded under area weights and region bins (built from the whole
chunk's coords, then sliced), FSS with the longitudes sharded (its window
dims made whole first), a host-gathered or resident climatology on sharded
latitudes, and a statistic that hides a reduction over a sharded dim
refused.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_rank_cases as cases
from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import categorical as j_categorical
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu.metrics import spatial as j_spatial
from weatherbenchx_tpu.parallel import pipeline as j_pipeline
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import multichip
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.metrics import spatial
from weatherbenchx_tpu_torch.metrics import wrappers

ATOL = 1e-5
TIMEOUT_S = 240.0
CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'torch_rank_cases.py')


@pytest.fixture(scope='module')
def mesh8():
  return multichip.run_ranks(f'{CASES}:case_mesh8', 8, timeout_s=TIMEOUT_S,
                             num_threads=1)


@pytest.fixture(scope='module')
def mesh4():
  return multichip.run_ranks(f'{CASES}:case_mesh4', 4, timeout_s=TIMEOUT_S,
                             num_threads=1)


def _assert_values(got, want):
  assert set(got) == set(want)
  for k, (dims, values) in want.items():
    gdims, gvalues = got[k]
    if set(gdims) == set(dims):
      gvalues = np.transpose(gvalues, [gdims.index(d) for d in dims])
    np.testing.assert_allclose(gvalues, values, atol=ATOL, err_msg=k)


def _every_rank(results, name, *wants):
  for r in results:
    for want in wants:
      _assert_values(r[name], want)


def _j_run(metrics, agg, pred, tgt, times, mesh=None, dim_to_axis=None,
           **kw):
  """The JAX package's pipeline: values as ``cases.as_numpy``."""
  return cases.as_numpy(j_pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=agg,
      predictions_loader=j_loaders.PredictionsFromDataset(
          ds=cases.wrap(jd, pred), rename_dimensions=None),
      targets_loader=j_loaders.TargetsFromDataset(
          ds=cases.wrap(jd, tgt), rename_dimensions=None),
      times=times, mesh=mesh, dim_to_axis=dim_to_axis, **kw,
  ).run().metric_values(metrics))


def _j_direct(metrics, agg, pred, tgt, inits, leads):
  p = j_loaders.PredictionsFromDataset(ds=cases.wrap(jd, pred),
                                       rename_dimensions=None)
  t = j_loaders.TargetsFromDataset(ds=cases.wrap(jd, tgt),
                                   rename_dimensions=None)
  return cases.as_numpy(j_aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, p.load_chunk(inits, leads), t.load_chunk(inits, leads)))


def _j_rmse_bias():
  return {'rmse': j_deterministic.RMSE(), 'bias': j_deterministic.Bias()}


@pytest.mark.parametrize('name,reduce_dims', [
    ('all', ['init_time', 'lead_time', 'latitude', 'longitude']),
    ('keep_lead', ['init_time', 'latitude', 'longitude']),
])
def test_mesh_equivalence(mesh8, name, reduce_dims):
  """``{'batch': 2, 'space': 4}``, ``init_time`` and ``longitude`` sharded,
  area-weighted: equal to the JAX package's mesh run, its single-device
  run and the direct result."""
  pred, tgt, inits, leads = cases.source_arrays()
  agg = j_aggregation.Aggregator(
      reduce_dims=reduce_dims, weigh_by=[j_weighting.GridAreaWeighting()])
  times = j_time_chunks.TimeChunks(inits, leads, init_time_chunk_size=6,
                                   lead_time_chunk_size=4)
  sharded = _j_run(_j_rmse_bias(), agg, pred, tgt, times,
                   jax.make_mesh((2, 4), ('batch', 'space')),
                   {'init_time': 'batch', 'longitude': 'space'})
  single = _j_run(_j_rmse_bias(), agg, pred, tgt, times)
  direct = _j_direct(_j_rmse_bias(), agg, pred, tgt, inits, leads)
  _every_rank(mesh8, f'equivalence_{name}', sharded, single, direct)


def test_ensemble_axis_sharding(mesh8):
  """``number`` over an 8-rank ``ensemble`` axis with a custom statistic
  that means over it and declares nothing: made whole first."""

  class EnsMeanSE(j_base.PerVariableStatistic):

    def _compute_per_variable(self, predictions, targets):
      return (predictions.mean('number') - targets) ** 2

  pred, tgt, inits, leads = cases.source_arrays(seed=5, ens=8)
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
  times = j_time_chunks.TimeChunks(inits, leads)
  metrics = {'emse': EnsMeanSE()}
  sharded = _j_run(metrics, agg, pred, tgt, times,
                   jax.make_mesh((8,), ('ensemble',)), {'number': 'ensemble'})
  plain = _j_run(metrics, agg, pred, tgt, times)
  _every_rank(mesh8, 'ensemble_custom', sharded, plain)


def test_ensemble_axis_sharding_crps(mesh8):
  """The CRPS family with ``number`` sharded: it declares the ensemble dim,
  so each rank's kernel sees every member."""
  pred, tgt, inits, leads = cases.source_arrays(seed=5, ens=8)
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
  metrics = {'crps': j_probabilistic.CRPSEnsemble(),
             'spread_skill': j_probabilistic.UnbiasedSpreadSkillRatio()}
  plain = _j_run(metrics, agg, pred, tgt, j_time_chunks.TimeChunks(
      inits, leads))
  _every_rank(mesh8, 'ensemble_crps', plain)


def test_batched_on_mesh(mesh8):
  """``test_batched_on_mesh``: 4 chunks per dispatch stacked along
  ``_chunk`` (never sharded), ``lead_time`` over batch and ``longitude``
  over space, with an ACC climatology and two regions; equal to the JAX
  package's one-chunk-per-dispatch run and its batched mesh run."""
  pred, tgt, inits, leads = cases.source_arrays()
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[j_weighting.GridAreaWeighting()],
      bin_by=[j_binning.Regions({'global': ((-90, 90), (0, 360)),
                                 'nh': ((20, 90), (0, 360))})])
  clim = cases.wrap(jd, cases.climatology_arrays())
  metrics = dict(_j_rmse_bias(), acc=j_deterministic.ACC(climatology=clim))
  times = j_time_chunks.TimeChunks(inits, leads, init_time_chunk_size=1,
                                   lead_time_chunk_size=2)
  single = _j_run(metrics, agg, pred, tgt, times)
  batched = _j_run(metrics, agg, pred, tgt, times,
                   jax.make_mesh((2, 4), ('batch', 'space')),
                   {'lead_time': 'batch', 'longitude': 'space'},
                   chunks_per_dispatch=4)
  _every_rank(mesh8, 'batched', single, batched)


def test_latitude_sharded_with_area_weights_and_regions(mesh4):
  """The latitudes over 4 ranks: the area weights normalise over the whole
  chunk's latitudes and the region masks align by label there, then each
  rank takes its slice."""
  pred, tgt, inits, leads = cases.source_arrays(n_lat=8, seed=3)
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[j_weighting.GridAreaWeighting()],
      bin_by=[j_binning.Regions({'global': ((-90, 90), (0, 360)),
                                 'sh': ((-90, -20), (0, 360)),
                                 'tropics': ((-30, 30), (90, 270))})])
  times = j_time_chunks.TimeChunks(inits, leads, init_time_chunk_size=4,
                                   lead_time_chunk_size=2)
  _every_rank(mesh4, 'latitude_regions',
              _j_run(_j_rmse_bias(), agg, pred, tgt, times),
              _j_direct(_j_rmse_bias(), agg, pred, tgt, inits, leads))


def test_fss_with_longitude_sharded(mesh4):
  """FSS reads across its window dims: a rank's longitudes are made whole
  before the neighbourhood means (wrapping the dateline)."""
  pred, tgt, inits, leads = cases.fss_arrays()
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'])
  times = j_time_chunks.TimeChunks(inits, leads, init_time_chunk_size=2)
  _every_rank(mesh4, 'fss',
              _j_run(cases.fss_metrics(j_spatial), agg, pred, tgt, times))


def _j_host_gather(monkeypatch, n_lat, budget, mesh=None, dim_to_axis=None):
  pred, tgt, clim, inits, leads = cases.host_gather_arrays(n_lat=n_lat)
  clim = cases.wrap(jd, clim)
  metrics = {
      'acc': j_deterministic.ACC(climatology=clim),
      'activity': j_deterministic.PredictionActivity(climatology=clim),
      'seeps': j_categorical.SEEPS(variables=['precip'], climatology=clim),
      'rmse': j_deterministic.RMSE(),
  }
  if budget is None:
    monkeypatch.delenv('WBX_RESOURCE_BYTES', raising=False)
  else:
    monkeypatch.setenv('WBX_RESOURCE_BYTES', str(budget))
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'], masked=True)
  times = j_time_chunks.TimeChunks(inits, leads, init_time_chunk_size=3,
                                   lead_time_chunk_size=2)
  return _j_run(metrics, agg, pred, tgt, times, mesh, dim_to_axis)


def test_forced_host_gather_on_mesh(mesh4, monkeypatch):
  """``test_forced_host_gather_on_mesh``: every climatology host-gathered,
  ``latitude`` mapped to a 4-rank axis that does not divide its 5 points
  (so it stays whole, as the JAX package replicates it)."""
  resident = _j_host_gather(monkeypatch, 5, None)
  gathered = _j_host_gather(monkeypatch, 5, 1,
                            jax.make_mesh((4,), ('space',)),
                            {'latitude': 'space'})
  _every_rank(mesh4, 'host_gather_replicated', resident, gathered)


@pytest.mark.parametrize('plan', ['host_gather_sharded', 'resident_sharded'])
def test_climatology_on_sharded_latitudes(mesh4, monkeypatch, plan):
  """8 latitudes over 4 ranks: host-gathered climatology slices follow the
  rank's slice, and a resident climatology (and SEEPS's resident p1)
  resolves to it; equal to the JAX package's resident run."""
  _every_rank(mesh4, plan, _j_host_gather(monkeypatch, 8, None))


def test_pairs_placed_before_evaluation_keep_their_own_slice(mesh4):
  """Two chunks placed on a ``{'batch': 2, 'space': 2}`` mesh before the
  first is evaluated, then ``eval_accum``-ed in turn, with ``init_time``
  sharded, kept and binned by hour: each pair carries the shard it was cut
  by, so its gathered ``init_time`` labels and its bin masks are its own.
  Equal to the JAX package's direct result over both chunks' inits and
  to its run on the 8-device mesh."""
  pred, tgt, inits, leads = cases.source_arrays()
  agg = j_aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude'],
      weigh_by=[j_weighting.GridAreaWeighting()],
      bin_by=[j_binning.ByTimeUnit('hour', 'init_time')])
  direct = _j_direct(_j_rmse_bias(), agg, pred, tgt, inits[:8], leads)
  sharded = _j_run(_j_rmse_bias(), agg, pred, tgt, j_time_chunks.TimeChunks(
      inits[:8], leads, init_time_chunk_size=4),
      jax.make_mesh((2, 4), ('batch', 'space')),
      {'init_time': 'batch', 'longitude': 'space'})
  _every_rank(mesh4, 'two_pairs_placed', direct, sharded)


def test_a_plain_tuple_is_refused_on_a_mesh():
  """On a mesh only the ``PlacedPair`` that ``to_device`` returns knows
  the rank's slice, so a bare tuple raises rather than guessing."""
  from weatherbenchx_tpu_torch.parallel import evaluator

  class FakeMesh:
    mesh_dim_names = ('space',)

    def size(self, i):
      return 1

  ev = evaluator.ChunkEvaluator(
      {'rmse': deterministic.RMSE()},
      aggregation.Aggregator(reduce_dims=['latitude']), 'cpu',
      mesh=FakeMesh(), dim_to_axis={'latitude': 'space'})
  with pytest.raises(TypeError, match='PlacedPair'):
    ev.eval_accum(({}, {}), aggregation.AggregationState.zero())


def test_undeclared_reduction_over_a_sharded_dim_is_refused(mesh4):
  for r in mesh4:
    assert r['undeclared'] is not None
    assert 'reads_across' in r['undeclared']
    assert "['number']" in r['undeclared']


def test_statistics_declare_the_dims_they_read_across():
  crps = probabilistic.CRPSEnsemble()
  assert {s.reads_across() for s in crps.statistics.values()} == {
      ('number',)}
  assert {s.reads_across() for s in spatial.FSS(3).statistics.values()} == {
      spatial.WINDOW_DIMS}
  assert deterministic.SquaredError().reads_across() == ()
  rank = probabilistic.RankHistogram(ensemble_dim='member')
  assert rank.reads_across() == ('member',)
  wrapped = wrappers.WrappedMetric(deterministic.RMSE(),
                                   [wrappers.EnsembleMean('predictions')])
  assert [s.reads_across() for s in wrapped.statistics.values()] == [
      ('number',)]
  # Array thresholds vary along data dims: the transform reads them whole.
  thresholds = td.DimArray(np.zeros((2, 3), np.float32),
                           ('threshold', 'latitude'))
  binary = wrappers.ContinuousToBinary('both', thresholds, 'threshold',
                                       unique_name_suffix='t')
  assert binary.reads_across() == ('latitude',)
  assert wrappers.ContinuousToBinary('both', [0.5], 'threshold'
                                     ).reads_across() == ()

  class Custom(base.PerVariableStatistic):

    def _compute_per_variable(self, predictions, targets):
      return predictions - targets

  assert Custom().reads_across() is None
  assert wrappers.union_reads_across(('a',), None) is None


def test_operands_come_from_the_whole_chunk():
  """Area weights built from a slice of the latitudes would normalise to
  that slice's mean; ``ChunkShard`` builds them from the whole chunk's
  coords and then slices them, as the bin masks."""
  lat = np.linspace(-90, 90, 8)
  lon = np.linspace(0, 360, 4, endpoint=False)
  whole = td.DimArray(torch.zeros(8, 4), ('latitude', 'longitude'),
                      {'latitude': lat, 'longitude': lon})
  agg = aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions({'sh': ((-90, -20), (0, 360))})])
  full_ops = agg.aggregation_operands(whole)
  sl = slice(2, 4)
  shard = aggregation.ChunkShard({'latitude': sl}, {'latitude': 8},
                                 {'latitude': whole.coords['latitude']})
  part = whole.isel(latitude=sl)
  ops = agg.prepare_operands({'s': {'v': part}}, shard=shard)['s']['v']
  for op, full in zip(ops, full_ops):
    np.testing.assert_array_equal(op.values, full.isel(latitude=sl).values)
    np.testing.assert_array_equal(op.coord_values('latitude'), lat[sl])
  naive = agg.aggregation_operands(part)[0]
  assert not np.allclose(naive.values, full_ops[0].isel(latitude=sl).values)
  assert shard.only(['longitude']) is None
  cache = {}
  agg.prepare_operands({'s': {'v': part}}, cache, shard=shard)
  other = aggregation.ChunkShard({'latitude': slice(4, 6)}, {'latitude': 8},
                                 shard.whole_coords)
  agg.prepare_operands({'s': {'v': whole.isel(latitude=slice(4, 6))}}, cache,
                       shard=other)
  assert len(cache) == 2  # the slice is part of the key
