"""Batched dispatch (``chunks_per_dispatch``) against the JAX package's.

The configuration of the JAX package's ``TestChunksPerDispatch``: 12 inits
x 4 leads of a 7 x 8 grid, chunks of one init x 2 leads (24 chunks),
reduced over init_time, latitude and longitude, two regions, area weights,
RMSE, bias and ACC with a dayofyear x hour climatology. The same seeded
numpy stores go through the JAX pipeline (``jax.vmap`` over the stacked
chunks) and the port's (chunks stacked on the device along
``evaluator.CHUNK_DIM``, CPU here) at the same group sizes: 5 does not
divide 24, so the tail flush runs. Values agree within atol 1e-5, as
there; the port's batched runs also agree with its own group-1 run.
Then the port's own guarantees: the climatology host-gathered, a binning
that reads a time coord splitting the batch, the sink turning batching
off, resume from a checkpoint taken mid-batch, and one fused-kernel
wrapper call per dispatch of an ensemble.
"""

import json

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.parallel import pipeline as j_pipeline
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator as evaluator_lib
from weatherbenchx_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

ATOL = 1e-5
N_VALID, N_LEAD = 16, 4
LAT = np.linspace(-90, 90, 7)
LON = np.linspace(0, 360, 8, endpoint=False)
VALID = (np.datetime64('2020-01-01', 'ns')
         + np.arange(N_VALID) * np.timedelta64(6, 'h'))
LEADS = (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
INITS = VALID[:N_VALID - N_LEAD]
N_CHUNKS = len(INITS) * 2
REGIONS = {'global': ((-90, 90), (0, 360)), 'nh': ((20, 90), (0, 360))}


def _stores(mod, seed=0, ens=None):
  """(predictions, targets, climatology) of module ``mod``, from a seed."""
  rng = np.random.default_rng(seed)
  tgt = {'2m_temperature': mod.DimArray(
      rng.standard_normal((N_VALID, 7, 8)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': VALID, 'latitude': LAT, 'longitude': LON})}
  pshape = (len(INITS), N_LEAD, 7, 8)
  pdims = ('init_time', 'lead_time', 'latitude', 'longitude')
  pcoords = {'init_time': INITS, 'lead_time': LEADS, 'latitude': LAT,
             'longitude': LON}
  if ens:
    pshape, pdims = (ens,) + pshape, ('number',) + pdims
    pcoords = {**pcoords, 'number': np.arange(ens)}
  pred = {'2m_temperature': mod.DimArray(
      rng.standard_normal(pshape).astype(np.float32), pdims, pcoords)}
  clim = {'2m_temperature': mod.DimArray(
      np.random.default_rng(7).standard_normal((366, 4, 7, 8)).astype(
          np.float32),
      ('dayofyear', 'hour', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
       'latitude': LAT, 'longitude': LON})}
  return pred, tgt, clim


def _metrics(det, clim):
  return {'rmse': det.RMSE(), 'bias': det.Bias(),
          'acc': det.ACC(climatology=clim)}


def _jax_values(group, bin_by=None):
  pred, tgt, clim = _stores(j_darray)
  metrics = _metrics(j_deterministic, clim)
  pipe = j_pipeline.EvaluationPipeline(
      metrics=metrics,
      aggregator=j_aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[j_weighting.GridAreaWeighting()],
          bin_by=bin_by or [j_binning.Regions(REGIONS)]),
      predictions_loader=j_loaders.PredictionsFromDataset(
          ds=pred, rename_dimensions=None),
      targets_loader=j_loaders.TargetsFromDataset(
          ds=tgt, rename_dimensions=None),
      times=j_time_chunks.TimeChunks(INITS, LEADS, init_time_chunk_size=1,
                                     lead_time_chunk_size=2),
      chunks_per_dispatch=group)
  return pipe.run().metric_values(metrics)


def _pipe(group, bin_by=None, obs=None, **kwargs):
  pred, tgt, clim = _stores(darray)
  return pipeline.EvaluationPipeline(
      metrics=_metrics(deterministic, clim),
      aggregator=aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=bin_by or [binning.Regions(REGIONS)]),
      predictions_loader=loaders.PredictionsFromDataset(
          ds=pred, rename_dimensions=None),
      targets_loader=kwargs.pop('targets_loader', None)
      or loaders.TargetsFromDataset(ds=tgt, rename_dimensions=None),
      times=time_chunks.TimeChunks(INITS, LEADS, init_time_chunk_size=1,
                                   lead_time_chunk_size=2),
      device='cpu', chunks_per_dispatch=group,
      metrics_registry=obs or observability.Metrics(), **kwargs)


def _assert_values_close(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    g = got[k].transpose(*want[k].dims)
    np.testing.assert_array_equal(g.coord_values('region'),
                                  np.asarray(want[k].coords['region'].values))
    np.testing.assert_allclose(g.values, np.asarray(want[k].values),
                               atol=ATOL, rtol=0, err_msg=k)


def _assert_states_equal(got, want):
  got, want = got.to_dataset(), want.to_dataset()
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims, k
    assert torch.equal(got[k].data, want[k].data), k


@pytest.mark.parametrize('plan', ['resident', 'host_gathered'])
@pytest.mark.parametrize('group', [1, 3, 5])
def test_batched_pipeline_matches_jax(group, plan, monkeypatch):
  """Group sizes 1, 3, 5 against the JAX pipeline at the same group; the
  climatology resident or host-gathered (``WBX_RESOURCE_BYTES`` below its
  328 KB)."""
  if plan == 'host_gathered':
    monkeypatch.setenv('WBX_RESOURCE_BYTES', '1000')
  want = _jax_values(group)
  single = _pipe(1)
  single_values = single.run().metric_values(single.metrics)
  pipe = _pipe(group)
  got = pipe.run().metric_values(pipe.metrics)
  _assert_values_close(got, want)
  _assert_values_close(got, single_values)
  ev = pipe._evaluator
  assert bool(ev.host_gather_ids) == (plan == 'host_gathered')
  # Every chunk of the run shares one signature: full groups and a tail.
  assert ev.dispatches == -(-N_CHUNKS // group)
  assert ev.signature_splits == 0
  assert pipe._obs.counters['chunks_done'] == N_CHUNKS
  assert pipe._obs.timings['eval_chunk_seconds'].count == ev.dispatches


def test_binning_that_reads_a_time_coord_splits_the_batch():
  """ByTimeUnit reads init_time by content: only the two lead chunks of
  one init share a signature, so groups of 3 flush at every new init."""
  obs = observability.Metrics()
  pipe = _pipe(3, bin_by=[binning.Regions(REGIONS),
                          binning.ByTimeUnit('hour', 'init_time')], obs=obs)
  got = pipe.run().metric_values(pipe.metrics)
  want = _jax_values(3, bin_by=[j_binning.Regions(REGIONS),
                                j_binning.ByTimeUnit('hour', 'init_time')])
  assert sorted(got) == sorted(want)
  for k in want:
    g = got[k].transpose(*want[k].dims)
    np.testing.assert_allclose(g.values, np.asarray(want[k].values),
                               atol=ATOL, rtol=0, err_msg=k)
  assert pipe._evaluator.dispatches == len(INITS)
  assert obs.counters['signature_splits'] == len(INITS) - 1


def test_signature_reads_layout_not_times():
  ev = _pipe(2)._evaluator
  pred, tgt, _ = _stores(darray)
  one = ({k: v.isel(init_time=[0], lead_time=[0, 1]) for k, v in pred.items()},
         {k: v.isel(valid_time=[0, 1]) for k, v in tgt.items()})
  later = ({k: v.isel(init_time=[3], lead_time=[2, 3])
            for k, v in pred.items()},
           {k: v.isel(valid_time=[5, 6]) for k, v in tgt.items()})
  assert ev.signature(*one) == ev.signature(*later)
  shifted = ({k: v.assign_coords(latitude=LAT + 1) for k, v in one[0].items()},
             one[1])
  assert ev.signature(*shifted) != ev.signature(*one)
  wider = ({k: v.isel(init_time=[0], lead_time=[0, 1, 2])
            for k, v in pred.items()}, one[1])
  assert ev.signature(*wider) != ev.signature(*one)
  # Pairs of different signatures are evaluated one by one.
  states = ev.eval_chunks([one, wider])
  assert ev.signature_splits == 1 and ev.dispatches == 2
  _assert_states_equal(states[1], ev.eval_chunk(*wider))


def test_sink_turns_batching_off():
  calls = []
  pipe = _pipe(3, chunk_stats_sink=lambda i, offsets, stats: calls.append(i))
  got = pipe.run().metric_values(pipe.metrics)
  assert calls == list(range(N_CHUNKS))
  assert pipe._evaluator.dispatches == N_CHUNKS
  single = _pipe(1)
  _assert_states_equal(_pipe(3, chunk_stats_sink=lambda *a: None).run(),
                       single.run())
  _assert_values_close(got, single.run().metric_values(single.metrics))


class _CrashAt(loaders.TargetsFromDataset):
  """Raises when asked for the chunk of ``init_time``'s second lead block."""

  def __init__(self, init_time, **kwargs):
    super().__init__(**kwargs)
    self._at = init_time

  def load_chunk(self, init_times, lead_times=None, reference=None):
    if init_times[0] == self._at and lead_times[0] == LEADS[2]:
      raise RuntimeError('simulated preemption')
    return super().load_chunk(init_times, lead_times, reference)


@pytest.mark.parametrize('every,resume_group', [(2, 3), (3, 3), (2, 1)])
def test_resume_mid_run_equals_uninterrupted_batched_run(tmp_path, every,
                                                         resume_group):
  """Groups of 3; the run crashes loading chunk 9 with a batch unflushed.
  The last checkpoint (after chunk 7 at every 2, inside the batch 6-8;
  after chunk 8 at every 3) resumes to the uninterrupted batched run's
  state by torch.equal: the resumed run evaluates the interrupted batch
  again as it was and adds only its chunks from the checkpoint's on. A
  resume at group 1 starts at the checkpoint's chunk and agrees within
  atol 1e-5."""
  full = _pipe(3).run()
  ckpt = str(tmp_path / 'ck')
  _, tgt, _ = _stores(darray)
  crashing = _pipe(3, checkpoint_path=ckpt, checkpoint_every=every,
                   targets_loader=_CrashAt(INITS[4], ds=tgt,
                                           rename_dimensions=None))
  with pytest.raises(RuntimeError, match='preemption'):
    crashing.run()
  with open(ckpt + '.manifest.json') as f:
    manifest = json.load(f)
  next_chunk = manifest['next_chunk']
  assert (next_chunk, manifest['batch_start']) == (
      (8, 6) if every == 2 else (9, 9))
  resumed = _pipe(resume_group, checkpoint_path=ckpt, checkpoint_every=every)
  got = resumed.run()
  assert resumed._obs.counters['chunks_done'] == N_CHUNKS - next_chunk
  if resume_group == 3:
    _assert_states_equal(got, full)
  else:
    assert resumed._evaluator.dispatches == N_CHUNKS - next_chunk
    _assert_values_close(got.metric_values(resumed.metrics),
                         full.metric_values(resumed.metrics))


def test_one_fused_wrapper_call_per_dispatch_of_an_ensemble(monkeypatch):
  """Three 5-member chunks in one dispatch: one call of the fused-kernel
  wrapper for all of them (on the card, one launch); each chunk's state
  as its own evaluation gives it."""
  calls = []
  fused = crps_pairwise.fused_ensemble_stats

  def counted(x, y):
    calls.append(tuple(x.shape))
    return fused(x, y)

  monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', counted)
  pred, tgt, _ = _stores(darray, ens=5)
  metrics = {'crps': probabilistic.CRPSEnsemble(),
             'mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE()}
  ev = evaluator_lib.ChunkEvaluator(
      metrics, aggregation.Aggregator(
          reduce_dims=['latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=[binning.Regions(REGIONS)]), 'cpu')
  loader_p = loaders.PredictionsFromDataset(ds=pred, rename_dimensions=None)
  loader_t = loaders.TargetsFromDataset(ds=tgt, rename_dimensions=None)
  pairs = []
  for i in range(3):
    t = loader_t.load_chunk(INITS[i:i + 1], LEADS)
    pairs.append((loader_p.load_chunk(INITS[i:i + 1], LEADS, reference=t), t))
  states = ev.eval_chunks(pairs)
  assert calls == [(5, 3, 1, N_LEAD, 7, 8)]
  assert ev.dispatches == 1
  for (p, t), state in zip(pairs, states):
    want = ev.eval_chunk(p, t).to_dataset()
    got = state.to_dataset()
    assert sorted(got) == sorted(want)
    for k in want:
      assert got[k].dims == want[k].dims, k
      np.testing.assert_array_equal(got[k].coord_values('init_time'),
                                    want[k].coord_values('init_time'))
      np.testing.assert_allclose(got[k].values, want[k].values, rtol=1e-6,
                                 atol=1e-6, err_msg=k)
  assert len(calls) == 4
