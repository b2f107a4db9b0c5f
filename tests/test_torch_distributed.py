"""Chunk-parallel ranks of the port against the JAX package, on the CPU.

Real gloo ranks in spawned processes (``multichip.run_ranks``, a
``file://`` rendezvous in a temporary directory; each spawn and every
collective under a time limit) run the port's ``EvaluationPipeline(
distributed=True)`` on the inputs of the JAX package's distributed tests
(``tests/test_pipeline.py``'s partition and per-process checkpoint tests,
``tests/test_multiprocess.py``'s two-process runs), made from numpy seeds
in ``tests/torch_rank_cases.py``; the parent process runs the JAX package's
single-device pipeline or direct computation on the same inputs, and every
rank's total must agree to atol 1e-5. Also: the per-rank resume is
bit-identical per rank, a changed rank count is refused, the cross-rank sum
outer-joins ragged and empty states, groups of ranks each shard a chunk
over their own mesh, ``multichip.dryrun_multichip(4)`` passes its six
phases, and ``distributed=True`` without a process group raises.
"""

import os

import numpy as np
import pytest
import torch

import torch_rank_cases as cases
from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.parallel import pipeline as j_pipeline
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import multichip
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import distributed
from weatherbenchx_tpu_torch.parallel import pipeline

ATOL = 1e-5
TIMEOUT_S = 240.0
CASES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'torch_rank_cases.py')


def _ranks(case, world, **kwargs):
  return multichip.run_ranks(f'{CASES}:{case}', world, kwargs,
                             timeout_s=TIMEOUT_S, num_threads=1)


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
  return _ranks('case_world2', 2,
                work_dir=str(tmp_path_factory.mktemp('world2')))


@pytest.fixture(scope='module')
def world4():
  return _ranks('case_world4', 4)


def _assert_values(got, want):
  """Port values (``cases.as_numpy``) against the JAX package's."""
  assert set(got) == set(want)
  for k, (dims, values) in want.items():
    gdims, gvalues = got[k]
    if set(gdims) == set(dims):
      gvalues = np.transpose(gvalues, [gdims.index(d) for d in dims])
    np.testing.assert_allclose(gvalues, values, atol=ATOL, err_msg=k)


def _j_metrics():
  return {'rmse': j_deterministic.RMSE(), 'bias': j_deterministic.Bias()}


def _j_single_pipeline():
  """The JAX package's single-device pipeline on the partition inputs."""
  pred, tgt, inits, leads = cases.source_arrays()
  return cases.as_numpy(j_pipeline.EvaluationPipeline(
      metrics=_j_metrics(),
      aggregator=j_aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[j_weighting.GridAreaWeighting()]),
      predictions_loader=j_loaders.PredictionsFromDataset(
          ds=cases.wrap(jd, pred), rename_dimensions=None),
      targets_loader=j_loaders.TargetsFromDataset(
          ds=cases.wrap(jd, tgt), rename_dimensions=None),
      times=j_time_chunks.TimeChunks(inits, leads, init_time_chunk_size=1,
                                     lead_time_chunk_size=2),
  ).run().metric_values(_j_metrics()))


def _j_multiprocess_direct():
  """``tests/test_multiprocess.py:_direct_values``."""
  pred, tgt, inits, leads = cases.multiprocess_arrays()
  p = j_loaders.PredictionsFromDataset(ds=cases.wrap(jd, pred),
                                       rename_dimensions=None)
  t = j_loaders.TargetsFromDataset(ds=cases.wrap(jd, tgt),
                                   rename_dimensions=None)
  return cases.as_numpy(j_aggregation.compute_metric_values_for_single_chunk(
      _j_metrics(),
      j_aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[j_weighting.GridAreaWeighting()]),
      p.load_chunk(inits, leads), t.load_chunk(inits, leads)))


def _n_chunks(inits, leads, init_chunk, lead_chunk):
  return len(time_chunks.TimeChunks(inits, leads,
                                    init_time_chunk_size=init_chunk,
                                    lead_time_chunk_size=lead_chunk))


@pytest.mark.parametrize('world', [2, 4])
def test_ranks_partials_sum_to_full_result(world, world2, world4):
  """``test_two_process_partials_sum_to_full_result`` on real ranks: the
  ranks keep disjoint, jointly exhaustive chunk sets by ``index % world``,
  and every rank returns the single-device total."""
  results = world2 if world == 2 else world4
  _, _, inits, leads = cases.source_arrays()
  kept = [r['partition']['kept'] for r in results]
  assert sorted(i for k in kept for i in k) == list(
      range(_n_chunks(inits, leads, 1, 2)))
  for rank, k in enumerate(kept):
    assert k and all(i % world == rank for i in k)
  want = _j_single_pipeline()
  for r in results:
    _assert_values(r['partition']['values'], want)


def test_per_rank_checkpoints_resume_bit_identical(world2):
  """``test_failure_then_resume_matches_direct`` and
  ``test_per_process_resume_sums_to_full``: each rank fails mid-run after
  checkpointing under its own prefix, resumes without reloading its
  completed chunks, ends with its partial state bit-identical to an
  uninterrupted run's, and the total is the direct result."""
  want = _j_multiprocess_direct()
  _, _, inits, leads = cases.multiprocess_arrays()
  n = _n_chunks(inits, leads, 2, 2)
  for rank, r in enumerate(world2):
    res = r['resume']
    assert res['failed']
    assert res['manifests'] == ['state.p0.manifest.json',
                                'state.p1.manifest.json']
    owned = len(range(rank, n, 2))
    assert 0 < res['loads'] < owned
    assert res['bit_identical']
    _assert_values(res['values'], want)


def test_changed_rank_count_raises(world2):
  """``test_process_count_mismatch_raises``: a checkpoint written by 2
  ranks is refused by a run of another count."""
  for r in world2:
    assert r['resume']['mismatch'] is not None
    assert '2 processes' in r['resume']['mismatch']


def test_every_rank_checkpoints(world2):
  """``test_every_process_checkpoints``: the cadence counts a rank's own
  completions, so every rank checkpoints under an even cadence."""
  for r in world2:
    assert r['resume']['cadence'] == ['ck.p0.manifest.json',
                                      'ck.p1.manifest.json']


def test_ragged_and_zero_states_sum_over_ranks(world4):
  """``test_ragged_and_zero_states_outer_join`` over real ranks: stations
  {1, 2, 3} and {2, 4} on two ranks, the zero state (``b''``) on two,
  summed by the outer join on every rank as the JAX package sums them."""
  a = _j_station_state([1, 2, 3], [1.0, 2.0, 3.0])
  b = _j_station_state([2, 4], [10.0, 40.0])
  want = j_aggregation.AggregationState.sum([a, b]).sum_weighted_statistics[
      'SquaredError']['t']
  for r in world4:
    np.testing.assert_array_equal(r['ragged']['station'],
                                  want.coord_values('station'))
    np.testing.assert_allclose(r['ragged']['values'], np.asarray(want.values))
    np.testing.assert_allclose(r['ragged']['values'], [1.0, 12.0, 3.0, 40.0])


def test_groups_of_ranks_shard_their_chunks_over_a_mesh(world4):
  """``test_mesh_sharded_distributed_matches_direct``: 4 ranks in groups of
  2 consecutive ranks, each group a mesh with ``longitude`` sharded; the
  chunks are split over the groups, and the total is the direct result."""
  want = _j_multiprocess_direct()
  _, _, inits, leads = cases.multiprocess_arrays()
  n = _n_chunks(inits, leads, 2, 2)
  for rank, r in enumerate(world4):
    group = rank // 2
    assert r['groups']['mesh'] == [2 * group, 2 * group + 1]
    assert r['groups']['kept'] == list(range(group, n, 2))
    _assert_values(r['groups']['values'], want)


def test_dryrun_multichip_passes_all_six_phases():
  lines = multichip.dryrun_multichip(4, device='cpu', timeout_s=TIMEOUT_S)
  assert len(lines) == 6
  assert lines[0].startswith("dryrun_multichip(4) OK: mesh={'batch': 2, "
                             "'space': 1, 'ensemble': 2}")
  for phase in ('sharded multi-chunk run == direct', 'unaggregated Zarr',
                'failure + resume == direct', 'ragged sparse outer-join',
                'sharded padded sparse'):
    assert any(phase in line for line in lines[1:]), phase


@pytest.mark.parametrize('call', ['function', 'command line'])
def test_dryrun_runs_on_the_gpu_unless_asked_for_the_cpu(call, monkeypatch):
  """The dryrun's device defaults to the GPU, and without one it raises
  before any rank starts rather than running on the CPU."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    if call == 'function':
      multichip.dryrun_multichip(4)
    else:
      multichip.main(['4'])


def test_a_failing_rank_stops_the_others():
  """A rank that raises ends the spawn at once with its traceback; the
  rank waiting for it in a collective is stopped, not left to time out."""
  import time
  t0 = time.monotonic()
  with pytest.raises(RuntimeError, match='rank 1 gives up'):
    multichip.run_ranks(f'{CASES}:case_one_rank_fails', 2, timeout_s=120.0)
  assert time.monotonic() - t0 < 60


@pytest.mark.parametrize('world', [3, 5, 8])
def test_dryrun_mesh_shapes_follow_the_jax_dryrun(world):
  assert multichip.mesh_shape(world) == {
      3: ((3,), ('space',)),
      5: ((5,), ('space',)),
      8: ((2, 2, 2), ('batch', 'space', 'ensemble'))}[world]


def test_distributed_without_a_process_group_raises():
  """No fallback: ``distributed=True`` never runs as one process."""
  pred, tgt, inits, leads = cases.source_arrays()
  with pytest.raises(RuntimeError, match='init_process_group'):
    pipeline.EvaluationPipeline(
        metrics={'rmse': deterministic.RMSE()},
        aggregator=aggregation.Aggregator(reduce_dims=['latitude']),
        predictions_loader=None, targets_loader=None,
        times=time_chunks.TimeChunks(inits, leads), device='cpu',
        distributed=True)
  with pytest.raises(RuntimeError, match='init_process_group'):
    list(pipeline.stream_chunk_pairs(
        lambda chunk: chunk, time_chunks.TimeChunks(inits, leads),
        distributed=True))
  for fn in (distributed.rank, distributed.world_size, distributed.barrier):
    with pytest.raises(RuntimeError, match='init_process_group'):
      fn()


def _station_state(stations, values):
  da = td.DimArray(torch.tensor(values, dtype=torch.float64), ('station',),
                   {'station': np.asarray(stations)})
  return aggregation.AggregationState(
      {'SquaredError': {'t': da}},
      {'SquaredError': {'t': da.copy(data=torch.ones_like(da.data))}})


def _j_station_state(stations, values):
  da = jd.DimArray(np.asarray(values, np.float64), ('station',),
                   {'station': np.asarray(stations)})
  return j_aggregation.AggregationState(
      {'SquaredError': {'t': da}},
      {'SquaredError': {'t': da.copy(data=np.ones_like(da.values))}})


def test_allgather_sum_states_outer_joins_blobs(monkeypatch):
  """``TestAllgatherSumStates.test_ragged_and_zero_states_outer_join``:
  the blobs of the JAX package's own serialiser, ragged and empty."""
  a = _j_station_state([1, 2, 3], [1.0, 2.0, 3.0])
  b = _j_station_state([2, 4], [10.0, 40.0])
  blobs = [j_io.dumps_dataset(a.to_dataset()), b'',
           j_io.dumps_dataset(b.to_dataset())]
  monkeypatch.setattr(distributed, 'allgather_bytes', lambda p: blobs)
  total = distributed.allgather_sum_states(
      _station_state([1, 2, 3], [1.0, 2.0, 3.0]))
  out = total.sum_weighted_statistics['SquaredError']['t']
  np.testing.assert_array_equal(out.coord_values('station'), [1, 2, 3, 4])
  np.testing.assert_allclose(out.values, [1.0, 12.0, 3.0, 40.0])


def test_zero_state_sends_empty_payload(monkeypatch):
  """``test_local_zero_state_participates``, and a mesh rank that is not
  its group's first sends nothing either."""
  b = _station_state([5], [7.0])
  seen = []

  def gather(payload):
    seen.append(payload)
    return [b'', io.dumps_dataset(b.to_dataset())]

  monkeypatch.setattr(distributed, 'allgather_bytes', gather)
  for state, contribute in ((aggregation.AggregationState.zero(), True),
                            (_station_state([1], [1.0]), False)):
    total = distributed.allgather_sum_states(state, contribute=contribute)
    np.testing.assert_allclose(
        total.sum_weighted_statistics['SquaredError']['t'].values, [7.0])
  assert seen == [b'', b'']


def test_state_bytes_roundtrip_with_jax():
  """``test_dumps_loads_roundtrip``: a state's bytes read back by both
  packages."""
  a = _station_state([1, 2], [1.5, -2.5])
  blob = io.dumps_dataset(a.to_dataset())
  for back in (io.loads_dataset(blob), j_io.loads_dataset(blob)):
    assert set(back) == set(a.to_dataset())
    for k, da in a.to_dataset().items():
      np.testing.assert_array_equal(np.asarray(back[k].values), da.values)
