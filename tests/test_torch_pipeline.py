"""The port's chunked pipeline against the JAX package's, on the CPU.

The same small stores (5 forecast members against a 4-member ensemble
analysis, 2 inits x 2 leads x 8 x 16, float32 from a numpy seed) go through
``weatherbenchx_tpu.parallel.pipeline.evaluate`` (its Pallas kernels in
interpret mode) and through the port's with ``device='cpu'``; values agree
to rtol 1e-5 / atol 1e-6. Then the port's own guarantees: bit-identical
checkpoint resume, the two-generation checkpoint, retries and skips, the
loaders' thread safety and time-unit handling, and the CLI against the
JAX CLI.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.apps import run_evaluation as j_run_evaluation
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu.parallel import pipeline as j_pipeline
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import fileio
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch import zarr_io
from weatherbenchx_tpu_torch.apps import run_evaluation
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
MX, MY, N_INIT, N_LEAD, N_LAT, N_LON = 5, 4, 2, 2, 8, 16
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-30, 30), (0, 360))}
INIT_TIMES = (np.datetime64('2020-01-01T00', 'ns')
              + np.arange(N_INIT) * np.timedelta64(12, 'h'))
LEAD_TIMES = (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype(
    'timedelta64[ns]')
# Valid times 6 h apart cover every init + lead.
VALID_TIMES = (np.datetime64('2020-01-01T00', 'ns')
               + np.arange(4) * np.timedelta64(6, 'h'))


def _stores(mod, seed=0):
  """(predictions, targets) in-memory stores of module ``mod``."""
  rng = np.random.default_rng(seed)
  lat = np.linspace(-90, 90, N_LAT)
  lon = np.linspace(0, 360, N_LON, endpoint=False)
  x = rng.standard_normal((MX, N_INIT, N_LEAD, N_LAT, N_LON)).astype(
      np.float32)
  y = (0.5 + rng.standard_normal((MY, len(VALID_TIMES), N_LAT, N_LON))
       ).astype(np.float32)
  preds = {'2m_temperature': mod.DimArray(
      x, ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(MX), 'init_time': INIT_TIMES,
       'lead_time': LEAD_TIMES, 'latitude': lat, 'longitude': lon})}
  tgts = {'2m_temperature': mod.DimArray(
      y, ('number', 'valid_time', 'latitude', 'longitude'),
      {'number': np.arange(MY), 'valid_time': VALID_TIMES, 'latitude': lat,
       'longitude': lon})}
  return preds, tgts


def _mask_fn(mod):
  """process_chunk_fn attaching a (latitude, longitude) mask coord."""
  mask = np.random.default_rng(99).random((N_LAT, N_LON)) > 0.25
  def fn(chunk):
    return {k: da.assign_coords(mask=mod.Coord(('latitude', 'longitude'),
                                               mask))
            for k, da in chunk.items()}
  return fn


def _metrics(prob):
  return {'energy': prob.CRPSEnsembleDistance(use_sort=True),
          'crps': prob.CRPSEnsemble(use_sort=True),
          'umr': prob.UnbiasedEnsembleMeanRMSE()}


def _setup(mods, reduce_dims, masked, init_chunk, lead_chunk, seed=0):
  darray_mod, agg_mod, bin_mod, w_mod, prob_mod, loaders_mod, tc_mod = mods
  preds, tgts = _stores(darray_mod, seed)
  kwargs = {'process_chunk_fn': _mask_fn(darray_mod)} if masked else {}
  return dict(
      metrics=_metrics(prob_mod),
      aggregator=agg_mod.Aggregator(
          reduce_dims=reduce_dims, weigh_by=[w_mod.GridAreaWeighting()],
          bin_by=[bin_mod.Regions(REGIONS)], masked=masked),
      predictions_loader=loaders_mod.PredictionsFromDataset(
          ds=preds, rename_dimensions=None),
      targets_loader=loaders_mod.TargetsFromDataset(
          ds=tgts, rename_dimensions=None, **kwargs),
      times=tc_mod.TimeChunks(INIT_TIMES, LEAD_TIMES, init_chunk,
                              lead_chunk))


JAX_MODS = (j_darray, j_aggregation, j_binning, j_weighting,
            j_probabilistic, j_loaders, j_time_chunks)
PORT_MODS = (darray, aggregation, binning, weighting, probabilistic,
             loaders, time_chunks)

KEEP_LEAD = ['init_time', 'latitude', 'longitude']
KEEP_INIT = ['lead_time', 'latitude', 'longitude']


def _assert_values_match(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims, k
    for name in got[k].dims:
      np.testing.assert_array_equal(got[k].coord_values(name),
                                    np.asarray(want[k].coords[name].values))
    g = got[k].values.astype(np.float64)
    w = np.asarray(want[k].values, np.float64)
    assert np.isfinite(g).all(), k
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize('reduce_dims,init_chunk,lead_chunk', [
    (KEEP_LEAD, 1, None),   # one bucket per lead block: fast-path adds
    (KEEP_LEAD, None, 1),   # lead buckets joined at the end
    (KEEP_INIT, 1, 1),      # init buckets joined at the end
])
@pytest.mark.parametrize('masked', [False, True])
def test_evaluate_matches_jax(reduce_dims, init_chunk, lead_chunk, masked,
                              monkeypatch):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  want = j_pipeline.evaluate(**_setup(JAX_MODS, reduce_dims, masked,
                                      init_chunk, lead_chunk))
  got = pipeline.evaluate(**_setup(PORT_MODS, reduce_dims, masked,
                                   init_chunk, lead_chunk),
                          device='cpu', metrics_registry=observability.Metrics())
  assert sorted(got) == ['crps.2m_temperature', 'energy.2m_temperature',
                         'umr.2m_temperature']
  _assert_values_match(got, want)


def _pipe(ckpt=None, seed=1, **kwargs):
  return pipeline.EvaluationPipeline(
      **_setup(PORT_MODS, KEEP_LEAD, True, 1, 1, seed), device='cpu',
      checkpoint_path=ckpt, checkpoint_every=1 if ckpt else 0,
      metrics_registry=observability.Metrics(), **kwargs)


def _assert_states_equal(got, want):
  got, want = got.to_dataset(), want.to_dataset()
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims
    assert torch.equal(got[k].data, want[k].data), k


class _CrashAt(loaders.TargetsFromDataset):
  """Raises when asked for the chunk at ``init_time`` / ``lead_time``."""

  def __init__(self, init_time, lead_time, **kwargs):
    super().__init__(**kwargs)
    self._at = (init_time, lead_time)

  def load_chunk(self, init_times, lead_times=None, reference=None):
    if (init_times[0], lead_times[0]) == self._at:
      raise RuntimeError('simulated preemption')
    return super().load_chunk(init_times, lead_times, reference)


def test_resume_is_bit_identical(tmp_path):
  """4 chunks in 2 lead buckets; crash at the last; resume; torch.equal."""
  full = _pipe().run()
  ckpt = str(tmp_path / 'ck')
  crashing = _pipe(ckpt)
  crashing.targets_loader = _CrashAt(
      INIT_TIMES[1], LEAD_TIMES[1], ds=_stores(darray, 1)[1],
      rename_dimensions=None, process_chunk_fn=_mask_fn(darray))
  with pytest.raises(RuntimeError, match='preemption'):
    crashing.run()
  manifest = json.load(open(ckpt + '.manifest.json'))
  assert manifest['next_chunk'] == 3
  assert {b['dtypes']['CRPSSkill_number#2m_temperature#sum_weights']
          for b in manifest['buckets']} == {'float32'}
  resumed = _pipe(ckpt)
  _assert_states_equal(resumed.run(), full)
  assert resumed._obs.counters['chunks_done'] == 1


def test_checkpoint_generations_alternate(tmp_path):
  ckpt = str(tmp_path / 'ck')
  pipe = _pipe(ckpt)
  _, _, (p, t) = next(pipe._chunk_stream())
  state = pipe._evaluator.eval_chunk(p, t)
  pipe._save_checkpoint({(-1, 0): state}, 1)
  m1 = json.load(open(ckpt + '.manifest.json'))
  pipe._save_checkpoint({(-1, 0): state}, 2)
  m2 = json.load(open(ckpt + '.manifest.json'))
  assert m1['generation'] != m2['generation']
  paths1 = {b['path'] for b in m1['buckets']}
  paths2 = {b['path'] for b in m2['buckets']}
  assert paths1.isdisjoint(paths2)
  assert all(os.path.exists(p) for p in paths1 | paths2)


def test_crashed_save_preserves_previous_checkpoint(tmp_path, monkeypatch):
  ckpt = str(tmp_path / 'ck')
  pipe = _pipe(ckpt)
  stream = pipe._chunk_stream()
  _, _, (p, t) = next(stream)
  state1 = pipe._evaluator.eval_chunk(p, t)
  pipe._save_checkpoint({(-1, 0): state1}, 1)
  _, _, (p2, t2) = next(stream)
  state2 = state1 + pipe._evaluator.eval_chunk(p2, t2)

  def crash(*args, **kwargs):
    raise RuntimeError('simulated preemption')
  # The second save crashes after its bucket files are written, before the
  # manifest commit.
  monkeypatch.setattr(pipeline.fileio, 'write_text_atomic', crash)
  with pytest.raises(RuntimeError, match='preemption'):
    pipe._save_checkpoint({(-1, 0): state2}, 2)
  monkeypatch.undo()

  buckets, next_chunk = _pipe(ckpt)._load_checkpoint()
  assert next_chunk == 1
  _assert_states_equal(buckets[(-1, 0)], state1)


class _FlakyPredictions(loaders.PredictionsFromDataset):
  """Fault injection: ``plan`` maps a chunk's first init_time to N (fail the
  first N attempts with OSError) or 'always' / 'keyerror' (never succeed).
  """

  def __init__(self, plan, **kwargs):
    super().__init__(**kwargs)
    self._plan = dict(plan)
    self._lock = threading.Lock()
    self.attempts = {}

  def load_chunk(self, init_times, lead_times=None, reference=None):
    key = np.datetime64(init_times[0], 'ns')
    with self._lock:
      n = self.attempts.get(key, 0)
      self.attempts[key] = n + 1
    spec = self._plan.get(key)
    if spec == 'keyerror':
      raise KeyError(f'permanent bug for chunk at {key}')
    if spec == 'always':
      raise OSError(f'permanent transient-looking failure at {key}')
    if isinstance(spec, int) and n < spec:
      raise OSError(f'injected transient failure {n + 1}/{spec} at {key}')
    return super().load_chunk(init_times, lead_times, reference)


def _retry_run(plan, retry, out_path=None):
  setup = _setup(PORT_MODS, KEEP_INIT, False, 1, None, seed=2)
  setup['predictions_loader'] = _FlakyPredictions(
      plan, ds=_stores(darray, 2)[0], rename_dimensions=None)
  obs = observability.Metrics()
  pipe = pipeline.EvaluationPipeline(**setup, device='cpu', retry=retry,
                                     metrics_registry=obs)
  return pipe, obs, pipe.run_and_write(out_path)


def test_transient_failures_retried_result_exact():
  plan = {INIT_TIMES[0]: 2, INIT_TIMES[1]: 1}
  _, obs, values = _retry_run(
      plan, pipeline.RetryPolicy(retries=3, backoff_s=0.0))
  _, _, clean = _retry_run({}, None)
  for k in clean:
    assert torch.equal(values[k].data, clean[k].data), k
  assert obs.counters['load_retries'] == 3
  assert 'chunks_failed' not in obs.counters


def test_exhausted_retries_raise_without_skip():
  with pytest.raises(OSError, match='permanent'):
    _retry_run({INIT_TIMES[1]: 'always'},
               pipeline.RetryPolicy(retries=2, backoff_s=0.0))


def test_no_policy_fails_immediately():
  with pytest.raises(OSError, match='injected'):
    _retry_run({INIT_TIMES[0]: 1}, None)


def test_skip_failed_drops_chunk_reports_and_writes_sidecar(tmp_path):
  out_path = str(tmp_path / 'metrics.npz')
  pipe, obs, values = _retry_run(
      {INIT_TIMES[1]: 'always'},
      pipeline.RetryPolicy(retries=1, backoff_s=0.0, skip_failed=True),
      out_path)
  # The result holds exactly the surviving init time, with the values of
  # a run over that init alone.
  setup = _setup(PORT_MODS, KEEP_INIT, False, 1, None, seed=2)
  setup['times'] = time_chunks.TimeChunks(INIT_TIMES[:1], LEAD_TIMES)
  want = pipeline.evaluate(**setup, device='cpu',
                           metrics_registry=observability.Metrics())
  for k, v in want.items():
    np.testing.assert_array_equal(values[k].coord_values('init_time'),
                                  INIT_TIMES[:1])
    assert torch.equal(values[k].data, v.data), k
  assert obs.counters['chunks_failed'] == 1
  assert obs.counters['load_retries'] == 1
  assert len(pipe.failed_chunks) == 1
  idx, _, err = pipe.failed_chunks[0]
  assert idx == 1 and 'OSError' in err
  with open(out_path + '.failures.json') as f:
    sidecar = json.load(f)
  assert len(sidecar) == 1 and sidecar[0]['chunk'] == 1
  assert sidecar[0]['offsets'] == {'init_time': 1, 'lead_time': 0}
  assert 'OSError' in sidecar[0]['error']
  written = io.load_dataset(out_path)
  for k in values:
    assert torch.equal(written[k].data, values[k].data), k


def test_programming_errors_never_skipped():
  with pytest.raises(KeyError, match='permanent bug'):
    _retry_run({INIT_TIMES[0]: 'keyerror'},
               pipeline.RetryPolicy(retries=3, backoff_s=0.0,
                                    skip_failed=True))


def test_preprocessing_fn_applied_once_under_concurrency():
  preds = _stores(darray, 3)[0]
  calls = []

  def preprocess(ds):
    calls.append(1)
    return {k: v + 100.0 for k, v in ds.items()}

  loader = loaders.PredictionsFromDataset(
      ds=preds, rename_dimensions=None, preprocessing_fn=preprocess)
  barrier = threading.Barrier(8)
  errors = []

  def prepare():
    try:
      barrier.wait(timeout=30)
      loader.maybe_prepare_dataset()
    except Exception as e:  # pragma: no cover
      errors.append(e)

  threads = [threading.Thread(target=prepare) for _ in range(8)]
  for th in threads:
    th.start()
  for th in threads:
    th.join(timeout=60)
  assert not any(th.is_alive() for th in threads)
  assert not errors
  assert len(calls) == 1, f'preprocessing_fn ran {len(calls)} times'
  np.testing.assert_array_equal(
      loader._ds['2m_temperature'].values,
      preds['2m_temperature'].values + np.float32(100.0))


def test_targets_valid_time_in_seconds_unit():
  tgts = _stores(darray, 4)[1]
  da = tgts['2m_temperature']
  coarse = {'2m_temperature': da.assign_coords(
      valid_time=VALID_TIMES.astype('datetime64[s]'))}
  want = loaders.TargetsFromDataset(
      ds=tgts, rename_dimensions=None).load_chunk(INIT_TIMES, LEAD_TIMES)
  got = loaders.TargetsFromDataset(
      ds=coarse, rename_dimensions=None).load_chunk(INIT_TIMES, LEAD_TIMES)
  got, want = got['2m_temperature'], want['2m_temperature']
  assert got.dims == ('number', 'init_time', 'lead_time', 'latitude',
                      'longitude')
  assert torch.equal(got.data, want.data)
  # And the gather picks valid time init + lead, against JAX's loader.
  j_got = j_loaders.TargetsFromDataset(
      ds=_stores(j_darray, 4)[1], rename_dimensions=None).load_chunk(
          INIT_TIMES, LEAD_TIMES)['2m_temperature']
  np.testing.assert_array_equal(got.values, np.asarray(j_got.values))
  np.testing.assert_array_equal(got.coord_values('valid_time'),
                                np.asarray(j_got.coords['valid_time'].values))


def test_loaders_match_jax_with_renames_and_selections(tmp_path):
  """An .npz store with upstream names, a variable list and a level sel."""
  rng = np.random.default_rng(5)
  x = rng.standard_normal((N_INIT, N_LEAD, 3, N_LAT, N_LON)).astype(
      np.float32)

  def store(mod):
    return {v: mod.DimArray(
        x + i, ('time', 'prediction_timedelta', 'level', 'lat', 'lon'),
        {'time': INIT_TIMES, 'prediction_timedelta': LEAD_TIMES,
         'level': np.array([500, 700, 850]),
         'lat': np.linspace(-90, 90, N_LAT),
         'lon': np.linspace(0, 360, N_LON, endpoint=False)})
            for i, v in enumerate(('geopotential', 'temperature'))}

  path = str(tmp_path / 'preds.npz')
  io.save_dataset(path, store(darray))
  kwargs = dict(variables=['temperature'], sel_kwargs={'level': [850, 500]})
  got = loaders.PredictionsFromDataset(path=path, **kwargs).load_chunk(
      INIT_TIMES[1:], slice(LEAD_TIMES[0], LEAD_TIMES[1]))
  want = j_loaders.PredictionsFromDataset(ds=store(j_darray), **kwargs
                                          ).load_chunk(
      INIT_TIMES[1:], slice(LEAD_TIMES[0], LEAD_TIMES[1]))
  assert list(got) == list(want) == ['temperature']
  g, w = got['temperature'], want['temperature']
  assert g.dims == w.dims == ('init_time', 'lead_time', 'level', 'latitude',
                              'longitude')
  assert g.data.is_contiguous()
  np.testing.assert_array_equal(g.values, np.asarray(w.values))
  np.testing.assert_array_equal(g.coord_values('level'), [850, 500])
  with pytest.raises(ValueError, match='Exactly one'):
    loaders.PredictionsFromDataset()
  # The sparse path's options, refused until it was ported, now load: a
  # dense chunk has no ``index`` to pad, so it comes back as it was, and
  # its values ride along as a coord.
  padded = loaders.PredictionsFromDataset(
      path=path, pad_index_multiple=8, add_values_to_coords=True,
      **kwargs).load_chunk(INIT_TIMES[1:], slice(LEAD_TIMES[0],
                                                 LEAD_TIMES[1]))['temperature']
  np.testing.assert_array_equal(padded.values, g.values)
  np.testing.assert_array_equal(padded.coord_values('values_as_coord'),
                                g.values)


def _cli_stores(tmp_path):
  """N(0,1) forecasts and analyses with upstream dim names, as .npz."""
  rng = np.random.default_rng(6)
  inits = np.arange('2020-01-01', '2020-01-03', np.timedelta64(12, 'h'),
                    dtype='datetime64[ns]')
  leads = np.arange(0, 12, 6, dtype='timedelta64[h]').astype(
      'timedelta64[ns]')
  valid = np.arange('2020-01-01', '2020-01-04', np.timedelta64(6, 'h'),
                    dtype='datetime64[ns]')
  space = {'latitude': np.linspace(-90, 90, 9),
           'longitude': np.linspace(0, 360, 12, endpoint=False)}
  preds = {'2m_temperature': j_darray.DimArray(
      rng.standard_normal((len(inits), 2, 9, 12)).astype(np.float32),
      ('time', 'prediction_timedelta', 'latitude', 'longitude'),
      {'time': inits, 'prediction_timedelta': leads, **space})}
  tgts = {'2m_temperature': j_darray.DimArray(
      rng.standard_normal((len(valid), 9, 12)).astype(np.float32),
      ('time', 'latitude', 'longitude'), {'time': valid, **space})}
  p, t = str(tmp_path / 'preds.npz'), str(tmp_path / 'tgts.npz')
  j_io.save_dataset(p, preds)
  j_io.save_dataset(t, tgts)
  return p, t


def test_cli_matches_the_jax_cli(tmp_path, capsys):
  p, t = _cli_stores(tmp_path)
  common = [f'--prediction_path={p}', f'--target_path={t}',
            '--time_start=2020-01-01', '--time_stop=2020-01-03',
            '--lead_time_stop=12', '--variables=2m_temperature',
            '--time_chunk_size=2']
  j_run_evaluation.main(common + [f'--output_path={tmp_path}/jax.npz'])
  run_evaluation.main(common + [f'--output_path={tmp_path}/port.npz',
                                f'--aggregation_state_output_path='
                                f'{tmp_path}/state.npz', '--device=cpu'])
  assert 'Wrote 2 metric variables' in capsys.readouterr().out
  got = io.load_dataset(f'{tmp_path}/port.npz')
  want = j_io.load_dataset(f'{tmp_path}/jax.npz')
  assert sorted(got) == sorted(want) == ['mse.2m_temperature',
                                         'rmse.2m_temperature']
  for k in want:
    assert got[k].dims == want[k].dims == ('lead_time', 'region')
    np.testing.assert_array_equal(got[k].coord_values('region'),
                                  np.asarray(want[k].coords['region'].values))
    np.testing.assert_allclose(got[k].values, np.asarray(want[k].values),
                               rtol=RTOL, atol=ATOL, err_msg=k)
  state = aggregation.AggregationState.load(f'{tmp_path}/state.npz')
  assert state.sum_weights['SquaredError']['2m_temperature'].shape == (2, 2)


def _port_copy(path: str, suffix: str, **zarr_kwargs) -> str:
  """The .npz store at path rewritten by the port's writers as suffix."""
  out = path[:-len('.npz')] + suffix
  ds = io.load_dataset(path)
  if zarr_kwargs:
    zarr_io.save_dataset_zarr(out, ds, **zarr_kwargs)
  else:
    io.save_dataset(out, ds)
  return out


CLI_CONTAINERS = {
    'wbx': ('.wbx', {}), 'nc': ('.nc', {}),
    'zarr2_blosc': ('.zarr', {'compressor': 'blosc',
                              'chunks': {'time': 1}}),
    'zarr3_sharded_zstd': ('.3.zarr', {'compressor': 'zstd', 'zarr_format': 3,
                                       'chunks': {'time': 1},
                                       'shards': {'time': 4}}),
}


@pytest.mark.parametrize('container', list(CLI_CONTAINERS))
def test_cli_from_every_container_matches_its_npz_run(tmp_path, container):
  """The evaluation CLI from each container, with its output in the same
  container, equals its .npz run bit for bit; the JAX CLI from the same
  stores agrees within the file's tolerances."""
  p, t = _cli_stores(tmp_path)
  suffix, zarr_kwargs = CLI_CONTAINERS[container]
  cp, ct = (_port_copy(x, suffix, **zarr_kwargs) for x in (p, t))
  common = ['--time_start=2020-01-01', '--time_stop=2020-01-03',
            '--lead_time_stop=12', '--variables=2m_temperature',
            '--time_chunk_size=2']
  out = f'{tmp_path}/out{suffix}'
  run_evaluation.main(common + [f'--prediction_path={p}', f'--target_path={t}',
                                f'--output_path={tmp_path}/npz.npz',
                                '--device=cpu'])
  run_evaluation.main(common + [f'--prediction_path={cp}',
                                f'--target_path={ct}', f'--output_path={out}',
                                '--device=cpu'])
  j_run_evaluation.main(common + [f'--prediction_path={cp}',
                                  f'--target_path={ct}',
                                  f'--output_path={tmp_path}/jax.npz'])
  got, want = io.load_dataset(out), io.load_dataset(f'{tmp_path}/npz.npz')
  jax_ = j_io.load_dataset(f'{tmp_path}/jax.npz')
  assert sorted(got) == sorted(want) == sorted(jax_)
  for k in want:
    assert got[k].dims == want[k].dims
    assert torch.equal(got[k].data, want[k].data), k
    np.testing.assert_allclose(got[k].values, np.asarray(jax_[k].values),
                               rtol=RTOL, atol=ATOL, err_msg=k)


def test_checkpoints_are_wbx_locally_and_npz_remotely(tmp_path):
  """Bucket files are .wbx block containers on a local path and the npz
  container's bytes on a remote one (fsspec memory://); a crashed run
  resumes from either bit-identical to an uninterrupted one."""
  full = _pipe().run()
  for ckpt in (str(tmp_path / 'ck'), f'memory://{tmp_path.name}/ck'):
    crashing = _pipe(ckpt)
    crashing.targets_loader = _CrashAt(
        INIT_TIMES[1], LEAD_TIMES[1], ds=_stores(darray, 1)[1],
        rename_dimensions=None, process_chunk_fn=_mask_fn(darray))
    with pytest.raises(RuntimeError, match='preemption'):
      crashing.run()
    manifest = json.loads(fileio.read_text(ckpt + '.manifest.json'))
    for b in manifest['buckets']:
      assert b['path'].endswith('.wbx')
      magic = fileio.read_byte_range(b['path'], 0, 8)
      if fileio.is_remote(ckpt):
        assert magic[:4] == b'PK\x03\x04', magic  # a zip: the npz container
      else:
        assert magic == b'WBXBLK01', magic
    _assert_states_equal(_pipe(ckpt).run(), full)


def test_cli_cuda_device_raises_without_a_gpu(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  p, t = _cli_stores(tmp_path)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    run_evaluation.main([f'--prediction_path={p}', f'--target_path={t}',
                         f'--output_path={tmp_path}/out.npz'])
  assert not os.path.exists(f'{tmp_path}/out.npz')


def test_deterministic_rmse_through_the_pipeline_matches_direct():
  """A deterministic run keeps working without an ensemble dim."""
  preds, tgts = _stores(darray, 7)
  preds = {k: v.isel(number=0) for k, v in preds.items()}
  tgts = {k: v.isel(number=0) for k, v in tgts.items()}
  agg = aggregation.Aggregator(reduce_dims=KEEP_LEAD,
                               weigh_by=[weighting.GridAreaWeighting()])
  metrics = {'rmse': deterministic.RMSE()}
  p_loader = loaders.PredictionsFromDataset(ds=preds, rename_dimensions=None)
  t_loader = loaders.TargetsFromDataset(ds=tgts, rename_dimensions=None)
  got = pipeline.evaluate(
      metrics, agg, p_loader, t_loader,
      time_chunks.TimeChunks(INIT_TIMES, LEAD_TIMES, 1, 1), device='cpu',
      metrics_registry=observability.Metrics())
  want = aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, p_loader.load_chunk(INIT_TIMES, LEAD_TIMES),
      t_loader.load_chunk(INIT_TIMES, LEAD_TIMES))
  np.testing.assert_allclose(got['rmse.2m_temperature'].values,
                             want['rmse.2m_temperature'].values, rtol=1e-6)


@pytest.mark.parametrize('prefetch', [1, 2, 3])
def test_host_chunks_in_flight_are_at_most_prefetch(prefetch):
  """As the JAX package's stream: the next load starts once the consumer
  is done with its chunk, so the chunk it holds and the loads started are
  at most ``prefetch``; the stream's order and contents are unchanged."""
  times = time_chunks.TimeChunks(INIT_TIMES, LEAD_TIMES, 1, 1)
  started = []
  lock = threading.Lock()

  def load(chunk):
    with lock:
      started.append(chunk)
    return chunk

  got = []
  for k, (i, _, chunk) in enumerate(pipeline.stream_chunk_pairs(
      load, times, prefetch=prefetch)):
    time.sleep(0.02)  # lets a load already submitted start
    with lock:
      assert len(started) <= k + prefetch, (k, len(started))
    got.append((i, chunk))
  assert [i for i, _ in got] == list(range(len(times)))
  assert [c for _, c in got] == list(times)
