"""``observability.maybe_profile``: the JAX package's ``jax.profiler`` trace
as a ``torch.profiler`` trace, on the CPU.

Without a directory it does nothing. With one, a pipeline run (a 5-member
ensemble of 2 inits x 2 leads x 7 x 8, float32 from a numpy seed, fair
CRPS and ensemble-mean RMSE, 2 chunks per dispatch) writes a
Chrome/TensorBoard trace whose events name the port's ranges: one per
statistic per dispatch, and the fused-kernel wrapper's.
"""

import os

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

INITS = (np.datetime64('2020-01-01', 'ns')
         + np.arange(2) * np.timedelta64(12, 'h'))
LEADS = (np.arange(2) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
VALID = (np.datetime64('2020-01-01', 'ns')
         + np.arange(4) * np.timedelta64(6, 'h'))
LAT = np.linspace(-90, 90, 7)
LON = np.linspace(0, 360, 8, endpoint=False)


def _pipe(profile_dir):
  rng = np.random.default_rng(0)
  pred = {'t2m': darray.DimArray(
      rng.standard_normal((5, 2, 2, 7, 8)).astype(np.float32),
      ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(5), 'init_time': INITS, 'lead_time': LEADS,
       'latitude': LAT, 'longitude': LON})}
  tgt = {'t2m': darray.DimArray(
      rng.standard_normal((4, 7, 8)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': VALID, 'latitude': LAT, 'longitude': LON})}
  return pipeline.EvaluationPipeline(
      metrics={'crps': probabilistic.CRPSEnsemble(),
               'mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE()},
      aggregator=aggregation.Aggregator(
          reduce_dims=['latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()]),
      predictions_loader=loaders.PredictionsFromDataset(
          ds=pred, rename_dimensions=None),
      targets_loader=loaders.TargetsFromDataset(ds=tgt,
                                                rename_dimensions=None),
      times=time_chunks.TimeChunks(INITS, LEADS, init_time_chunk_size=1),
      device='cpu', chunks_per_dispatch=2, profile_dir=profile_dir,
      metrics_registry=observability.Metrics())


def test_maybe_profile_without_a_directory_does_nothing(tmp_path):
  for trace_dir in (None, ''):
    with observability.maybe_profile(trace_dir, 'cpu'):
      assert not torch.autograd.profiler._is_profiler_enabled
  assert not os.listdir(tmp_path)


def test_profiled_pipeline_writes_a_trace_naming_the_ranges(tmp_path):
  trace_dir = str(tmp_path / 'trace')
  pipe = _pipe(trace_dir)
  profiled = pipe.run()
  files = [f for f in os.listdir(trace_dir) if f.endswith('.pt.trace.json')]
  assert len(files) == 1
  summary = observability.trace_summary(trace_dir)
  assert summary['path'] == os.path.join(trace_dir, files[0])
  ranges = summary['ranges']
  # 2 inits x 1 lead chunk of 2 leads, 2 per dispatch: one dispatch.
  assert pipe._evaluator.dispatches == 1
  assert ranges['wbx.fused_ensemble_stats'] == 1
  for name in pipe._evaluator._stat_names:
    assert ranges[f'wbx.statistic.{name}'] == 1, name
  assert summary['kernels'] == 0  # no device on the CPU
  # Profiling changes no value.
  plain = _pipe(None).run().to_dataset()
  got = profiled.to_dataset()
  assert sorted(got) == sorted(plain)
  for k in plain:
    assert torch.equal(got[k].data, plain[k].data), k
