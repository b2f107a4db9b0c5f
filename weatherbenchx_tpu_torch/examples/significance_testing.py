"""Post-hoc statistical inference on a saved AggregationState.

The port of ``examples/significance_testing.py``: run the pipeline with
init_time preserved (the experimental unit), save the state, then compute
point estimates, confidence intervals, and a paired baseline comparison.

Run: python -m weatherbenchx_tpu_torch.examples.significance_testing
[--device cpu] (``--device cuda``, the default, raises without a GPU)
"""

import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import aggregation, weighting
from weatherbenchx_tpu_torch import time_chunks as tc
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.examples import parse_device
from weatherbenchx_tpu_torch.inference import t_test
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import pipeline as pipeline_lib


def main(argv: Optional[Sequence[str]] = None) -> dict[str, float]:
  """Prints the two lines; returns the RMSE, its interval, the paired
  p-value and whether it is significant."""
  device = parse_device(argv, __doc__)
  rng = np.random.default_rng(0)
  lats = np.linspace(-90, 90, 19)
  lons = np.linspace(0, 360, 36, endpoint=False)
  init = np.datetime64('2020-01-01', 'ns') + np.arange(40) * np.timedelta64(
      12, 'h')
  lead = np.array([12], 'timedelta64[h]').astype('timedelta64[ns]')
  valid = np.datetime64('2020-01-01', 'ns') + np.arange(
      41) * np.timedelta64(12, 'h')

  tgt = {'t2m': DimArray(
      rng.standard_normal((41, 19, 36)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid, 'latitude': lats, 'longitude': lons})}
  metrics = {'rmse': deterministic.RMSE()}

  def run_model(noise_scale):
    pred = {'t2m': DimArray(
        (noise_scale * rng.standard_normal((40, 1, 19, 36))).astype(
            np.float32),
        ('init_time', 'lead_time', 'latitude', 'longitude'),
        {'init_time': init, 'lead_time': lead,
         'latitude': lats, 'longitude': lons})}
    pipe = pipeline_lib.EvaluationPipeline(
        metrics=metrics,
        aggregator=aggregation.Aggregator(
            reduce_dims=['latitude', 'longitude'],  # init_time preserved
            weigh_by=[weighting.GridAreaWeighting()]),
        predictions_loader=loaders.PredictionsFromDataset(
            ds=pred, rename_dimensions=None),
        targets_loader=loaders.TargetsFromDataset(
            ds=tgt, rename_dimensions=None),
        times=tc.TimeChunks(init, lead, init_time_chunk_size=8),
        device=device)
    return pipe.run().sum_along_dims(['lead_time'])

  state_main = run_model(noise_scale=1.0)       # "my model"
  state_base = run_model(noise_scale=1.3)       # worse baseline

  # States serialize losslessly; inference runs on the loaded artifact.
  with tempfile.TemporaryDirectory(prefix='wbx_example_') as tmp:
    path = os.path.join(tmp, 'state.npz')
    state_main.save(path)
    state_main = aggregation.AggregationState.load(path)

  inf = t_test.GeerAR2Corrected(metrics, state_main,
                                experimental_unit_dim='init_time')
  pe = float(np.asarray(inf.point_estimates()['rmse']['t2m'].values))
  lo, hi = inf.confidence_intervals(0.05)  # alpha = miscoverage: 95% CI
  lo = float(np.asarray(lo['rmse']['t2m'].values))
  hi = float(np.asarray(hi['rmse']['t2m'].values))
  print(f'rmse = {pe:.4f}  95% CI = [{lo:.4f}, {hi:.4f}]')

  # Paired comparison vs the baseline: is the difference significant?
  paired = t_test.IID.for_baseline_comparison(
      metrics, state_main, state_base, experimental_unit_dim='init_time')
  p = float(np.asarray(paired.p_values()['rmse']['t2m'].values))
  sig = bool(np.asarray(
      paired.significance_tests(0.05)['rmse']['t2m'].values))
  print(f'rmse difference vs baseline: p = {p:.2e} '
        f'significant at 5%: {sig}')
  return {'rmse': pe, 'ci_low': lo, 'ci_high': hi, 'p_value': p,
          'significant': sig}


if __name__ == '__main__':
  main()
