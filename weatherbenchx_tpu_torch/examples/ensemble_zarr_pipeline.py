"""Chunked ensemble evaluation from a Zarr store, with unaggregated output.

The port of ``examples/ensemble_zarr_pipeline.py``, the production shape:
write a blosc-compressed Zarr forecast store of 8 members, stream it
chunk-by-chunk through the pipeline computing CRPS + spread/skill +
ensemble-mean RMSE (the fused ensemble kernel at M = 8 on a GPU), and tee
the raw per-point statistics into a second Zarr store from the same pass.

Run: python -m weatherbenchx_tpu_torch.examples.ensemble_zarr_pipeline
[--device cpu] (writes into a new temporary directory; ``--device cuda``,
the default, raises without a GPU)
"""

import tempfile
from typing import Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import aggregation, weighting, zarr_io
from weatherbenchx_tpu_torch import time_chunks as tc
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.examples import parse_device
from weatherbenchx_tpu_torch.metrics import deterministic, probabilistic
from weatherbenchx_tpu_torch.metrics import wrappers
from weatherbenchx_tpu_torch.parallel import pipeline as pipeline_lib
from weatherbenchx_tpu_torch.parallel import unaggregated


def main(argv: Optional[Sequence[str]] = None) -> dict[str, DimArray]:
  """Prints the metric values and the unaggregated store's shapes;
  returns the metric values."""
  device = parse_device(argv, __doc__)
  tmp = tempfile.mkdtemp(prefix='wbx_example_')
  rng = np.random.default_rng(0)
  lats = np.linspace(-90, 90, 19)
  lons = np.linspace(0, 360, 36, endpoint=False)
  init = np.datetime64('2020-01-01', 'ns') + np.arange(8) * np.timedelta64(
      12, 'h')
  lead = np.array([12, 24], 'timedelta64[h]').astype('timedelta64[ns]')
  valid = np.datetime64('2020-01-01', 'ns') + np.arange(
      10) * np.timedelta64(12, 'h')

  # Forecast: 8 members; targets: deterministic analysis at valid_time.
  zarr_io.save_dataset_zarr(f'{tmp}/preds.zarr', {'t2m': DimArray(
      rng.standard_normal((8, 8, 2, 19, 36)).astype(np.float32),
      ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(8), 'init_time': init, 'lead_time': lead,
       'latitude': lats, 'longitude': lons})},
      chunks={'init_time': 2}, compressor='blosc')
  zarr_io.save_dataset_zarr(f'{tmp}/era5.zarr', {'t2m': DimArray(
      rng.standard_normal((10, 19, 36)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid, 'latitude': lats, 'longitude': lons})},
      chunks={'valid_time': 4}, compressor='blosc')

  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'mean_rmse': wrappers.WrappedMetric(
          deterministic.RMSE(),
          [wrappers.EnsembleMean(which='predictions',
                                 ensemble_dim='number')]),
  }
  times = tc.TimeChunks(init, lead, init_time_chunk_size=2)
  stats_store = unaggregated.ZarrStatsStore(times, f'{tmp}/stats.zarr',
                                            compressor='zstd')

  pipe = pipeline_lib.EvaluationPipeline(
      metrics=metrics,
      aggregator=aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()]),
      predictions_loader=loaders.PredictionsFromDataset(
          path=f'{tmp}/preds.zarr', rename_dimensions=None),
      targets_loader=loaders.TargetsFromDataset(
          path=f'{tmp}/era5.zarr', rename_dimensions=None),
      times=times,
      chunk_stats_sink=stats_store.write_chunk,
      device=device)

  values = pipe.run().metric_values(metrics)
  stats_store.finalize()

  for name, da in values.items():
    print(f'{name}: dims={da.dims} values={np.asarray(da.values).round(3)}')
  raw = unaggregated.load_unaggregated(f'{tmp}/stats.zarr')
  print('unaggregated statistics:', {k: v.shape for k, v in raw.items()})
  return values


if __name__ == '__main__':
  main()
