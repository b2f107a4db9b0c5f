"""Example evaluation CLI: RMSE/MSE with area weighting and region bins.

The port of ``weatherbenchx_tpu/apps/run_evaluation.py``: the same flags
and metric/aggregation setup, plus ``--device`` (default ``cuda``; without
a GPU that raises, it never falls back to the CPU, and on a GPU the native
I/O libraries must build: the pure-Python codecs serve only CPU runs, as
``resolve_device`` says). ``--chunks_per_dispatch`` evaluates that many
chunks of one layout stacked on the device at once. The JAX CLI's
``--compilation_cache_dir`` has no counterpart here: nothing is compiled
per chunk shape.

Stores open lazily by ``io.open_dataset_auto`` (``.npz``, ``.wbx``, zarr v2
and v3 local or through fsspec, netCDF), and the outputs take the container
their suffix names.

Example:
  python -m weatherbenchx_tpu_torch.apps.run_evaluation \
      --prediction_path=preds.npz --target_path=targets.npz \
      --time_start=2020-01-01 --time_stop=2020-01-11 \
      --output_path=results.npz --device=cuda
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation, binning, native, weighting
from weatherbenchx_tpu_torch import time_chunks as time_chunks_lib
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import pipeline as pipeline_lib

DEFAULT_VARIABLES = [
    'geopotential',
    'temperature',
    'u_component_of_wind',
    'v_component_of_wind',
    'specific_humidity',
    '2m_temperature',
    'mean_sea_level_pressure',
]


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--prediction_path', required=True,
                 help='Forecasts to evaluate: a .npz, .wbx, .zarr (v2 or '
                      'v3, local or an fsspec URL) or netCDF store')
  p.add_argument('--target_path', required=True,
                 help='Ground truth, a store of the same kinds')
  p.add_argument('--time_start', default='2020-01-01',
                 help='ISO 8601 start of evaluation inits (inclusive)')
  p.add_argument('--time_stop', default='2020-12-31',
                 help='ISO 8601 end of evaluation inits (exclusive)')
  p.add_argument('--time_frequency', type=int, default=12,
                 help='Init frequency in hours')
  p.add_argument('--time_chunk_size', type=int, default=None)
  p.add_argument('--lead_time_start', type=int, default=0,
                 help='Lead time start in hours')
  p.add_argument('--lead_time_stop', type=int, default=24 * 10,
                 help='Lead time end in hours (exclusive)')
  p.add_argument('--lead_time_frequency', type=int, default=6,
                 help='Lead time frequency in hours')
  p.add_argument('--lead_time_chunk_size', type=int, default=None)
  p.add_argument('--levels', default=None,
                 help='Comma-delimited pressure levels to select')
  p.add_argument('--variables', default=','.join(DEFAULT_VARIABLES),
                 help='Comma-delimited variables to evaluate')
  p.add_argument('--reduce_dims', default='init_time,latitude,longitude',
                 help='Comma-delimited dims to reduce over')
  p.add_argument('--output_path', required=True,
                 help='File for metric results; the container by suffix '
                      '(.npz, .wbx, .zarr, .nc)')
  p.add_argument('--aggregation_state_output_path', default=None,
                 help='Optional file for the final AggregationState, the '
                      'container by suffix')
  p.add_argument('--checkpoint_path', default=None,
                 help='Optional running-state checkpoint path (resume)')
  p.add_argument('--checkpoint_every', type=int, default=0)
  p.add_argument('--chunks_per_dispatch', type=int, default=1,
                 help='Chunks of one layout evaluated together, stacked on '
                      'the device (one kernel launch for all of them)')
  p.add_argument('--load_retries', type=int, default=0,
                 help='Retries per chunk load on transient (I/O) failures, '
                      'with exponential backoff')
  p.add_argument('--load_retry_backoff', type=float, default=1.0,
                 help='First retry delay in seconds (doubles per attempt)')
  p.add_argument('--skip_failed_chunks', action='store_true',
                 help='Skip (and report in <output>.failures.json) chunks '
                      'whose transient failures survive all retries, '
                      'instead of failing the run')
  p.add_argument('--device', default='cuda',
                 help="Device the chunks are evaluated on: 'cuda' (the "
                      "default; raises without a GPU) or 'cpu'")
  return p


def resolve_device(name: str) -> torch.device:
  """The evaluation device named by ``--device``. A GPU must exist, and on
  it the native blockstore and zarr codec must build: the pure-Python
  codecs are the fallback of a machine without a toolchain evaluating on
  the CPU, never a quiet slower path beside a GPU."""
  device = torch.device(name)
  if device.type != 'cuda':
    return device
  if not torch.cuda.is_available():
    raise RuntimeError(
        f'--device={name}: no CUDA device is available (pass '
        '--device=cpu to evaluate on the CPU)')
  missing = [lib for lib, ok in (
      ('blockstore', native.blockstore_available()),
      ('zarrcodec', native.zarrcodec_available())) if not ok]
  if missing:
    raise RuntimeError(
        f'--device={name}: the native I/O libraries {missing} did not build '
        '(they need g++, zlib, libzstd.so.1 and liblz4.so.1; the log above '
        'says why)')
  return device


def retry_policy_from_args(args) -> Optional[pipeline_lib.RetryPolicy]:
  if not args.load_retries and not args.skip_failed_chunks:
    return None
  return pipeline_lib.RetryPolicy(
      retries=args.load_retries, backoff_s=args.load_retry_backoff,
      skip_failed=args.skip_failed_chunks)


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)

  init_times = np.arange(
      args.time_start, args.time_stop,
      np.timedelta64(args.time_frequency, 'h'), dtype='datetime64[ns]')
  lead_times = np.arange(
      args.lead_time_start, args.lead_time_stop, args.lead_time_frequency,
      dtype='timedelta64[h]').astype('timedelta64[ns]')
  times = time_chunks_lib.TimeChunks(
      init_times, lead_times,
      init_time_chunk_size=args.time_chunk_size,
      lead_time_chunk_size=args.lead_time_chunk_size)

  variables = [v for v in args.variables.split(',') if v]
  sel_kwargs = ({'level': [int(l) for l in args.levels.split(',')]}
                if args.levels else None)

  target_loader = loaders.TargetsFromDataset(
      path=args.target_path, variables=variables, sel_kwargs=sel_kwargs)
  prediction_loader = loaders.PredictionsFromDataset(
      path=args.prediction_path, variables=variables, sel_kwargs=sel_kwargs)

  all_metrics = {'rmse': deterministic.RMSE(), 'mse': deterministic.MSE()}
  regions = {
      'global': ((-90, 90), (0, 360)),
      'northern-hemisphere': ((20, 90), (0, 360)),
  }
  aggregation_method = aggregation.Aggregator(
      reduce_dims=[d for d in args.reduce_dims.split(',') if d],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(regions)])

  values = pipeline_lib.evaluate(
      all_metrics, aggregation_method, prediction_loader, target_loader,
      times,
      out_path=args.output_path,
      aggregation_state_out_path=args.aggregation_state_output_path,
      device=device,
      checkpoint_path=args.checkpoint_path,
      checkpoint_every=args.checkpoint_every,
      chunks_per_dispatch=args.chunks_per_dispatch,
      retry=retry_policy_from_args(args))
  print(f'Wrote {len(values)} metric variables to {args.output_path}')
  for k, v in sorted(values.items()):
    print(f'  {k}: dims={v.dims} shape={v.shape}')


if __name__ == '__main__':
  main()
