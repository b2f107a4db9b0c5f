"""Sparse (METAR-shaped) pipeline at realistic scale: throughput and
operand builds.

The port of ``tools/sparse_scale_demo.py``: the same generator and the
same pipeline. It writes a synthetic month of hive-partitioned station
observations (thousands of stations, hourly cadence, duplicate reports, QC
flags, elevations: the shape of WeatherBench-X's METAR input), then runs
the grid-to-sparse evaluation end to end:

  gridded forecast -> GridToSparseWithAltitudeAdjustment gather ->
  METARFromParquet targets (QC NaNing, closest-duplicate removal,
  pad-to-bucket) -> masked aggregation with BySets station-network bins
  + ByExactCoord lead bins -> AggregationState.

Prints ONE JSON line with wall time, observation throughput, and
``operand_builds``: the aggregation layouts the evaluator built
(``ChunkEvaluator.operand_builds``; the pad-to-bucket policy keeps them to
one per padded size), where the JAX tool counts XLA compilations.

The Parquet side needs pandas and pyarrow; without them it raises their
ImportError.

Usage:
  python -m weatherbenchx_tpu_torch.tools.sparse_scale_demo --stations 6000
      --days 31 [--device cpu]
"""

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import aggregation, binning, interpolations
from weatherbenchx_tpu_torch import time_chunks as tc
from weatherbenchx_tpu_torch.apps import run_evaluation
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.data import loaders, sparse_parquet
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import pipeline as pl


def generate_parquet_month(root, n_stations, days, freq_h=1, seed=0):
  """Writes year=2020/month=1 hive-partitioned METAR-shaped parquet."""
  import pandas as pd

  rng = np.random.default_rng(seed)
  lat = rng.uniform(-65, 75, n_stations)
  lon = rng.uniform(0, 360, n_stations)
  elev = np.abs(rng.normal(200, 350, n_stations))
  names = np.array([f'S{i:05d}' for i in range(n_stations)])
  times = np.arange(np.datetime64('2020-01-01'),
                    np.datetime64('2020-01-01') + np.timedelta64(days, 'D'),
                    np.timedelta64(freq_h, 'h'))
  frames = []
  n_rows = 0
  for t in times:
    # ~97% of stations report each cycle; ~1% file duplicate reports.
    present = rng.random(n_stations) < 0.97
    idx = np.where(present)[0]
    dup = idx[rng.random(len(idx)) < 0.01]
    rows_idx = np.concatenate([idx, dup])
    n = len(rows_idx)
    temp = (288 - 0.0065 * elev[rows_idx]
            - 25 * np.cos(np.deg2rad(lat[rows_idx]))
            + rng.standard_normal(n) * 3)
    qc = np.where(rng.random(n) < 0.02, 'Z', 'S')  # 2% bad-quality
    frames.append(pd.DataFrame({
        'timeNominal': np.repeat(t, n).astype('datetime64[ns]')
        + rng.integers(-15, 15, n) * np.timedelta64(1, 'm'),
        'stationName': names[rows_idx],
        'latitude': lat[rows_idx], 'longitude': lon[rows_idx],
        'elevation': elev[rows_idx],
        'temperature': temp.astype(np.float32),
        'temperatureDD': qc,
    }))
    n_rows += n
  df = pd.concat(frames, ignore_index=True)
  fn = os.path.join(root, 'year=2020', 'month=1', '2020-01.parquet')
  os.makedirs(os.path.dirname(fn), exist_ok=True)
  df.to_parquet(fn)
  return names, n_rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
  """Prints and returns the JSON line's fields."""
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--stations', type=int, default=6000)
  p.add_argument('--days', type=int, default=31)
  p.add_argument('--obs_freq_h', type=int, default=1)
  p.add_argument('--grid', default='240x121')
  p.add_argument('--pad_multiple', type=int, default=8192)
  p.add_argument('--init_freq_h', type=int, default=12)
  p.add_argument('--leads_h', default='6,12,24,48')
  p.add_argument('--cache_files', type=int, default=2)
  p.add_argument('--workdir', default='/tmp/wbx_sparse_demo')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default; raises without a GPU) or 'cpu'")
  args = p.parse_args(argv)
  device = run_evaluation.resolve_device(args.device)

  obs_root = os.path.join(
      args.workdir, f'obs_{args.stations}_{args.days}_{args.obs_freq_h}')
  marker = os.path.join(obs_root, 'done.json')
  if os.path.exists(marker):
    with open(marker) as f:
      names, n_rows = json.load(f)
    names = np.asarray(names)
  else:
    t0 = time.perf_counter()
    names, n_rows = generate_parquet_month(
        obs_root, args.stations, args.days, args.obs_freq_h)
    with open(marker, 'w') as f:
      json.dump([list(names), n_rows], f)
    print(f'# generated {n_rows} obs rows in '
          f'{time.perf_counter() - t0:.1f}s', file=sys.stderr)

  nlon, nlat = map(int, args.grid.split('x'))
  lats = np.linspace(-90, 90, nlat)
  lons = np.linspace(0, 360, nlon, endpoint=False)
  init_times = np.arange(
      np.datetime64('2020-01-01'),
      np.datetime64('2020-01-01') + np.timedelta64(args.days - 3, 'D'),
      np.timedelta64(args.init_freq_h, 'h')).astype('datetime64[ns]')
  lead_times = np.array([int(h) for h in args.leads_h.split(',')],
                        dtype='timedelta64[h]').astype('timedelta64[ns]')
  rng = np.random.default_rng(1)
  pred_ds = {'2m_temperature': DimArray(
      (288 + 3 * rng.standard_normal(
          (len(init_times), len(lead_times), nlat, nlon))).astype(np.float32),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': init_times, 'lead_time': lead_times,
       'latitude': lats, 'longitude': lons})}
  grid_elevation = DimArray(
      np.abs(200 + 300 * np.sin(np.deg2rad(lats))[:, None]
             * np.cos(3 * np.deg2rad(lons))[None, :]).astype(np.float32),
      ('latitude', 'longitude'), {'latitude': lats, 'longitude': lons})

  targets_loader = sparse_parquet.METARFromParquet(
      path=obs_root, variables=['2m_temperature'], time_dim='timeNominal',
      partitioned_by='month',
      tolerance=np.timedelta64(90, 'm'),
      remove_duplicates=True, pick_closest_duplicate_by='timeNominal',
      add_nan_mask=True,
      pad_index_multiple=args.pad_multiple,
      cache_files=args.cache_files)
  predictions_loader = loaders.PredictionsFromDataset(
      ds=pred_ds, rename_dimensions=None,
      interpolation=interpolations.GridToSparseWithAltitudeAdjustment(
          'linear', grid_elevation=grid_elevation, wrap_longitude=True))

  networks = {'even': [n for i, n in enumerate(names) if i % 2 == 0]}
  agg = aggregation.Aggregator(
      reduce_dims=['index'], masked=True,
      bin_by=[binning.BySets(networks, coord_name='stationName',
                             bin_dim_name='network',
                             add_set_complements=True, add_global_bin=True),
              binning.ByExactCoord('lead_time')])

  metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
  times = tc.TimeChunks(init_times, lead_times,
                        init_time_chunk_size=2, lead_time_chunk_size=4)
  pipe = pl.EvaluationPipeline(
      metrics=metrics, aggregator=agg, predictions_loader=predictions_loader,
      targets_loader=targets_loader, times=times, prefetch=2, device=device)

  t0 = time.perf_counter()
  values = pipe.run().metric_values(metrics)
  wall = time.perf_counter() - t0
  rmse = values['rmse.2m_temperature']
  n_chunks = len(times)
  out = {
      'metric': 'sparse_metar_month', 'device': str(device),
      'stations': args.stations, 'days': args.days,
      'obs_rows': n_rows, 'chunks': n_chunks,
      'wall_s': wall,
      'obs_per_sec': n_rows / wall,
      'chunks_per_sec': n_chunks / wall,
      'operand_builds': pipe._evaluator.operand_builds,
      'rmse_global': float(np.asarray(
          rmse.sel(network='global').values)[0]),
  }
  print(json.dumps(out))
  return out


if __name__ == '__main__':
  main()
