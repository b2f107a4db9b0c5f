"""Year-scale 0.25-degree streaming-evaluation demo, and its 50-member month.

The port of ``tools/stream_scale_demo.py``. It validates the lazy
windowed-read path at production scale: a store far larger than a chunk
evaluates chunk by chunk with bounded host memory, since the process holds
only the chunks in flight (the pipeline's prefetch), whatever the store's
size. Two workloads:

* ``--ens``: the north-star month. A 0.25-degree 50-member ensemble of 31
  daily inits (6.4 GB as zarr v2 blosc, ``init_time`` cells of 4) against
  its analyses: fair CRPS (sorted form), the unbiased spread/skill ratio
  and the RMSE of the ensemble mean, area-weighted. The fused ensemble
  kernel carries it on a GPU.
* otherwise: a 6-hourly year (1,460 inits x 2 leads, 18 GB as ``.wbx``):
  RMSE and MSE over a global and a northern bin.

Both flip the stores' descending latitudes on read, as real ERA5 stores
need. ``--store_dir``, ``--n_init``, ``--members`` and ``--grid`` cut the
sizes (the defaults are the JAX tool's). ``--run`` prints one JSON line:
the metric values unrounded; wall seconds; the store's size; the host RSS
once the modules are imported (before the device is touched), before the
first chunk (the pipeline built and the device's context made; with the
peak RSS by then), after the third chunk and at the end, and its peak
(sampled every 10 ms); one chunk's host bytes; each chunk's seconds (from
one chunk's completion to the next) with their medians and means over
chunks 2-6 and over the last 5 (two prefetch threads load two chunks at
once, so chunks tend to finish in pairs: the means give the rate); the
stage timers' medians over the same chunks; the native codec's seconds;
the kernel launches.
``--checkpoint_path``/``--checkpoint_every`` go to the pipeline's
checkpoints, and a rerun resumes from them; ``--output`` writes the metric
values (``run_and_write``), so that two runs compare bit for bit. At the
full deterministic size the run fails unless the peak RSS is below a
third of the store.

Usage:
  python -m weatherbenchx_tpu_torch.tools.stream_scale_demo --make_store
      [--ens] [--format=wbx|zarr] [--compressor=none|zstd|blosc]
  python -m weatherbenchx_tpu_torch.tools.stream_scale_demo --run [--ens]
      [--device cpu] [--chunk=32] [--format=wbx|zarr]
The month as it is meant to run, on the card:
  ... --make_store --ens --format zarr --compressor blosc
  ... --run --ens --format zarr --chunk 4

Run ``--make_store`` and ``--run`` as separate invocations so that the
store's generation stays out of the evaluation's RSS. ``--device cuda``,
the default, raises without a GPU.
"""

import argparse
import collections
import dataclasses
import json
import os
import statistics
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation, binning, native, observability
from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch import time_chunks as time_chunks_lib
from weatherbenchx_tpu_torch import weighting, zarr_io
from weatherbenchx_tpu_torch.apps import run_evaluation
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import deterministic, probabilistic
from weatherbenchx_tpu_torch.metrics import wrappers
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import pipeline as pipeline_lib

STORE_DIR = '/tmp/stream'
N_INIT = 1460  # 1 year, 6-hourly (deterministic mode)
N_LEAD = 2
NLAT, NLON = 721, 1440
ENS_N_INIT = 31  # ensemble mode: 1 month daily, north-star metric set
ENS_MEMBERS = 50
# The month's metrics share one fused ensemble pass per chunk: CRPS and
# the spread/skill ratio read its statistics through the compute-pass
# memo (counted on the CPU by tests/test_torch_demos.py).
FUSED_LAUNCHES_PER_CHUNK = 1
# The year's bins.
YEAR_REGIONS = {'global': ((-90, 90), (0, 360)), 'nh': ((20, 90), (0, 360))}
# Chunks whose seconds and stage timers are reported apart: the 2nd to the
# 6th (past the first chunk's start-up), and the last ones.
EARLY_CHUNKS = slice(1, 6)
LAST_CHUNKS = 5


@dataclasses.dataclass(frozen=True)
class Sizes:
  """Where the stores live and how large they are."""

  store_dir: str = STORE_DIR
  n_init: int = N_INIT
  members: int = ENS_MEMBERS
  nlat: int = NLAT
  nlon: int = NLON

  @property
  def full(self) -> bool:
    """The JAX tool's deterministic size."""
    return (self.n_init, self.nlat, self.nlon) == (N_INIT, NLAT, NLON)


def store_paths(sizes: Sizes, fmt: str, ens: bool = False
                ) -> tuple[str, str]:
  """(targets, predictions) store paths."""
  tag = 'ens_' if ens else ''
  return (f'{sizes.store_dir}/{tag}era5.{fmt}',
          f'{sizes.store_dir}/{tag}preds.{fmt}')


def store_gb(sizes: Sizes, fmt: str, ens: bool = False) -> float:
  total = 0
  for p in store_paths(sizes, fmt, ens=ens):
    if os.path.isdir(p):
      total += sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(p) for f in fs)
    else:
      total += os.path.getsize(p)
  return total / 1e9


def _grid(sizes: Sizes) -> tuple[np.ndarray, np.ndarray]:
  """Latitudes descending, like real ERA5 stores; longitudes."""
  return (np.linspace(90, -90, sizes.nlat),
          np.linspace(0, 360, sizes.nlon, endpoint=False))


def _filler(sizes: Sizes, tile: np.ndarray):
  """``filled(shape)``: float32 (*shape, lat, lon) slabs from a small random
  tile, full-entropy content at memcpy speed; slab i's corner holds i, so
  no two slabs are equal."""
  def filled(shape):
    out = np.empty(tuple(shape) + (sizes.nlat, sizes.nlon), np.float32)
    flat = out.reshape(-1, sizes.nlat, sizes.nlon)
    for i in range(flat.shape[0]):
      flat[i] = tile[i % tile.shape[0]]
      flat[i, 0, 0] = i
    return out
  return filled


def _save(path: str, ds: dict, fmt: str, chunks: dict, compressor) -> None:
  if fmt == 'zarr':
    zarr_io.save_dataset_zarr(path, ds, chunks=chunks, compressor=compressor)
  else:
    io_lib.save_dataset(path, ds)


def _ens_times(sizes: Sizes) -> tuple[np.ndarray, np.ndarray]:
  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(sizes.n_init) * np.timedelta64(24, 'h'))
  lead_times = np.array([np.timedelta64(24, 'h')], 'timedelta64[ns]')
  return init_times, lead_times


def make_ens_store(sizes: Sizes, fmt: str = 'zarr',
                   compressor: Optional[str] = 'blosc') -> float:
  """Writes the month's stores; returns their GB on disk."""
  os.makedirs(sizes.store_dir, exist_ok=True)
  rng = np.random.default_rng(1)
  init_times, lead_times = _ens_times(sizes)
  valid_times = init_times + lead_times[0]
  lats, lons = _grid(sizes)
  filled = _filler(sizes, rng.standard_normal(
      (8, sizes.nlat, sizes.nlon)).astype(np.float32))

  tgt_path, pred_path = store_paths(sizes, fmt, ens=True)
  _save(tgt_path, {'2m_temperature': DimArray(
      filled((sizes.n_init,)), ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})},
        fmt, {'valid_time': 4}, compressor)
  _save(pred_path, {'2m_temperature': DimArray(
      filled((sizes.members, sizes.n_init, 1)),
      ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(sizes.members), 'init_time': init_times,
       'lead_time': lead_times, 'latitude': lats, 'longitude': lons})},
        fmt, {'init_time': 4, 'number': sizes.members}, compressor)
  gb = store_gb(sizes, fmt, ens=True)
  print(f'wrote ensemble store ({fmt}, {compressor}): {gb:.1f} GB')
  return gb


def _det_times(sizes: Sizes) -> tuple[np.ndarray, np.ndarray]:
  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(sizes.n_init) * np.timedelta64(6, 'h'))
  lead_times = (np.arange(N_LEAD) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')
  return init_times, lead_times


def make_store(sizes: Sizes, fmt: str = 'wbx',
               compressor: Optional[str] = None) -> float:
  """Writes the year's stores; returns their GB on disk."""
  os.makedirs(sizes.store_dir, exist_ok=True)
  rng = np.random.default_rng(0)
  init_times, lead_times = _det_times(sizes)
  valid_times = (np.datetime64('2020-01-01', 'ns')
                 + np.arange(sizes.n_init + N_LEAD) * np.timedelta64(6, 'h'))
  lats, lons = _grid(sizes)
  filled = _filler(sizes, rng.standard_normal(
      (8, sizes.nlat, sizes.nlon)).astype(np.float32))

  tgt_path, pred_path = store_paths(sizes, fmt)
  _save(tgt_path, {'2m_temperature': DimArray(
      filled((sizes.n_init + N_LEAD,)),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})},
        fmt, {'valid_time': 8}, compressor)
  _save(pred_path, {'2m_temperature': DimArray(
      filled((sizes.n_init, N_LEAD)),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': init_times, 'lead_time': lead_times,
       'latitude': lats, 'longitude': lons})},
        fmt, {'init_time': 8}, compressor)
  gb = store_gb(sizes, fmt)
  print(f'wrote {sizes.store_dir} ({fmt}, {compressor}): {gb:.1f} GB')
  return gb


def rss_gb() -> float:
  """This process's resident set now (Linux), in GB."""
  with open('/proc/self/statm') as f:
    pages = int(f.read().split()[1])
  return pages * os.sysconf('SC_PAGE_SIZE') / 1e9


class RssPeak:
  """The peak of this process's RSS while the context is open, sampled by
  a thread every ``interval`` seconds. Not ``ru_maxrss``: a process that a
  large one spawned (``subprocess`` forks or vforks, then execs) inherits
  the parent's peak there."""

  def __init__(self, interval: float = 0.01):
    self.interval = interval
    self.peak = rss_gb()
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._sample, daemon=True)

  def _sample(self) -> None:
    while not self._stop.wait(self.interval):
      self.peak = max(self.peak, rss_gb())

  def __enter__(self) -> 'RssPeak':
    self._thread.start()
    return self

  def __exit__(self, *exc) -> None:
    self._stop.set()
    self._thread.join()
    self.peak = max(self.peak, rss_gb())


class ChunkRecorder(observability.Metrics):
  """The pipeline's registry, which also keeps every timer sample in the
  order recorded, the monotonic time at which each chunk was done, and the
  RSS once the third chunk is done."""

  def __init__(self):
    super().__init__()
    self.samples: dict[str, list] = collections.defaultdict(list)
    self.done_at: list[float] = []
    self.rss_after_chunk_3: Optional[float] = None

  def record(self, name: str, seconds: float) -> None:
    super().record(name, seconds)
    with self._lock:
      self.samples[name].append(seconds)

  def counter(self, name: str, increment: int = 1) -> None:
    super().counter(name, increment)
    if name == 'chunks_done':
      self.done_at.append(time.monotonic())
      if len(self.done_at) == 3:
        self.rss_after_chunk_3 = rss_gb()


def _median(values) -> Optional[float]:
  return statistics.median(values) if values else None


def _mean(values) -> Optional[float]:
  return statistics.fmean(values) if values else None


def _sort_lat(ds):
  return {k: (v.sortby('latitude') if 'latitude' in v.dims else v)
          for k, v in ds.items()}


def _stream(metrics, aggregator, sizes: Sizes, fmt: str, ens: bool,
            times: time_chunks_lib.TimeChunks, device: torch.device,
            checkpoint_path: Optional[str], checkpoint_every: int,
            output: Optional[str]) -> tuple[dict, dict]:
  """Runs the pipeline over the stores; (metric values, the report)."""
  rss_start = rss_gb()
  tgt_path, pred_path = store_paths(sizes, fmt, ens=ens)
  recorder = ChunkRecorder()
  with RssPeak() as peak:
    pipe = pipeline_lib.EvaluationPipeline(
        metrics=metrics, aggregator=aggregator,
        predictions_loader=loaders.PredictionsFromDataset(
            path=pred_path, rename_dimensions=None,
            preprocessing_fn=_sort_lat),
        targets_loader=loaders.TargetsFromDataset(
            path=tgt_path, rename_dimensions=None,
            preprocessing_fn=_sort_lat),
        times=times, device=device, prefetch=2,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        metrics_registry=recorder)
    torch.zeros((), device=device)  # the CUDA context counts in the baseline
    crps_pairwise.reset_launch_counts()
    native.reset_call_counts()
    rss_before, peak_before = rss_gb(), max(peak.peak, rss_gb())
    t0 = time.monotonic()
    values = pipe.run_and_write(output)
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
  ends = [t0] + recorder.done_at
  chunk_s = [b - a for a, b in zip(ends, ends[1:])]
  timers = {name: {'chunks_2_6': _median(s[EARLY_CHUNKS]),
                   f'last_{LAST_CHUNKS}': _median(s[-LAST_CHUNKS:]),
                   'total': sum(s)}
            for name, s in sorted(recorder.samples.items())}
  report = {
      'device': str(device),
      'device_name': (torch.cuda.get_device_name(device)
                      if device.type == 'cuda' else 'cpu'),
      'format': fmt, 'wall_seconds': wall,
      'store_gb': store_gb(sizes, fmt, ens=ens),
      'rss_start_gb': rss_start, 'rss_before_gb': rss_before,
      'peak_rss_before_gb': peak_before,
      'rss_after_chunk_3_gb': recorder.rss_after_chunk_3,
      'rss_end_gb': rss_gb(), 'peak_rss_gb': peak.peak,
      'chunks': len(times), 'chunks_run': len(chunk_s),
      'chunk_seconds': chunk_s,
      'chunk_s_median_2_6': _median(chunk_s[EARLY_CHUNKS]),
      f'chunk_s_median_last_{LAST_CHUNKS}': _median(chunk_s[-LAST_CHUNKS:]),
      'chunk_s_mean_2_6': _mean(chunk_s[EARLY_CHUNKS]),
      f'chunk_s_mean_last_{LAST_CHUNKS}': _mean(chunk_s[-LAST_CHUNKS:]),
      'timers': timers, 'native_seconds': dict(native.SECONDS),
      'launches': dict(crps_pairwise.LAUNCHES),
  }
  return values, report


def _first(values: dict, name: str) -> float:
  return float(np.asarray(values[name].values).ravel()[0])


def run_ens(sizes: Sizes, device: torch.device, chunk: int,
            fmt: str = 'zarr', checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, output: Optional[str] = None
            ) -> dict:
  """CRPS(sort) + unbiased spread/skill + ensemble-mean RMSE over the
  month's store (the production probabilistic metric set); prints and
  returns the report."""
  init_times, lead_times = _ens_times(sizes)
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'mean_rmse': wrappers.WrappedMetric(
          deterministic.RMSE(), [wrappers.EnsembleMean(
              which='predictions', ensemble_dim='number')]),
  }
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()])
  times = time_chunks_lib.TimeChunks(init_times, lead_times,
                                     init_time_chunk_size=chunk)
  values, stream = _stream(metrics, agg, sizes, fmt, True, times, device,
                           checkpoint_path, checkpoint_every, output)
  field = sizes.nlat * sizes.nlon
  report = {
      'mode': 'ensemble', **stream,
      'ens_gridpoints_per_second': (
          sizes.n_init * field * sizes.members / stream['wall_seconds']),
      'chunk_host_gb': min(chunk, sizes.n_init) * field * 4
                       * (sizes.members + 1) / 1e9,
      'crps_global': _first(values, 'crps.2m_temperature'),
      'spread_skill': _first(values, 'spread_skill.2m_temperature'),
      'mean_rmse': _first(values, 'mean_rmse.2m_temperature'),
  }
  print(json.dumps(report))
  return report


def run(sizes: Sizes, device: torch.device, chunk: int, fmt: str = 'wbx',
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
        output: Optional[str] = None) -> dict:
  """RMSE and MSE over the year's store in a global and a northern bin;
  prints and returns the report. Fails at the full size unless the peak
  RSS stayed below a third of the store."""
  init_times, lead_times = _det_times(sizes)
  metrics = {'rmse': deterministic.RMSE(), 'mse': deterministic.MSE()}
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(YEAR_REGIONS)])
  times = time_chunks_lib.TimeChunks(init_times, lead_times,
                                     init_time_chunk_size=chunk)
  values, stream = _stream(metrics, agg, sizes, fmt, False, times, device,
                           checkpoint_path, checkpoint_every, output)
  field = sizes.nlat * sizes.nlon
  pts = sizes.n_init * N_LEAD * field
  n = min(chunk, sizes.n_init)
  report = {
      'mode': 'deterministic', **stream, 'gridpoints': pts,
      'gridpoints_per_second': pts / stream['wall_seconds'],
      'chunk_host_gb': (n * N_LEAD + n + N_LEAD - 1) * field * 4 / 1e9,
      'rmse_global': _first(values, 'rmse.2m_temperature'),
  }
  print(json.dumps(report))
  if sizes.full and not report['peak_rss_gb'] < report['store_gb'] / 3:
    raise AssertionError(
        f'RSS {report["peak_rss_gb"]:.1f} GB not bounded vs store '
        f'{report["store_gb"]:.1f} GB')
  return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
  """Runs the flags' steps; returns {'store_gb': ..., 'report': ...} for
  the steps it ran."""
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--make_store', action='store_true')
  ap.add_argument('--run', action='store_true')
  ap.add_argument('--device', default='cuda',
                  help="'cuda' (the default; raises without a GPU) or 'cpu'")
  ap.add_argument('--chunk', type=int, default=32,
                  help='inits per chunk (the month runs best at 4, the '
                       "store's own cells)")
  ap.add_argument('--format', default='wbx', choices=['wbx', 'zarr'])
  ap.add_argument('--compressor', default='none',
                  choices=['none', 'zstd', 'blosc'])
  ap.add_argument('--ens', action='store_true',
                  help='month-scale 50-member CRPS workload instead of the '
                       'year-scale deterministic one')
  ap.add_argument('--store_dir', default=STORE_DIR)
  ap.add_argument('--n_init', type=int, default=None,
                  help=f'inits (default {N_INIT}, with --ens {ENS_N_INIT})')
  ap.add_argument('--members', type=int, default=ENS_MEMBERS)
  ap.add_argument('--grid', default=f'{NLON}x{NLAT}',
                  help='NLONxNLAT of the 0.25-degree default grid')
  ap.add_argument('--checkpoint_path', default=None)
  ap.add_argument('--checkpoint_every', type=int, default=0)
  ap.add_argument('--output', default=None,
                  help='writes the metric values here (e.g. values.npz)')
  args = ap.parse_args(argv)
  nlon, nlat = map(int, args.grid.split('x'))
  n_init = args.n_init or (ENS_N_INIT if args.ens else N_INIT)
  sizes = Sizes(args.store_dir, n_init, args.members, nlat, nlon)
  comp = None if args.compressor == 'none' else args.compressor
  out = {}
  if args.make_store:
    out['store_gb'] = (make_ens_store if args.ens else make_store)(
        sizes, args.format, comp)
  if args.run:
    device = run_evaluation.resolve_device(args.device)
    out['report'] = (run_ens if args.ens else run)(
        sizes, device, args.chunk, args.format, args.checkpoint_path,
        args.checkpoint_every, args.output)
  return out


if __name__ == '__main__':
  main()
