#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (weatherbenchx_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, each printing progress lines; any failed check raises, so the
script exits nonzero:

1. Device: requires a CUDA device; prints the card's name and power limit.
2. Build: compiles the port's CUDA kernels from ops/csrc with nvcc.
3. Kernels against their plain PyTorch versions on the card: several
   ensemble sizes and shapes, NaN members, |mean| >> std, float32 and
   bfloat16, and the main path's own shape.
4. Main path at full width: ChunkEvaluator with fair CRPS, the unbiased
   spread/skill ratio and the unbiased ensemble-mean RMSE over 3 chunks of
   a 50-member 0.25-degree ensemble (50 x 1 x 4 x 721 x 1440 float32,
   iid N(0, 1) from the seed), area-weighted over 3 regions and their land
   parts, masked. Checks one fused kernel launch per chunk, agreement with
   a float64 recomputation, and the closed forms for iid normals.
5. Timing with CUDA events: the fused kernel, its plain version, and one
   whole eval_chunk.

The line before the last is a JSON object describing the kernels of the
main path; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

M = 50
GRID = (1, 4, 721, 1440)  # init_time, lead_time, latitude, longitude
DEVICE = 'cuda'
N_CHUNKS = 3
# Tolerances, relative to max(|want|, 1), of a kernel against its plain
# version on identical input: float32 allows summation-order roundoff;
# bfloat16 outputs are rounded from float32 on both sides, so they may sit
# one bfloat16 step (2**-7 relative) apart.
KERNEL_RTOL = {'float32': 1e-5, 'bfloat16': 1e-2}
# Port metric values against the float64 recomputation.
F64_RTOL = 1e-5
# Closed forms for an iid N(0,1) ensemble against iid N(0,1) targets, with
# sampling tolerances of >= 7 standard errors for the smallest region
# (~1e5 gridpoints over 3 chunks).
CLOSED_FORMS = {'crps': (1 / math.sqrt(math.pi), 0.01),
                'spread_skill': (1.0, 0.02),
                'unbiased_mean_rmse': (1.0, 0.02)}
REGIONS = {'global': ((-90, 90), (0, 360)),
           'tropics': ((-20, 20), (0, 360)),
           'extratropics_north': ((20, 90), (0, 360))}


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def rel_err(got, want):
  """(NaN patterns equal, max |got-want| / max(|want|, 1), max abs err)."""
  import torch
  got, want = got.double(), want.double()
  same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
  ok = ~torch.isnan(want)
  diff = (got[ok] - want[ok]).abs()
  if diff.numel() == 0:
    return same_nan, 0.0, 0.0
  rel = (diff / want[ok].abs().clamp(min=1.0)).max().item()
  return same_nan, rel, diff.max().item()


def check_kernels(seed: int) -> dict:
  """Phase 3: both kernels against their plain versions on the card."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  rng = np.random.default_rng(seed)
  # (members, rest shape, NaN at (member, flat point) or None, offset, scale)
  cases = [
      (2, (1000,), None, 0.0, 1.0),
      (3, (1000,), (1, 17), 0.0, 1.0),
      (8, (3, 2, 37, 71), None, 0.0, 1.0),
      (21, (1, 2, 37, 71), (10, 500), 0.0, 1.0),
      (50, (4, 777), None, 288.0, 3.0),
      (50, (1, 2, 37, 71), (49, 0), 0.0, 1.0),
      (M, GRID, None, 0.0, 1.0),
  ]
  main_path_err = {}
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for m, rest, nan_at, offset, scale in cases:
      if rest == GRID and dtype != torch.float32:
        continue  # the main path runs float32
      x = (offset + scale * rng.standard_normal((m,) + rest, dtype=np.float32))
      y = (offset + scale * rng.standard_normal(rest, dtype=np.float32))
      if nan_at is not None:
        x.reshape(m, -1)[nan_at] = np.nan
      xd = torch.from_numpy(x).to(DEVICE, dtype)
      yd = torch.from_numpy(y).to(DEVICE, dtype)
      got = cp.fused_ensemble_stats(xd, yd) + (cp.pairwise_spread_sum(xd),)
      want = cp.fused_ensemble_stats_plain(xd, yd) + (
          cp.pairwise_spread_sum_plain(xd),)
      torch.cuda.synchronize()
      names = ('spread_sum', 'skill_sum', 'mean', 'sq_dev_sum', 'spread_only')
      worst = 0.0
      for name, g, w in zip(names, got, want):
        same_nan, rel, abs_err = rel_err(g, w)
        if not same_nan:
          raise AssertionError(f'{name} M={m} rest={rest} {dname}: NaN '
                               'pattern differs from the plain version')
        if rel > KERNEL_RTOL[dname]:
          raise AssertionError(f'{name} M={m} rest={rest} {dname}: rel err '
                               f'{rel:.3g} > {KERNEL_RTOL[dname]}')
        worst = max(worst, rel)
        if rest == GRID:
          main_path_err[name] = abs_err
      if nan_at is not None and not all(
          bool(torch.isnan(g.reshape(-1)[nan_at[1]])) for g in got):
        raise AssertionError(f'M={m}: NaN member did not poison its point')
      log(f'kernel check M={m} rest={rest} {dname} nan={nan_at is not None} '
          f'offset={offset}: max rel err {worst:.3g} '
          f'(tol {KERNEL_RTOL[dname]}) ok')
  return main_path_err


def grid_coords():
  """Ascending latitudes and longitudes of the GRID (0.25 degrees)."""
  nlat, nlon = GRID[2:]
  return (np.arange(nlat) * (180 / (nlat - 1)) - 90,
          np.arange(nlon) * (360 / nlon))


def make_chunk(seed: int, k: int):
  """One host chunk (predictions, targets) of the main-path configuration."""
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  rng = np.random.default_rng([seed, k])
  lat, lon = grid_coords()
  lat = lat[::-1].copy()  # north to south, as ERA5 stores it
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')
                             + k * np.timedelta64(12, 'h')]),
      'lead_time': (np.arange(GRID[1]) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
  }
  # A coverage mask that drops the two pole rows.
  mask = np.ones(GRID[2:], bool)
  mask[[0, -1]] = False
  coords['mask'] = Coord(('latitude', 'longitude'), mask)
  x = rng.standard_normal((M,) + GRID, dtype=np.float32)
  y = rng.standard_normal(GRID, dtype=np.float32)
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  preds = {'2m_temperature': DimArray(
      x, ('number',) + dims, dict(coords, number=np.arange(M)))}
  tgts = {'2m_temperature': DimArray(y, dims, coords)}
  return preds, tgts


def land_sea_mask():
  """A smooth synthetic land mask, stored south to north."""
  from weatherbenchx_tpu_torch.darray import DimArray
  lat, lon = grid_coords()
  land = (np.cos(np.deg2rad(lat))[:, None]
          * np.sin(3 * np.deg2rad(lon))[None, :]) > 0.3
  return DimArray(land, ('latitude', 'longitude'),
                  {'latitude': lat, 'longitude': lon})


def f64_reference(chunks, aggregator) -> dict:
  """Metric values recomputed in float64 with the plain versions on the card.

  Independent of the port's aggregation: explicit weighted sums over
  (init_time, latitude, longitude) per region and lead time.
  """
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  num, den = {}, None
  for preds, tgts in chunks:
    p, t = preds['2m_temperature'], tgts['2m_temperature']
    x = p.data.to(DEVICE, torch.float64)
    y = t.data.to(DEVICE, torch.float64)
    spread, skill, mean, sq_dev = cp.fused_ensemble_stats_plain(x, y)
    var = sq_dev / (M - 1)
    stats = {'skill': skill / M, 'spread': spread / (M * (M - 1)),
             'var': var, 'umse': (mean - y) ** 2 - var / M}
    w = torch.from_numpy(np.asarray(
        aggregator.weigh_by[0].weights(t).values, np.float64)).to(DEVICE)
    bins = torch.from_numpy(aggregator.bin_by[0].create_bin_mask(t).values
                            ).to(DEVICE).double()
    mask = torch.from_numpy(t.coords['mask'].values).to(DEVICE).double()
    wb = w[None, :, None] * mask[None] * bins  # (region, lat, lon)
    for k, s in stats.items():
      # s: (init, lead, lat, lon) -> (lead, region)
      part = (s[:, :, None] * wb[None, None]).sum((0, 3, 4))
      num[k] = num.get(k, 0) + part
    d = wb.sum((1, 2))[None, :] * s.shape[0]
    den = d if den is None else den + d
  mean_stat = {k: v / den for k, v in num.items()}
  return {
      'crps': mean_stat['skill'] - 0.5 * mean_stat['spread'],
      'spread_skill': torch.sqrt(mean_stat['var'] / mean_stat['umse']),
      'unbiased_mean_rmse': torch.sqrt(mean_stat['umse']),
  }


def main_path(seed: int):
  """Phase 4: the port's main path at full width, checked."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }
  aggregator = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(REGIONS, land_sea_mask=land_sea_mask())],
      masked=True)
  ev = evaluator.ChunkEvaluator(metrics, aggregator, device=DEVICE)
  t0 = time.perf_counter()
  chunks = [make_chunk(seed, k) for k in range(N_CHUNKS)]
  log(f'main path: made {N_CHUNKS} chunks of {M} x {GRID} float32 in '
      f'{time.perf_counter() - t0:.1f} s')

  cp.reset_launch_counts()
  t0 = time.perf_counter()
  states = [ev.eval_chunk(p, t) for p, t in chunks]
  values = aggregation.AggregationState.sum(states).metric_values(metrics)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = dict(cp.LAUNCHES)
  log(f'main path: {N_CHUNKS} chunks evaluated in {seconds:.2f} s, '
      f'kernel launches {launches}')
  if launches['fused_ensemble_stats'] != N_CHUNKS:
    raise AssertionError(f'expected {N_CHUNKS} fused launches (one per '
                         f'chunk), got {launches}')

  ref = f64_reference(chunks, aggregator)
  for name, (closed, tol) in CLOSED_FORMS.items():
    da = values[f'{name}.2m_temperature']
    if da.dims != ('lead_time', 'region') or da.shape != (GRID[1], 6):
      raise AssertionError(f'{name}: dims {da.dims} shape {da.shape}')
    got = da.data.double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'{name}: non-finite values {got}')
    rel = ((got - ref[name]).abs() / ref[name].abs()).max().item()
    if rel > F64_RTOL:
      raise AssertionError(f'{name}: rel err vs float64 {rel:.3g} > '
                           f'{F64_RTOL}')
    far = (got - closed).abs().max().item()
    if far > tol:
      raise AssertionError(f'{name}: {far:.4g} from the closed form '
                           f'{closed:.4f} (tol {tol})')
    log(f'main path {name}: mean {got.mean().item():.6f}, closed form '
        f'{closed:.6f} (max dev {far:.4g}, tol {tol}); rel err vs float64 '
        f'{rel:.3g} (tol {F64_RTOL}) ok')
  return ev, chunks, launches, seconds


def time_cuda(fns: dict, rounds: int) -> dict:
  """Median and IQR (ms) per function, CUDA events, taken in turns."""
  import torch
  samples = {k: [] for k in fns}
  names = list(fns)
  for r in range(rounds + 1):
    for name in (names if r % 2 == 0 else names[::-1]):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fns[name]()
      end.record()
      end.synchronize()
      if r:  # round 0 warms up
        samples[name].append(start.elapsed_time(end))
  return {k: (float(np.median(v)), float(np.percentile(v, 25)),
              float(np.percentile(v, 75)), len(v))
          for k, v in samples.items()}


def timing(ev, chunks, card: str) -> dict:
  """Phase 5: kernel vs plain at the main-path shape; one eval_chunk."""
  import torch
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  p, t = chunks[0]
  x = p['2m_temperature'].data.to(DEVICE)
  y = t['2m_temperature'].data.to(DEVICE)
  n = x[0].numel()
  res = time_cuda({
      'fused_kernel': lambda: cp.fused_ensemble_stats(x, y),
      'fused_plain': lambda: cp.fused_ensemble_stats_plain(x, y),
      'spread_kernel': lambda: cp.pairwise_spread_sum(x),
      'spread_plain': lambda: cp.pairwise_spread_sum_plain(x),
  }, rounds=12)
  pair = ev.prepare_pair(p, t)
  res.update(time_cuda({
      'eval_chunk (host chunk in)': lambda: ev.eval_chunk(p, t),
      'eval_accum (chunk on device)':
          lambda: ev.eval_accum(pair, AggregationState.zero()),
  }, rounds=10))
  for name, (med, q1, q3, count) in res.items():
    log(f'timing {name}: median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms '
        f'over {count} runs; M={M}, N={n}, float32; card {card}')
  return res


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args()

  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs only on the GPU',
          file=sys.stderr)
    return 1
  card = card_line()
  log(card)
  kind = torch.cuda.get_device_name(0)
  log(f'phase 1 device: {kind}, {torch.cuda.device_count()} device(s), '
      f'torch {torch.__version__}, CUDA {torch.version.cuda}')

  from weatherbenchx_tpu_torch.ops import _build
  t0 = time.perf_counter()
  lib_path = _build.build()
  _build.load_library()
  log(f'phase 2 build: {_build.SOURCE} -> {lib_path} in '
      f'{time.perf_counter() - t0:.1f} s')
  with open(lib_path + '.log') as f:
    for line in f:
      if 'registers' in line or 'spill' in line or 'Compiling' in line:
        log(f'  nvcc: {line.strip()}')

  main_err = check_kernels(args.seed)
  log('phase 3 kernels: all checks within tolerance')
  ev, chunks, launches, _ = main_path(args.seed)
  log('phase 4 main path: ok')
  res = timing(ev, chunks, card)
  log('phase 5 timing: done')

  print(json.dumps({'kernels': [{
      'name': 'fused_ensemble_stats',
      'route': 'cuda',
      'source': 'weatherbenchx_tpu_torch/ops/csrc/crps_pairwise.cu',
      'replaces': 'weatherbenchx_tpu/ops/crps_pairwise.py:238',
      'launches': launches['fused_ensemble_stats'],
      'max_abs_err': max(main_err[k] for k in (
          'spread_sum', 'skill_sum', 'mean', 'sq_dev_sum')),
      'ms': res['fused_kernel'][0],
      'plain_ms': res['fused_plain'][0],
  }]}), flush=True)
  print(card, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
