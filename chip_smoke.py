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
   bfloat16, 1-D input, and the main paths' own shapes.
4. Main path at full width: ChunkEvaluator with fair CRPS, the unbiased
   spread/skill ratio and the unbiased ensemble-mean RMSE over 3 chunks of
   a 50-member 0.25-degree ensemble (50 x 1 x 4 x 721 x 1440 float32,
   iid N(0, 1) from the seed), area-weighted over 3 regions and their land
   parts, masked. Checks one fused kernel launch per chunk, agreement with
   a float64 recomputation, and the closed forms for iid normals.
5. Ensemble-vs-ensemble path at full width: pipeline.evaluate over
   in-memory stores, 50 forecast members (3 inits x 4 leads x 721 x 1440,
   iid N(0, 1)) against a 10-member ensemble analysis (8 valid times, iid
   N(0.5, 1)), 3 chunks of one init: energy-distance CRPS, fair CRPS and
   the unbiased ensemble-mean RMSE, same weights and bins, masked. Checks
   the launch counts (one cross and two spread launches per chunk, no
   fused), agreement with a float64 recomputation, and the closed forms.
6. The evaluation CLI (python -m weatherbenchx_tpu_torch.apps.run_evaluation
   --device cuda) on a small .npz store in a temporary directory: RMSE of
   N(0, 1) against N(0, 1) is sqrt(2).
7. Timing with CUDA events: each kernel against its plain version at its
   path's shape, one whole eval_chunk, and the pipeline's seconds per chunk.

The line before the last is a JSON object describing the kernels of the
two paths; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
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
# The ensemble-vs-ensemble path: 50 forecast members against a 10-member
# ensemble analysis (ERA5's EDA member count), 3 inits 12 h apart, each
# one chunk of the GRID's 4 leads 6 h apart, so 8 valid times.
M_TARGETS = 10
N_ENS_INITS = 3
N_VALID = 8
TARGET_MEAN = 0.5
# E|X - Y| for X ~ N(0, 1), Y ~ N(0.5, 1): X - Y ~ N(-0.5, 2), so
# E|X - Y| = (2/sqrt(pi)) exp(-1/16) + 0.5 erf(1/4) = 1.198177; and
# E|X - X'| = E|Y - Y'| = 2/sqrt(pi). Tolerances: per-gridpoint standard
# deviations 0.113 (energy distance), 0.157 (CRPS) and 0.388 (unbiased
# ensemble-mean MSE) by simulation; the smallest bin (tropics land, ~93k
# gridpoints per init) has an area-weighted effective size of 278,660 over
# the 3 inits, so standard errors 2.1e-4, 3.0e-4 and 7.4e-4 (RMSE); the
# tolerances are 9.4, 10 and 8.2 of them.
E_ABS_XY = 2 / math.sqrt(math.pi) * math.exp(-1 / 16) + 0.5 * math.erf(0.25)
ENS_CLOSED_FORMS = {
    'energy_distance': (E_ABS_XY - 2 / math.sqrt(math.pi), 0.002),
    'crps': (E_ABS_XY - 1 / math.sqrt(math.pi), 0.003),
    'unbiased_mean_rmse': (TARGET_MEAN, 0.006),
}
# The CLI phase: N(0, 1) forecasts against N(0, 1) analyses on a 1.5-degree
# grid, 8 inits x 2 leads. RMSE = sqrt(2); its standard error in the
# northern-hemisphere bin (effective size 70,263) is 3.8e-3; the
# tolerance is 7.9 of them.
CLI_GRID = (121, 240)
CLI_RMSE_TOL = 0.03


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
  main_path_err['cross'] = check_cross_kernel(rng)
  return main_path_err


def check_cross_kernel(rng) -> float:
  """The cross kernel against its plain version; max abs err at the path's
  shape."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  # (Mx, My, rest shape, NaN at (side, member, flat point) or None, offset,
  # scale)
  cases = [
      (1, 1, (1000,), None, 0.0, 1.0),
      (3, 5, (3, 2, 37, 71), None, 0.0, 1.0),
      (8, 2, (1, 2, 37, 71), ('x', 7, 500), 0.0, 1.0),
      (25, 25, (1, 2, 37, 71), ('y', 24, 0), 0.0, 1.0),
      (50, 10, (4, 777), None, 288.0, 3.0),
      (50, 50, (1, 2, 37, 71), ('y', 3, 4000), 0.0, 1.0),
      (6, 4, (), None, 0.0, 1.0),  # 1-D input
      (M, M_TARGETS, GRID, None, 0.0, 1.0),
  ]
  path_err = None
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for mx, my, rest, nan_at, offset, scale in cases:
      if rest == GRID and dtype != torch.float32:
        continue  # the path runs float32
      x = offset + scale * rng.standard_normal((mx,) + rest, dtype=np.float32)
      y = offset + scale * rng.standard_normal((my,) + rest, dtype=np.float32)
      if nan_at is not None:
        side, member, point = nan_at
        poisoned = x if side == 'x' else y
        poisoned.reshape(poisoned.shape[0], -1)[member, point] = np.nan
      xd = torch.from_numpy(x).to(DEVICE, dtype)
      yd = torch.from_numpy(y).to(DEVICE, dtype)
      got = cp.pairwise_cross_sum(xd, yd)
      want = cp.pairwise_cross_sum_plain(xd, yd)
      torch.cuda.synchronize()
      same_nan, rel, abs_err = rel_err(got, want)
      if got.shape != rest or got.dtype != dtype:
        raise AssertionError(f'cross Mx={mx} My={my} {dname}: shape '
                             f'{tuple(got.shape)} dtype {got.dtype}')
      if not same_nan:
        raise AssertionError(f'cross Mx={mx} My={my} rest={rest} {dname}: '
                             'NaN pattern differs from the plain version')
      if rel > KERNEL_RTOL[dname]:
        raise AssertionError(f'cross Mx={mx} My={my} rest={rest} {dname}: '
                             f'rel err {rel:.3g} > {KERNEL_RTOL[dname]}')
      if nan_at is not None and not (
          bool(torch.isnan(got.reshape(-1)[nan_at[2]]))
          and int(torch.isnan(got).sum()) == 1):
        raise AssertionError(f'cross Mx={mx} My={my}: a NaN member must '
                             'poison its own point and no other')
      if rest == GRID:
        path_err = abs_err
      log(f'cross kernel check Mx={mx} My={my} rest={rest} {dname} '
          f'nan={nan_at is not None} offset={offset}: max rel err {rel:.3g} '
          f'(tol {KERNEL_RTOL[dname]}) ok')
  return path_err


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


def bin_weights(aggregator, da):
  """Area weights x mask x region bins, (region, lat, lon) float64 on the
  card, for a DimArray with latitude, longitude and mask coords."""
  import torch
  w = torch.from_numpy(np.asarray(
      aggregator.weigh_by[0].weights(da).values, np.float64)).to(DEVICE)
  bins = torch.from_numpy(aggregator.bin_by[0].create_bin_mask(da).values
                          ).to(DEVICE).double()
  mask = torch.from_numpy(np.asarray(da.coords['mask'].values)).to(
      DEVICE).double()
  return w[None, :, None] * mask[None] * bins


def weighted_means(stat_chunks, wb) -> dict:
  """Explicit weighted means per (lead, region) of per-chunk statistics.

  stat_chunks: one {name: (init, lead, lat, lon) tensor} per chunk; wb:
  (region, lat, lon) weights. Sums over (init, lat, lon) in float64.
  """
  num, den = {}, 0
  for stats in stat_chunks:
    for k, s in stats.items():
      num[k] = num.get(k, 0) + (s[:, :, None] * wb[None, None]).sum((0, 3, 4))
    den = den + wb.sum((1, 2))[None, :] * s.shape[0]
  return {k: v / den for k, v in num.items()}


def f64_reference(chunks, aggregator) -> dict:
  """Metric values recomputed in float64 with the plain versions on the card.

  Independent of the port's aggregation: explicit weighted sums over
  (init_time, latitude, longitude) per region and lead time.
  """
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  stat_chunks = []
  for preds, tgts in chunks:
    x = preds['2m_temperature'].data.to(DEVICE, torch.float64)
    y = tgts['2m_temperature'].data.to(DEVICE, torch.float64)
    spread, skill, mean, sq_dev = cp.fused_ensemble_stats_plain(x, y)
    var = sq_dev / (M - 1)
    stat_chunks.append({'skill': skill / M, 'spread': spread / (M * (M - 1)),
                        'var': var, 'umse': (mean - y) ** 2 - var / M})
  mean_stat = weighted_means(stat_chunks,
                             bin_weights(aggregator, chunks[0][1][
                                 '2m_temperature']))
  return {
      'crps': mean_stat['skill'] - 0.5 * mean_stat['spread'],
      'spread_skill': torch.sqrt(mean_stat['var'] / mean_stat['umse']),
      'unbiased_mean_rmse': torch.sqrt(mean_stat['umse']),
  }


def region_aggregator():
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  return aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(REGIONS, land_sea_mask=land_sea_mask())],
      masked=True)


def check_values(path: str, values: dict, ref: dict, closed_forms: dict
                 ) -> None:
  """Each metric: dims, finite, within F64_RTOL of float64, near its closed
  form."""
  import torch
  for name, (closed, tol) in closed_forms.items():
    da = values[f'{name}.2m_temperature']
    if da.dims != ('lead_time', 'region') or da.shape != (GRID[1], 6):
      raise AssertionError(f'{path} {name}: dims {da.dims} shape {da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'{path} {name}: non-finite values {got}')
    rel = ((got - ref[name]).abs() / ref[name].abs()).max().item()
    if rel > F64_RTOL:
      raise AssertionError(f'{path} {name}: rel err vs float64 {rel:.3g} > '
                           f'{F64_RTOL}')
    far = (got - closed).abs().max().item()
    if far > tol:
      raise AssertionError(f'{path} {name}: {far:.4g} from the closed form '
                           f'{closed:.6f} (tol {tol})')
    log(f'{path} {name}: mean {got.mean().item():.6f}, closed form '
        f'{closed:.6f} (max dev {far:.4g}, tol {tol}); rel err vs float64 '
        f'{rel:.3g} (tol {F64_RTOL}) ok')


def main_path(seed: int):
  """Phase 4: the port's main path at full width, checked."""
  import torch
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }
  aggregator = region_aggregator()
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
  if launches != {'fused_ensemble_stats': N_CHUNKS, 'pairwise_spread_sum': 0,
                  'pairwise_cross_sum': 0}:
    raise AssertionError(f'expected {N_CHUNKS} fused launches (one per '
                         f'chunk) and no other, got {launches}')
  check_values('main path', values, f64_reference(chunks, aggregator),
               CLOSED_FORMS)
  return ev, chunks, launches, seconds


def ensemble_stores(seed: int):
  """(predictions, targets) in-memory stores of the ensemble path."""
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng([seed, 1000])
  lat, lon = grid_coords()
  lat = lat[::-1].copy()  # north to south, as ERA5 stores it
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(N_ENS_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(GRID[1]) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  valid = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(N_VALID) * np.timedelta64(6, 'h'))
  space = {'latitude': lat, 'longitude': lon}
  x = rng.standard_normal((M, N_ENS_INITS) + GRID[1:], dtype=np.float32)
  y = rng.standard_normal((M_TARGETS, N_VALID) + GRID[2:], dtype=np.float32)
  y += TARGET_MEAN
  preds = {'2m_temperature': DimArray(
      x, ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(M), 'init_time': inits, 'lead_time': leads,
       **space})}
  tgts = {'2m_temperature': DimArray(
      y, ('number', 'valid_time', 'latitude', 'longitude'),
      {'number': np.arange(M_TARGETS), 'valid_time': valid, **space})}
  return preds, tgts


def attach_mask(chunk):
  """process_chunk_fn: the coverage mask of the main path (no pole rows)."""
  from weatherbenchx_tpu_torch.darray import Coord
  mask = np.ones(GRID[2:], bool)
  mask[[0, -1]] = False
  return {k: da.assign_coords(mask=Coord(('latitude', 'longitude'), mask))
          for k, da in chunk.items()}


def ensemble_metrics():
  from weatherbenchx_tpu_torch.metrics import probabilistic
  return {
      'energy_distance': probabilistic.CRPSEnsembleDistance(use_sort=True),
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
  }


def run_ensemble_pipeline(stores, registry):
  """pipeline.evaluate over the stores on the card; (values, seconds)."""
  import torch
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.parallel import pipeline
  preds, tgts = stores
  times = time_chunks.TimeChunks(
      preds['2m_temperature'].coord_values('init_time'),
      preds['2m_temperature'].coord_values('lead_time'),
      init_time_chunk_size=1)
  t0 = time.perf_counter()
  values = pipeline.evaluate(
      ensemble_metrics(), region_aggregator(),
      loaders.PredictionsFromDataset(ds=preds, rename_dimensions=None,
                                     process_chunk_fn=attach_mask),
      loaders.TargetsFromDataset(ds=tgts, rename_dimensions=None,
                                 process_chunk_fn=attach_mask),
      times, device=DEVICE, metrics_registry=registry)
  torch.cuda.synchronize()
  return values, time.perf_counter() - t0


def ensemble_f64_reference(stores) -> dict:
  """The ensemble path's metric values in float64 with the plain versions
  on the card, gathered from the stores by index (valid = 2 init + lead)."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  preds, tgts = (s['2m_temperature'] for s in stores)
  mx, my = M, M_TARGETS
  stat_chunks = []
  for k in range(N_ENS_INITS):
    x = preds.data[:, k:k + 1].to(DEVICE, torch.float64)
    y = tgts.data[:, 2 * k:2 * k + GRID[1]][:, None].to(DEVICE, torch.float64)
    var_x, var_y = x.var(0, correction=1), y.var(0, correction=1)
    stat_chunks.append({
        'skill': cp.pairwise_cross_sum_plain(x, y) / (mx * my),
        'spread_x': cp.pairwise_spread_sum_plain(x) / (mx * (mx - 1)),
        'spread_y': cp.pairwise_spread_sum_plain(y) / (my * (my - 1)),
        'umse': (x.mean(0) - y.mean(0)) ** 2 - var_x / mx - var_y / my})
    del x, y
  grid = attach_mask({'g': DimArray(
      np.zeros(GRID[2:], np.float32), ('latitude', 'longitude'),
      {'latitude': preds.coord_values('latitude'),
       'longitude': preds.coord_values('longitude')})})['g']
  s = weighted_means(stat_chunks, bin_weights(region_aggregator(), grid))
  return {
      'energy_distance': s['skill'] - 0.5 * s['spread_x'] - 0.5 * s['spread_y'],
      'crps': s['skill'] - 0.5 * s['spread_x'],
      'unbiased_mean_rmse': torch.sqrt(s['umse']),
  }


def ensemble_path(seed: int):
  """Phase 5: the ensemble-vs-ensemble path through pipeline.evaluate."""
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  t0 = time.perf_counter()
  stores = ensemble_stores(seed)
  log(f'ensemble path: made stores of {M} x {N_ENS_INITS} x {GRID[1:]} and '
      f'{M_TARGETS} x {N_VALID} x {GRID[2:]} float32 in '
      f'{time.perf_counter() - t0:.1f} s')
  registry = observability.Metrics()
  cp.reset_launch_counts()
  values, seconds = run_ensemble_pipeline(stores, registry)
  launches = dict(cp.LAUNCHES)
  log(f'ensemble path: {N_ENS_INITS} chunks through pipeline.evaluate in '
      f'{seconds:.2f} s, kernel launches {launches}; '
      f'{registry.summary()!r}')
  want = {'fused_ensemble_stats': 0, 'pairwise_spread_sum': 2 * N_ENS_INITS,
          'pairwise_cross_sum': N_ENS_INITS}
  if launches != want:
    raise AssertionError(f'expected launches {want}, got {launches}')
  check_values('ensemble path', values, ensemble_f64_reference(stores),
               ENS_CLOSED_FORMS)
  return stores, launches


def cli_phase(seed: int) -> None:
  """Phase 6: the evaluation CLI on the card over a small .npz store."""
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng([seed, 2000])
  inits = np.arange('2020-01-01', '2020-01-05', np.timedelta64(12, 'h'),
                    dtype='datetime64[ns]')
  leads = np.array([0, 6], dtype='timedelta64[h]').astype('timedelta64[ns]')
  valid = np.arange('2020-01-01', '2020-01-05T12', np.timedelta64(6, 'h'),
                    dtype='datetime64[ns]')
  space = {'latitude': np.linspace(-90, 90, CLI_GRID[0]),
           'longitude': np.arange(CLI_GRID[1]) * (360 / CLI_GRID[1])}
  with tempfile.TemporaryDirectory() as tmp:
    p, t, out = (os.path.join(tmp, f) for f in ('p.npz', 't.npz', 'o.npz'))
    io.save_dataset(p, {'2m_temperature': DimArray(
        rng.standard_normal((len(inits), 2) + CLI_GRID, dtype=np.float32),
        ('time', 'prediction_timedelta', 'latitude', 'longitude'),
        {'time': inits, 'prediction_timedelta': leads, **space})})
    io.save_dataset(t, {'2m_temperature': DimArray(
        rng.standard_normal((len(valid),) + CLI_GRID, dtype=np.float32),
        ('time', 'latitude', 'longitude'), {'time': valid, **space})})
    cmd = [sys.executable, '-m', 'weatherbenchx_tpu_torch.apps.run_evaluation',
           '--device', 'cuda', f'--prediction_path={p}',
           f'--target_path={t}', f'--output_path={out}',
           '--time_start=2020-01-01', '--time_stop=2020-01-05',
           '--lead_time_stop=12', '--variables=2m_temperature',
           '--time_chunk_size=2']
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          check=False)
    if proc.returncode != 0:
      raise AssertionError(f'CLI failed ({proc.returncode}):\n'
                           f'{(proc.stdout + proc.stderr)[-4000:]}')
    rmse = io.load_dataset(out)['rmse.2m_temperature']
  far = float(np.abs(rmse.values - math.sqrt(2)).max())
  if rmse.shape != (2, 2) or not far <= CLI_RMSE_TOL:
    raise AssertionError(f'CLI rmse {rmse.values} (shape {rmse.shape}): '
                         f'{far:.4g} from sqrt(2), tol {CLI_RMSE_TOL}')
  log(f'cli: {len(inits)} inits x 2 leads x {CLI_GRID} in '
      f'{time.perf_counter() - t0:.1f} s; rmse {rmse.values.ravel()} vs '
      f'sqrt(2) (max dev {far:.4g}, tol {CLI_RMSE_TOL}) ok')


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


def timing(ev, chunks, stores, card: str) -> dict:
  """Phase 7: kernels vs plain at their paths' shapes; one eval_chunk; the
  ensemble pipeline's seconds per chunk."""
  import torch
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  p, t = chunks[0]
  x = p['2m_temperature'].data.to(DEVICE)
  y = t['2m_temperature'].data.to(DEVICE)
  yt = stores[1]['2m_temperature'].data[:, :GRID[1]][:, None].to(
      DEVICE).contiguous()
  n = x[0].numel()
  res = time_cuda({
      'fused_kernel': lambda: cp.fused_ensemble_stats(x, y),
      'fused_plain': lambda: cp.fused_ensemble_stats_plain(x, y),
      'spread_kernel': lambda: cp.pairwise_spread_sum(x),
      'spread_plain': lambda: cp.pairwise_spread_sum_plain(x),
      'cross_kernel': lambda: cp.pairwise_cross_sum(x, yt),
      'cross_plain': lambda: cp.pairwise_cross_sum_plain(x, yt),
  }, rounds=12)
  pair = ev.prepare_pair(p, t)
  res.update(time_cuda({
      'eval_chunk (host chunk in)': lambda: ev.eval_chunk(p, t),
      'eval_accum (chunk on device)':
          lambda: ev.eval_accum(pair, AggregationState.zero()),
  }, rounds=10))
  for name, (med, q1, q3, count) in res.items():
    shape = f'Mx={M}, My={M_TARGETS}' if 'cross' in name else f'M={M}'
    log(f'timing {name}: median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms '
        f'over {count} runs; {shape}, N={n}, float32; card {card}')
  del x, y, yt, pair
  registry = observability.Metrics()
  _, seconds = run_ensemble_pipeline(stores, registry)
  per_chunk = {k: d.mean for k, d in registry.timings.items()}
  log(f'timing ensemble pipeline: {seconds / N_ENS_INITS:.4f} s per chunk '
      f'({N_ENS_INITS} chunks, wall clock to a final synchronize); per-chunk '
      f'means (s) {json.dumps(per_chunk)}; card {card}')
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
  ev, chunks, main_launches, _ = main_path(args.seed)
  log('phase 4 main path: ok')
  stores, ens_launches = ensemble_path(args.seed)
  log('phase 5 ensemble path: ok')
  cli_phase(args.seed)
  log('phase 6 cli: ok')
  res = timing(ev, chunks, stores, card)
  log('phase 7 timing: done')

  source = 'weatherbenchx_tpu_torch/ops/csrc/crps_pairwise.cu'
  replaced = 'weatherbenchx_tpu/ops/crps_pairwise.py'
  print(json.dumps({'kernels': [{
      'name': 'fused_ensemble_stats', 'route': 'cuda', 'source': source,
      'replaces': f'{replaced}:238',
      'launches': main_launches['fused_ensemble_stats'],
      'max_abs_err': max(main_err[k] for k in (
          'spread_sum', 'skill_sum', 'mean', 'sq_dev_sum')),
      'ms': res['fused_kernel'][0], 'plain_ms': res['fused_plain'][0],
  }, {
      'name': 'pairwise_spread_sum', 'route': 'cuda', 'source': source,
      'replaces': f'{replaced}:229',
      'launches': ens_launches['pairwise_spread_sum'],
      'max_abs_err': main_err['spread_only'],
      'ms': res['spread_kernel'][0], 'plain_ms': res['spread_plain'][0],
  }, {
      'name': 'pairwise_cross_sum', 'route': 'cuda', 'source': source,
      'replaces': f'{replaced}:426',
      'launches': ens_launches['pairwise_cross_sum'],
      'max_abs_err': main_err['cross'],
      'ms': res['cross_kernel'][0], 'plain_ms': res['cross_plain'][0],
  }]}), flush=True)
  print(card, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
