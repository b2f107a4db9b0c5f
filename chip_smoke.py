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
6. The deterministic benchmark path at full width, through
   run_benchmark_evaluation's own construction (build_loaders,
   load_climatology, build_metrics, build_aggregator) over in-memory
   stores with ECMWF names: the registry default of hres_1440x721_2020,
   25 field-levels (6 upper-air variables x 500/700/850 hPa, 5 surface, 2
   precipitation) at 0.25 degrees, 2 chunks of 1 init x 12 leads 6 h
   apart, the 17 regions and their land parts (34 bins), area weights,
   masked. Data from the seed on the card: target = clim(doy, hour) +
   z_c(valid) + z_t and prediction = clim + z_c + z_p, z iid N(0, 1), so
   RMSE = sqrt(2), MSE = 2, bias = 0, ACC = 1/2, prediction activity =
   sqrt(2) and wind-vector RMSE = 2 (precipitation in metres, 1e-3 of
   those where they scale); SEEPS has no closed form. Every value within
   1e-5 of a float64 recomputation and within 6 standard errors of its
   closed form. Run twice: under the default resource budget (every
   climatology resident) and under WBX_RESOURCE_BYTES at half the
   climatology's size (the largest arrays host-gathered, SEEPS's p1
   resident); the two AggregationStates equal by torch.equal. Prints the
   seconds per chunk, the stage timers and the peak device memory.
7. The evaluation CLI (python -m weatherbenchx_tpu_torch.apps.run_evaluation
   --device cuda) on a small .npz store in a temporary directory: RMSE of
   N(0, 1) against N(0, 1) is sqrt(2).
8. The benchmark CLI (python -m
   weatherbenchx_tpu_torch.apps.run_benchmark_evaluation --device cuda) on
   64 x 32 .npz stores with ECMWF names: the deterministic recipe above
   (RMSE = sqrt(2), ACC = 1/2) and --prediction=ens with 8 N(0, 1)
   members against N(0, 1) (CRPS = 1/sqrt(pi) = 0.5642, unbiased
   spread/skill = 1, ensemble-mean RMSE = sqrt(1 + 1/8)), with the fused
   kernel launched at least once per chunk; tolerances are 6 standard
   errors at the global bin's effective size.
9. Timing with CUDA events: each kernel against its plain version at its
   path's shape, one whole eval_chunk, and the pipeline's seconds per chunk.

The last three lines are a JSON object describing the three kernels, the
card's name and power limit, and {"ok": true, "device": {...}}.
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
  """Phase 7: the evaluation CLI on the card over a small .npz store."""
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


# -- the deterministic benchmark path (run_benchmark_evaluation's setup) -------

# The registry's default for hres_1440x721_2020: STANDARD_VARIABLES +
# PRECIPITATION_VARIABLES at the CLI's default levels 500/700/850, i.e.
# 6 x 3 upper-air + 5 surface + 2 precipitation = 25 field-levels, on the
# 0.25-degree grid; --lead_time_chunk_size 12 with leads 6 h apart, one
# init per chunk; 2 chunks (the 00z and 12z inits of 2020-01-01), so 14
# valid times and a climatology of the touched window (dayofyear 1-4 x 4
# hours = 16 slots), 17 regions and their land parts (34 bins).
BENCH_GRID = (721, 1440)
BENCH_LEVELS = (500, 700, 850)
BENCH_LEADS = 12
BENCH_INITS = 2
# Precipitation follows the same recipe in metres (1e-3 x N(0, 1) fields);
# its closed forms scale with it.
PRECIP_SCALE = 1e-3
# Sampling tolerances: BENCH_SIGMAS standard errors, each the metric's
# per-gridpoint standard deviation (for iid normal z's: RMSE 1, MSE
# 2*sqrt(2), bias sqrt(2), ACC (1 - rho^2) = 0.75, activity 1, vector RMSE
# 1, in units of the field's scale) over the square root of the bin's
# effective size: Kish's (sum w)^2 / sum w^2 of the area weights, times the
# independent inits.
BENCH_SIGMAS = 6.0
BENCH_CLOSED_FORMS = {  # metric: (value, per-point sd, power of the scale)
    'rmse': (math.sqrt(2), 1.0, 1), 'mse': (2.0, 2 * math.sqrt(2), 2),
    'bias': (0.0, math.sqrt(2), 1), 'acc': (0.5, 0.75, 0),
    'prediction_activity': (math.sqrt(2), 1.0, 1),
    'vector_rmse': (2.0, 1.0, 1)}
# Differences from the float64 recomputation are taken relative to
# max(|float64 value|, the field's scale ** power): bias is near 0.
BENCH_F64_RTOL = 1e-5


def bench_variables():
  from weatherbenchx_tpu_torch.apps import configs
  return configs.STANDARD_VARIABLES + configs.PRECIPITATION_VARIABLES


def bench_land_sea_mask():
  """5-degree land/sea checkerboard, stored north to south as ERA5 does:
  every region's land part holds land."""
  from weatherbenchx_tpu_torch.darray import DimArray
  lat = np.linspace(90, -90, BENCH_GRID[0])
  lon = np.arange(BENCH_GRID[1]) * (360 / BENCH_GRID[1])
  land = ((np.floor(lat / 5)[:, None] + np.floor(lon / 5)[None, :]) % 2) == 0
  return DimArray(land.astype(np.float32), ('latitude', 'longitude'),
                  {'latitude': lat, 'longitude': lon})


def bench_stores(seed: int) -> dict:
  """Host stores of the benchmark path, generated on the card.

  target = clim(doy, hour) + z_c(valid) + z_t and prediction = clim +
  z_c + z_p (tools/gen_demo_fixtures.py's recipe), all z iid N(0, 1) from
  a torch.Generator seeded by ``seed``; ECMWF dim names; analyses and
  climatology latitude-descending as ERA5 stores them, predictions
  ascending. The SEEPS climatology: wet thresholds 1.5e-3 + 2e-4 N(0, 1)
  and dry fractions in 0.05-0.95 (bench.py:534-535's range), so some
  points fall outside [min_p1, max_p1] and are masked.
  """
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.darray import DimArray
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(seed)
  nlat, nlon = BENCH_GRID
  lat = np.linspace(-90, 90, nlat)
  lon = np.arange(nlon) * (360 / nlon)
  inits = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(BENCH_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(BENCH_LEADS) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  n_valid = 2 * (BENCH_INITS - 1) + BENCH_LEADS
  valid = (np.datetime64('2020-01-01T00', 'ns')
           + np.arange(n_valid) * np.timedelta64(6, 'h'))
  n_slots = 4 * ((n_valid + 3) // 4)
  up = {'latitude': lat, 'longitude': lon}
  down = {'latitude': lat[::-1].copy(), 'longitude': lon}
  ccoords = {'dayofyear': np.arange(1, n_slots // 4 + 1),
             'hour': np.array([0, 6, 12, 18])}
  # Valid time v (6-hourly from Jan 1 00z) is climatology slot v, and
  # init k's lead j is valid time 2k + j.
  vpos = torch.tensor([2 * k + j for k in range(BENCH_INITS)
                       for j in range(BENCH_LEADS)], device=DEVICE)

  def randn(*shape):
    return torch.randn(shape, generator=gen, device=DEVICE)

  def host(x, flip):
    return (x.flip(-2) if flip else x).cpu().numpy()

  preds, tgts, clim = {}, {}, {}
  for name in bench_variables():
    lev = name in configs.UPPER_LEVEL_VARIABLES
    fshape = ((len(BENCH_LEVELS),) if lev else ()) + BENCH_GRID
    fdims = (('level',) if lev else ()) + ('latitude', 'longitude')
    lcoords = {'level': np.array(BENCH_LEVELS)} if lev else {}
    scale = PRECIP_SCALE if name in configs.PRECIPITATION_VARIABLES else 1.0
    c = randn(n_slots, *fshape)
    zc = randn(n_valid, *fshape)
    t = c[:n_valid] + zc + randn(n_valid, *fshape)
    p = (c[vpos] + zc[vpos]).reshape((BENCH_INITS, BENCH_LEADS) + fshape)
    p += randn(BENCH_INITS, BENCH_LEADS, *fshape)
    tgts[name] = DimArray(host(t * scale, True), ('time',) + fdims,
                          {'time': valid, **down, **lcoords})
    preds[name] = DimArray(
        host(p * scale, False), ('time', 'prediction_timedelta') + fdims,
        {'time': inits, 'prediction_timedelta': leads, **up, **lcoords})
    clim[name] = DimArray(
        host(c.reshape((n_slots // 4, 4) + fshape) * scale, True),
        ('dayofyear', 'hour') + fdims, {**ccoords, **down, **lcoords})
    del c, zc, t, p
  cshape = (n_slots // 4, 4) + BENCH_GRID
  cdims = ('dayofyear', 'hour', 'latitude', 'longitude')
  for name in configs.PRECIPITATION_VARIABLES:
    clim[f'{name}_seeps_threshold'] = DimArray(
        host(1.5e-3 + 2e-4 * randn(*cshape), True), cdims,
        {**ccoords, **down})
    # A dry fraction that varies from point to point far more than from
    # slot to slot, so that its mean p1 leaves [0.1, 0.85] at some points.
    u = 0.05 + 0.9 * torch.rand(BENCH_GRID, generator=gen, device=DEVICE)
    jitter = torch.rand(cshape, generator=gen, device=DEVICE) - 0.5
    clim[f'{name}_seeps_dry_fraction'] = DimArray(
        host((u + 0.04 * jitter).clamp(0.05, 0.95), True), cdims,
        {**ccoords, **down})
  tgts['land_sea_mask'] = bench_land_sea_mask()
  return {'predictions': preds, 'targets': tgts, 'climatology': clim,
          'inits': inits, 'leads': leads}


def bench_pipeline(stores, registry):
  """The benchmark CLI's own construction over the in-memory stores."""
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.apps import run_benchmark_evaluation as cli
  from weatherbenchx_tpu_torch.parallel import pipeline
  variables, levels = bench_variables(), list(BENCH_LEVELS)
  pred_cfg = {'ds': stores['predictions']}
  tgt_cfg = {'ds': stores['targets'],
             'data_loader_kwargs': {'preprocessing_fn': configs.sort_latitude}}
  p_loader, t_loader = cli.build_loaders('hres', pred_cfg, tgt_cfg,
                                         variables, levels)
  climatology = cli.load_climatology({'ds': stores['climatology']},
                                     variables, levels)
  metrics = cli.build_metrics(variables, climatology, is_probabilistic=False)
  aggregator = cli.build_aggregator(stores['targets']['land_sea_mask'],
                                    temporal=False)
  times = time_chunks.TimeChunks(stores['inits'], stores['leads'],
                                 init_time_chunk_size=1,
                                 lead_time_chunk_size=BENCH_LEADS)
  return pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=aggregator, predictions_loader=p_loader,
      targets_loader=t_loader, times=times, device=DEVICE,
      metrics_registry=registry)


def run_bench(stores, budget_bytes, card: str):
  """One pipeline run under a resource budget (None: the default);
  returns (pipeline, host state, seconds)."""
  import torch
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.metrics import base
  if budget_bytes is None:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  else:
    os.environ['WBX_RESOURCE_BYTES'] = str(budget_bytes)
  try:
    registry = observability.Metrics()
    pipe = bench_pipeline(stores, registry)
  finally:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  ev = pipe._evaluator
  seeps = pipe.metrics['seeps']
  p1_ids = {base.resource_id(p1) for p1 in seeps._p1.values()}
  if p1_ids & ev.host_gather_ids or not p1_ids <= set(ev.resources()):
    raise AssertionError('SEEPS p1 must stay resident')
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = pipe.run()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  timers = {k: round(d.mean, 4) for k, d in registry.timings.items()}
  plan = 'default' if budget_bytes is None else f'{budget_bytes} B'
  log(f'benchmark path [{plan} budget]: {len(ev.host_gather_ids)} of '
      f'{len(ev.resources()) + len(ev.host_gather_ids)} climatology arrays '
      f'host-gathered, {ev.resource_bytes / 2**30:.3f} GiB resident; '
      f'{seconds / BENCH_INITS:.3f} s per chunk ({BENCH_INITS} chunks, wall '
      f'clock to a final synchronize); per-chunk means (s) '
      f'{json.dumps(timers)}; peak device memory {peak / 2**30:.2f} GiB; '
      f'card {card}')
  return pipe, state, seconds


def bench_weights(aggregator):
  """(region, lat, lon) float64 area weights x bins on the card, ascending
  latitude, and each bin's effective size per init (Kish)."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  lat = np.linspace(-90, 90, BENCH_GRID[0])
  lon = np.arange(BENCH_GRID[1]) * (360 / BENCH_GRID[1])
  grid = DimArray(np.zeros(BENCH_GRID, np.float32), ('latitude', 'longitude'),
                  {'latitude': lat, 'longitude': lon})
  w = torch.from_numpy(np.asarray(
      aggregator.weigh_by[0].weights(grid).values, np.float64)).to(DEVICE)
  bins = torch.from_numpy(aggregator.bin_by[0].create_bin_mask(grid).values
                          ).to(DEVICE).double()
  wb = w[None, :, None] * bins
  n_eff = wb.sum((1, 2)) ** 2 / (wb ** 2).sum((1, 2))
  return wb, n_eff


def bench_f64_reference(stores, wb) -> dict:
  """Every metric value recomputed in float64 on the card from the host
  stores: explicit weighted sums over (init, lat, lon) per lead, level and
  region; independent of the port's statistics, alignment and
  aggregation."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  preds, tgts, clim = (stores[k] for k in ('predictions', 'targets',
                                           'climatology'))

  def card(store, name, flip):
    x = store[name].data.to(DEVICE, torch.float64)
    return x.flip(-2) if flip else x

  def wsum(s, w=wb):  # (lead, [level], lat, lon) -> (lead, [level], region)
    return torch.einsum('l...yx,ryx->l...r', s, w)

  num, den = {}, {}

  def add(key, s, w=wb):
    num[key] = num.get(key, 0) + wsum(s, w)
    den[key] = den.get(key, 0) + w.sum((1, 2))

  wind = {'u_component_of_wind': ('v_component_of_wind', 'wind'),
          '10m_u_component_of_wind': ('10m_v_component_of_wind', '10m_wind')}
  for k in range(BENCH_INITS):
    window = slice(2 * k, 2 * k + BENCH_LEADS)
    for name in bench_variables():
      p = card(preds, name, False)[k]
      t = card(tgts, name, True)[window]
      c = card(clim, name, True).flatten(0, 1)[window]
      add(('se', name), (p - t) ** 2)
      add(('err', name), p - t)
      add(('spa', name), (p - c) ** 2)
      add(('sta', name), (t - c) ** 2)
      add(('cov', name), (p - c) * (t - c))
      if name in wind:
        v_name, vector = wind[name]
        pv = card(preds, v_name, False)[k]
        tv = card(tgts, v_name, True)[window]
        add(('wse', vector), (p - t) ** 2 + (pv - tv) ** 2)
      if name in configs.SEEPS_DRY_THRESHOLDS_MM:
        add(('seeps', name),
            *bench_seeps_reference(clim, name, p, t, window, wb))
      del p, t, c
  mean = {key: num[key] / (den[key] * 1.0) for key in num}
  out = {}
  for name in bench_variables():
    out[f'rmse.{name}'] = mean[('se', name)].sqrt()
    out[f'mse.{name}'] = mean[('se', name)]
    out[f'bias.{name}'] = mean[('err', name)]
    out[f'acc.{name}'] = mean[('cov', name)] / (
        mean[('spa', name)].sqrt() * mean[('sta', name)].sqrt())
    out[f'prediction_activity.{name}'] = mean[('spa', name)].sqrt()
    if name in configs.SEEPS_DRY_THRESHOLDS_MM:
      out[f'seeps.{name}'] = mean[('seeps', name)]
  for vector in ('wind', '10m_wind'):
    out[f'vector_rmse.{vector}'] = mean[('wse', vector)].sqrt()
  return out


def bench_seeps_reference(clim, name, p, t, window, wb):
  """(score, weights) of SEEPS in float64: the port's semantics (a NaN
  wet threshold scores 0; p1 the float32 mean dry fraction; points with
  p1 outside [0.1, 0.85] carry no weight), with the float32 images of the
  constants the port compares float32 data against."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  def card(key):
    return clim[key].data.to(DEVICE, torch.float64).flip(-2)

  wet = card(f'{name}_seeps_threshold').flatten(0, 1)[window]
  p1 = card(f'{name}_seeps_dry_fraction').mean((0, 1)).float().double()
  lo = float(np.float32(configs.SEEPS_DRY_THRESHOLDS_MM[name] / 1000))

  def bands(x):
    return x <= lo, (x > lo) & (x < wet), x >= wet

  fd, fl, fh = bands(p)
  td, tl, th = bands(t)
  score = 0.5 * ((fd & tl) * (1 / (1 - p1)) + (fd & th) * (4 / (1 - p1))
                 + (fl & td) * (1 / p1) + (fl & th) * (3 / (1 - p1))
                 + (fh & td) * (1 / p1 + 3 / (2 + p1))
                 + (fh & tl) * (3 / (2 + p1)))
  keep = ((p1 >= float(np.float32(0.1)))
          & (p1 <= float(np.float32(0.85)))).double()
  return score * keep, wb * keep


def check_bench_values(values: dict, ref: dict, n_eff, masked_p1: dict
                       ) -> float:
  """Every metric: dims, finite, within BENCH_F64_RTOL of float64 and (all
  but SEEPS) within BENCH_SIGMAS standard errors of its closed form."""
  import torch
  from weatherbenchx_tpu_torch.apps import configs
  worst = 0.0
  n_indep = n_eff * BENCH_INITS
  for key, want in ref.items():
    metric, name = key.split('.', 1)
    da = values[key]
    lev = name in configs.UPPER_LEVEL_VARIABLES or name == 'wind'
    dims = ('lead_time',) + (('level',) if lev else ()) + ('region',)
    shape = (BENCH_LEADS,) + ((len(BENCH_LEVELS),) if lev else ()) + (34,)
    if da.dims != dims or da.shape != shape:
      raise AssertionError(f'{key}: dims {da.dims} shape {da.shape}')
    got = da.data.to(DEVICE).double()
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'{key}: non-finite values')
    scale = PRECIP_SCALE if name in configs.PRECIPITATION_VARIABLES else 1.0
    value, sd, power = BENCH_CLOSED_FORMS.get(metric, (None, None, 1))
    floor = scale ** power
    rel = ((got - want).abs() / want.abs().clamp(min=floor)).max().item()
    if rel > BENCH_F64_RTOL:
      raise AssertionError(f'{key}: rel err vs float64 {rel:.3g} > '
                           f'{BENCH_F64_RTOL}')
    worst = max(worst, rel)
    if value is None:
      continue
    tol = BENCH_SIGMAS * sd * floor / n_indep.sqrt()  # per region
    dev = (got - value * floor).abs() / tol
    if dev.max().item() > 1:
      raise AssertionError(f'{key}: {dev.max().item():.3g} tolerances from '
                           f'the closed form {value * floor:.6g}')
  for metric, (value, sd, _) in BENCH_CLOSED_FORMS.items():
    names = ['wind', '10m_wind'] if metric == 'vector_rmse' else [
        'geopotential', '2m_temperature']
    for name in names:
      got = values[f'{metric}.{name}'].data.double()
      log(f'benchmark path {metric}.{name}: mean {got.mean().item():.6f}, '
          f'closed form {value:.6f}; global bin range '
          f'[{got[..., 0].min().item():.6f}, {got[..., 0].max().item():.6f}]')
  for name in configs.PRECIPITATION_VARIABLES:
    got = values[f'seeps.{name}'].data.double()
    log(f'benchmark path seeps.{name}: mean {got.mean().item():.6f} '
        '(no closed form; held to float64 only)')
  for name, p1 in masked_p1.items():
    log(f'benchmark path seeps.{name}: p1 outside [0.1, 0.85] at '
        f'{p1:.2%} of gridpoints (masked)')
  log(f'benchmark path: {len(ref)} metric arrays within {worst:.3g} of '
      f'float64 (tol {BENCH_F64_RTOL}); closed forms within '
      f'{BENCH_SIGMAS} standard errors (smallest bin effective size '
      f'{int(n_indep.min().item())})')
  return worst


def benchmark_path(seed: int, card: str) -> dict:
  """Phase 6: the deterministic benchmark path at full width, under the
  default budget (every climatology resident) and under a budget below
  the climatology's size (the largest arrays host-gathered); the two
  states equal by torch.equal."""
  import torch
  t0 = time.perf_counter()
  stores = bench_stores(seed)
  nbytes = sum(da.data.numel() * da.data.element_size()
               for key in ('predictions', 'targets', 'climatology')
               for da in stores[key].values())
  log(f'benchmark path: made {len(bench_variables())} variables '
      f'({len(BENCH_LEVELS)} levels upper-air), {nbytes / 2**30:.2f} GiB of '
      f'host stores, in {time.perf_counter() - t0:.1f} s')
  pipe, state, seconds = run_bench(stores, None, card)
  ev = pipe._evaluator
  if ev.host_gather_ids:
    raise AssertionError('the default budget should keep every climatology '
                         f'resident; {len(ev.host_gather_ids)} were demoted')
  values = state.metric_values(pipe.metrics)
  wb, n_eff = bench_weights(pipe.aggregator)
  masked_p1 = {
      name: float(((p1.data < np.float32(0.1)) | (p1.data > np.float32(0.85))
                   ).float().mean())
      for name, p1 in pipe.metrics['seeps']._p1.items()}
  check_bench_values(values, bench_f64_reference(stores, wb), n_eff,
                     masked_p1)
  budget = ev.resource_bytes // 2
  del pipe, values, wb
  torch.cuda.empty_cache()
  pipe2, state2, seconds2 = run_bench(stores, budget, card)
  demoted = len(pipe2._evaluator.host_gather_ids)
  if not demoted:
    raise AssertionError('a budget below the climatology demoted nothing')
  got, want = state2.to_dataset(), state.to_dataset()
  if sorted(got) != sorted(want) or not all(
      torch.equal(got[k].data, want[k].data) for k in want):
    raise AssertionError('host-gather and resident states differ')
  log(f'benchmark path: resident and host-gather states equal by '
      f'torch.equal ({len(want)} arrays; {demoted} arrays demoted under '
      f'{budget} B)')
  del pipe2
  torch.cuda.empty_cache()
  return {'resident_s_per_chunk': seconds / BENCH_INITS,
          'host_gather_s_per_chunk': seconds2 / BENCH_INITS}


# The benchmark CLI phase: the demo recipe at 64 x 32 (1.6 M-gridpoint
# fields are not needed to exercise the CLI), ECMWF dim names, 8 inits 12 h
# apart x 4 leads, geopotential at 3 levels and 2m temperature; and an
# 8-member N(0, 1) ensemble against N(0, 1) analyses.
BENCH_CLI_GRID = (32, 64)
BENCH_CLI_INITS = 8
BENCH_CLI_MEMBERS = 8


def bench_cli_stores(tmp: str, seed: int) -> dict:
  """Writes the CLI phase's .npz stores with the port's io; returns paths."""
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng([seed, 3000])
  nlat, nlon = BENCH_CLI_GRID
  space = {'latitude': np.linspace(-90, 90, nlat),
           'longitude': np.arange(nlon) * (360 / nlon)}
  inits = (np.datetime64('2020-01-01', 'ns')
           + np.arange(BENCH_CLI_INITS) * np.timedelta64(12, 'h'))
  leads = (np.arange(4) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  n_valid = 2 * (BENCH_CLI_INITS - 1) + 4
  valid = (np.datetime64('2020-01-01', 'ns')
           + np.arange(n_valid) * np.timedelta64(6, 'h'))
  vpos = (2 * np.arange(BENCH_CLI_INITS)[:, None]
          + np.arange(4)[None, :]).reshape(-1)
  n_days = (n_valid + 3) // 4
  pred, tgt, clim, ens, ens_tgt = {}, {}, {}, {}, {}
  for name, lev in (('geopotential', True), ('2m_temperature', False)):
    fshape = ((3,) if lev else ()) + BENCH_CLI_GRID
    fdims = (('level',) if lev else ()) + ('latitude', 'longitude')
    lcoords = {'level': np.array(BENCH_LEVELS)} if lev else {}

    def rand(*lead):
      return rng.standard_normal(lead + fshape, dtype=np.float32)

    c = rand(4 * n_days)
    zc = rand(n_valid)
    tgt[name] = DimArray(c[:n_valid] + zc + rand(n_valid), ('time',) + fdims,
                         {'time': valid, **space, **lcoords})
    pred[name] = DimArray(
        (c[vpos] + zc[vpos]).reshape((BENCH_CLI_INITS, 4) + fshape)
        + rand(BENCH_CLI_INITS, 4), ('time', 'prediction_timedelta') + fdims,
        {'time': inits, 'prediction_timedelta': leads, **space, **lcoords})
    clim[name] = DimArray(
        c.reshape((n_days, 4) + fshape), ('dayofyear', 'hour') + fdims,
        {'dayofyear': np.arange(1, n_days + 1),
         'hour': np.array([0, 6, 12, 18]), **space, **lcoords})
    ens[name] = DimArray(
        rand(BENCH_CLI_MEMBERS, BENCH_CLI_INITS, 4),
        ('number', 'time', 'prediction_timedelta') + fdims,
        {'number': np.arange(BENCH_CLI_MEMBERS), 'time': inits,
         'prediction_timedelta': leads, **space, **lcoords})
    ens_tgt[name] = DimArray(rand(n_valid), ('time',) + fdims,
                             {'time': valid, **space, **lcoords})
  paths = {}
  for key, ds in (('hres', pred), ('era5', tgt), ('clim', clim),
                  ('ens', ens), ('ens_era5', ens_tgt)):
    paths[key] = os.path.join(tmp, f'{key}.npz')
    io.save_dataset(paths[key], ds)
  return paths


def run_bench_cli(args: list) -> str:
  cmd = [sys.executable, '-m',
         'weatherbenchx_tpu_torch.apps.run_benchmark_evaluation',
         '--device', 'cuda', '--init_time_start=2020-01-01',
         f'--init_time_stop=2020-01-{1 + BENCH_CLI_INITS // 2:02d}',
         '--lead_time_stop_days=1', '--resolution=64x32', *args]
  proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                        cwd=os.path.dirname(os.path.abspath(__file__)),
                        check=False)
  if proc.returncode != 0:
    raise AssertionError(f'benchmark CLI failed ({proc.returncode}):\n'
                         f'{(proc.stdout + proc.stderr)[-4000:]}')
  return proc.stdout


def global_n_eff() -> float:
  """Effective size (Kish, area weights) of the global bin of one init at
  BENCH_CLI_GRID, times the inits."""
  from weatherbenchx_tpu_torch import weighting
  from weatherbenchx_tpu_torch.darray import DimArray
  grid = DimArray(np.zeros(BENCH_CLI_GRID, np.float32),
                  ('latitude', 'longitude'),
                  {'latitude': np.linspace(-90, 90, BENCH_CLI_GRID[0]),
                   'longitude': np.arange(BENCH_CLI_GRID[1]) * 5.625})
  w = np.broadcast_to(np.asarray(
      weighting.GridAreaWeighting().weights(grid).values, np.float64)[:, None],
                      BENCH_CLI_GRID)
  return float(w.sum() ** 2 / (w ** 2).sum()) * BENCH_CLI_INITS


def ensemble_sds(m: int) -> dict:
  """Per-gridpoint standard deviations, by simulation on the card (4 M
  draws), of the statistics behind the ensemble metrics for an m-member
  N(0, 1) ensemble against N(0, 1): fair CRPS; the log spread/skill ratio's
  numerator minus denominator (delta method: the ratio's standard error
  is half that over the root of the size); and the squared ensemble-mean
  error (the RMSE's is that over 2 RMSE)."""
  import torch
  gen = torch.Generator(device=DEVICE)
  gen.manual_seed(7)
  x = torch.randn((m, 1 << 22), generator=gen, device=DEVICE,
                  dtype=torch.float64)
  y = torch.randn((1 << 22,), generator=gen, device=DEVICE,
                  dtype=torch.float64)
  skill = (x - y).abs().mean(0)
  xs = x.sort(0).values
  k = torch.arange(1, m + 1, device=DEVICE, dtype=torch.float64)[:, None]
  spread = 2 * ((2 * k - m - 1) * xs).sum(0) / (m * (m - 1))
  var = x.var(0, correction=1)
  sq = (x.mean(0) - y) ** 2
  return {'crps': (skill - 0.5 * spread).std().item(),
          'spread_skill': (var - (sq - var / m)).std().item(),
          'mean_rmse_sq': sq.std().item()}


def benchmark_cli_phase(seed: int) -> dict:
  """Phase 8: python -m ...run_benchmark_evaluation --device cuda on .npz
  stores, deterministic (RMSE = sqrt(2), ACC = 1/2) and --prediction=ens
  (CRPS = 1/sqrt(pi), unbiased spread/skill = 1, ensemble-mean RMSE =
  sqrt(1 + 1/8), one fused launch per chunk and variable at least)."""
  from weatherbenchx_tpu_torch import io
  n = global_n_eff()
  with tempfile.TemporaryDirectory() as tmp:
    paths = bench_cli_stores(tmp, seed)
    t0 = time.perf_counter()
    run_bench_cli(['--prediction=hres', f'--prediction_path={paths["hres"]}',
                   f'--target_path={paths["era5"]}',
                   f'--climatology_path={paths["clim"]}',
                   '--variables=geopotential,2m_temperature',
                   f'--output_dir={tmp}/det'])
    det = io.load_dataset(
        f'{tmp}/det/hres_vs_era5_64x32_2020-init12h.npz')
    det_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run_bench_cli(['--prediction=ens',
                         f'--prediction_path={paths["ens"]}',
                         f'--target_path={paths["ens_era5"]}',
                         '--variables=geopotential,2m_temperature',
                         f'--output_dir={tmp}/ens'])
    ens = io.load_dataset(f'{tmp}/ens/ens_vs_era5_64x32_2020-init12h.npz')
    ens_s = time.perf_counter() - t0
  line = [l for l in out.splitlines() if l.startswith('Kernel launches: ')]
  launches = json.loads(line[-1].removeprefix('Kernel launches: '))
  n_chunks = BENCH_CLI_INITS  # one init per chunk, its 4 leads in one
  if launches['fused_ensemble_stats'] < n_chunks:
    raise AssertionError(f'expected >= {n_chunks} fused launches (one per '
                         f'chunk), got {launches}')
  sds = ensemble_sds(BENCH_CLI_MEMBERS)
  m = BENCH_CLI_MEMBERS
  checks = [
      (det, 'rmse', math.sqrt(2), 1.0),
      (det, 'acc', 0.5, 0.75),
      (ens, 'crps', 1 / math.sqrt(math.pi), sds['crps']),
      (ens, 'unbiased_spread_skill', 1.0, 0.5 * sds['spread_skill']),
      (ens, 'mean_rmse', math.sqrt(1 + 1 / m),
       sds['mean_rmse_sq'] / (2 * math.sqrt(1 + 1 / m))),
  ]
  for ds, metric, value, sd in checks:
    tol = BENCH_SIGMAS * sd / math.sqrt(n)
    for name in ('geopotential', '2m_temperature'):
      da = ds[f'{metric}.{name}']
      glob = da.values[..., list(da.coord_values('region')).index('global')]
      far = float(np.abs(glob - value).max())
      if not np.isfinite(glob).all() or far > tol:
        raise AssertionError(f'benchmark CLI {metric}.{name}: {glob} is '
                             f'{far:.4g} from {value:.6f} (tol {tol:.4g})')
      log(f'benchmark cli {metric}.{name}: global bin mean '
          f'{glob.mean():.6f} vs {value:.6f} (max dev {far:.4g}, tol '
          f'{tol:.4g}) ok')
  log(f'benchmark cli: deterministic {det_s:.1f} s, ensemble {ens_s:.1f} s '
      f'(process wall time); ensemble kernel launches {launches}')
  return launches


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
  """Phase 9: kernels vs plain at their paths' shapes; one eval_chunk; the
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
  bench = benchmark_path(args.seed, card)
  log('phase 6 benchmark path: ok')
  cli_phase(args.seed)
  log('phase 7 cli: ok')
  benchmark_cli_phase(args.seed)
  log('phase 8 benchmark cli: ok')
  res = timing(ev, chunks, stores, card)
  log('phase 9 timing: done')
  log(f'benchmark path seconds per chunk: {json.dumps(bench)}; card {card}')

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
