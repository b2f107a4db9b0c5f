#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (weatherbenchx_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, each printing progress lines; any failed check raises, so the
script exits nonzero:

1. Device: requires a CUDA device; prints the card's name and power limit.
2. Build: compiles the port's CUDA kernels from ops/csrc with nvcc, the
   register kernels' generated translation units in parallel; prints the
   build time, the registers of every register kernel and fails unless
   each shows 0 bytes of stack frame and spills.
3. Kernels against their plain PyTorch versions on the card: several
   ensemble sizes and shapes, NaN members, |mean| >> std, float32 and
   bfloat16, 1-D input, and the main paths' own shapes; each route
   boundary (2, 63, 64 and 65 members); a NaN at every member position
   (the network route); +-inf members at 2, 3, 10, 19, 20, 21, 49, 50, 64,
   65 and 100 members, every route, against the plain version and the JAX
   kernels' inf/NaN pattern (their sort body from 20 members, their pair
   body below); every register kernel built, M = 2..64, in both dtypes;
   and 1,816, 1,817 and 4,000 members through the metrics (one, two and
   three shared-memory tiles: the fused pass, the spread and the
   two-ensemble skill against the float64 broadcast, each launch counted),
   with +-inf and NaN members on both sides of a tile's edge.
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
   N(0, 1) against N(0, 1) is sqrt(2); again from .wbx and netCDF copies
   of the stores, each equal to the .npz run bit for bit.
8. The benchmark CLI (python -m
   weatherbenchx_tpu_torch.apps.run_benchmark_evaluation --device cuda) on
   64 x 32 .npz stores with ECMWF names: the deterministic recipe above
   (RMSE = sqrt(2), ACC = 1/2) and --prediction=ens with 8 N(0, 1)
   members against N(0, 1) (CRPS = 1/sqrt(pi) = 0.5642, unbiased
   spread/skill = 1, ensemble-mean RMSE = sqrt(1 + 1/8)), with the fused
   kernel launched at least once per chunk; tolerances are 6 standard
   errors at the global bin's effective size. Both branches again from
   zarr v2 blosc-lz4 copies of the stores (one field per cell), writing
   zarr, wbx and netCDF outputs, each equal to its .npz run bit for bit,
   the ensemble run with the .npz run's fused launches.
9. The benchmark path of phase 6 from on-disk stores: phase 6's stores
   written by the port's writers into a git-ignored directory of the
   checkout (predictions zarr v2 consolidated, blosc-lz4 with byte shuffle,
   one (init, lead, level) field per cell; targets zarr v3 sharded with
   zstd; climatology .wbx), opened lazily through the CLI's construction
   (the configs' path), the AggregationState equal to phase 6's by
   torch.equal. Requires the native blockstore and zarr codec built and
   called (their call counts and seconds are printed); prints the write
   seconds and rates per container, the bytes on disk, the loaders'
   one-time preparation (timed apart from seconds per chunk, which are
   also printed with it counted in), the per-chunk stage timers with the
   native decode's share of each load, one chunk of targets read with and
   without the latitude flip, and seconds per chunk beside phase 6's
   in-memory figures of the same run; deletes the stores.
10. Timing with CUDA events: each kernel against its plain version at its
   path's shape (fused and spread at M = 50, spread at M = 10, cross 50 x
   10), beside its bound and beside a device-to-device copy of the 50-member
   ensemble (the card's streaming rate); one whole eval_chunk, and the
   pipeline's seconds per chunk.
11. The metric families at full width (1 init x 4 leads x 721 x 1440,
   float32, from the seed), each through ChunkEvaluator.eval_chunk and
   metric_values over the 17 regions and their land parts (34 bins), area
   weights, masked: the fractions skill score (3 x 3 pixels, longitude
   wrapping) of two iid Bernoulli(1/2) fields, the rank histogram of a
   50-member iid ensemble (51 ranks), the relative economic value of an
   8-member probability against a boolean target (8 thresholds x 8
   cost/loss ratios); and RMSE and CSI (through ContinuousToBinary) binned
   by land/sea x 30-degree latitude bands x the hour of the lead time at
   once. Every value within 1e-5 (relative to |value|; the relative
   economic value, which crosses zero, to max(|value|, 1)) of a float64
   recomputation from the same inputs without the port's statistics,
   weights or bins (weatherbenchx_tpu_torch/bench_families.py); FSS
   near 0.9 and every rank near 1/51 within 6 standard errors; the same
   chunk evaluated twice equal by torch.equal; every tensor on the card;
   no kernel launch counted (these families are jnp in the JAX package,
   torch ops here). Prints per family the median and IQR of 12 eval_accum
   steps by CUDA events, the card's busy time within one step and its
   three longest kernels by torch.profiler, the host-fed eval_chunk and
   the peak device memory.

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
# Member counts on the network route checked with a NaN at every member
# position (odd: the median's weight is 0).
NAN_POSITION_MEMBERS = (21, 49)
# Member counts checked with infinite members: both sides of the JAX
# kernels' sort threshold (20) and of the register route's end (64).
INFINITY_MEMBERS = (2, 3, 10, 19, 20, 21, 49, 50, 64, 65, 100)
# The H100 SXM's HBM rate, and its float32 issue rate for operations that
# are not FMAs (min, max, add, subtract): 128 per clock per SM x 132 SMs x
# 1.98 GHz; the data sheet's 67 TFLOP/s counts an FMA as two. For the
# kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# Calls per timed sample (time_cuda), for kernels and plain versions alike.
TIMING_REPS = 20


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def rel_err(got, want):
  """(NaN, +inf and -inf patterns equal, max |got-want| / max(|want|, 1)
  and max abs err over the points where want is finite)."""
  import torch
  got, want = got.double(), want.double()
  same_nan = all(bool(torch.equal(f(got), f(want)))
                 for f in (torch.isnan, torch.isposinf, torch.isneginf))
  ok = torch.isfinite(want)
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
      # The route boundaries (the network from 2 members, the shared form
      # past 64) and the ensemble path's 10 members.
      (2, (2, 37, 71), (1, 700), 0.0, 1.0),
      (10, (2, 37, 71), (5, 700), 0.0, 1.0),
      (63, (2, 37, 71), (0, 700), 0.0, 1.0),
      (64, (2, 37, 71), (63, 700), 0.0, 1.0),
      (65, (2, 37, 71), (32, 700), 288.0, 3.0),
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
      log(f'kernel check M={m} ({cp.spread_form(m)}) rest={rest} {dname} '
          f'nan={nan_at is not None} offset={offset}: max rel err '
          f'{worst:.3g} (tol {KERNEL_RTOL[dname]}) ok')
  check_nan_positions(rng)
  check_infinities(rng)
  check_every_register_kernel(rng)
  main_path_err['cross'] = check_cross_kernel(rng)
  check_member_tiles(rng)
  return main_path_err


def stats_against_plain(x, y, label: str, dname: str) -> tuple:
  """The fused and spread-only kernels against their plain versions on
  x (M, N) and y (N); returns the five outputs. Raises unless every output
  has the plain version's NaN and +-inf pattern and is within
  KERNEL_RTOL."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  got = cp._launch_stats(x, y) + (cp._launch_stats(x, None),)
  want = cp.fused_ensemble_stats_plain(x, y) + (
      cp.pairwise_spread_sum_plain(x),)
  torch.cuda.synchronize()
  names = ('spread_sum', 'skill_sum', 'mean', 'sq_dev_sum', 'spread_only')
  for name, g, w in zip(names, got, want):
    same, rel, _ = rel_err(g, w)
    if not same:
      raise AssertionError(f'{label} {name} {dname}: NaN/inf pattern differs '
                           'from the plain version')
    if rel > KERNEL_RTOL[dname]:
      raise AssertionError(f'{label} {name} {dname}: rel err {rel:.3g} > '
                           f'{KERNEL_RTOL[dname]}')
  return got


def check_nan_positions(rng) -> None:
  """On the network route: point p holds a NaN at member p, for every p;
  each output must be NaN there and nowhere else."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in NAN_POSITION_MEMBERS:
    if cp.spread_form(m) != 'network':
      raise AssertionError(f'M={m} is not on the network route')
    x = rng.standard_normal((m, 4000), dtype=np.float32)
    for p in range(m):
      x[p, p] = np.nan
    y = rng.standard_normal(4000, dtype=np.float32)
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                torch.from_numpy(y).to(DEVICE, dtype),
                                f'NaN positions M={m}', dname)
      want = torch.arange(4000, device=DEVICE) < m
      if not all(torch.equal(torch.isnan(g), want) for g in got):
        raise AssertionError(f'M={m}: a NaN member must poison its own '
                             'point, at every member position, and no other')
      log(f'kernel check M={m} (network) {dname}: a NaN at each of the {m} '
          'member positions poisons its own point only ok')


def jax_infinite_spread(m: int, n_pos: int, n_neg: int) -> float:
  """The JAX kernels' spread of m members, n_pos of them +inf and n_neg
  -inf: their sort body (from 20 members) weights rank k by 2k - m - 1 and
  leaves the zero weight out, so terms of both signs (NaN) appear once
  2 n_pos > m + 1 or 2 n_neg > m + 1; their pair body (below 20) takes
  |inf - inf| = NaN for two members at one infinity."""
  nan = 2 * n_pos > m + 1 or 2 * n_neg > m + 1
  if m < 20:
    nan = nan or n_pos > 1 or n_neg > 1
  return math.nan if nan else math.inf


def check_infinities(rng) -> None:
  """Every route (network to 64 members, shared past it), both dtypes:
  +-inf members in seven columns (one +inf; one -inf; one of each; two
  +inf; m//2 + 1 +inf; m//2 + 1 -inf; m//2 + 2 +inf) give the plain
  version's inf and NaN points, which are the JAX kernels'."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  for m in INFINITY_MEMBERS:
    x = rng.standard_normal((m, 1000), dtype=np.float32)
    counts = [(1, 0), (0, 1), (1, 1), (2, 0), (m // 2 + 1, 0),
              (0, m // 2 + 1), (m // 2 + 2, 0)]
    want = []
    for col, (n_pos, n_neg) in enumerate(counts):
      n_pos = min(n_pos, m)
      rows = rng.permutation(m)
      x[rows[:n_pos], col] = np.inf
      x[rows[n_pos:n_pos + n_neg], col] = -np.inf
      want.append(jax_infinite_spread(m, n_pos, n_neg))
    y = rng.standard_normal(1000, dtype=np.float32)
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                torch.from_numpy(y).to(DEVICE, dtype),
                                f'infinities M={m}', dname)
      head = got[4][:7].float().cpu().numpy()
      if not (np.array_equal(np.isnan(head), np.isnan(want))
              and np.array_equal(np.isposinf(head), np.isposinf(want))
              and bool(torch.isfinite(got[4][7:]).all())):
        raise AssertionError(f'M={m}: spread at the infinite points {head}, '
                             f'the JAX kernels give {want}')
      log(f'kernel check M={m} ({cp.spread_form(m)}) {dname}: +-inf members '
          f'give the plain version\'s and the JAX kernels\' inf/NaN points '
          f'{head.tolist()} ok')


def check_every_register_kernel(rng) -> None:
  """Each register kernel built, M = 2..64, fused and spread-only, against
  the plain versions: a NaN member, a +inf and a -inf at other points.
  Raises after all kernels, naming every one that failed."""
  import torch
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  failed = []
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for m in cp.REGISTER_MEMBERS:
      x = rng.standard_normal((m, 3000), dtype=np.float32)
      x[m // 2, 0] = np.nan
      x[0, 1] = np.inf
      x[m - 1, 2] = -np.inf
      y = rng.standard_normal(3000, dtype=np.float32)
      try:
        got = stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                                  torch.from_numpy(y).to(DEVICE, dtype),
                                  f'M={m}', dname)
        if not all(bool(torch.isnan(g[0])) for g in got):
          raise AssertionError(f'M={m} {dname}: NaN member did not poison '
                               'its point')
      except AssertionError as e:
        failed.append(str(e))
    log(f'kernel check: {len(cp.REGISTER_MEMBERS)} register kernels (M) '
        f'{dname}, fused and spread-only, against the plain versions')
  if failed:
    raise AssertionError(f'{len(failed)} register kernel checks failed:\n'
                         + '\n'.join(failed))
  log('kernel check: every register kernel matches the plain versions ok')


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


def pair_sum_f64(a, b):
  """sum_{i,j} |a_i - b_j| per point by the float64 broadcast, 16 points at
  a time: the definition, written out here."""
  import torch
  return torch.cat([(a[:, None, lo:lo + 16] - b[None, :, lo:lo + 16]).abs()
                    .sum((0, 1)) for lo in range(0, a.shape[1], 16)])


def check_member_tiles(rng) -> None:
  """Ensembles past one shared-memory tile (1,816 members: 227 KB at the
  smallest block) are walked tile by tile inside the kernels. Through the
  metrics, at 1,816, 1,817 and 4,000 members (one, two, three tiles): the
  fused pass, the spread outside a pass and the two-ensemble skill (both
  ensembles past a tile) against the float64 broadcast, one launch counted
  for each; then +-inf and NaN members in the first tile, the second and
  on either side of the edge, against the plain versions."""
  import torch
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.metrics import base, probabilistic
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  n = 96
  for m, tiles in ((1816, 1), (1817, 2), (4000, 3)):
    if cp.member_tiles(m) != tiles:
      raise AssertionError(f'{m} members: {cp.member_tiles(m)} tiles')
    x = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
    yt = torch.from_numpy(rng.standard_normal((m + 3, n), dtype=np.float32))
    x[m - 5, 7] = float('nan')
    preds = {'v': DimArray(x.to(DEVICE), ('number', 'point'))}
    tgts = {'v': DimArray(y.to(DEVICE), ('point',))}
    ens_tgts = {'v': DimArray(yt.to(DEVICE), ('number', 'point'))}
    cp.reset_launch_counts()
    with base.computation_cache():
      got = {
          'fused skill': probabilistic.CRPSSkill().compute(preds, tgts)['v'],
          'fused spread': probabilistic.CRPSSpread().compute(preds, tgts)['v'],
          'fused variance': probabilistic.EnsembleVariance().compute(
              preds, tgts)['v'],
      }
    got['spread'] = probabilistic.CRPSSpread().compute(preds, tgts)['v']
    got['cross'] = probabilistic.CRPSSkill().compute(preds, ens_tgts)['v']
    torch.cuda.synchronize()
    if cp.LAUNCHES != {'fused_ensemble_stats': 1, 'pairwise_spread_sum': 1,
                       'pairwise_cross_sum': 1}:
      raise AssertionError(f'M={m}: launches {cp.LAUNCHES}, want one each')
    xd, yd, ytd = (t.to(DEVICE, torch.float64) for t in (x, y, yt))
    spread = pair_sum_f64(xd, xd) / (m * (m - 1))
    want = {'fused skill': (xd - yd).abs().mean(0), 'fused spread': spread,
            'fused variance': xd.var(0, correction=1), 'spread': spread,
            'cross': pair_sum_f64(xd, ytd) / (m * (m + 3))}
    worst = 0.0
    for name, da in got.items():
      if da.device.type != DEVICE or da.dtype != torch.float32:
        raise AssertionError(f'M={m} {name}: {da.device} {da.dtype}')
      same_nan, rel, _ = rel_err(da.data, want[name])
      if not same_nan or not bool(torch.isnan(da.data[7])):
        raise AssertionError(f'M={m} {name}: NaN pattern differs')
      if rel > KERNEL_RTOL['float32']:
        raise AssertionError(f'M={m} {name}: rel err vs float64 {rel:.3g} > '
                             f'{KERNEL_RTOL["float32"]}')
      worst = max(worst, rel)
    log(f'member tiles check M={m} ({tiles} tile(s), cross against '
        f'{m + 3}): fused pass, spread and cross launched once each, max '
        f'rel err vs the float64 broadcast {worst:.3g} (tol '
        f'{KERNEL_RTOL["float32"]}) ok')
  m = 1817 + 370
  x = rng.standard_normal((m, n), dtype=np.float32)
  x[3, 0] = x[2000, 1] = np.inf
  x[1815, 2] = x[1816, 2] = -np.inf
  x[5, 3], x[2100, 3] = np.inf, -np.inf
  x[m - 1, 4] = np.nan
  y = rng.standard_normal(n, dtype=np.float32)
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    stats_against_plain(torch.from_numpy(x).to(DEVICE, dtype),
                        torch.from_numpy(y).to(DEVICE, dtype),
                        f'member tiles M={m}', dname)
    log(f'member tiles check M={m} {dname}: +-inf and NaN members across '
        'two tiles give the plain version\'s points ok')


def build_report(build_log: str) -> None:
  """Phase 2's reading of nvcc's -Xptxas -v lines: the shared-memory and
  cross kernels line by line; the register kernels as registers per
  (dtype, output set) and M. Raises unless every register kernel was
  compiled, with 0 bytes of stack frame and spills."""
  import re
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  entry = re.compile(r"Compiling entry function '(\S+)'")
  props = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                     r'(\d+) bytes spill loads')
  regs = re.compile(r'Used (\d+) registers')
  name = re.compile(r'register_stats_kernelI(f|13__nv_bfloat16)Lb([01])E'
                    r'Li(\d+)E')
  kernels = {}  # mangled name -> [registers, stack + spill bytes]
  current = None
  for line in build_log.splitlines():
    if line.startswith('== '):
      log(f'  nvcc: {line}')
    if m := entry.search(line):
      current = m.group(1)
      kernels[current] = [None, None]
      if 'register_stats_kernel' not in current:
        log(f'  nvcc: {line.strip()}')
    elif current and (m := props.search(line)):
      kernels[current][1] = sum(int(g) for g in m.groups())
      if 'register_stats_kernel' not in current:
        log(f'  nvcc: {line.strip()}')
    elif current and (m := regs.search(line)):
      kernels[current][0] = int(m.group(1))
      if 'register_stats_kernel' not in current:
        log(f'  nvcc: {line.strip()}')
  table = {}
  for mangled, (nregs, spill) in kernels.items():
    if 'register_stats_kernel' not in mangled:
      continue
    if nregs is None or spill is None:
      raise AssertionError(f'no ptxas properties for {mangled}')
    if spill:
      raise AssertionError(f'{mangled}: {spill} bytes of stack frame and '
                           'spills on a register route')
    if m := name.search(mangled):
      dtype = 'f32' if m.group(1) == 'f' else 'bf16'
      key = (dtype, ('spread', 'fused')[int(m.group(2))])
      table.setdefault(key, {})[int(m.group(3))] = nregs
  want = 4 * len(cp.REGISTER_MEMBERS)
  got = sum(len(v) for v in table.values())
  if got != want:
    raise AssertionError(f'{got} register kernels in the build log, want '
                         f'{want}')
  for (dtype, outs), by_m in sorted(table.items()):
    log(f'  nvcc: network {outs} {dtype} registers by M: '
        + ' '.join(f'{m}:{r}' for m, r in sorted(by_m.items())))
  log(f'  nvcc: {want} register kernels, every one with 0 bytes of stack '
      'frame, spill stores and spill loads')


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
    p, t = os.path.join(tmp, 'p.npz'), os.path.join(tmp, 't.npz')
    io.save_dataset(p, {'2m_temperature': DimArray(
        rng.standard_normal((len(inits), 2) + CLI_GRID, dtype=np.float32),
        ('time', 'prediction_timedelta', 'latitude', 'longitude'),
        {'time': inits, 'prediction_timedelta': leads, **space})})
    io.save_dataset(t, {'2m_temperature': DimArray(
        rng.standard_normal((len(valid),) + CLI_GRID, dtype=np.float32),
        ('time', 'latitude', 'longitude'), {'time': valid, **space})})

    def run(suffix: str):
      """The CLI over the stores in ``suffix``'s container, its output in
      the same container; returns the RMSE."""
      if suffix != '.npz':
        for path in (p, t):
          io.save_dataset(path[:-4] + suffix, io.load_dataset(path))
      out = os.path.join(tmp, f'o{suffix}')
      cmd = [sys.executable, '-m',
             'weatherbenchx_tpu_torch.apps.run_evaluation', '--device', 'cuda',
             f'--prediction_path={p[:-4]}{suffix}',
             f'--target_path={t[:-4]}{suffix}', f'--output_path={out}',
             '--time_start=2020-01-01', '--time_stop=2020-01-05',
             '--lead_time_stop=12', '--variables=2m_temperature',
             '--time_chunk_size=2']
      proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            check=False)
      if proc.returncode != 0:
        raise AssertionError(f'CLI ({suffix}) failed ({proc.returncode}):\n'
                             f'{(proc.stdout + proc.stderr)[-4000:]}')
      return io.load_dataset(out)['rmse.2m_temperature']

    t0 = time.perf_counter()
    rmse = run('.npz')
    seconds = time.perf_counter() - t0
    for suffix in ('.wbx', '.nc'):
      other = run(suffix)
      if not (other.dims == rmse.dims
              and np.array_equal(other.values, rmse.values)):
        raise AssertionError(f'CLI from {suffix} stores: {other.values} '
                             f'differs from the .npz run {rmse.values}')
      log(f'cli: from {suffix} stores with a {suffix} output, equal to the '
          '.npz run bit for bit ok')
  far = float(np.abs(rmse.values - math.sqrt(2)).max())
  if rmse.shape != (2, 2) or not far <= CLI_RMSE_TOL:
    raise AssertionError(f'CLI rmse {rmse.values} (shape {rmse.shape}): '
                         f'{far:.4g} from sqrt(2), tol {CLI_RMSE_TOL}')
  log(f'cli: {len(inits)} inits x 2 leads x {CLI_GRID} in '
      f'{seconds:.1f} s; rmse {rmse.values.ravel()} vs '
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


def bench_sources(stores, paths=None) -> dict:
  """The CLI's configs of the three stores: in memory (``ds``), or the
  on-disk stores at ``paths`` (``path``)."""
  from weatherbenchx_tpu_torch.apps import configs
  out = {}
  for key in ('predictions', 'targets', 'climatology'):
    out[key] = ({'path': paths[key]} if paths else {'ds': stores[key]})
  out['targets']['data_loader_kwargs'] = {
      'preprocessing_fn': configs.sort_latitude}
  return out


def bench_pipeline(stores, registry, sources):
  """The benchmark CLI's own construction over the stores' configs."""
  from weatherbenchx_tpu_torch import time_chunks
  from weatherbenchx_tpu_torch.apps import run_benchmark_evaluation as cli
  from weatherbenchx_tpu_torch.parallel import pipeline
  variables, levels = bench_variables(), list(BENCH_LEVELS)
  p_loader, t_loader = cli.build_loaders(
      'hres', sources['predictions'], sources['targets'], variables, levels)
  climatology = cli.load_climatology(sources['climatology'], variables,
                                     levels)
  metrics = cli.build_metrics(variables, climatology, is_probabilistic=False)
  aggregator = cli.build_aggregator(
      cli.open_store(sources['targets'])['land_sea_mask'], temporal=False)
  times = time_chunks.TimeChunks(stores['inits'], stores['leads'],
                                 init_time_chunk_size=1,
                                 lead_time_chunk_size=BENCH_LEADS)
  return pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=aggregator, predictions_loader=p_loader,
      targets_loader=t_loader, times=times, device=DEVICE,
      metrics_registry=registry)


def run_bench(stores, budget_bytes, card: str, sources=None,
              label: str = 'benchmark path'):
  """One pipeline run under a resource budget (None: the default) over
  the stores' configs (``bench_sources``; default in memory); returns
  (pipeline, host state, seconds, timings): the run's seconds and stage
  timers, the construction's seconds (climatology opened and uploaded)
  and the loaders' one-time preparation. The preparation is timed apart,
  before the run, so seconds per chunk leave it out; ``s_per_chunk_with_
  prepare`` counts it in, as a run that prepares on its first chunk
  pays it."""
  import torch
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.metrics import base
  if budget_bytes is None:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  else:
    os.environ['WBX_RESOURCE_BYTES'] = str(budget_bytes)
  t0 = time.perf_counter()
  try:
    registry = observability.Metrics()
    pipe = bench_pipeline(stores, registry, sources or bench_sources(stores))
  finally:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  ev = pipe._evaluator
  seeps = pipe.metrics['seeps']
  p1_ids = {base.resource_id(p1) for p1 in seeps._p1.values()}
  if p1_ids & ev.host_gather_ids or not p1_ids <= set(ev.resources()):
    raise AssertionError('SEEPS p1 must stay resident')
  torch.cuda.synchronize()
  setup = time.perf_counter() - t0
  t0 = time.perf_counter()
  pipe.predictions_loader.maybe_prepare_dataset()
  pipe.targets_loader.maybe_prepare_dataset()
  prepare = time.perf_counter() - t0
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = pipe.run()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  timers = {k: round(d.mean, 4) for k, d in registry.timings.items()}
  plan = 'default' if budget_bytes is None else f'{budget_bytes} B'
  log(f'{label} [{plan} budget]: {len(ev.host_gather_ids)} of '
      f'{len(ev.resources()) + len(ev.host_gather_ids)} climatology arrays '
      f'host-gathered, {ev.resource_bytes / 2**30:.3f} GiB resident; '
      f'construction (climatology opened and uploaded) {setup:.3f} s; '
      f'loaders\' one-time preparation {prepare:.3f} s; '
      f'{seconds / BENCH_INITS:.3f} s per chunk ({BENCH_INITS} chunks, wall '
      f'clock to a final synchronize), {(prepare + seconds) / BENCH_INITS:.3f} '
      f'with the preparation counted in; per-chunk means (s) '
      f'{json.dumps(timers)}; peak device memory {peak / 2**30:.2f} GiB; '
      f'card {card}')
  return pipe, state, seconds, {'s_per_chunk': seconds / BENCH_INITS,
                                's_per_chunk_with_prepare':
                                    (prepare + seconds) / BENCH_INITS,
                                'construction_s': setup,
                                'prepare_s': prepare, **timers}


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


def benchmark_path(seed: int, card: str) -> tuple:
  """Phase 6: the deterministic benchmark path at full width, under the
  default budget (every climatology resident) and under a budget below
  the climatology's size (the largest arrays host-gathered); the two
  states equal by torch.equal. Returns (seconds per chunk, the stores, the
  resident run's state, its timings)."""
  import torch
  t0 = time.perf_counter()
  stores = bench_stores(seed)
  nbytes = sum(da.data.numel() * da.data.element_size()
               for key in ('predictions', 'targets', 'climatology')
               for da in stores[key].values())
  log(f'benchmark path: made {len(bench_variables())} variables '
      f'({len(BENCH_LEVELS)} levels upper-air), {nbytes / 2**30:.2f} GiB of '
      f'host stores, in {time.perf_counter() - t0:.1f} s')
  pipe, state, seconds, timings = run_bench(stores, None, card)
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
  pipe2, state2, seconds2, _ = run_bench(stores, budget, card)
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
  return ({'resident_s_per_chunk': seconds / BENCH_INITS,
           'host_gather_s_per_chunk': seconds2 / BENCH_INITS},
          stores, state, timings)


# Phase 9's stores on disk, written where git ignores them, and the room
# they need: about 6 GB of float32 fields that barely compress, with
# room to spare.
DISK_STORE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              'build', 'chip_smoke_stores')
DISK_STORE_NEEDS_BYTES = 12 * 2**30
# The containers: WeatherBench 2's public stores are zarr v2 with
# blosc-lz4 and byte shuffle, one (init, lead, level) field per cell.
DISK_CONTAINERS = {
    'predictions': ('predictions.zarr', {
        'compressor': 'blosc', 'zarr_format': 2, 'chunks': {
            'time': 1, 'prediction_timedelta': 1, 'level': 1}}),
    'targets': ('targets.zarr', {
        'compressor': 'zstd', 'zarr_format': 3,
        'chunks': {'time': 1, 'level': 1}, 'shards': {'time': 7}}),
    'climatology': ('climatology.wbx', None),
}


def tree_bytes(path: str) -> int:
  if os.path.isfile(path):
    return os.path.getsize(path)
  return sum(os.path.getsize(os.path.join(root, f))
             for root, _, files in os.walk(path) for f in files)


def time_target_flip(stores, path: str, card: str) -> dict:
  """The first chunk's targets read from the on-disk store by the loader,
  with and without sort_latitude's latitude flip, in turns (flip, plain,
  plain, flip), each read's native decode seconds beside it: the flip's
  cost apart from the decode. The flipped chunk must equal the plain one
  reversed along latitude."""
  import torch
  from weatherbenchx_tpu_torch import native, time_chunks
  from weatherbenchx_tpu_torch.apps import configs
  from weatherbenchx_tpu_torch.data import loaders
  inits, leads = time_chunks.TimeChunks(
      stores['inits'], stores['leads'], init_time_chunk_size=1,
      lead_time_chunk_size=BENCH_LEADS)[0]
  reads, chunks = {'flip': [], 'plain': []}, {}
  for name in ('flip', 'plain', 'plain', 'flip'):
    loader = loaders.TargetsFromDataset(
        path=path, variables=bench_variables(),
        sel_kwargs={'level': list(BENCH_LEVELS)},
        preprocessing_fn=configs.sort_latitude if name == 'flip' else None)
    loader.maybe_prepare_dataset()
    native.reset_call_counts()
    t0 = time.perf_counter()
    chunks[name] = loader.load_chunk(inits, leads)
    seconds = time.perf_counter() - t0
    reads[name].append({'seconds': seconds,
                        'decode_ranges_s': native.SECONDS['decode_ranges']})
  for k, da in chunks['plain'].items():
    if 'latitude' in da.dims and not torch.equal(
        chunks['flip'][k].data,
        da.data.flip(da.dims.index('latitude'))):
      raise AssertionError(f'{k}: the flipped targets are not the plain '
                           'ones reversed along latitude')
  out = {name: {key: float(np.median([r[key] for r in rs]))
                for key in rs[0]} for name, rs in reads.items()}
  log(f'disk benchmark path: one chunk of targets read with the latitude '
      f'flip {out["flip"]["seconds"]:.3f} s (native decode '
      f'{out["flip"]["decode_ranges_s"]:.3f} s), without it '
      f'{out["plain"]["seconds"]:.3f} s (decode '
      f'{out["plain"]["decode_ranges_s"]:.3f} s); medians of 2 reads each, '
      f'in turns; card {card}')
  return out


def disk_benchmark_path(stores, want_state, in_memory: dict,
                        card: str) -> dict:
  """Phase 9: phase 6's stores written to disk by the port's writers and
  evaluated from there through the CLI's construction (lazy opens); the
  state equal to phase 6's by torch.equal. Fails unless the native
  blockstore and zarr codec are built and called."""
  import shutil
  import torch
  from weatherbenchx_tpu_torch import io, native, zarr_io
  if not (native.blockstore_available() and native.zarrcodec_available()):
    raise AssertionError('the native blockstore and zarr codec must build '
                         'on the card\'s machine (g++, zlib, zstd, lz4)')
  shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  os.makedirs(DISK_STORE_DIR)
  free = shutil.disk_usage(DISK_STORE_DIR).free
  if free < DISK_STORE_NEEDS_BYTES:
    raise AssertionError(f'{DISK_STORE_DIR}: {free} bytes free, the stores '
                         f'need {DISK_STORE_NEEDS_BYTES}')
  try:
    native.reset_call_counts()
    paths, writes = {}, {}
    for key, (name, zarr_kwargs) in DISK_CONTAINERS.items():
      path = paths[key] = os.path.join(DISK_STORE_DIR, name)
      nbytes = sum(da.data.numel() * da.data.element_size()
                   for da in stores[key].values())
      t0 = time.perf_counter()
      if zarr_kwargs is None:
        io.save_dataset(path, stores[key])
      else:
        zarr_io.save_dataset_zarr(path, stores[key], **zarr_kwargs)
      seconds = time.perf_counter() - t0
      on_disk = tree_bytes(path)
      writes[key] = {'seconds': seconds, 'GB_per_s': nbytes / seconds / 1e9,
                     'array_bytes': nbytes, 'bytes_on_disk': on_disk}
      log(f'disk benchmark path: wrote {key} ({name}, {nbytes} bytes of '
          f'arrays, {on_disk} bytes on disk) in {seconds:.3f} s, '
          f'{nbytes / seconds / 1e9:.3f} GB/s; card {card}')
    write_calls = {k: (native.CALLS[k], native.BYTES[k]) for k in native.CALLS}
    native.reset_call_counts()
    _, state, _, timings = run_bench(
        stores, None, card, bench_sources(stores, paths),
        label='disk benchmark path')
    run_calls = {k: (native.CALLS[k], native.BYTES[k]) for k in native.CALLS}
    run_native_s = dict(native.SECONDS)
    log(f'disk benchmark path: native (calls, array bytes) while writing '
        f'{write_calls}; while evaluating {BENCH_INITS} chunks {run_calls}')
    # Each loader thread calls its native reads one after another, so a
    # function's seconds over the chunks split its loader's per-chunk mean
    # into the native read and decode and the Python around it (axis plans,
    # shard indexes, the scatter into the window; for the predictions also
    # the statistics' host preparation). The construction's few calls (the
    # land-sea mask) are counted in.
    loads = {}
    for timer, fn in (('load_targets_seconds', 'decode_ranges'),
                      ('load_predictions_seconds', 'decode_cells')):
      total, in_native = timings[timer], run_native_s[fn] / BENCH_INITS
      loads[timer] = {'seconds': total, f'native_{fn}_s': in_native,
                      'python_s': total - in_native}
      log(f'disk benchmark path: {timer} {total:.3f} s per chunk, of which '
          f'native {fn} {in_native:.3f} s and the Python around it '
          f'{total - in_native:.3f} s; card {card}')
    log(f'disk benchmark path: native seconds while evaluating '
        f'{BENCH_INITS} chunks {json.dumps(run_native_s)}; card {card}')
    if not (write_calls['pwrite_blocks'][0] and write_calls['encode_cells'][0]
            and write_calls['encode_buffers'][0]
            and run_calls['decode_cells'][0]
            and run_calls['decode_ranges'][0]):
      raise AssertionError('the native blockstore and zarr codec must carry '
                           'the writes and the reads')
    got, want = state.to_dataset(), want_state.to_dataset()
    if sorted(got) != sorted(want) or not all(
        torch.equal(got[k].data, want[k].data) for k in want):
      raise AssertionError('the on-disk run\'s state differs from the '
                           'in-memory run\'s')
    log(f'disk benchmark path: state equal to phase 6\'s by torch.equal '
        f'({len(want)} arrays); seconds per chunk {timings["s_per_chunk"]:.3f} '
        f'on disk vs {in_memory["s_per_chunk"]:.3f} in memory (this run); '
        f'one-time preparation {timings["prepare_s"]:.3f} vs '
        f'{in_memory["prepare_s"]:.3f} s; card {card}')
    flip = time_target_flip(stores, paths['targets'], card)
  finally:
    shutil.rmtree(DISK_STORE_DIR, ignore_errors=True)
  return {'writes': writes, 'on_disk': timings, 'in_memory': in_memory,
          'loads': loads, 'target_flip': flip,
          'native_calls': {'write': write_calls, 'evaluate': run_calls},
          'native_seconds': run_native_s}


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


def kernel_launches(stdout: str) -> dict:
  line = [l for l in stdout.splitlines() if l.startswith('Kernel launches: ')]
  return json.loads(line[-1].removeprefix('Kernel launches: '))


def bench_cli_from_zarr(tmp: str, paths: dict, det: dict, ens: dict) -> dict:
  """Phase 8's CLI runs again from zarr v2 blosc-lz4 copies of the stores
  (one field per cell, as WeatherBench 2's public stores), the metrics
  written as zarr, netCDF and wbx; each equal to its .npz run bit for bit.
  Returns the ensemble run's kernel launches."""
  from weatherbenchx_tpu_torch import io, zarr_io
  zpaths = {}
  for key, path in paths.items():
    zpaths[key] = path[:-4] + '.zarr'
    zarr_io.save_dataset_zarr(
        zpaths[key], io.load_dataset(path), compressor='blosc',
        chunks={'time': 1, 'prediction_timedelta': 1, 'level': 1,
                'number': 1})
  out = None
  for prediction, fmt, want in (('hres', 'zarr', det), ('hres', 'nc', det),
                                ('ens', 'wbx', ens)):
    args = [f'--prediction={prediction}',
            f'--prediction_path={zpaths[prediction]}',
            '--variables=geopotential,2m_temperature',
            f'--output_dir={tmp}/{prediction}_{fmt}',
            f'--output_format={fmt}']
    if prediction == 'hres':
      args += [f'--target_path={zpaths["era5"]}',
               f'--climatology_path={zpaths["clim"]}']
    else:
      args += [f'--target_path={zpaths["ens_era5"]}']
    stdout = run_bench_cli(args)
    if prediction == 'ens':
      out = stdout
    got = io.load_dataset(f'{tmp}/{prediction}_{fmt}/{prediction}_vs_era5_'
                          f'64x32_2020-init12h.{fmt}')
    if sorted(got) != sorted(want) or not all(
        got[k].dims == want[k].dims
        and np.array_equal(got[k].values, want[k].values, equal_nan=True)
        for k in want):
      raise AssertionError(f'benchmark CLI {prediction} from zarr ({fmt} '
                           'output) differs from its .npz run')
    log(f'benchmark cli: {prediction} from zarr v2 blosc stores, {fmt} '
        'output, equal to the .npz run bit for bit ok')
  return kernel_launches(out)


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
    launches = kernel_launches(out)
    zarr_launches = bench_cli_from_zarr(tmp, paths, det, ens)
  if zarr_launches != launches:
    raise AssertionError(f'the ensemble run from zarr launched '
                         f'{zarr_launches}, from .npz {launches}')
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


def time_cuda(fns: dict, rounds: int, reps: int = 1) -> dict:
  """Median and IQR (ms per call) per function, taken in turns: CUDA
  events around ``reps`` calls back to back, so that the host's launch
  overhead hides behind the device's work."""
  import torch
  samples = {k: [] for k in fns}
  names = list(fns)
  for r in range(rounds + 1):
    for name in (names if r % 2 == 0 else names[::-1]):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(reps):
        fns[name]()
      end.record()
      end.synchronize()
      if r:  # round 0 warms up
        samples[name].append(start.elapsed_time(end) / reps)
  return {k: (float(np.median(v)), float(np.percentile(v, 25)),
              float(np.percentile(v, 75)), len(v))
          for k, v in samples.items()}


def stats_work(m: int, n: int, fused: bool) -> tuple:
  """(bytes, operations) of the fused or spread-only kernel on float32
  x (m, n), in the form spread_form(m): each input read once, each output
  written once; per point the compare-exchanges' min and max, the shift
  and weighted sum and the NaN test (network), or a difference and an add
  per pair (shared); fused adds the sum, skill, mean and squared
  deviations."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  if cp.spread_form(m) == 'network':
    ops = 2 * len(cp.sort_network(m)) + 3 * m
  else:
    ops = m * (m - 1)
  if fused:
    ops += 5 * m + 1
  nbytes = 4 * n * (m + (1 + 4 if fused else 1))
  return nbytes, ops * n


def cross_work(mx: int, my: int, n: int) -> tuple:
  """(bytes, operations) of the cross kernel on float32 x (mx, n) and
  y (my, n): a difference and an add per pair."""
  return 4 * n * (mx + my + 1), 2 * mx * my * n


def bound(nbytes: int, ops: int) -> tuple:
  """(least ms on the card, 'bytes' or 'operations')."""
  t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
  return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                     else 'operations')


def time_kernels(x, y, yt, card: str) -> dict:
  """Phase 10's kernel timings at the paths' shapes, float32: fused and
  spread at M = 50, spread at M = 10 (the ensemble path's analysis), cross
  50 x 10, each against its plain version, TIMING_REPS calls per sample
  for both; and, in the kernels' turns, a device-to-device copy of x
  (x.clone()), the card's streaming rate. Returns {name: (median, q1, q3,
  runs)} in ms and logs each kernel beside its bound and its rate beside
  the copy's."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  n = y.numel()
  res = time_cuda({
      'fused_kernel': lambda: cp.fused_ensemble_stats(x, y),
      'spread_kernel': lambda: cp.pairwise_spread_sum(x),
      'spread10_kernel': lambda: cp.pairwise_spread_sum(yt),
      'cross_kernel': lambda: cp.pairwise_cross_sum(x, yt),
      'copy': x.clone,
  }, rounds=12, reps=TIMING_REPS)
  res.update(time_cuda({
      'fused_plain': lambda: cp.fused_ensemble_stats_plain(x, y),
      'spread_plain': lambda: cp.pairwise_spread_sum_plain(x),
      'spread10_plain': lambda: cp.pairwise_spread_sum_plain(yt),
      'cross_plain': lambda: cp.pairwise_cross_sum_plain(x, yt),
  }, rounds=6, reps=TIMING_REPS))
  m, mt = x.shape[0], yt.shape[0]
  med, q1, q3, count = res['copy']
  copy_bytes = 2 * x.numel() * x.element_size()
  log(f'timing copy (x.clone(), {copy_bytes} bytes read and written): '
      f'median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms over {count} runs; '
      f'{copy_bytes / med / 1e9:.4f} TB/s, '
      f'{copy_bytes / med * 1e3 / HBM_BYTES_PER_S:.1%} of '
      f'{HBM_BYTES_PER_S / 1e12} TB/s; card {card}')
  work = {'fused': stats_work(m, n, True), 'spread': stats_work(m, n, False),
          'spread10': stats_work(mt, n, False), 'cross': cross_work(m, mt, n)}
  for name, (med, q1, q3, count) in res.items():
    if name == 'copy':
      continue
    key, kind = name.rsplit('_', 1)
    ms, by = bound(*work[key])
    share = ''
    if kind == 'kernel':
      share = (f'{ms / med:.1%} of the bound, '
               f'{copy_share(res, work[key][0], med, copy_bytes):.1%} of the '
               'copy\'s rate; ')
    log(f'timing {name}: median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms '
        f'over {count} runs; {share}bound {ms:.4f} ms by {by}; N={n}, '
        f'float32; card {card}')
  return res


def copy_share(res: dict, nbytes: int, ms: float, copy_bytes: int) -> float:
  """A kernel's bytes per ms over the copy's in the same run."""
  return (nbytes / ms) / (copy_bytes / res['copy'][0])


def timing(ev, chunks, stores, card: str) -> dict:
  """Phase 10: the kernels (time_kernels) at their paths' shapes; one
  eval_chunk; the ensemble pipeline's seconds per chunk."""
  from weatherbenchx_tpu_torch import observability
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  p, t = chunks[0]
  x = p['2m_temperature'].data.to(DEVICE)
  y = t['2m_temperature'].data.to(DEVICE)
  yt = stores[1]['2m_temperature'].data[:, :GRID[1]][:, None].to(
      DEVICE).contiguous()
  res = time_kernels(x, y, yt, card)
  pair = ev.prepare_pair(p, t)
  steps = time_cuda({
      'eval_chunk (host chunk in)': lambda: ev.eval_chunk(p, t),
      'eval_accum (chunk on device)':
          lambda: ev.eval_accum(pair, AggregationState.zero()),
  }, rounds=10)
  for name, (med, q1, q3, count) in steps.items():
    log(f'timing {name}: median {med:.4f} ms, IQR [{q1:.4f}, {q3:.4f}] ms '
        f'over {count} runs; M={M}, N={x[0].numel()}, float32; card {card}')
  res.update(steps)
  del x, y, yt, pair
  registry = observability.Metrics()
  _, seconds = run_ensemble_pipeline(stores, registry)
  per_chunk = {k: d.mean for k, d in registry.timings.items()}
  log(f'timing ensemble pipeline: {seconds / N_ENS_INITS:.4f} s per chunk '
      f'({N_ENS_INITS} chunks, wall clock to a final synchronize); per-chunk '
      f'means (s) {json.dumps(per_chunk)}; card {card}')
  return res


def timing_fields(res: dict, key: str, work: tuple, form: str,
                  copy_bytes: int) -> dict:
  """A kernel's time, its plain version's (both TIMING_REPS calls per
  sample), its bound and its rate against the copy's at one shape."""
  ms = res[f'{key}_kernel'][0]
  bound_ms, by = bound(*work)
  return {'ms': ms, 'plain_ms': res[f'{key}_plain'][0], 'bound_ms': bound_ms,
          'bound_by': by, 'library_ms': None, 'bytes': work[0],
          'bound_share': bound_ms / ms,
          'copy_share': copy_share(res, work[0], ms, copy_bytes),
          'form': form}


def kernels_line(main_launches, ens_launches, main_err, res, n) -> dict:
  """The `kernels` JSON: fused and spread at M = 50, cross at 50 x 10, and
  the spread's M = 10 launch (the ensemble path's analysis) beside it. No
  single PyTorch call computes any of the three functions, so library_ms
  is null."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  csrc = 'weatherbenchx_tpu_torch/ops/csrc/'
  replaced = 'weatherbenchx_tpu/ops/crps_pairwise.py'
  # The TPU kernel the JAX package runs for a spread of m members: its
  # _spread_kernel_sort :229 from 20 members on (_spread_form),
  # _spread_kernel :124 below.
  def spread_line(m):
    return 229 if m >= 20 else 124
  f50, f10 = cp.spread_form(M), cp.spread_form(M_TARGETS)
  register = csrc + ('crps_pairwise.cu' if f50 == 'shared'
                     else 'register_stats.cuh')
  copy_bytes = 2 * 4 * M * n
  return {'kernels': [{
      'name': 'fused_ensemble_stats', 'route': 'cuda', 'source': register,
      'replaces': f'{replaced}:238',
      'launches': main_launches['fused_ensemble_stats'],
      'max_abs_err': max(main_err[k] for k in (
          'spread_sum', 'skill_sum', 'mean', 'sq_dev_sum')),
      **timing_fields(res, 'fused', stats_work(M, n, True), f50, copy_bytes),
  }, {
      'name': 'pairwise_spread_sum', 'route': 'cuda', 'source': register,
      'replaces': f'{replaced}:{spread_line(M)}',
      'launches': ens_launches['pairwise_spread_sum'],
      'max_abs_err': main_err['spread_only'],
      **timing_fields(res, 'spread', stats_work(M, n, False), f50,
                      copy_bytes),
      'm10': {'replaces': f'{replaced}:{spread_line(M_TARGETS)}',
              **timing_fields(res, 'spread10',
                              stats_work(M_TARGETS, n, False), f10,
                              copy_bytes)},
  }, {
      'name': 'pairwise_cross_sum', 'route': 'cuda',
      'source': csrc + 'crps_pairwise.cu', 'replaces': f'{replaced}:426',
      'launches': ens_launches['pairwise_cross_sum'],
      'max_abs_err': main_err['cross'],
      **timing_fields(res, 'cross', cross_work(M, M_TARGETS, n), 'cross',
                      copy_bytes),
  }]}


# Phase 11, the metric families: the three families of the JAX package's
# benchmark that have no kernel of their own (FSS, rank histogram, relative
# economic value), as it defines them, on the production aggregator (the 17
# regions and their land parts, area weights, masked), and a drive of three
# binnings at once (weatherbenchx_tpu_torch/bench_families.py holds the
# cases and their float64 references). One init x 4 leads x 721 x 1440,
# float32, from the seed.
FAMILY_GRID = (1, 4, 721, 1440)
# Against float64: relative to |value|, the relative economic value (which
# crosses zero) to max(|value|, 1).
FAMILY_F64_RTOL = 1e-5
FAMILY_SIGMAS = 6.0  # closed forms: standard errors at a bin's Kish size
# The 51 ranks' means against 1: each is its own float32 contraction over a
# region's points, so they sum to 1 within float32 roundoff only (the
# float64 reference within 1e-12).
RANK_SUM_TOL = 1e-6


def device_time(fn) -> tuple:
  """(ms the card was busy, [(kernel, ms), ...] the three longest) during
  one call of fn, by torch.profiler's kernel records; (None, []) where it
  records no device time."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    fn()
    torch.cuda.synchronize()
  # Kernel records only: an operator's record repeats its kernels' time.
  rows = [(e.key, e.self_device_time_total / 1e3) for e in p.key_averages()
          if e.device_type == DeviceType.CUDA]
  rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
  if not rows:
    return None, []
  return sum(ms for _, ms in rows), rows[:3]


def family_phase(seed: int, card: str) -> dict:
  """Phase 11: each family through ChunkEvaluator.eval_chunk and
  metric_values on the card; values against float64, the same chunk twice
  to the same bits, no kernel launch counted, tensors on the card; step
  times by CUDA events, the host-fed eval_chunk and peak memory."""
  import torch
  from weatherbenchx_tpu_torch import aggregation, bench_families
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
  from weatherbenchx_tpu_torch.parallel import evaluator
  grid = FAMILY_GRID
  weights = bench_families.family_weights(grid, DEVICE)
  cp.reset_launch_counts()
  report = {}
  for name in bench_families.FAMILIES:
    t0 = time.perf_counter()
    metrics, aggregator, preds, tgts = bench_families.family_case(
        name, seed, grid)
    made = time.perf_counter() - t0
    ev = evaluator.ChunkEvaluator(metrics, aggregator, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ev.eval_chunk(preds, tgts)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    again = ev.eval_chunk(preds, tgts)
    arrays = state.to_dataset()
    for key, da in arrays.items():
      if da.device.type != DEVICE:
        raise AssertionError(f'families {name}: {key} on {da.device}')
      if not torch.equal(da.data, again.to_dataset()[key].data):
        raise AssertionError(f'families {name}: {key} differs between two '
                             'evaluations of one chunk')
    values = state.metric_values(metrics)
    if any(da.device.type != DEVICE for da in values.values()):
      raise AssertionError(f'families {name}: values not on {DEVICE}')
    ref = bench_families.family_reference(name, preds, tgts, weights)
    checked = bench_families.check_family_values(
        name, values, ref, weights, rtol=FAMILY_F64_RTOL,
        sigmas=FAMILY_SIGMAS, rank_sum_tol=RANK_SUM_TOL)
    for metric, (err, note) in checked.items():
      measure = ('max(|value|, 1)' if metric in bench_families.RELATIVE_FLOOR
                 else '|value|')
      log(f'families {metric}: {note}, max rel err vs float64 {err:.3g} '
          f'(tol {FAMILY_F64_RTOL}, relative to {measure}) ok')
    rel = {metric: err for metric, (err, _) in checked.items()}
    pair = ev.prepare_pair(preds, tgts)
    steps = time_cuda({
        'eval_accum': lambda: ev.eval_accum(pair, AggregationState.zero()),
    }, rounds=12)
    fed = time_cuda({'eval_chunk': lambda: ev.eval_chunk(preds, tgts)},
                    rounds=3)
    med, q1, q3, count = steps['eval_accum']
    busy, longest = device_time(
        lambda: ev.eval_accum(pair, AggregationState.zero()))
    busy_note = 'device time not measured' if busy is None else (
        f'card busy {busy:.4f} ms of a step ({busy / med:.1%} of the '
        'median), longest kernels ' + ', '.join(
            f'{k[:60]} {ms:.3f} ms' for k, ms in longest))
    # The operands' cache key: the coords the binnings read enter it by
    # content, hashed once per coord object (cold), then found (warm).
    stat = pair[0][bench_families.VARIABLE]
    aggregation._CONTENT_FINGERPRINTS.clear()
    t0 = time.perf_counter()
    aggregator.layout_key(stat)
    key_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(100):
      aggregator.layout_key(stat)
    key_warm = (time.perf_counter() - t0) / 100
    n_stats = sum(len(v) for v in state.sum_weights.values())
    log(f'families {name}: {n_stats} statistic arrays, inputs made in '
        f'{made:.2f} s; '
        f'eval_accum (chunk on the card) median {med:.4f} ms, IQR '
        f'[{q1:.4f}, {q3:.4f}] ms over {count} runs; {busy_note}; '
        f'eval_chunk (host chunk '
        f'in) median {fed["eval_chunk"][0]:.4f} ms over '
        f'{fed["eval_chunk"][3]} runs, first call {first * 1e3:.1f} ms; '
        f'peak device memory {peak / 2**30:.3f} GiB; layout key (host) '
        f'{key_cold * 1e6:.0f} us cold, {key_warm * 1e6:.0f} us warm, reading '
        f'{sorted({c for b in aggregator.bin_by for c in b.host_coords})}; '
        f'two evaluations equal '
        f'by torch.equal; grid {tuple(grid)}, float32; card {card}')
    report[name] = {'eval_accum_ms': med, 'eval_accum_iqr_ms': [q1, q3],
                    'device_busy_ms': busy,
                    'eval_chunk_ms': fed['eval_chunk'][0],
                    'first_eval_chunk_ms': first * 1e3,
                    'peak_gib': peak / 2**30,
                    'layout_key_us': [key_cold * 1e6, key_warm * 1e6],
                    'max_rel_err': rel}
    del ev, pair, stat, preds, tgts, state, again, values, ref
    torch.cuda.empty_cache()
  if any(cp.LAUNCHES.values()):
    raise AssertionError('the metric families have no kernel of their own, '
                         f'yet launches were counted: {cp.LAUNCHES}')
  return report


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
  log(f'phase 2 build: {_build.CSRC} + {len(_build.generated_sources())} '
      f'generated files -> {lib_path} in {time.perf_counter() - t0:.1f} s '
      f'({_build.PARTS + 1} nvcc processes at once, then the link)')
  with open(lib_path + '.log') as f:
    build_report(f.read())

  main_err = check_kernels(args.seed)
  log('phase 3 kernels: all checks within tolerance')
  ev, chunks, main_launches, _ = main_path(args.seed)
  log('phase 4 main path: ok')
  stores, ens_launches = ensemble_path(args.seed)
  log('phase 5 ensemble path: ok')
  bench, bstores, bstate, in_memory = benchmark_path(args.seed, card)
  log('phase 6 benchmark path: ok')
  cli_phase(args.seed)
  log('phase 7 cli: ok')
  benchmark_cli_phase(args.seed)
  log('phase 8 benchmark cli: ok')
  disk = disk_benchmark_path(bstores, bstate, in_memory, card)
  del bstores, bstate
  log('phase 9 disk benchmark path: ok')
  res = timing(ev, chunks, stores, card)
  log('phase 10 timing: done')
  del ev, chunks, stores
  families = family_phase(args.seed, card)
  log('phase 11 metric families: ok')
  log(f'benchmark path seconds per chunk: {json.dumps(bench)}; card {card}')
  log(f'disk benchmark path: {json.dumps(disk)}; card {card}')
  log(f'metric families: {json.dumps(families)}; card {card}')

  n = math.prod(GRID)
  print(json.dumps(kernels_line(main_launches, ens_launches, main_err, res,
                                n)), flush=True)
  print(card, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
