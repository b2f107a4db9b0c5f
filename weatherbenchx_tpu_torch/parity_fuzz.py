"""Randomized parity fuzz of the port: seeded evaluation configs, each run
on a device and held against the port's own CPU run of the same config.

Fixed configurations pin behaviours one at a time; this sweep draws their
interactions: metric subset x reduce dims x binning stack x weighting x
skipna x NaN placement, wrapper chains, FSS sizes and the longitude wrap,
SEEPS thresholds and p1 bounds, and the aggregation contraction at the
production 721 x 1440 grid with up to 34 region bins. A device's own
numerics (a contraction's precision, a kernel's NaN handling, a sort, a
gather) show here as a gap between the device and the CPU.

Families (``draw(family, seed)``):

* ``config``: a deterministic (rmse, mse, bias, mae, acc, activity, and
  csi/ets under ``ContinuousToBinary``), ensemble (crps by sort,
  unbiased spread/skill, unbiased ensemble-mean RMSE) or two-ensemble
  (energy-distance CRPS, Wasserstein, against 5 target members) metric
  subset, random NaNs, reduce dims, skipna, region and latitude-band bins,
  area weights or none;
* ``wrappers``: the ensemble mean, quantiles, Weibull to a binary Brier
  score, or the fair ranked probability score;
* ``spatial_rank``: FSS over binarised fields (random sizes and wrap) and
  the rank histogram (NaN-free);
* ``seeps``: dry thresholds x p1 bounds x NaNs, masked, optional regions;
* ``large_k``: the aggregation alone at 721 x 1440, 6-17 regions and their
  land parts, area weights, 3-5 statistics x 2-4 leads, held to a float64
  contraction of the same weights and bin masks (``large_k_check``).

The layers' families (``LAYER_FAMILIES``), each a layer the four above
never draw:

* ``time_bins``: ``ByTimeUnit`` / ``ByTimeUnitSets`` over every time unit
  both packages take (datetimes from 1900 to 2100 with sub-second parts,
  calendar edges, timedelta leads), ``ByTimeUnitFromSeconds``,
  ``ByCoordBins`` (edges on, between and outside the values),
  ``BySets`` (string and integer sets, complements, global bins), stacked
  with regions;
* ``sparse``: grid forecasts to 0-40 stations through the loaders'
  ``load_chunk`` (a station table or an (init, lead, station) block;
  linear or nearest, wrap, extrapolation, the altitude adjustment, NaN
  masks, ``pad_index_multiple``, station-name networks);
* ``dispatch``: 3-7 chunks through ``EvaluationPipeline`` at 1-8 chunks a
  dispatch, their signature changing mid-stream (``stream_loader``);
* ``inference``: one of the six inference methods (and its baseline
  comparison) on a float64 AR(1) state over init times, held at
  ``INFERENCE_RTOL``;
* ``large_members``: CRPS, spread/skill and ensemble-mean RMSE at 65 to
  70,000 members (the sorted runs, the block sort, the merge sort), ties,
  NaN and +-inf members near 280 K; also held to ``float64_reference``.

Seeds correspond to the JAX package's: the four small families draw call
for call as ``TestRandomizedConfigParity`` in
``tests/test_reference_parity.py`` does (its grid, times, members and
climatology axes are copied here), and ``large_k`` as
``tools/tpu_parity_fuzz.py``, so seed N here is seed N there. A drawn
``Spec`` is plain data (numpy arrays, dates and times, and ``Call`` trees
naming constructors by module path), so the same draw builds and runs in
any package with this package's module layout (``build``, ``run_in``).

Usage (the card by default; ``--device cuda`` raises without one):

  python -m weatherbenchx_tpu_torch.parity_fuzz --seeds 200 \
      [--families time_bins,dispatch --family_seeds dispatch=20]

prints one JSON line (per family: configs, failures, the largest gap,
seconds on the device and on the CPU, kernel launches and the member
counts the kernels saw; the card's name and power limit), then the first
failures, and exits nonzero on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import subprocess
import sys
import time
import types
from typing import Any, Callable, Mapping

import numpy as np
import torch

import weatherbenchx_tpu_torch
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.ops import crps_pairwise

# The fixture of tests/test_reference_parity.py:160-170.
N_INIT, N_LEAD, N_ENS = 4, 3, 7
N_TARGET_MEMBERS = 5
INIT_TIMES = (np.datetime64('2020-01-03T00', 'ns')
              + np.arange(N_INIT) * np.timedelta64(12, 'h'))
LEAD_TIMES = (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype(
    'timedelta64[ns]')
LATS = np.linspace(-90, 90, 19)
LONS = np.linspace(0, 360, 36, endpoint=False)
CLIM_HOURS = np.array([0, 6, 12, 18])
CLIM_DOYS = np.arange(1, 21)
AXES = {'init_time': INIT_TIMES, 'lead_time': LEAD_TIMES, 'latitude': LATS,
        'longitude': LONS, 'hour': CLIM_HOURS, 'dayofyear': CLIM_DOYS}

FAMILIES = ('config', 'wrappers', 'spatial_rank', 'seeps')
LARGE_K = 'large_k'
LARGE_K_GRID = (721, 1440)
# The reference's envelope (BASELINE.md:25), for values and for a large-K
# bin sum relative to max(|sum|, its row's RMS): a float32 contraction
# (numpy's einsum included) lands near 1.3e-5 there.
ATOL = RTOL = 1e-5
COORD_RTOL = 1e-6
LARGE_K_LIMIT = 2e-5

DET_METRICS = ('rmse', 'mse', 'bias', 'mae', 'acc', 'activity', 'csi', 'ets')
ENS_METRICS = ('crps', 'unbiased_spread_skill', 'unbiased_mean_rmse')
ENS2_METRICS = ('crps_distance', 'wasserstein')
CONFIG_KINDS = ('deterministic', 'ensemble', 'two_ensemble')
REGIONS = {'tropics': ((-20, 20), (0, 360)), 'nh': ((20, 90), (0, 360))}


# -- specs: plain data ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Field:
  """An array with its dims and coords (numpy): a dim's values, or
  ``(dims, values)`` for a coord over other dims."""
  values: np.ndarray
  dims: tuple
  coords: dict


@dataclasses.dataclass(frozen=True)
class Call:
  """A constructor named by its path in the package
  (``'metrics.deterministic.RMSE'``), with arguments that may hold Calls,
  Fields and containers of them."""
  path: str
  kwargs: dict = dataclasses.field(default_factory=dict)
  args: tuple = ()


@dataclasses.dataclass(frozen=True)
class Case:
  """One evaluation: ``compute_metric_values_for_single_chunk`` of these
  metrics under this aggregator."""
  metrics: dict
  aggregator: Call
  predictions: dict
  targets: dict


@dataclasses.dataclass(frozen=True)
class Spec:
  family: str
  seed: int
  kind: str
  cases: tuple


@dataclasses.dataclass(frozen=True)
class LargeK:
  """Statistics ``{name: Field}`` (each aggregated as variable ``'v'``)
  under one aggregator."""
  aggregator: Call
  statistics: dict


def field(arr, dims) -> Field:
  """A fixture array with its coords (``Var`` of the JAX test): the
  ensemble dim ``number`` sized from the data."""
  arr = np.asarray(arr)
  coords = {d: (np.arange(arr.shape[i]) if d == 'number' else AXES[d])
            for i, d in enumerate(dims)}
  return Field(arr, tuple(dims), coords)


def grid_var(seed, *, ens=False, positive=False, scale=1.0, nan_at=()):
  dims = ['init_time', 'lead_time'] + (['number'] if ens else [])
  shape = [N_INIT, N_LEAD] + ([N_ENS] if ens else [])
  dims += ['latitude', 'longitude']
  shape += [len(LATS), len(LONS)]
  arr = np.random.default_rng(seed).random(tuple(shape), dtype=np.float32)
  if positive:
    arr = (-np.log(arr + 1e-6)).astype(np.float32)
  arr = (arr * scale).astype(np.float32)
  for idx in nan_at:
    arr[idx] = np.nan
  return field(arr, dims)


def clim_var(seed, *, lo=0.0, hi=1.0):
  dims = ('hour', 'dayofyear', 'latitude', 'longitude')
  shape = tuple(len(AXES[d]) for d in dims)
  return field(np.random.default_rng(seed).uniform(lo, hi, shape).astype(
      np.float32), dims)


def area_aggregator(**kw) -> Call:
  kw.setdefault('weigh_by', [Call('weighting.GridAreaWeighting')])
  return Call('aggregation.Aggregator', kw)


def regions() -> Call:
  return Call('binning.Regions', dict(regions=REGIONS, bin_dim_name='region'))


def config_metric(name: str, seed: int) -> Call:
  """``_paired_metric`` of the JAX test, one side."""
  clim = {'2m_temperature': clim_var(4000 + seed)}

  def binary(base, thresholds):
    return Call('metrics.wrappers.WrappedMetric', args=(
        Call(f'metrics.categorical.{base}'),
        [Call('metrics.wrappers.ContinuousToBinary', dict(
            which='both', threshold_value=thresholds,
            threshold_dim='threshold'))]))

  table = {
      'rmse': Call('metrics.deterministic.RMSE'),
      'mse': Call('metrics.deterministic.MSE'),
      'bias': Call('metrics.deterministic.Bias'),
      'mae': Call('metrics.deterministic.MAE'),
      'acc': Call('metrics.deterministic.ACC', {'climatology': clim}),
      'activity': Call('metrics.deterministic.PredictionActivity',
                       {'climatology': clim}),
      'crps': Call('metrics.probabilistic.CRPSEnsemble', {'use_sort': True}),
      'unbiased_spread_skill': Call(
          'metrics.probabilistic.UnbiasedSpreadSkillRatio'),
      'unbiased_mean_rmse': Call(
          'metrics.probabilistic.UnbiasedEnsembleMeanRMSE'),
      'crps_distance': Call('metrics.probabilistic.CRPSEnsembleDistance'),
      'wasserstein': Call('metrics.probabilistic.WassersteinDistance'),
      'csi': binary('CSI', [0.3, 0.6]),
      'ets': binary('ETS', [0.5]),
  }
  return table[name]


# -- the draws (TestRandomizedConfigParity, call for call) ---------------------


def draw_config(seed: int) -> Spec:
  r = np.random.default_rng(1000 + seed)
  kind = int(r.integers(3))
  pool = (DET_METRICS, ENS_METRICS, ENS2_METRICS)[kind]
  names = [str(n) for n in r.choice(
      pool, size=int(r.integers(1, min(3, len(pool) + 1))), replace=False)]

  def nan_idx(n_members):
    idxs = []
    for _ in range(int(r.integers(0, 4))):
      idx = (int(r.integers(N_INIT)), int(r.integers(N_LEAD)))
      if n_members:
        idx += (int(r.integers(n_members)),)
      idx += (int(r.integers(len(LATS))), int(r.integers(len(LONS))))
      idxs.append(idx)
    return tuple(idxs)

  ens = kind > 0
  predictions = {'2m_temperature': grid_var(
      2000 + seed, ens=ens, nan_at=nan_idx(N_ENS if ens else 0))}
  if kind == 2:
    arr = np.random.default_rng(3000 + seed).random(
        (N_INIT, N_LEAD, N_TARGET_MEMBERS, len(LATS), len(LONS)),
        dtype=np.float32)
    for idx in nan_idx(N_TARGET_MEMBERS):
      arr[idx] = np.nan
    # The fixture's `number2` (5 members), renamed `number` on both sides.
    target = field(arr, ('init_time', 'lead_time', 'number', 'latitude',
                         'longitude'))
  else:
    target = grid_var(3000 + seed, nan_at=nan_idx(0))
  metrics = {n: config_metric(n, seed) for n in names}

  reduce = ['latitude', 'longitude']
  if r.integers(2):
    reduce.append('init_time')
  if r.integers(2):
    reduce.append('lead_time')
  kw = dict(reduce_dims=reduce, skipna=bool(r.integers(2)))
  bins_choice = int(r.integers(3))
  if bins_choice >= 1:
    kw['bin_by'] = [regions()]
  if bins_choice == 2:
    kw['bin_by'].append(Call('binning.LatitudeBins',
                             dict(degrees=60, bin_dim_name='band')))
  if not r.integers(2):  # half the configs run unweighted
    kw['weigh_by'] = []
  return Spec('config', seed, CONFIG_KINDS[kind], (Case(
      metrics, area_aggregator(**kw), predictions,
      {'2m_temperature': target}),))


def draw_wrappers(seed: int) -> Spec:
  r = np.random.default_rng(8000 + seed)
  predictions = {'2m_temperature': grid_var(8100 + seed, ens=True)}
  targets = {'2m_temperature': grid_var(8200 + seed)}
  base = str(r.choice(['rmse', 'mae', 'mse', 'bias']))
  base = {'rmse': 'RMSE', 'mae': 'MAE', 'mse': 'MSE', 'bias': 'Bias'}[base]
  chain = str(r.choice(['mean', 'quantiles', 'weibull', 'rps']))

  def wrapped(base_path, *transforms):
    return Call('metrics.wrappers.WrappedMetric',
                args=(Call(base_path), list(transforms)))

  if chain == 'mean':
    metric = wrapped(f'metrics.deterministic.{base}', Call(
        'metrics.wrappers.EnsembleMean',
        dict(which='predictions', ensemble_dim='number')))
  elif chain == 'quantiles':
    q = sorted(float(x) for x in r.choice(
        [0.1, 0.25, 0.5, 0.75, 0.9], size=int(r.integers(1, 4)),
        replace=False))
    metric = wrapped(f'metrics.deterministic.{base}', Call(
        'metrics.wrappers.EnsembleQuantiles',
        dict(which='predictions', quantiles=q, ensemble_dim='number')))
  elif chain == 'weibull':
    thr = [round(float(r.uniform(0.2, 0.8)), 3)]
    metric = wrapped(
        'metrics.deterministic.MSE',
        Call('metrics.wrappers.WeibullEnsembleToProbabilistic',
             dict(which='predictions', ensemble_dim='number')),
        Call('metrics.wrappers.ContinuousToBinary',
             dict(which='both', threshold_value=thr,
                  threshold_dim='threshold')))
  else:
    bins = np.sort(r.uniform(0.1, 0.9, size=int(r.integers(2, 5))))
    metric = Call('metrics.probabilistic.EnsembleRankedProbabilityScore', dict(
        prediction_bin_thresholds=bins, target_bin_thresholds=bins,
        bin_dim='rps_bin', unique_name_suffix='fuzz'))

  reduce = ['latitude', 'longitude']
  if r.integers(2):
    reduce.append('init_time')
  kw = dict(reduce_dims=reduce)
  if not r.integers(2):
    kw['weigh_by'] = []
  return Spec('wrappers', seed, chain, (Case(
      {'m': metric}, area_aggregator(**kw), predictions, targets),))


def draw_spatial_rank(seed: int) -> Spec:
  r = np.random.default_rng(7000 + seed)
  thr = float(r.uniform(0.3, 0.7))
  reduce = ['latitude', 'longitude']
  if r.integers(2):
    reduce.append('lead_time')
  pv, tv = grid_var(7100 + seed), grid_var(7200 + seed)
  sizes = sorted(int(s) for s in r.choice([1, 3, 5, 7], size=2,
                                          replace=False))
  wrap = bool(r.integers(2))
  fss = Case(
      {'fss': Call('metrics.spatial.FSS', dict(
          neighborhood_size_in_pixels=sizes, wrap_longitude=wrap))},
      area_aggregator(reduce_dims=list(reduce)),
      {'precip': field(pv.values > thr, pv.dims)},
      {'precip': field(tv.values > thr, tv.dims)})
  # The rank histogram stays NaN-free: the reference counts a missing
  # member at a definite rank where both packages NaN-poison the point.
  rank_predictions = {'2m_temperature': grid_var(7300 + seed, ens=True)}
  rank_targets = {'2m_temperature': grid_var(7400 + seed)}
  skipna = bool(r.integers(2))
  rank = Case(
      {'rank_histogram': Call('metrics.probabilistic.RankHistogram')},
      area_aggregator(reduce_dims=list(reduce), skipna=skipna),
      rank_predictions, rank_targets)
  return Spec('spatial_rank', seed, 'wrap' if wrap else 'no_wrap',
              (fss, rank))


def draw_seeps(seed: int) -> Spec:
  r = np.random.default_rng(6000 + seed)

  def precip(seed_):
    v = grid_var(seed_, positive=True,
                 scale=float(r.choice([0.0005, 0.002, 0.01])))
    arr = v.values.copy()
    for _ in range(int(r.integers(0, 4))):
      arr[int(r.integers(N_INIT)), int(r.integers(N_LEAD)),
          int(r.integers(len(LATS))), int(r.integers(len(LONS)))] = np.nan
    return field(arr, v.dims)

  name = 'total_precipitation_24hr'
  predictions = {name: precip(6100 + seed)}
  targets = {name: precip(6200 + seed)}
  clim = {f'{name}_seeps_threshold': clim_var(6300 + seed, lo=0.0005,
                                              hi=0.004),
          f'{name}_seeps_dry_fraction': clim_var(6400 + seed, lo=0.01,
                                                 hi=0.99)}
  seeps_kw = dict(
      variables=[name],
      dry_threshold_mm=float(r.choice([0.1, 0.25, 1.0])),
      min_p1=float(r.choice([0.05, 0.1, 0.3])),
      max_p1=float(r.choice([0.7, 0.85, 0.95])))
  reduce = ['latitude', 'longitude']
  if r.integers(2):
    reduce.append('init_time')
  kw = dict(reduce_dims=reduce, masked=True, skipna=bool(r.integers(2)))
  if r.integers(2):
    kw['bin_by'] = [regions()]
  return Spec('seeps', seed, 'regions' if 'bin_by' in kw else 'global', (Case(
      {'seeps': Call('metrics.categorical.SEEPS',
                     dict(climatology=clim, **seeps_kw))},
      area_aggregator(**kw), predictions, targets),))


def draw_large_k(seed: int) -> LargeK:
  """``tools/tpu_parity_fuzz.py``'s production-K draw, call for call."""
  rng = np.random.default_rng(10_000 + seed)
  nlat, nlon = LARGE_K_GRID
  n_lead = int(rng.integers(2, 5))
  n_stats = int(rng.integers(3, 6))
  coords = {'latitude': np.linspace(-90, 90, nlat),
            'longitude': np.linspace(0, 360, nlon, endpoint=False)}
  n_regions = int(rng.integers(6, 18))
  edges = np.sort(rng.uniform(-90, 90, 2 * n_regions)).reshape(-1, 2)
  boxes = {f'r{i}': ((float(a), float(b)), (0.0, 360.0))
           for i, (a, b) in enumerate(edges)}
  land = Field(rng.random((nlat, nlon)) > 0.5, ('latitude', 'longitude'),
               coords)
  agg = area_aggregator(reduce_dims=['latitude', 'longitude'], bin_by=[
      Call('binning.Regions', dict(regions=boxes, land_sea_mask=land))])
  stats = {f's{i}': Field(
      rng.standard_normal((n_lead, nlat, nlon)).astype(np.float32),
      ('lead_time', 'latitude', 'longitude'), coords)
           for i in range(n_stats)}
  return LargeK(agg, stats)


# -- the layers' draws: binnings, sparse, dispatch, inference, large M ---------

LAYER_FAMILIES = ('time_bins', 'sparse', 'dispatch', 'inference',
                  'large_members')
# Inference runs in float64 on both sides (tests/test_torch_inference.py).
INFERENCE_ATOL, INFERENCE_RTOL = 1e-12, 1e-9
TOLERANCES = {'inference': (INFERENCE_ATOL, INFERENCE_RTOL)}

# Every datetime unit that both packages' _extract_time_unit take (the JAX
# package's pandas attributes; the ISO week is the port's alone).
DATETIME_UNITS = (
    'year', 'month', 'day', 'hour', 'minute', 'second', 'microsecond',
    'nanosecond', 'dayofyear', 'day_of_year', 'dayofweek', 'day_of_week',
    'weekday', 'quarter', 'days_in_month', 'daysinmonth', 'is_leap_year',
    'is_month_start', 'is_month_end', 'is_quarter_start', 'is_quarter_end',
    'is_year_start', 'is_year_end', 'date', 'time', 'timetz')
TIMEDELTA_UNITS = ('second', 'minute', 'hour', 'day', 'week', 'year')
# Fixed sizes: the draws vary the values that the binnings read.
TIME_BINS_INITS, TIME_BINS_LEADS = 6, 3
SMALL_LATS = np.linspace(-90, 90, 7)
SMALL_LONS = np.linspace(0, 360, 12, endpoint=False)
DAY_NS = 86_400 * 10**9
# Days at the calendar's edges: month, quarter and year ends and starts.
EDGE_DAYS = ('01-01', '02-28', '03-01', '03-31', '04-01', '06-30', '07-01',
             '09-30', '10-01', '11-30', '12-01', '12-31')
# One metric set a kind for the layers (the config family draws the
# subsets): the JAX package compiles each op of a metric again for every
# new shape, and these families vary the shapes.
LAYER_DET_METRICS = {'rmse': Call('metrics.deterministic.RMSE'),
                     'bias': Call('metrics.deterministic.Bias')}
LAYER_ENS_METRICS = ('crps', 'unbiased_spread_skill')


def ens_metrics(r) -> dict:
  names = r.choice(ENS_METRICS, size=int(r.integers(1, 4)), replace=False)
  return {str(n): config_metric(str(n), 0) for n in names}


def draw_datetimes(r, n: int) -> np.ndarray:
  """n datetime64[ns] from 1900 to 2100 with sub-second parts: half
  anywhere, half on the calendar's edges (leap days included) at
  midnight, a nanosecond before the next, or any instant of the day."""
  lo = np.datetime64('1900-01-01', 'ns').astype(np.int64)
  hi = np.datetime64('2101-01-01', 'ns').astype(np.int64)
  ns = r.integers(lo, hi, n)
  for i in range(n // 2, n):
    year = int(r.integers(1900, 2101))
    day = str(r.choice(EDGE_DAYS))
    if r.integers(4) == 0 and year % 4 == 0 and (
        year % 100 or year % 400 == 0):
      day = '02-29'
    start = np.datetime64(f'{year}-{day}', 'ns').astype(np.int64)
    ns[i] = start + int(r.choice([0, DAY_NS - 1, int(r.integers(DAY_NS))]))
  return ns.astype('datetime64[ns]')


def draw_leads(r, n: int) -> np.ndarray:
  """Leads up to 15 days, whole hours or with sub-second parts."""
  ns = np.where(r.integers(2, size=n) == 0,
                r.integers(0, 360, n) * 3_600 * 10**9,
                r.integers(0, 15 * DAY_NS, n))
  return ns.astype('timedelta64[ns]')


def unit_members(r, values: np.ndarray, absent) -> list:
  """1-3 members drawn from a unit's values (Python scalars, dates or
  times), now and then one that no value has."""
  unique = list(dict.fromkeys(values.reshape(-1).tolist()))
  k = int(r.integers(1, min(3, len(unique)) + 1))
  members = [unique[i] for i in r.choice(len(unique), size=k, replace=False)]
  if absent is not None and r.integers(3) == 0:
    members.append(absent)
  return members


def time_binning(which: int, r, inits, coords) -> Call:
  """One of the seven binnings over the drawn coords."""
  from weatherbenchx_tpu_torch.binning import _extract_time_unit
  glob = bool(r.integers(2))
  if which == 0:
    return Call('binning.ByTimeUnit', dict(
        unit=str(r.choice(DATETIME_UNITS)), time_dim='init_time',
        add_global_bin=glob))
  if which == 1:
    return Call('binning.ByTimeUnit', dict(
        unit=str(r.choice(TIMEDELTA_UNITS)), time_dim='lead_time',
        add_global_bin=glob))
  if which == 2:
    unit = str(r.choice(DATETIME_UNITS))
    values = _extract_time_unit(inits, unit)
    absent = -1 if values.dtype.kind == 'i' else None
    if unit == 'date':
      absent = datetime.date(1850, 1, 1)
    sets = {}
    for k in range(int(r.integers(1, 4))):
      members = unit_members(r, values, absent)
      # A lone member is given bare half the time, as a set may be.
      bare = len(members) == 1 and r.integers(2)
      sets[f's{k}'] = members[0] if bare else members
    return Call('binning.ByTimeUnitSets', dict(
        sets=sets, unit=unit, dim='init_time', add_global_bin=glob))
  if which == 3:
    unit = str(r.choice(['second', 'minute', 'hour', 'day']))
    seconds = coords['valid_seconds'][1]
    divisor = {'second': 1, 'minute': 60, 'hour': 3600, 'day': 86400}[unit]
    bins = None
    if unit == 'day' or r.integers(2):
      bins = sorted(set(unit_members(r, seconds // divisor, -10**6)))
    return Call('binning.ByTimeUnitFromSeconds', dict(
        unit=unit, time_dim='valid_seconds', bins=bins))
  if which == 4:
    values = np.unique(coords['elevation'][1])
    edges = np.concatenate([
        r.choice(values, size=min(3, len(values)), replace=False),
        r.choice(values, size=2) + 50.0, [-1000.0, 5000.0][:int(
            r.integers(3))]])
    edges = np.unique(edges)
    if len(edges) < 2:
      edges = np.array([-1000.0, 5000.0])
    return Call('binning.ByCoordBins', dict(
        dim_name='elevation', bin_edges=edges, add_global_bin=glob))
  coord = 'zone' if which == 5 else 'band_id'
  values = coords[coord][1]
  absent = 'q' if which == 5 else 99
  sets = {f'{coord}{k}': unit_members(r, values, absent)
          for k in range(int(r.integers(1, 4)))}
  return Call('binning.BySets', dict(
      sets=sets, coord_name=coord, bin_dim_name=f'{coord}_set',
      add_set_complements=bool(r.integers(2)), add_global_bin=glob))


def draw_time_bins(seed: int) -> Spec:
  """The host binnings, stacked: the time units of a datetime (every unit
  of both packages) or a timedelta coord, sets of them, int seconds, edge
  bins over a float coord, string and integer sets, and a region bin."""
  r = np.random.default_rng(20_000 + seed)
  inits = draw_datetimes(r, TIME_BINS_INITS)
  leads = draw_leads(r, TIME_BINS_LEADS)
  nlat, nlon = len(SMALL_LATS), len(SMALL_LONS)
  coords = {
      'init_time': inits, 'lead_time': leads, 'latitude': SMALL_LATS,
      'longitude': SMALL_LONS,
      'valid_seconds': (('init_time', 'lead_time'), r.integers(
          -30 * 86400, 30 * 86400, (len(inits), len(leads)))),
      'elevation': (('latitude', 'longitude'), 100.0 * r.integers(
          -2, 31, (nlat, nlon))),
      'zone': (('longitude',), r.choice(['a', 'b', 'c', 'd'], nlon)),
      'band_id': (('latitude',), r.integers(0, 4, nlat)),
  }
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  shape = (len(inits), len(leads), nlat, nlon)

  def data(nan: bool) -> Field:
    arr = r.standard_normal(shape).astype(np.float32)
    if nan:
      arr[tuple(r.integers(0, n) for n in shape)] = np.nan
    return Field(arr, dims, coords)
  nan = bool(r.integers(3) == 0)
  kinds = sorted(int(k) for k in r.choice(7, size=int(r.integers(1, 3)),
                                           replace=False))
  bin_by = [time_binning(k, r, inits, coords) for k in kinds]
  if r.integers(2):
    bin_by.append(regions())
  reduce = ['latitude', 'longitude']
  reduce += [d for d in ('init_time', 'lead_time') if r.integers(2)]
  kw = dict(reduce_dims=reduce, bin_by=bin_by, skipna=bool(r.integers(2)))
  if r.integers(2):
    kw['weigh_by'] = []
  return Spec('time_bins', seed, '+'.join(c.path.split('.')[-1]
                                          for c in bin_by), (Case(
      dict(LAYER_DET_METRICS), area_aggregator(**kw),
      {'2m_temperature': data(nan)}, {'2m_temperature': data(nan)}),))


# 0 stations only in a station table: both packages refuse an empty
# (init, lead, station) block (test_torch_parity_fuzz_layers.py).
STATION_COUNTS = (0, 1, 7, 40)
SPARSE_LATS = np.linspace(-90, 90, 13)
SPARSE_LONS = np.linspace(0, 360, 24, endpoint=False)


@dataclasses.dataclass(frozen=True)
class Loaded:
  """One chunk through the loaders' ``load_chunk``: the targets (served
  by ``stream_loader`` with ``targets_loader_kwargs``), then the
  predictions against them as the reference; then
  ``compute_metric_values_for_single_chunk``."""
  metrics: dict
  aggregator: Call
  predictions_loader: Call
  targets: dict
  targets_loader_kwargs: dict
  init_times: np.ndarray
  lead_times: np.ndarray


def draw_sparse(seed: int) -> Spec:
  """Grid forecasts interpolated to 0-40 stations (linear or nearest,
  with and without the longitude wrap and extrapolation, with and without
  the altitude adjustment), NaN stations, NaN masks, padded ``index`` and
  station-name networks. The observations are a station table as the
  Parquet loaders give it (rows over ``index`` with their init and lead
  times, interpolated point by point) or a (init, lead, station) block
  (interpolated over latitude and longitude)."""
  r = np.random.default_rng(30_000 + seed)
  layout = str(r.choice(['table', 'block']))
  # Station counts from a list (the JAX package compiles each op again
  # for every new count); a block has stations (STATION_BLOCK_EMPTY).
  n = int(r.choice(STATION_COUNTS[layout == 'block':]))
  lat = r.uniform(-90, 90, n)
  lon = r.uniform(-180, 360, n)
  on_lat = r.integers(3, size=n) == 0
  lat[on_lat] = r.choice(np.concatenate([[-90.0, 90.0], SPARSE_LATS]),
                         on_lat.sum())
  on_lon = r.integers(3, size=n) == 0
  lon[on_lon] = r.choice(np.concatenate([[0.0, -0.0, 360.0, -180.0],
                                         SPARSE_LONS]), on_lon.sum())
  station = dict(latitude=lat, longitude=lon,
                 elevation=r.uniform(-50, 3000, n),
                 stationName=np.array([f'ST{i:03d}' for i in range(n)]))
  inits = np.datetime64('2020-01-01T00', 'ns') + np.arange(2) * np.timedelta64(
      12, 'h')
  leads = (np.arange(3) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  if layout == 'table':
    # One row a (station, init, lead), stations outermost.
    rows = {k: np.repeat(v, 6) for k, v in station.items()}
    rows['init_time'] = np.tile(np.repeat(inits, 3), n)
    rows['lead_time'] = np.tile(leads, 2 * n)
    obs_dims, obs_shape = ('index',), (6 * n,)
    obs_coords = {'index': np.arange(6 * n),
                  **{k: (('index',), v) for k, v in rows.items()}}
  else:
    obs_dims, obs_shape = ('init_time', 'lead_time', 'index'), (2, 3, n)
    obs_coords = {'init_time': inits, 'lead_time': leads,
                  'index': np.arange(n),
                  **{k: (('index',), v) for k, v in station.items()}}
  grid_coords = {'init_time': inits, 'lead_time': leads,
                 'latitude': SPARSE_LATS, 'longitude': SPARSE_LONS}
  variables = ['2m_temperature'] + (['10m_wind_speed'] if r.integers(2)
                                    else [])
  grid, observations = {}, {}
  for v in variables:
    base = 270.0 if v == '2m_temperature' else 8.0
    grid[v] = Field((base + r.standard_normal(
        (2, 3, len(SPARSE_LATS), len(SPARSE_LONS)))).astype(np.float32),
                    ('init_time', 'lead_time', 'latitude', 'longitude'),
                    grid_coords)
    obs = (base + r.standard_normal(obs_shape)).astype(np.float32)
    if n:
      nan_station = r.integers(4, size=n) == 0  # NaN stations
      obs[..., np.repeat(nan_station, obs.shape[-1] // n)] = np.nan
      obs[tuple(r.integers(0, k) for k in obs.shape)] = np.nan
    observations[v] = Field(obs, obs_dims, obs_coords)
  method = str(r.choice(['linear', 'nearest']))
  interp_kw = dict(method=method, wrap_longitude=bool(r.integers(2)),
                   extrapolate_out_of_bounds=bool(r.integers(2)))
  if layout == 'block':
    interp_kw['dims'] = ['latitude', 'longitude']
  if r.integers(2):
    elevation = Field(r.uniform(0, 2000, (len(SPARSE_LATS), len(
        SPARSE_LONS))).astype(str(r.choice(['float32', 'float64']))),
                      ('latitude', 'longitude'),
                      {'latitude': SPARSE_LATS, 'longitude': SPARSE_LONS})
    interp = Call('interpolations.GridToSparseWithAltitudeAdjustment',
                  dict(grid_elevation=elevation, **interp_kw))
  else:
    interp = Call('interpolations.InterpolateToReferenceCoords', interp_kw)
  masked = bool(r.integers(2))
  pad = int(r.choice([4, 8, 16])) if masked and r.integers(2) else None
  loader_kw = dict(add_nan_mask=masked, pad_index_multiple=pad)
  bin_by = []
  if n and r.integers(2):
    names = station['stationName']
    sets = {f'net{k}': [str(x) for x in r.choice(
        names, size=int(r.integers(1, n + 1)), replace=False)]
            for k in range(int(r.integers(1, 3)))}
    bin_by.append(Call('binning.BySets', dict(
        sets=sets, coord_name='stationName', bin_dim_name='network',
        add_set_complements=bool(r.integers(2)),
        add_global_bin=bool(r.integers(2)))))
  reduce = ['index'] + (['init_time'] if layout == 'block' and r.integers(2)
                        else [])
  aggregator = Call('aggregation.Aggregator', dict(
      reduce_dims=reduce, bin_by=bin_by, masked=masked,
      skipna=bool(r.integers(2))))
  return Spec('sparse', seed, f'{layout}/{interp.path.split(".")[-1]}/'
              f'{method}', (Loaded(
                  dict(LAYER_DET_METRICS), aggregator,
                  Call('data.loaders.PredictionsFromDataset', dict(
                      ds=grid, interpolation=interp, rename_dimensions=None,
                      **loader_kw)),
                  observations, loader_kw, inits, leads),))


@dataclasses.dataclass(frozen=True)
class Stream:
  """Chunks through an ``EvaluationPipeline``: one init time a chunk,
  served by ``stream_loader`` by its init time (int ns)."""
  metrics: dict
  aggregator: Call
  predictions: dict
  targets: dict
  init_times: np.ndarray
  lead_times: np.ndarray
  chunks_per_dispatch: int


def draw_dispatch(seed: int) -> Spec:
  """3-7 chunks whose signature changes mid-stream, one change a seed (a
  binned coord's values, a mask coord, or float64 data) on and off in
  random chunks; 1-8 chunks a dispatch."""
  r = np.random.default_rng(40_000 + seed)
  n_chunks = int(r.integers(3, 8))
  ens = bool(r.integers(2))
  inits = np.datetime64('2020-01-01T00', 'ns') + np.arange(
      n_chunks) * np.timedelta64(6, 'h')
  leads = (np.arange(2) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  nlat, nlon = len(SMALL_LATS), len(SMALL_LONS)
  zones = r.choice(['a', 'b', 'c'], nlon)
  other_zones = r.choice(['a', 'b', 'c'], nlon)
  mask = r.random((nlat, nlon)) > 0.2
  change = str(r.choice(['coord', 'mask'] + ([] if ens else ['dtype'])))
  variants = ['base', change] + [str(v) for v in r.choice(
      ['base', change], n_chunks - 2)]
  r.shuffle(variants)
  predictions, targets = {}, {}
  for k, (t, variant) in enumerate(zip(inits, variants)):
    coords = {'init_time': np.array([t]), 'lead_time': leads,
              'latitude': SMALL_LATS, 'longitude': SMALL_LONS,
              'zone': (('longitude',), zones if variant != 'coord'
                       else other_zones)}
    shape = (1, len(leads), nlat, nlon)
    dtype = np.float64 if variant == 'dtype' else np.float32
    tgt_coords = dict(coords)
    if variant == 'mask':
      tgt_coords['mask'] = (('latitude', 'longitude'), mask)
    pdims = ('init_time', 'lead_time', 'latitude', 'longitude')
    pshape = shape
    if ens:
      pdims = ('number',) + pdims
      pshape = (N_ENS,) + shape
    key = int(t.astype(np.int64))
    predictions[key] = {'2m_temperature': Field(
        r.standard_normal(pshape).astype(dtype), pdims, coords)}
    tgt = r.standard_normal(shape).astype(dtype)
    if r.integers(3) == 0:
      tgt[0, 0, int(r.integers(nlat)), int(r.integers(nlon))] = np.nan
    targets[key] = {'2m_temperature': Field(tgt, pdims[-4:], tgt_coords)}
  bin_by = [Call('binning.BySets', dict(
      sets={'ab': ['a', 'b'], 'c': 'c'}, coord_name='zone',
      bin_dim_name='zone_set'))]
  if r.integers(2):
    bin_by.append(regions())
  reduce = ['latitude', 'longitude'] + (['init_time'] if r.integers(2)
                                        else [])
  kw = dict(reduce_dims=reduce, bin_by=bin_by, masked=bool(r.integers(2)),
            skipna=bool(r.integers(2)))
  if r.integers(2):
    kw['weigh_by'] = []
  per_dispatch = int(r.integers(1, 9))
  metrics = ({n: config_metric(n, 0) for n in LAYER_ENS_METRICS} if ens
             else dict(LAYER_DET_METRICS))
  return Spec('dispatch', seed, 'ensemble' if ens else 'deterministic', (
      Stream(metrics, area_aggregator(**kw), predictions, targets, inits,
             leads, per_dispatch),))


INFERENCE_KINDS = ('rmse_bias', 'acc', 'rev')
INFERENCE_UNITS = (8, 31, 80)
INFERENCE_CLR = np.geomspace(0.01, 1, 5)[:-1]


@dataclasses.dataclass(frozen=True)
class Inference:
  """Every inference method (and a baseline comparison) on a state over
  ``init_time`` units: aggregated here from (predictions, targets) over
  ``x``, or given as its sums (ACC's anomaly statistics)."""
  metrics: dict
  predictions: dict
  targets: dict
  baseline: dict
  sums: tuple
  methods: tuple
  replicates: int


def ar1(r, shape, phi: float) -> np.ndarray:
  """AR(1) noise along the first axis (the units), unit variance."""
  x = r.standard_normal(shape)
  for i in range(1, shape[0]):
    x[i] = phi * x[i - 1] + np.sqrt(1 - phi ** 2) * x[i]
  return x


def draw_inference(seed: int) -> Spec:
  """An AR(1) state of 8-80 units, phi in -0.5..0.95 and an offset: RMSE
  and bias against a baseline, ACC, or the relative economic value; one
  of the six methods, with its baseline comparison where there is a
  baseline."""
  r = np.random.default_rng(50_000 + seed)
  kind = INFERENCE_KINDS[seed % 3]
  # Every (kind, method) pair once in 18 seeds, each kind's methods in
  # turn; the first 8 seeds take all six methods, REV by bootstrap (its
  # delta-method t-tests cost the JAX package seconds of compiling).
  methods = (tuple(METHODS)[(seed // 3 + (0, 4, 3)[seed % 3]) % 6],)
  # The unit count steps through a short list every 6 seeds: the JAX
  # package runs these methods op by op and compiles each op again for
  # every new shape, so a run of seeds at one count compiles it once.
  n = INFERENCE_UNITS[seed // 6 % len(INFERENCE_UNITS)]
  n_lead, n_x = 2, 4
  phi = float(r.uniform(-0.5, 0.95))
  offset = float(r.uniform(-1, 1))
  inits = np.datetime64('2020-01-01T00', 'ns') + np.arange(
      n) * np.timedelta64(12, 'h')
  dims = ('init_time', 'lead_time', 'x')
  coords = {'init_time': inits, 'lead_time': np.arange(n_lead),
            'x': np.arange(n_x),
            'day': (('init_time',), inits.astype('datetime64[D]'))}
  shape = (n, n_lead, n_x)
  predictions, targets, baseline, sums = {}, {}, {}, ()
  if kind == 'rmse_bias':
    t = r.standard_normal(shape)
    noise = ar1(r, shape, phi)
    predictions = {'v': Field(t + offset + noise, dims, coords)}
    baseline = {'v': Field(t + ar1(r, shape, phi), dims, coords)}
    targets = {'v': Field(t, dims, coords)}
    metrics = {'rmse': Call('metrics.deterministic.RMSE'),
               'bias': Call('metrics.deterministic.Bias')}
  elif kind == 'rev':
    prob = r.random(shape)
    targets = {'v': Field((r.random(shape) < prob).astype(np.float64), dims,
                          coords)}
    predictions['v'] = Field((r.random((5,) + shape) < np.clip(
        prob + offset * 0.2, 0, 1)[None]).mean(0), dims, coords)
    # The thresholds lie between the 5 members' probabilities.
    opt = Field(r.choice([0.1, 0.3, 0.5, 0.7, 0.9], 4), ('cost_loss_ratio',),
                {'cost_loss_ratio': INFERENCE_CLR})
    metrics = {'rev': Call('metrics.probabilistic.RelativeEconomicValue', dict(
        ensemble_size=5, cost_loss_ratios=INFERENCE_CLR,
        optimal_thresholds=opt))}
  else:
    # ACC's three anomaly statistics as sums over x (its climatology
    # alignment is the metric families' and the config family's).
    ta = r.standard_normal(shape)
    pa = 0.6 * ta + 0.8 * ar1(r, shape, phi) + offset
    stats = {'SquaredPredictionAnomaly': pa ** 2,
             'SquaredTargetAnomaly': ta ** 2, 'AnomalyCovariance': pa * ta}
    sums = tuple((k, Field(v.sum(-1), dims[:2], coords),
                  Field(np.full(shape[:2], float(n_x)), dims[:2], coords))
                 for k, v in stats.items())
    clim = Field(np.zeros((2, 4, n_x)), ('dayofyear', 'hour', 'x'),
                 {'dayofyear': np.arange(1, 3), 'hour': np.arange(0, 24, 6),
                  'x': np.arange(n_x)})
    metrics = {'acc': Call('metrics.deterministic.ACC',
                           dict(climatology={'v': clim}))}
  return Spec('inference', seed, kind, (Inference(
      metrics, predictions, targets, baseline, sums, methods,
      int(r.choice([20, 50]))),))


# The port's routes past the register networks (ops/crps_pairwise.py).
LARGE_ROUTES = ('sorted', 'blocksort', 'mergesort', 'sorted', 'blocksort')
LARGE_POINT_MEMBERS = 2 ** 19


# Each route's edges and sizes the kernels treat apart (run counts, tile
# and block boundaries, HENS's 7,424 and its lagged 59,392).
LARGE_MEMBERS = {
    'sorted': (65, 96, 100, 127, 128, 129, 192, 255, 256),
    'blocksort': (257, 500, 1_023, 1_024, 1_025, 1_816, 4_000, 7_424,
                  14_848, 29_000, 58_112),
    'mergesort': (58_113, 59_392, 65_536, 70_000),
}


def large_member_count(route: str, seed: int, r) -> int:
  """A listed count three times in four, the route's list in turn every
  ``len(LARGE_ROUTES)`` seeds (the JAX package compiles each of its ops
  again for every new M), else any count of the route."""
  if r.integers(4):
    counts = LARGE_MEMBERS[route]
    return counts[seed // len(LARGE_ROUTES) % len(counts)]
  if route == 'sorted':
    return int(r.integers(65, 257))
  if route == 'blocksort':
    return int(np.exp(r.uniform(np.log(257), np.log(58_112 + 1))))
  return int(r.integers(58_113, 70_001))


def draw_large_members(seed: int) -> Spec:
  """CRPS (by sort), unbiased spread/skill and ensemble-mean RMSE at M
  past 64: 65..256 (the sorted runs), 257..58,112 (the block sort) or
  58,113..70,000 (the merge sort), over a few points near 280 K, with
  ties, NaN and +-inf members."""
  r = np.random.default_rng(60_000 + seed)
  route = LARGE_ROUTES[seed % len(LARGE_ROUTES)]
  m = large_member_count(route, seed, r)
  points = int(max(1, min(8, LARGE_POINT_MEMBERS // m)))
  # Spreads of 2-5 K: an ensemble mean near 280 K rounds to float32 by
  # up to 1.5e-5 K in any order of sums, so the ensemble-mean statistics
  # of a spread below about 2 K cannot meet 1e-5 relative in float32.
  scale = float(r.choice([2.0, 5.0]))
  offset = float(280.0 + r.uniform(-5, 5))
  x = offset + scale * r.standard_normal((m, points))
  if r.integers(2):  # ties: members on a coarse grid
    x = np.round(x / scale * 4) * scale / 4
  x = x.astype(np.float32)
  y = (offset + scale * r.standard_normal(points)).astype(np.float32)
  for _ in range(int(r.integers(0, 3))):
    x[int(r.integers(m)), int(r.integers(points))] = r.choice(
        [np.nan, np.inf, -np.inf])
  coords = {'number': np.arange(m), 'x': np.arange(points)}
  return Spec('large_members', seed, route, (Case(
      ens_metrics(r), Call('aggregation.Aggregator', dict(
          reduce_dims=['x'], skipna=bool(r.integers(2)))),
      {'t': Field(x, ('number', 'x'), coords)},
      {'t': Field(y, ('x',), {'x': coords['x']})}),))


def as_float64(spec: Spec) -> Spec:
  """The spec with every float32 input in float64 (the float64
  reference of ``large_members``)."""
  def cast(obj):
    if isinstance(obj, Field) and obj.values.dtype == np.float32:
      return Field(obj.values.astype(np.float64), obj.dims, obj.coords)
    if isinstance(obj, dict):
      return {k: cast(v) for k, v in obj.items()}
    return obj
  return dataclasses.replace(spec, cases=tuple(
      dataclasses.replace(c, predictions=cast(c.predictions),
                          targets=cast(c.targets)) for c in spec.cases))


DRAWS = {'config': draw_config, 'wrappers': draw_wrappers,
         'spatial_rank': draw_spatial_rank, 'seeps': draw_seeps,
         'time_bins': draw_time_bins, 'sparse': draw_sparse,
         'dispatch': draw_dispatch, 'inference': draw_inference,
         'large_members': draw_large_members, LARGE_K: draw_large_k}


def draw(family: str, seed: int):
  """The family's config for the seed: a ``Spec`` (``LargeK`` for
  ``large_k``), numpy and plain Python only."""
  return DRAWS[family](seed)


# -- building and running ------------------------------------------------------


def build(obj, package: types.ModuleType, array: Callable[[Field], Any]):
  """A spec's tree as objects of ``package``: each ``Call`` constructed
  from ``package.<path>``, each ``Field`` made by ``array``."""
  if isinstance(obj, Call):
    module, name = obj.path.rsplit('.', 1)
    cls = getattr(importlib.import_module(f'{package.__name__}.{module}'),
                  name)
    return cls(*build(obj.args, package, array),
               **build(obj.kwargs, package, array))
  if isinstance(obj, Field):
    return array(obj)
  if isinstance(obj, dict):
    return {k: build(v, package, array) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(build(v, package, array) for v in obj)
  return obj


def on_device(device) -> Callable[[Field], DimArray]:
  def array(f: Field) -> DimArray:
    return DimArray(torch.from_numpy(np.ascontiguousarray(f.values)).to(device),
                    f.dims, dict(f.coords))
  return array


def stream_loader(package: types.ModuleType, chunks: dict, **kwargs):
  """A ``DataLoader`` of ``package`` serving built chunks by their first
  init time (int ns), through the package's own ``load_chunk``."""
  base = importlib.import_module(f'{package.__name__}.data.base')

  class StreamLoader(base.DataLoader):

    def _load_chunk_from_source(self, init_times, lead_times=None):
      t = np.asarray(init_times).astype('datetime64[ns]').astype(np.int64)
      return chunks[int(t[0])]
  return StreamLoader(**kwargs)


def run_case(case, package: types.ModuleType, array, device=None,
             states=None) -> dict:
  """One case's metric values by ``package``, its arrays made by
  ``array``; ``device`` goes to the port's pipeline, ``states`` (main,
  baseline) replace an ``Inference`` case's own."""
  agg = importlib.import_module(f'{package.__name__}.aggregation')
  if isinstance(case, Case):
    return agg.compute_metric_values_for_single_chunk(*build(
        (case.metrics, case.aggregator, case.predictions, case.targets),
        package, array))
  if isinstance(case, Loaded):
    metrics, aggregator, p_loader, targets = build(
        (case.metrics, case.aggregator, case.predictions_loader,
         case.targets), package, array)
    first = int(case.init_times[0].astype(np.int64))
    targets = stream_loader(package, {first: targets},
                            **case.targets_loader_kwargs).load_chunk(
                                case.init_times, case.lead_times)
    predictions = p_loader.load_chunk(case.init_times, case.lead_times,
                                      reference=targets)
    return agg.compute_metric_values_for_single_chunk(
        metrics, aggregator, predictions, targets)
  if isinstance(case, Stream):
    return run_stream(case, package, array, device)
  if isinstance(case, Inference):
    return run_inference(case, package, array, states)
  raise TypeError(f'unknown case {type(case).__name__}')


def run_stream(case: Stream, package, array, device=None) -> dict:
  pipeline = importlib.import_module(f'{package.__name__}.parallel.pipeline')
  time_chunks = importlib.import_module(f'{package.__name__}.time_chunks')
  metrics, aggregator, predictions, targets = build(
      (case.metrics, case.aggregator, case.predictions, case.targets),
      package, array)
  kwargs = {} if device is None else {'device': device}
  pipe = pipeline.EvaluationPipeline(
      metrics=metrics, aggregator=aggregator,
      predictions_loader=stream_loader(package, predictions),
      targets_loader=stream_loader(package, targets),
      times=time_chunks.TimeChunks(case.init_times, case.lead_times,
                                   init_time_chunk_size=1),
      chunks_per_dispatch=case.chunks_per_dispatch, **kwargs)
  return pipe.run().metric_values(metrics)


def inference_states(case: Inference, package, array) -> tuple:
  """(main, baseline) states of ``package`` over ``init_time`` units, in
  float64."""
  agg = importlib.import_module(f'{package.__name__}.aggregation')
  if case.sums:
    sums = build(case.sums, package, array)
    state = agg.AggregationState({k: {'v': s} for k, s, _ in sums},
                                 {k: {'v': w} for k, _, w in sums})
    return state, None
  base = importlib.import_module(f'{package.__name__}.metrics.base')
  metrics, predictions, baseline, targets = build(
      (case.metrics, case.predictions, case.baseline, case.targets),
      package, array)

  def state(p):
    stats = base.compute_unique_statistics_for_all_metrics(
        metrics, p, targets)
    # Indicator statistics come out in float32 in both packages.
    return agg.Aggregator(reduce_dims=['x']).aggregate_statistics(
        stats).map(lambda x: x.copy(data=array(Field(
            _host(x.data).astype(np.float64), x.dims, {})).data))
  return state(predictions), state(baseline) if baseline else None


METHODS = {
    'iid_t': ('t_test.IID', 'init_time', {}),
    'ar2_t': ('t_test.GeerAR2Corrected', 'init_time', {}),
    'hac_ewc_t': ('t_test.LazarusHACEWC', 'init_time', {}),
    'iid_bootstrap': ('bootstrap.IIDBootstrap', 'init_time', {'seed': 3}),
    'cluster_bootstrap': ('bootstrap.ClusterBootstrap', 'day', {'seed': 4}),
    'stationary_bootstrap': ('bootstrap.StationaryBootstrap', 'init_time',
                             {'seed': 5}),
}


def run_inference(case: Inference, package, array, states=None) -> dict:
  """Point estimates, standard errors, 90% intervals, p-values and tests
  of the case's methods; each one's baseline comparison too, where the
  case has a baseline."""
  main, baseline = states or inference_states(case, package, array)
  metrics = build(case.metrics, package, array)
  out = {}

  def keep(prefix, tree):
    for metric, per_var in tree.items():
      for var, da in per_var.items():
        out[f'{prefix}/{metric}/{var}'] = da

  for name in case.methods:
    path, unit, kw = METHODS[name]
    module, cls_name = path.rsplit('.', 1)
    cls = getattr(importlib.import_module(
        f'{package.__name__}.inference.{module}'), cls_name)
    if 'seed' in kw:
      kw = dict(kw, n_replicates=case.replicates)
    runs = {name: cls(metrics, main, unit, **kw)}
    if baseline is not None and unit == 'init_time':
      runs[f'{name}_vs_baseline'] = cls.for_baseline_comparison(
          metrics, main, baseline, experimental_unit_dim=unit, **kw)
    for key, method in runs.items():
      keep(f'{key}/point', method.point_estimates())
      keep(f'{key}/stderr', method.standard_error_estimates())
      lo, hi = method.confidence_intervals(0.1)
      keep(f'{key}/lower', lo)
      keep(f'{key}/upper', hi)
      keep(f'{key}/p', method.p_values(0.0))
      keep(f'{key}/significant', method.significance_tests(0.0, 0.1))
  return out


def run_in(spec: Spec, package: types.ModuleType, array, device=None,
           states=None) -> dict:
  """The spec's values by ``package`` (see ``run_case``)."""
  out = {}
  for case in spec.cases:
    out.update(run_case(case, package, array, device, states))
  return out


def run(spec: Spec, device) -> dict[str, DimArray]:
  """The spec's values by the port, every array on ``device``."""
  return run_in(spec, weatherbenchx_tpu_torch, on_device(device), device)


def per_chunk(spec: Spec) -> Spec:
  """The spec with each stream evaluated one chunk a dispatch."""
  return dataclasses.replace(spec, cases=tuple(
      dataclasses.replace(c, chunks_per_dispatch=1)
      if isinstance(c, Stream) else c for c in spec.cases))


def float64_reference(spec: Spec) -> dict | None:
  """``large_members``: the same draw in float64 through the port's CPU
  path (sorts with the median shift, float64 sums); None elsewhere."""
  if spec.family != 'large_members':
    return None
  return run(as_float64(spec), 'cpu')


def _host(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def compare_results(want: Mapping, got: Mapping, atol: float = ATOL,
                    rtol: float = RTOL) -> float:
  """Holds ``got`` to ``want`` (``{key: DimArray}`` of any package with
  this one's DimArray interface); returns the largest |got - want|.

  The key sets and each value's dims are equal; shared string and integer
  coords equal, float coords within 1e-6 relative; values within atol +
  rtol |want|, NaN where NaN. Raises AssertionError otherwise.
  """
  if set(want) != set(got):
    raise AssertionError(f'metric keys differ: want only '
                         f'{sorted(set(want) - set(got))}, got only '
                         f'{sorted(set(got) - set(want))}')
  gap = 0.0
  for k in sorted(want):
    w, g = want[k], got[k]
    if set(w.dims) != set(g.dims):
      raise AssertionError(f'{k}: dims {w.dims} != {g.dims}')
    wv = _host(w.transpose(*g.dims).data).astype(np.float64)
    gv = _host(g.data).astype(np.float64)
    for d in g.dims:
      if not (w.has_coord(d) and g.has_coord(d)):
        continue
      wc, gc = _host(w.coords[d].values), _host(g.coords[d].values)
      if wc.dtype.kind in 'UO' or gc.dtype.kind in 'UO':
        if [str(x) for x in wc] != [str(x) for x in gc]:
          raise AssertionError(f'{k}:{d} coords {wc} != {gc}')
      elif wc.dtype.kind == 'f' or gc.dtype.kind == 'f':
        np.testing.assert_allclose(gc.astype(np.float64),
                                   wc.astype(np.float64), rtol=COORD_RTOL,
                                   err_msg=f'{k}:{d}')
      else:
        np.testing.assert_array_equal(gc, wc, err_msg=f'{k}:{d}')
    np.testing.assert_allclose(gv, wv, atol=atol, rtol=rtol, equal_nan=True,
                               err_msg=k)
    both = np.isfinite(wv) & np.isfinite(gv)
    if both.any():
      gap = max(gap, float(np.max(np.abs(gv[both] - wv[both]))))
  return gap


def large_k_state(spec: LargeK, device) -> tuple:
  """(aggregator, state, statistics) of the port on ``device``."""
  agg = build(spec.aggregator, weatherbenchx_tpu_torch, on_device(device))
  stats = {name: {'v': on_device(device)(f)}
           for name, f in spec.statistics.items()}
  return agg, agg.aggregate_statistics(stats), stats


def large_k_oracle(agg, stat) -> tuple:
  """The float64 contraction ``(leads, bins)`` of one statistic
  ``(lead_time, latitude, longitude)`` with the aggregator's own weights
  and bin masks, taken to the host; and the bin count."""
  w64 = np.ones(stat.shape[1:])
  masks = None
  for op in agg.aggregation_operands(stat):
    arr = _host(op.data)
    if arr.dtype == np.bool_ and op.dims[0] not in stat.dims:
      masks = arr.astype(np.float64)
    else:
      w64 = w64 * arr.astype(np.float64).reshape(
          arr.shape + (1,) * (2 - arr.ndim))
  if masks is None:
    raise ValueError('the aggregator built no bin masks')
  s64 = _host(stat.data).astype(np.float64)
  want = (s64 * w64).reshape(s64.shape[0], -1) @ masks.reshape(
      masks.shape[0], -1).T
  return want, masks.shape[0]


def scaled_error(got: np.ndarray, want: np.ndarray) -> float:
  """max |got - want| / max(|want|, the RMS of want's row): the bin sums of
  a random-sign statistic are random walks, so a near-cancelling bin's
  relative error is unbounded for any float32 contraction."""
  scale = np.maximum(np.abs(want),
                     np.sqrt(np.mean(want ** 2, axis=-1, keepdims=True)))
  return float(np.max(np.abs(got - want) / scale))


def large_k_check(seed: int, device) -> dict:
  """The port's large-K aggregation on ``device`` against float64: the
  largest scaled error, the contraction's rows and bins."""
  spec = draw_large_k(seed)
  agg, state, stats = large_k_state(spec, device)
  worst, bins = 0.0, 0
  for name, per_var in stats.items():
    want, bins = large_k_oracle(agg, per_var['v'])
    got = state.sum_weighted_statistics[name]['v'].transpose(
        'lead_time', 'region')
    worst = max(worst, scaled_error(_host(got.data).astype(np.float64),
                                    want))
  n_lead = next(iter(spec.statistics.values())).values.shape[0]
  return {'error': worst, 'rows': 2 * len(stats) * n_lead, 'bins': bins}


# -- the sweep -----------------------------------------------------------------


def _sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def fuzz_family(family: str, seeds, device, failures: list) -> dict:
  """One family over ``seeds`` on ``device``, each config held to its CPU
  run; failures (a raise is one) appended to ``failures``."""
  report = {'configs': 0, 'failures': 0, 'max_gap': 0.0, 'seconds': 0.0,
            'cpu_seconds': 0.0, 'launches': {}, 'launches_by_kind': {},
            'members': {}, 'kinds': []}
  crps_pairwise.reset_launch_counts()
  for seed in seeds:
    report['configs'] += 1
    try:
      spec = draw(family, seed)
      report['kinds'].append(spec.kind)
      before = dict(crps_pairwise.LAUNCHES)
      t0 = time.perf_counter()
      got = run(spec, device)
      _sync(device)
      report['seconds'] += time.perf_counter() - t0
      by_kind = report['launches_by_kind'].setdefault(
          spec.kind, dict.fromkeys(before, 0))
      for k, n in crps_pairwise.LAUNCHES.items():
        by_kind[k] += n - before[k]
      t0 = time.perf_counter()
      want = run(spec, 'cpu')
      report['cpu_seconds'] += time.perf_counter() - t0
      atol, rtol = TOLERANCES.get(family, (ATOL, RTOL))
      report['max_gap'] = max(report['max_gap'],
                              compare_results(want, got, atol, rtol))
      reference = float64_reference(spec)
      if reference is not None:
        report['max_gap_float64'] = max(
            report.get('max_gap_float64', 0.0),
            compare_results(reference, got, atol, rtol))
    except Exception as e:  # noqa: BLE001 -- every config is reported
      report['failures'] += 1
      failures.append({'family': family, 'seed': seed,
                       'error': f'{type(e).__name__}: {str(e)[:400]}'})
  report['launches'] = dict(crps_pairwise.LAUNCHES)
  report['members'] = {k: sorted(v) for k, v in
                       crps_pairwise.MEMBER_COUNTS.items() if v}
  return report


def fuzz_large_k(seeds, device, failures: list) -> dict:
  report = {'configs': 0, 'failures': 0, 'max_error': 0.0, 'seconds': 0.0,
            'rows': [], 'bins': []}
  for seed in seeds:
    report['configs'] += 1
    try:
      t0 = time.perf_counter()
      res = large_k_check(seed, device)
      report['seconds'] += time.perf_counter() - t0
      report['max_error'] = max(report['max_error'], res['error'])
      report['rows'].append(res['rows'])
      report['bins'].append(res['bins'])
      if res['error'] > LARGE_K_LIMIT:
        raise AssertionError(
            f"large-K aggregation off by {res['error']:.3e} "
            f"(rows={res['rows']}, bins={res['bins']})")
    except Exception as e:  # noqa: BLE001 -- every config is reported
      report['failures'] += 1
      failures.append({'family': LARGE_K, 'seed': seed,
                       'error': f'{type(e).__name__}: {str(e)[:400]}'})
  return report


def fuzz(seeds: Mapping[str, int], device) -> tuple:
  """(report per family, failures) of the sweep on ``device``: seeds
  0..n-1 of each family ``{family: n}``."""
  failures: list = []
  report = {}
  for family, n in seeds.items():
    if family == LARGE_K:
      report[family] = fuzz_large_k(range(n), device, failures)
    else:
      report[family] = fuzz_family(family, range(n), device, failures)
  return report, failures


def resolve_device(name: str) -> torch.device:
  """``--device``: a CUDA device must exist; nothing falls back to the
  CPU."""
  device = torch.device(name)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'--device={name}: no CUDA device is available (pass '
                       '--device=cpu to run the sweep on the CPU)')
  return device


def card_line() -> str:
  """The card's name and power limit as nvidia-smi gives them."""
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--seeds', type=int, default=200,
                 help='seeds of each family; large_k, the 721 x 1440 '
                      'family, takes min(seeds, 20)')
  p.add_argument('--family_seeds', default='',
                 help='seeds by family, overriding --seeds, e.g. '
                      'dispatch=20,large_k=2; each family must be in '
                      '--families')
  p.add_argument('--families',
                 default=','.join(FAMILIES + LAYER_FAMILIES + (LARGE_K,)),
                 help='comma-separated families')
  p.add_argument('--max_report', type=int, default=5)
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default; raises without a GPU) or 'cpu'")
  args = p.parse_args(argv)
  device = resolve_device(args.device)
  families = tuple(f for f in args.families.split(',') if f)
  overrides = dict(kv.split('=') for kv in args.family_seeds.split(',') if kv)
  unknown = set(families) - set(DRAWS)
  if unknown:
    p.error(f'unknown families {sorted(unknown)}')
  absent = set(overrides) - set(families)
  if absent:
    p.error(f'--family_seeds names families not in --families: '
            f'{sorted(absent)}')
  seeds = {f: min(args.seeds, 20) if f == LARGE_K else args.seeds
           for f in families}
  seeds.update({f: int(n) for f, n in overrides.items()})
  t0 = time.perf_counter()
  report, failures = fuzz(seeds, device)
  print(json.dumps({
      'metric': 'port_parity_fuzz', 'device': str(device),
      'card': card_line() if device.type == 'cuda' else None,
      'seeds': seeds, 'large_k_seeds': seeds.get(LARGE_K, 0),
      'failures': len(failures),
      'wall_s': time.perf_counter() - t0, 'families': report}), flush=True)
  for f in failures[:args.max_report]:
    print(json.dumps(f), flush=True)
  return 1 if failures else 0


if __name__ == '__main__':
  sys.exit(main())
