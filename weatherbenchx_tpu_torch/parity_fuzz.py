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

Seeds correspond to the JAX package's: the four small families draw call
for call as ``TestRandomizedConfigParity`` in
``tests/test_reference_parity.py`` does (its grid, times, members and
climatology axes are copied here), and ``large_k`` as
``tools/tpu_parity_fuzz.py``, so seed N here is seed N there. A drawn
``Spec`` is plain data (numpy arrays and ``Call`` trees naming
constructors by module path), so the same draw builds in any package with
this package's module layout (``build``).

Usage (the card by default; ``--device cuda`` raises without one):

  python -m weatherbenchx_tpu_torch.parity_fuzz --seeds 200

prints one JSON line (per family: configs, failures, the largest gap,
seconds on the device and on the CPU, kernel launches and the member
counts the kernels saw; the card's name and power limit), then the first
failures, and exits nonzero on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from weatherbenchx_tpu_torch import aggregation
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
  """An array with its dims and its 1-D dim coords (numpy)."""
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


DRAWS = {'config': draw_config, 'wrappers': draw_wrappers,
         'spatial_rank': draw_spatial_rank, 'seeps': draw_seeps,
         LARGE_K: draw_large_k}


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


def run(spec: Spec, device) -> dict[str, DimArray]:
  """The spec's metric values by the port, every array on ``device``."""
  array = on_device(device)
  out = {}
  for case in spec.cases:
    out.update(aggregation.compute_metric_values_for_single_chunk(
        *build((case.metrics, case.aggregator, case.predictions,
                case.targets), weatherbenchx_tpu_torch, array)))
  return out


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
            'members': {}}
  crps_pairwise.reset_launch_counts()
  for seed in seeds:
    report['configs'] += 1
    try:
      spec = draw(family, seed)
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
      report['max_gap'] = max(report['max_gap'], compare_results(want, got))
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


def fuzz(families, seeds: int, large_k_seeds: int, device) -> tuple:
  """(report per family, failures) of the sweep on ``device``."""
  failures: list = []
  report = {f: fuzz_family(f, range(seeds), device, failures)
            for f in families if f != LARGE_K}
  if large_k_seeds:
    report[LARGE_K] = fuzz_large_k(range(large_k_seeds), device, failures)
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
  p.add_argument('--seeds', type=int, default=200)
  p.add_argument('--large_k_seeds', type=int, default=None,
                 help='seeds of the 721 x 1440 family (default: min(seeds, '
                      '20))')
  p.add_argument('--families', default=','.join(FAMILIES + (LARGE_K,)),
                 help='comma-separated families')
  p.add_argument('--max_report', type=int, default=5)
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default; raises without a GPU) or 'cpu'")
  args = p.parse_args(argv)
  device = resolve_device(args.device)
  families = tuple(f for f in args.families.split(',') if f)
  unknown = set(families) - set(DRAWS)
  if unknown:
    p.error(f'unknown families {sorted(unknown)}')
  n_large = (args.large_k_seeds if args.large_k_seeds is not None
             else min(args.seeds, 20)) if LARGE_K in families else 0
  t0 = time.perf_counter()
  report, failures = fuzz(families, args.seeds, n_large, device)
  print(json.dumps({
      'metric': 'port_parity_fuzz', 'device': str(device),
      'card': card_line() if device.type == 'cuda' else None,
      'seeds': args.seeds, 'large_k_seeds': n_large,
      'failures': len(failures),
      'wall_s': time.perf_counter() - t0, 'families': report}), flush=True)
  for f in failures[:args.max_report]:
    print(json.dumps(f), flush=True)
  return 1 if failures else 0


if __name__ == '__main__':
  sys.exit(main())
