"""The benchmark's metric families that have no kernel of their own.

The three families of the JAX package's benchmark (``bench.py:542-603``)
whose statistics are tensor ops on both sides: the fractions skill score
(``fss``), the rank histogram (``rank_histogram``) and the relative economic
value (``rev``), each on the production aggregator (the 17 regions and their
land parts, area weights, masked), and ``binnings``, a drive of three
binnings at once (land/sea x 30-degree latitude bands x the lead's hour)
under RMSE and CSI.

``family_case`` builds a family's metrics, aggregator and seeded inputs at
any grid. The ``*_reference`` functions compute the same values in float64
from the inputs alone: the regions' boxes, the latitudes' areas and the
statistics are written out here with plain tensor arithmetic, and use none
of the port's metrics, weightings, binnings or aggregation.
``check_family_values`` holds an evaluation to them. Device, grid and
tolerances are arguments: the smoke run on the card and the CPU tests call
the same functions with their own.
"""

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation, binning, weighting
from weatherbenchx_tpu_torch.apps import configs
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.metrics import (categorical, deterministic,
                                             probabilistic, spatial, wrappers)

FAMILIES = ('fss', 'rank_histogram', 'rev', 'binnings')
VARIABLE = '2m_temperature'
MEMBERS = 50
DIMS = ('init_time', 'lead_time', 'latitude', 'longitude')
REV_THRESHOLDS = (np.arange(8) + 0.5) / 8
REV_COST_LOSS = np.geomspace(0.01, 1, 9)[:-1]
BINNINGS_THRESHOLD = 0.5
LATITUDE_BAND_DEGREES = 30
# The dims of each metric's value, in its reference's order.
VALUE_DIMS = {
    'fss': ('lead_time', 'region', 'neighborhood_size'),
    'rank_histogram': ('lead_time', 'region', 'rank'),
    'rev': ('lead_time', 'region', 'threshold', 'cost_loss_ratio'),
    'rmse': ('land_sea', 'latitude_bins', 'lead_time_hour'),
    'csi': ('land_sea', 'latitude_bins', 'lead_time_hour', 'threshold'),
}
# What a difference from float64 is taken relative to: |value|, but
# max(|value|, 1) for the relative economic value, which crosses zero.
RELATIVE_FLOOR = {'rev': 1.0}


def family_coords(grid) -> dict:
  _, n_lead, nlat, nlon = grid
  return {'init_time': np.array(['2020-01-03'], dtype='datetime64[ns]'),
          'lead_time': (np.arange(n_lead) * np.timedelta64(6, 'h')).astype(
              'timedelta64[ns]'),
          'latitude': np.linspace(-90, 90, nlat),
          'longitude': np.linspace(0, 360, nlon, endpoint=False)}


def family_land(grid) -> np.ndarray:
  """A smooth synthetic land mask (latitude, longitude), bool."""
  c = family_coords(grid)
  yy, xx = np.meshgrid(np.deg2rad(c['latitude']), np.deg2rad(c['longitude']),
                       indexing='ij')
  return np.sin(3 * yy) * np.cos(4 * xx) > 0.1


def family_case(name: str, seed: int, grid) -> tuple:
  """(metrics, aggregator, predictions, targets) of one family, on the
  host, from the seed."""
  coords = family_coords(grid)
  rng = np.random.default_rng([seed, 11, sorted(FAMILIES).index(name)])

  def field(values, ens=None):
    dims, c = DIMS, dict(coords)
    if ens:
      dims, c['number'] = ('number',) + dims, np.arange(ens)
    return DimArray(values, dims, c)

  land = DimArray(family_land(grid).astype(np.float32),
                  ('latitude', 'longitude'),
                  {k: coords[k] for k in ('latitude', 'longitude')})
  aggregator = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      bin_by=[binning.Regions(configs.REGIONS, land_sea_mask=land)],
      weigh_by=[weighting.GridAreaWeighting()], masked=True)
  if name == 'fss':
    metrics = {'fss': spatial.FSS(neighborhood_size_in_pixels=[3],
                                  wrap_longitude=True)}
    preds = field(rng.random(grid, dtype=np.float32) > 0.5)
    tgts = field(rng.random(grid, dtype=np.float32) > 0.5)
  elif name == 'rank_histogram':
    metrics = {'rank_histogram': probabilistic.RankHistogram()}
    preds = field(rng.random((MEMBERS,) + tuple(grid), dtype=np.float32),
                  ens=MEMBERS)
    tgts = field(rng.random(grid, dtype=np.float32))
  elif name == 'rev':
    metrics = {'rev': probabilistic.RelativeEconomicValue(
        probability_thresholds=REV_THRESHOLDS, statistic_suffix='bench8',
        cost_loss_ratios=REV_COST_LOSS)}
    members = rng.random((8,) + tuple(grid), dtype=np.float32) > 0.5
    preds = field(members.mean(axis=0).astype(np.float32))
    tgts = field(rng.random(grid, dtype=np.float32) > 0.5)
  elif name == 'binnings':
    metrics = {
        'rmse': deterministic.RMSE(),
        'csi': wrappers.WrappedMetric(categorical.CSI(), [
            wrappers.ContinuousToBinary('both', [BINNINGS_THRESHOLD],
                                        'threshold')])}
    aggregator = aggregation.Aggregator(
        reduce_dims=list(DIMS),
        bin_by=[binning.LandSea(land),
                binning.LatitudeBins(LATITUDE_BAND_DEGREES),
                binning.ByTimeUnit('hour', 'lead_time')],
        weigh_by=[weighting.GridAreaWeighting()], masked=True)
    preds = field(rng.standard_normal(grid, dtype=np.float32))
    tgts = field(rng.standard_normal(grid, dtype=np.float32))
  else:
    raise KeyError(name)
  return metrics, aggregator, {VARIABLE: preds}, {VARIABLE: tgts}


# -- the float64 references --------------------------------------------------------


def family_weights(grid, device) -> tuple:
  """(area weights (lat,), region masks (34, lat, lon), Kish sizes (34,)):
  float64 on ``device``, from the regions' boxes and the latitudes alone."""
  c = family_coords(grid)
  lat, lon = c['latitude'], c['longitude']
  edges = np.deg2rad(np.concatenate([[-90.0], (lat[:-1] + lat[1:]) / 2,
                                     [90.0]]))
  area = np.sin(edges[1:]) - np.sin(edges[:-1])
  area = area / area.mean()
  boxes = []
  for (lat_lo, lat_hi), (lon_lo, lon_hi) in configs.REGIONS.values():
    in_lat = (lat >= lat_lo) & (lat <= lat_hi)
    lo, hi = lon_lo % 360, lon_hi % 360
    in_lon = ((lon >= lo) & (lon <= hi)) if hi > lo else (
        (lon >= lo) | (lon <= hi))
    boxes.append(in_lat[:, None] & in_lon[None, :])
  boxes = np.stack(boxes)
  masks = np.concatenate([boxes, boxes & family_land(grid)[None]])
  w = torch.from_numpy(area).to(device)
  masks = torch.from_numpy(masks).to(device).double()
  wb = w[None, :, None] * masks
  return w, masks, wb.sum((1, 2)) ** 2 / (wb ** 2).sum((1, 2))


def _region_means(stat, weights) -> torch.Tensor:
  """(lead, region, ...) area-weighted means over (latitude, longitude) of
  a float64 (lead, lat, lon, ...) statistic within each region mask."""
  w, masks, _ = weights
  num = torch.einsum('tyx...,y,ryx->tr...', stat, w, masks)
  den = torch.einsum('y,ryx->r', w, masks)
  return num / den.reshape((1, -1) + (1,) * (num.dim() - 2))


def _f64(da, weights) -> torch.Tensor:
  """A host DimArray's only init, float64 on the weights' device."""
  return da.data.to(weights[0].device).to(torch.float64).select(
      da.dims.index('init_time'), 0)


def fss_reference(preds, tgts, weights) -> torch.Tensor:
  """(lead, region): 3 x 3 fractions by shifted sums, longitude wrapping,
  the two pole rows zero."""

  def fractions(x):
    total = torch.zeros_like(x)
    for dy in (-1, 0, 1):
      for dx in (-1, 0, 1):
        total += torch.roll(x, (dy, dx), (1, 2))
    total /= 9
    total[:, [0, -1], :] = 0
    return total
  p, t = fractions(_f64(preds, weights)), fractions(_f64(tgts, weights))
  return 1 - _region_means((p - t) ** 2, weights) / (
      _region_means(p ** 2, weights) + _region_means(t ** 2, weights))


def rank_histogram_reference(preds, tgts, weights) -> torch.Tensor:
  """(lead, region, rank): the share of points where exactly r members lie
  below the target."""
  x, y = _f64(preds, weights), _f64(tgts, weights)
  below = (x < y[None]).sum(0)  # x (number, lead, lat, lon)
  return torch.stack([_region_means((below == r).double(), weights)
                      for r in range(x.shape[0] + 1)], dim=-1)


def rev_reference(preds, tgts, weights) -> torch.Tensor:
  """(lead, region, threshold, cost/loss ratio), the thresholds 0 (always
  warn) and 1 (never) added at the ends."""
  prob, event = _f64(preds, weights), _f64(tgts, weights) > 0.5
  base_rate = _region_means(event.double(), weights)
  zero = torch.zeros_like(base_rate)
  tp, fp, fn = [base_rate], [1 - base_rate], [zero]
  for th in REV_THRESHOLDS:
    warn = prob > float(th)
    tp.append(_region_means((warn & event).double(), weights))
    fp.append(_region_means((warn & ~event).double(), weights))
    fn.append(_region_means((~warn & event).double(), weights))
  tp, fp, fn = (torch.stack(v + [e], dim=-1)[..., None] for v, e in (
      (tp, zero), (fp, zero), (fn, base_rate)))
  ratio = torch.from_numpy(REV_COST_LOSS).to(prob.device)
  pred_cost = ratio * (tp + fp) + fn
  perf_cost = ratio * (tp + fn)
  clim_cost = torch.minimum(ratio.expand_as(perf_cost), (tp + fn).expand_as(
      perf_cost))
  return (clim_cost - pred_cost) / (clim_cost - perf_cost)


def binnings_reference(preds, tgts, weights) -> dict:
  """{'rmse', 'csi'}: (land_sea, latitude band, lead hour), over land and
  sea, closed 30-degree bands and the hour of each lead."""
  grid = (1,) + tuple(preds.shape[-3:])
  c = family_coords(grid)
  w = weights[0]
  land = torch.from_numpy(family_land(grid)).to(w.device)
  land_sea = torch.stack([land, ~land]).double()
  lat = torch.from_numpy(c['latitude']).to(w.device)
  starts = torch.arange(-90, 90, LATITUDE_BAND_DEGREES, device=w.device)
  bands = ((lat[None] >= starts[:, None]) & (
      lat[None] <= starts[:, None] + LATITUDE_BAND_DEGREES)).double()
  hours = (c['lead_time'] // np.timedelta64(1, 'h')) % 24
  hour_bins = torch.from_numpy(
      np.unique(hours)[:, None] == hours[None, :]).to(w.device).double()

  def mean(stat):
    num = torch.einsum('tyx,y,lyx,by,ht->lbh', stat, w, land_sea, bands,
                       hour_bins)
    den = torch.einsum('tyx,y,lyx,by,ht->lbh', torch.ones_like(stat), w,
                       land_sea, bands, hour_bins)
    return num / den
  p, t = _f64(preds, weights), _f64(tgts, weights)
  pb, tb = p > BINNINGS_THRESHOLD, t > BINNINGS_THRESHOLD
  tp, fp, fn = (mean(v.double()) for v in (pb & tb, pb & ~tb, ~pb & tb))
  return {'rmse': torch.sqrt(mean((p - t) ** 2)), 'csi': tp / (tp + fp + fn)}


REFERENCES = {'fss': fss_reference, 'rank_histogram': rank_histogram_reference,
              'rev': rev_reference, 'binnings': binnings_reference}


def family_reference(name: str, predictions, targets, weights):
  """The family's float64 value(s): a tensor, or {metric: tensor} for
  ``binnings``, in ``VALUE_DIMS`` order."""
  return REFERENCES[name](predictions[VARIABLE], targets[VARIABLE], weights)


def check_family_values(name: str, values: dict, ref, weights, *, rtol: float,
                        sigmas: float, rank_sum_tol: float) -> dict:
  """Holds a family's metric values to its float64 reference and, for the
  iid inputs of ``family_case``, to their closed forms.

  Every value lies within ``rtol`` of the reference, relative to |value|
  (``RELATIVE_FLOOR``: for ``rev``, to max(|value|, 1)); the rank
  histogram's bins sum to 1 within ``rank_sum_tol`` and each lies within
  ``sigmas`` standard errors (at its region's Kish size) of 1/(M + 1); the
  FSS of two independent Bernoulli(1/2) fields lies as near 0.9. Raises
  AssertionError otherwise. Returns {metric: (max relative difference,
  note)}.
  """
  refs = ref if isinstance(ref, dict) else {name: ref}
  n_eff = weights[2]
  out = {}
  for metric, want in refs.items():
    da = values[f'{metric}.{VARIABLE}']
    if set(da.dims) != set(VALUE_DIMS[metric]):
      raise AssertionError(f'families {metric}: dims {da.dims}')
    if da.device.type != want.device.type:
      raise AssertionError(f'families {metric}: values on {da.device}')
    got = da.transpose(*VALUE_DIMS[metric]).data.double().reshape(want.shape)
    if not bool(torch.isfinite(got).all()):
      raise AssertionError(f'families {metric}: non-finite values')
    # Where the reference is exactly 0 (an empty rank of a small region),
    # so must the value be: the tiny floor turns any difference into a miss.
    scale = want.abs().clamp(min=RELATIVE_FLOOR.get(metric, 1e-30))
    rel = ((got - want).abs() / scale).max().item()
    if rel > rtol:
      raise AssertionError(f'families {metric}: rel err vs float64 {rel:.3g} '
                           f'> {rtol}')
    note = ''
    if metric == 'rank_histogram':
      total = (got.sum(-1) - 1).abs().max().item()
      if total > rank_sum_tol or (want.sum(-1) - 1).abs().max() > 1e-12:
        raise AssertionError(f'rank histogram sums to 1 + {total:.3g}')
      share = 1 / got.shape[-1]
      tol = sigmas * torch.sqrt(share * (1 - share) / n_eff)
      far = ((got - share).abs() / tol[None, :, None]).max().item()
      if far > 1:
        raise AssertionError(f'rank histogram {far:.2f} tolerances from '
                             f'1/{got.shape[-1]}')
      note = (f'; bins sum to 1 within {total:.2g}, each within '
              f'{far:.2f} of {sigmas} standard errors of 1/{got.shape[-1]}')
    if metric == 'fss':
      # Fractions of 9 iid Bernoulli(1/2): E(P-T)^2 = 2 var, EP^2 = 1/4 +
      # var, var = 1/36, so FSS = 1 - 1/10; the per-point standard
      # deviation of its estimate is below 0.2.
      tol = sigmas * 0.2 / torch.sqrt(n_eff)
      far = ((got - 0.9).abs() / tol[None, :]).max().item()
      if far > 1:
        raise AssertionError(f'FSS {far:.2f} tolerances from 0.9')
      note = (f'; mean {got.mean().item():.6f}, closed form 0.9, within '
              f'{far:.2f} of {sigmas} standard errors')
    out[metric] = (rel, f'shape {tuple(got.shape)}{note}')
  return out
