"""The plain float64 reference of a cell's metric values.

Plain PyTorch and NumPy, written from the definitions (WeatherBench 2's
probabilistic metrics, Rasp et al. 2024, arXiv:2308.15560, section 4.4;
the fair CRPS of Zamo and Naveau 2018). It imports nothing of the port and
reads nothing the port made: from the same forecast, target and analysis
tensors the benchmark hands the port, it works out every per-point
statistic, the area weights, the validity mask, the region masks and the
weighted means again, and sums them over the chunks of a run.

Per gridpoint of an ensemble x_1..x_M and a target y (a deterministic
value, or an analysis ensemble y_1..y_K), in float64:

  skill   = mean_i |x_i - y|      (mean_{i,k} |x_i - y_k| for an ensemble)
  spread  = sum_{i != j} |x_i - x_j| / (M (M - 1))
          = 2 sum_k (2k - M - 1) x_(k) / (M (M - 1)), x_(k) sorted
  var     = sum_i (x_i - mean x)^2 / (M - 1)
  umse    = (mean x - mean y)^2 - var / M  (- var_y / K for an ensemble)

Weights: the cell-area integral of cos(latitude) between cell bounds
(midpoints, clamped at the poles), times the validity mask, times each
region's box (latitudes inclusive; longitudes mod 360, wrapping past 0).
A metric's value per (lead, region) follows from the weighted means over
(init, latitude, longitude) of all chunks of the run:

  fair_crps = skill - spread / 2; spread_skill = sqrt(var / umse);
  ensemble_mean_rmse = sqrt(umse).

This is the default reference module (``spec.py`` gives the contract):
a configuration that names no ``reference_module`` is held to this one.

The members are sorted in float32 (a sort is exact) and then taken to
float64. The points go in blocks of about ``BLOCK_VALUES`` members, so
that a block's temporaries fit beside the chunks on the device.
"""

import math

import numpy as np
import torch

BLOCK_VALUES = 1 << 27

# Reference metrics: the per-point statistics each needs, and its value
# from their weighted means.
REFERENCE_METRICS = {
    'fair_crps': (('skill', 'spread'),
                  lambda s: s['skill'] - 0.5 * s['spread']),
    'spread_skill': (('var', 'umse'),
                     lambda s: torch.sqrt(s['var'] / s['umse'])),
    'ensemble_mean_rmse': (('umse',), lambda s: torch.sqrt(s['umse'])),
}


def grid(config: dict) -> tuple:
  """(latitudes north to south, as ERA5 stores them; longitudes) in
  degrees, float64: the equiangular grid with both poles that the
  configuration's sizes give."""
  ny, nx = config['latitudes'], config['longitudes']
  return 90 - np.arange(ny) * (180 / (ny - 1)), np.arange(nx) * (360 / nx)


def validity_mask(config: dict) -> np.ndarray:
  """(latitude, longitude) bool of the points the stores hold:
  ``drop_pole_rows`` leaves out the two pole rows."""
  mask = np.ones((config['latitudes'], config['longitudes']), bool)
  if config.get('mask') == 'drop_pole_rows':
    mask[[0, -1]] = False
  elif config.get('mask') not in (None, 'none'):
    raise ValueError(f'unknown mask {config["mask"]!r}')
  return mask


def area_weights(lat_deg: np.ndarray) -> np.ndarray:
  """Cell areas of latitudes in degrees (any order), normalized to mean 1."""
  order = np.argsort(lat_deg)
  lat = np.deg2rad(np.asarray(lat_deg, np.float64)[order])
  mid = (lat[:-1] + lat[1:]) / 2
  bounds = np.concatenate([[max(lat[0] - (lat[1] - lat[0]) / 2, -np.pi / 2)],
                           mid,
                           [min(lat[-1] + (lat[-1] - lat[-2]) / 2,
                                np.pi / 2)]])
  area = np.sin(bounds[1:]) - np.sin(bounds[:-1])
  out = np.empty_like(area)
  out[order] = area
  return out / out.mean()


def region_masks(lat: np.ndarray, lon: np.ndarray, regions: dict
                 ) -> np.ndarray:
  """(region, latitude, longitude) bool of latitude/longitude boxes."""
  lon = np.mod(lon, 360)
  out = []
  for (lat0, lat1), (lon0, lon1) in regions.values():
    in_lat = (lat >= lat0) & (lat <= lat1)
    a, b = lon0 % 360, lon1 % 360
    in_lon = ((lon >= a) & (lon <= b)) if b > a else ((lon >= a) | (lon <= b))
    out.append(in_lat[:, None] & in_lon[None, :])
  return np.stack(out)


def point_statistics(x: torch.Tensor, target: torch.Tensor, kind: str,
                     names) -> dict:
  """{name: (N,) float64} of ``names`` (of skill, spread, var, umse) for an
  ensemble x (M, N) against a target (N,) or an analysis ensemble (K, N)."""
  m, n = x.shape
  block = max(1, BLOCK_VALUES // m)
  out = {k: torch.empty(n, dtype=torch.float64, device=x.device)
         for k in names}
  coeff = (2 * torch.arange(1, m + 1, dtype=torch.float64, device=x.device)
           - m - 1)
  for lo in range(0, n, block):
    hi = min(n, lo + block)
    xs = torch.sort(x[:, lo:hi].t().contiguous(), dim=1).values.double()
    if kind == 'deterministic':
      y = target[lo:hi].double()
      y_mean, y_var = y, None
    elif kind == 'analysis_ensemble':
      y = target[:, lo:hi].double()
      y_mean = y.mean(0)
      y_var = ((y - y_mean) ** 2).sum(0) / (y.shape[0] - 1)
    else:
      raise ValueError(f'unknown target kind {kind!r}')
    mean = xs.mean(1)
    var = ((xs - mean[:, None]) ** 2).sum(1) / (m - 1)
    if 'skill' in out:
      if kind == 'deterministic':
        skill = (xs - y[:, None]).abs().mean(1)
      else:
        skill = sum((xs - yk[:, None]).abs().sum(1) for yk in y)
        skill = skill / (m * y.shape[0])
      out['skill'][lo:hi] = skill
    if 'spread' in out:
      out['spread'][lo:hi] = 2 * (xs @ coeff) / (m * (m - 1))
    if 'var' in out:
      out['var'][lo:hi] = var
    if 'umse' in out:
      umse = (mean - y_mean) ** 2 - var / m
      if y_var is not None:
        umse = umse - y_var / y.shape[0]
      out['umse'][lo:hi] = umse
    del xs, y
  return out


class Reference:
  """The reference of one scoring of a cell: per pool chunk, the weighted
  sums (Σ w s, Σ w) per (lead, region) of each per-point statistic."""

  def __init__(self, config: dict, metrics: dict, target_kind: str,
               lat: np.ndarray, lon: np.ndarray, mask: np.ndarray,
               device):
    self.metrics = {name: m['reference'] for name, m in metrics.items()}
    unknown = set(self.metrics.values()) - set(REFERENCE_METRICS)
    if unknown:
      raise KeyError(f'no reference metric {sorted(unknown)}')
    self.stats = sorted({s for r in self.metrics.values()
                         for s in REFERENCE_METRICS[r][0]})
    self.kind = target_kind
    self.regions = list(config['regions'])
    w = (area_weights(lat)[None, :, None] * mask[None]
         * region_masks(lat, lon, config['regions']))
    self.weights = torch.from_numpy(w).to(device)  # (R, Y, X) float64

  def chunk_sums(self, forecast: torch.Tensor, target: torch.Tensor) -> dict:
    """{stat: (L, R) Σ w s, '_weights': (L, R) Σ w} of one chunk of one
    variable: forecast (M, I, L, Y, X), target (I, L, Y, X) or (K, I, L, Y,
    X)."""
    m, ni, nl, ny, nx = forecast.shape
    stats = point_statistics(forecast.reshape(m, -1),
                             target.reshape(-1) if self.kind ==
                             'deterministic' else
                             target.reshape(target.shape[0], -1),
                             self.kind, self.stats)
    out = {k: torch.einsum('ilyx,ryx->lr', s.reshape(ni, nl, ny, nx),
                           self.weights) for k, s in stats.items()}
    out['_weights'] = (ni * self.weights.sum((1, 2)))[None].expand(
        nl, -1).clone()
    return out

  def values(self, sums: list, counts: list) -> dict:
    """{metric: (L, R) float64} of a run whose pool chunk j, with sums
    ``sums[j]``, was handed over ``counts[j]`` times."""
    total = {k: sum(n * s[k] for n, s in zip(counts, sums))
             for k in sums[0]}
    means = {k: total[k] / total['_weights'] for k in self.stats}
    return {name: REFERENCE_METRICS[ref][1](means)
            for name, ref in self.metrics.items()}


def values(config: dict, traffic: dict, scoring, pool: list,
           resources: dict, counts: dict, device) -> dict:
  """The default reference module's values (``spec.py`` gives the
  contract): ``{metric: {variable: (('lead_time', 'region'), (L, R)
  float64, {'region': names})}}``, each pool chunk ``j`` summed
  ``counts[j]`` times."""
  del traffic, resources
  lat, lon = grid(config)
  ref = Reference(config, scoring.metrics, scoring.target, lat, lon,
                  validity_mask(config), device)
  n = [counts.get(j, 0) for j in range(len(pool))]
  out = {name: {} for name in scoring.metrics}
  for var in config['variables']:
    sums = [ref.chunk_sums(pc.forecast[var],
                           pc.target[var] if scoring.target ==
                           'deterministic' else pc.analysis[var])
            for pc in pool]
    for name, want in ref.values(sums, n).items():
      out[name][var] = (('lead_time', 'region'), want.cpu().numpy(),
                        {'region': ref.regions})
  return out


def relative_gap(got: np.ndarray, want: np.ndarray,
                 floor: float = 0.0) -> float:
  """max |got - want| / max(|want|, floor); inf where either is not
  finite or the shapes differ."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  if got.shape != want.shape or not (np.isfinite(got).all()
                                     and np.isfinite(want).all()):
    return math.inf
  return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), floor)))
