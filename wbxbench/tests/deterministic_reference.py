"""The plain float64 reference of ``deterministic_generator.py``'s
configurations (the contract is in ``spec.py``): RMSE, bias and ACC from
their definitions (Rasp et al. 2024, arXiv:2308.15560, section 4; ACC as
the port's ``metrics/deterministic.ACC`` defines it: the mean anomaly
covariance over the root of the mean squared anomalies, each a weighted
mean over the run). Imports nothing of the port.

Per point of a forecast p, a target t and the climatology c at the
point's valid time (its dayofyear and hour looked up among the
climatology's labels), in float64:

  se = (p - t)^2, err = p - t, spa = (p - c)^2, sta = (t - c)^2,
  cov = (p - c) (t - c)

Weights: area x validity mask x each region's box, and for each region
its ``<region>_land`` part (the land-sea mask's nonzero points). A value
per (lead, [level,] region) is a ratio of weighted sums over (init,
latitude, longitude) of every chunk of the run: each chunk key (pool
chunk, the chunk's init hours from 1 January) summed once, times its
count.

  rmse = sqrt(se), bias = err, acc = cov / sqrt(spa sta)   (means)
"""

import numpy as np
import torch

from wbxbench import reference as ref_lib

STATS = {'rmse': ('se',), 'bias': ('err',), 'acc': ('spa', 'sta', 'cov')}
VALUES = {
    'rmse': lambda m: torch.sqrt(m['se']),
    'bias': lambda m: m['err'],
    'acc': lambda m: m['cov'] / torch.sqrt(m['spa'] * m['sta']),
}


def _weights(config: dict, land_sea_mask) -> tuple:
  """((R, Y, X) float64 numpy weights, region labels) on the grid the
  configuration gives, the land parts after the regions."""
  lat, lon = ref_lib.grid(config)
  boxes = ref_lib.region_masks(lat, lon, config['regions'])
  land = np.asarray(land_sea_mask.data.cpu().numpy()) != 0
  masks = np.concatenate([boxes, boxes & land[None]])
  labels = list(config['regions']) + [f'{r}_land' for r in config['regions']]
  w = (ref_lib.area_weights(lat)[None, :, None]
       * ref_lib.validity_mask(config)[None] * masks)
  return w, labels


def _slots(climatology, valid_hours: np.ndarray) -> np.ndarray:
  """Flat (dayofyear, hour) slot of each valid time, by the labels."""
  days = list(np.asarray(climatology.coord_values('dayofyear')))
  hours = list(np.asarray(climatology.coord_values('hour')))
  day = valid_hours // 24 + 1
  return np.array([days.index(d) * len(hours) + hours.index(h)
                   for d, h in zip(day.ravel(), (valid_hours % 24).ravel())]
                  ).reshape(valid_hours.shape)


def values(config: dict, traffic: dict, scoring, pool: list,
           resources: dict, counts: dict, device) -> dict:
  names = {name: m['reference'] for name, m in scoring.metrics.items()}
  stats = sorted({s for r in names.values() for s in STATS[r]})
  w, labels = _weights(config, resources['land_sea_mask'])
  w = torch.from_numpy(w).to(device)
  chunk = traffic['chunk']
  lead_h = (config['first_lead_hours']
            + np.arange(chunk['leads']) * config['lead_step_hours'])
  out = {name: {} for name in names}
  for var in config['variables']:
    clim = resources['climatology'][var]
    clim_flat = clim.data.to(device).flatten(0, 1)  # (slot, ...)
    total = {s: 0 for s in stats}
    weight = 0
    for (j, inits), n in sorted(counts.items()):
      valid = np.array(inits)[:, None] + lead_h[None]
      c = clim_flat[torch.from_numpy(_slots(clim, valid)).to(device)].double()
      p = pool[j].forecast[var].double()
      t = pool[j].target[var].double()
      point = {'se': lambda: (p - t) ** 2, 'err': lambda: p - t,
               'spa': lambda: (p - c) ** 2, 'sta': lambda: (t - c) ** 2,
               'cov': lambda: (p - c) * (t - c)}
      for s in stats:
        total[s] = total[s] + n * torch.einsum('il...yx,ryx->l...r',
                                               point[s](), w)
      weight = weight + n * p.shape[0] * w.sum((1, 2))
      del c, p, t
    means = {s: total[s] / weight for s in stats}
    levels = (config['levels']
              if var in config.get('upper_air_variables', ()) else ())
    dims = ('lead_time',) + (('level',) if levels else ()) + ('region',)
    tags = {'region': labels}
    if levels:
      tags['level'] = [str(x) for x in levels]
    for name, r in names.items():
      out[name][var] = (dims, VALUES[r](means).cpu().numpy(), tags)
  return out
