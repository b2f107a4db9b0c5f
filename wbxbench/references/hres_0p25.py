"""The plain float64 reference of ``hres_0p25``, WeatherBench 2's
deterministic scorecard (the contract is in ``spec.py``).

Written from the definitions (Rasp et al. 2024, arXiv:2308.15560, section
4; SEEPS of Rodwell et al. 2010 as WeatherBench-X scores it), in plain
PyTorch and NumPy: it imports nothing of the port, reads nothing the port
made, and keeps TF32 off. From the same pool and resources, per point of a
forecast p and a target t (per variable and level), the climatology c at
the point's valid time (its dayofyear and hour looked up among the
climatology's labels), in float64:

  se = (p - t)^2, err = p - t, spa = (p - c)^2, sta = (t - c)^2,
  cov = (p - c)(t - c), wse = (p_u - t_u)^2 + (p_v - t_v)^2

and SEEPS: each side's category, dry where x <= the dry threshold, heavy
where x >= the wet threshold at the valid time, light between; the score
of the (forecast, target) pair from p1, the dry fraction's mean over the
climatology's slots,

  (dry, light) 1/(2(1 - p1)), (dry, heavy) 2/(1 - p1),
  (light, dry) 1/(2 p1), (light, heavy) 3/(2(1 - p1)),
  (heavy, dry) 1/(2 p1) + 3/(2(2 + p1)), (heavy, light) 3/(2(2 + p1)),

weighted only where p1 lies in [min_p1, max_p1]. The one departure from
float64: SEEPS classifies at float32, as the port does (the data, the wet
thresholds and p1 are float32; the dry threshold and the p1 bounds are
compared at their float32 images), so that a point within rounding of a
threshold takes the same category as in the port and not one that
depends on the dtype. The scores themselves are float64.

Weights: area x validity mask x each region's box, and for each region its
``<region>_land`` part (the land-sea mask's nonzero points). A value per
(lead, [level,] region) is a ratio of weighted sums over (init, latitude,
longitude) of every chunk of the run: each chunk key (pool chunk, the
chunk's init hours) summed once, times its count; the statistics that read
no climatology depend on the pool chunk alone, and are summed once a pool
chunk, times its chunks.

  rmse = sqrt(se), mse = se, bias = err, acc = cov / sqrt(spa sta),
  prediction_activity = sqrt(spa), vector_rmse = sqrt(wse),
  seeps = the weighted mean score                              (means)

The leads go in blocks of about ``BLOCK_VALUES`` values a field, so that
the float64 temporaries fit on the device beside the pool and the
climatology.
"""

import numpy as np
import torch

from wbxbench import reference as ref_lib

BLOCK_VALUES = 1 << 25
# Per-point statistics of each reference metric, and its value from their
# means.
STATS = {
    'rmse': ('se',), 'mse': ('se',), 'bias': ('err',),
    'acc': ('spa', 'sta', 'cov'), 'prediction_activity': ('spa',),
    'vector_rmse': ('wse',), 'seeps': ('seeps',),
}
VALUES = {
    'rmse': lambda m: torch.sqrt(m['se']),
    'mse': lambda m: m['se'],
    'bias': lambda m: m['err'],
    'acc': lambda m: m['cov'] / torch.sqrt(m['spa'] * m['sta']),
    'prediction_activity': lambda m: torch.sqrt(m['spa']),
    'vector_rmse': lambda m: torch.sqrt(m['wse']),
    'seeps': lambda m: m['seeps'],
}


def _f32(x: float) -> float:
  return float(np.float32(x))


def _weights(config: dict, land_sea_mask) -> tuple:
  """((R, Y, X) float64 numpy weights, region labels): the regions, then
  their land parts."""
  lat, lon = ref_lib.grid(config)
  boxes = ref_lib.region_masks(lat, lon, config['regions'])
  land = np.asarray(land_sea_mask.data.cpu().numpy()) != 0
  masks = np.concatenate([boxes, boxes & land[None]])
  labels = list(config['regions']) + [f'{r}_land' for r in config['regions']]
  w = (ref_lib.area_weights(lat)[None, :, None]
       * ref_lib.validity_mask(config)[None] * masks)
  return w, labels


def _slots(climatology, valid_hours: np.ndarray) -> np.ndarray:
  """Flat (dayofyear, hour) slot of each valid time (hours from 1
  January), by the climatology's labels."""
  days = list(np.asarray(climatology.coord_values('dayofyear')))
  hours = list(np.asarray(climatology.coord_values('hour')))
  day = valid_hours // 24 + 1
  return np.array([days.index(d) * len(hours) + hours.index(h)
                   for d, h in zip(day.ravel(), (valid_hours % 24).ravel())]
                  ).reshape(valid_hours.shape)


def _wsum(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """(I, L, [level,] Y, X) x (R, Y, X) -> (L, [level,] R)."""
  return torch.einsum('il...yx,ryx->l...r', s, w)


def _seeps_score(p, t, wet, dry: float, p1) -> torch.Tensor:
  """SEEPS's per-point score (module docstring) of forecast ``p`` and
  target ``t`` against the wet threshold ``wet`` and the dry threshold
  ``dry``, from the float64 ``p1``."""
  def bands(x):
    return x <= dry, (x > dry) & (x < wet), x >= wet
  fd, fl, fh = bands(p)
  td, tl, th = bands(t)
  return ((fd & tl) * (0.5 / (1 - p1)) + (fd & th) * (2 / (1 - p1))
          + (fl & td) * (0.5 / p1) + (fl & th) * (1.5 / (1 - p1))
          + (fh & td) * (0.5 / p1 + 1.5 / (2 + p1))
          + (fh & tl) * (1.5 / (2 + p1)))


def values(config: dict, traffic: dict, scoring, pool: list,
           resources: dict, counts: dict, device) -> dict:
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  metrics = {name: m['reference'] for name, m in scoring.metrics.items()}
  kwargs = {m['reference']: m.get('kwargs', {})
            for m in scoring.metrics.values()}
  stats = {s for r in metrics.values() for s in STATS[r]}
  w_np, labels = _weights(config, resources['land_sea_mask'])
  w = torch.from_numpy(w_np).to(device)
  clim = resources['climatology']
  chunk = traffic['chunk']
  nl = chunk['leads']
  lead_h = (config['first_lead_hours']
            + np.arange(nl) * config['lead_step_hours'])
  by_pool = {}
  for (j, inits), n in sorted(counts.items()):
    by_pool.setdefault(j, []).append((np.array(inits), n))
  # Every statistic is summed over the same inits of every chunk: its
  # weights' sum a lead is that of w (of SEEPS's weights for SEEPS).
  inits_summed = chunk['init_times'] * sum(counts.values())
  sums, weights = {}, {}

  def add(stat, name, b, n, s, w):
    """n times the sums of s (I, leads b, [level,] Y, X) under the
    weights w (R, Y, X), into sums[(stat, name)] (L, [level,] R)."""
    x = n * _wsum(s, w)
    if (stat, name) not in sums:
      sums[(stat, name)] = x.new_zeros((nl,) + tuple(x.shape[1:]))
      weights[(stat, name)] = inits_summed * w.sum((1, 2))
    sums[(stat, name)][b] += x

  def blocks(var):
    field = int(np.prod(pool[0].forecast[var].shape[2:]))
    step = max(1, BLOCK_VALUES // (chunk['init_times'] * field))
    return [slice(lo, min(nl, lo + step)) for lo in range(0, nl, step)]

  def gathered(name, inits, b):
    flat = clim[name].data.flatten(0, 1)
    slots = _slots(clim[name], inits[:, None] + lead_h[None, b])
    return flat[torch.from_numpy(slots).to(flat.device)].double()

  for var in config['variables']:
    for j, keys in by_pool.items():
      n_j = sum(n for _, n in keys)
      for b in blocks(var):
        p = pool[j].forecast[var][:, b].double()
        t = pool[j].target[var][:, b].double()
        if 'se' in stats:
          add('se', var, b, n_j, (p - t) ** 2, w)
        if 'err' in stats:
          add('err', var, b, n_j, p - t, w)
        if stats & {'spa', 'sta', 'cov'}:
          for inits, n in keys:
            c = gathered(var, inits, b)
            pa, ta = p - c, t - c
            del c
            for s, x in (('spa', lambda: pa * pa), ('sta', lambda: ta * ta),
                         ('cov', lambda: pa * ta)):
              if s in stats:
                add(s, var, b, n, x(), w)
            del pa, ta
        del p, t

  vectors = kwargs.get('vector_rmse', {})
  for u, v, name in zip(vectors.get('u_name', ()), vectors.get('v_name', ()),
                        vectors.get('vector_name', ())):
    for j, keys in by_pool.items():
      n_j = sum(n for _, n in keys)
      for b in blocks(u):
        pu, pv = (pool[j].forecast[x][:, b].double() for x in (u, v))
        tu, tv = (pool[j].target[x][:, b].double() for x in (u, v))
        add('wse', name, b, n_j, (pu - tu) ** 2 + (pv - tv) ** 2, w)
        del pu, pv, tu, tv

  seeps = kwargs.get('seeps', {})
  seeps_vars = list(seeps.get('variables', ()))

  def per_variable(key, default):
    x = seeps.get(key, default)
    return list(x) if isinstance(x, (list, tuple)) else [x] * len(seeps_vars)
  for var, dry_mm, lo, hi in zip(seeps_vars,
                                 per_variable('dry_threshold_mm', 0.25),
                                 per_variable('min_p1', 0.1),
                                 per_variable('max_p1', 0.85)):
    p1 = clim[f'{var}_seeps_dry_fraction'].data.double().mean((0, 1))
    p1_32 = p1.float().double()
    keep = (p1_32 >= _f32(lo)) & (p1_32 <= _f32(hi))
    w_seeps = w * keep
    dry = _f32(dry_mm / 1000.0)
    for j, keys in by_pool.items():
      for b in blocks(var):
        p = pool[j].forecast[var][:, b].double()
        t = pool[j].target[var][:, b].double()
        for inits, n in keys:
          wet = gathered(f'{var}_seeps_threshold', inits, b)
          add('seeps', var, b, n, _seeps_score(p, t, wet, dry, p1),
              w_seeps)
          del wet
        del p, t

  out = {name: {} for name in metrics}
  for name, r in metrics.items():
    if r == 'vector_rmse':
      names = list(zip(vectors['vector_name'], vectors['u_name']))
    elif r == 'seeps':
      names = [(v, v) for v in seeps_vars]
    else:
      names = [(v, v) for v in config['variables']]
    for key, var in names:
      means = {s: sums[(s, key)] / weights[(s, key)] for s in STATS[r]}
      levels = (config['levels']
                if var in config.get('upper_air_variables', ()) else ())
      dims = ('lead_time',) + (('level',) if levels else ()) + ('region',)
      tags = {'region': labels}
      if levels:
        tags['level'] = [str(x) for x in levels]
      out[name][key] = (dims, VALUES[r](means).cpu().numpy(), tags)
  return out
