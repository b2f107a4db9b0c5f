"""The generator of ``hres_0p25``, WeatherBench 2's deterministic scorecard
of HRES at 0.25 degrees (the contract is in ``spec.py``).

Every field is made on the device from the seed; the traffic's
``generator`` gives the statistics. Per field-level (a variable, at each of
the configuration's ``levels`` for its ``upper_air_variables``), with the
field's ``mean``, ``space_sd`` and ``anomaly_sd`` (a number, or a list with
one a level) and the shared ``slot_sd``, ``error_sd`` and ``bias`` in units
of ``anomaly_sd``:

  normal(y, x)      = mean + space_sd * N(0, 1)
  climatology(s)    = normal + slot_sd * anomaly_sd * N(0, 1)
                                        s: (dayofyear, hour), 6-hourly
  target(i, l)      = normal + anomaly_sd * N(0, 1)
  forecast(i, l)    = target + e(l) * anomaly_sd * (bias + N(0, 1))
  e(l)              = error_sd[0] + error_sd[1] * lead days

Each ``speeds`` variable is |(u, v)| of its two generated components, on
each side and in each climatology slot.

Precipitation (metres), per ``precipitation`` variable with its dry
threshold ``dry_mm`` and wet scale ``wet_scale_mm``: a dry fraction p1(y,
x) uniform in ``p1_range``; a latent z = N(0, 1) for the target and z_f =
(z + e(l) N(0, 1)) / sqrt(1 + e(l)^2) for the forecast; an amount

  amount(z, q) = wet_scale * E   where E = log(1 - q0) - log Phi(-z)
                                 is >= 0 (Phi(z) >= q0), else 0,
  q0 = (q - d) / (1 - d), d = 1 - exp(-dry / wet_scale),

exponential where it rains, and at most the dry threshold with
probability q: the target's q = p1 and the forecast's p1 - ``drizzle``
(it rains too often, as models do); traces below the dry threshold occur.
Its climatology is the mean amount (1 - q0) wet_scale at q = p1, times (1
+ slot_sd N(0, 1)); SEEPS's ``<variable>_seeps_threshold``, the 2/3
quantile of the amounts above the dry threshold, dry + wet_scale ln 3,
times (1 + ``threshold_slot_sd`` N(0, 1)) a slot;
``<variable>_seeps_dry_fraction`` p1 + ``dry_fraction_slot_sd`` N(0, 1) a
slot, clamped to [0, 1]. All three categories occur, and some points' p1
falls outside [0.1, 0.85].

The climatology covers the configuration's ``climatology_days`` from 1
January, 6-hourly, and stays on the device. The configuration's
``init_times`` inits (checked to keep every valid time inside the
climatology) fall into positions of a chunk's inits, and chunk ``c`` takes
position ``c`` modulo their number, so a run of any length stays inside
it; its statistics depend on its pool chunk
and its init times, the chunk key. The chunks carry no validity mask (the
configuration's ``mask`` is none). The land-sea mask is a checkerboard of
``land_block_degrees`` squares.
"""

import math

import numpy as np
import torch

from wbxbench import traffic as traffic_lib
from wbxbench.reference import grid

FIRST_INIT = np.datetime64('2020-01-01T00', 'ns')
HOURS = (0, 6, 12, 18)
DIMS = ('init_time', 'lead_time')
GRID_DIMS = ('latitude', 'longitude')


def levels_of(config: dict, var: str) -> tuple:
  return (tuple(config['levels'])
          if var in config.get('upper_air_variables', ()) else ())


def init_hours(config: dict, traffic: dict, c: int) -> np.ndarray:
  """Chunk ``c``'s init hours from 1 January: the configuration's
  ``init_times`` inits, ``init_step_hours`` apart, in positions of the
  chunk's inits; chunk ``c`` takes position ``c`` modulo their number.
  Raises where they do not fill whole positions, or where the last init's
  last valid time lies past the climatology's last slot."""
  ni = traffic['chunk']['init_times']
  step = config['init_step_hours']
  positions, rest = divmod(config['init_times'], ni)
  if rest:
    raise ValueError(f'{config["init_times"]} inits do not fill positions '
                     f'of {ni}')
  last = ((positions * ni - 1) * step
          + traffic_lib.lead_hours(config, traffic['chunk'])[-1])
  if last > config['climatology_days'] * 24 - 6:
    raise ValueError(f'{positions} init positions reach valid hour {last}, '
                     f'past the {config["climatology_days"]} days of '
                     'climatology')
  k = c % positions
  return (k * ni + np.arange(ni)) * step


def chunk_key(config: dict, traffic: dict, c: int, pool: int) -> tuple:
  """(pool chunk, the chunk's init hours from 1 January)."""
  return (c % pool, tuple(int(h) for h in init_hours(config, traffic, c)))


def _generator(seed: int, *parts, device) -> torch.Generator:
  g = torch.Generator(device=device)
  g.manual_seed(traffic_lib.mix(seed, *parts))
  return g


def _per_level(config: dict, var: str, value, device):
  """``value`` broadcast over a field: a number, or one a level as a
  (level, 1, 1) tensor."""
  if isinstance(value, list):
    if len(value) != len(levels_of(config, var)):
      raise ValueError(f'{var}: {len(value)} values for '
                       f'{len(levels_of(config, var))} levels')
    return torch.tensor(value, dtype=torch.float32,
                        device=device).reshape(-1, 1, 1)
  return float(value)


def _field_shape(config: dict, var: str) -> tuple:
  n = len(levels_of(config, var))
  return ((n,) if n else ()) + (config['latitudes'], config['longitudes'])


def _normal(config, gen, seed, var, device) -> torch.Tensor:
  f = gen['fields'][var]
  g = _generator(seed, 'normal', var, device=device)
  x = torch.randn(_field_shape(config, var), generator=g, device=device)
  return (x.mul_(_per_level(config, var, f['space_sd'], device))
          .add_(_per_level(config, var, f['mean'], device)))


def _dry_fraction(config, gen, seed, var, device) -> torch.Tensor:
  lo, hi = gen['p1_range']
  g = _generator(seed, 'p1', var, device=device)
  return lo + (hi - lo) * torch.rand(_field_shape(config, var), generator=g,
                                     device=device)


def _metres(gen: dict, var: str) -> tuple:
  """(dry threshold, wet scale) of a precipitation variable in metres."""
  p = gen['precipitation'][var]
  return p['dry_mm'] / 1000.0, p['wet_scale_mm'] / 1000.0


def _no_rain(q, dry_m: float, scale_m: float):
  """q0 (module docstring): the share of points without rain that leaves
  the share q at or below the dry threshold."""
  d = -math.expm1(-dry_m / scale_m)
  return ((q - d) / (1 - d)).clamp(min=0.0)


def _amount(z: torch.Tensor, q0, scale_m: float) -> torch.Tensor:
  """wet_scale * E where E = log(1 - q0) - log Phi(-z) >= 0, else 0
  (module docstring): log Phi(-z) keeps the upper tail from
  saturating."""
  e = torch.special.log_ndtr(-z).neg_().add_(torch.log1p(-q0))
  return torch.where(e >= 0, e.mul_(scale_m),
                     torch.zeros((), device=z.device))


def _error_scale(config, traffic, device) -> torch.Tensor:
  """e(l) as a (1, L) tensor."""
  sd0, per_day = traffic['generator']['error_sd']
  e = sd0 + per_day * traffic_lib.lead_hours(config, traffic['chunk']) / 24
  return torch.from_numpy(e).to(device, torch.float32)[None]


def make_chunk(config: dict, traffic: dict, seed: int, j: int,
               device) -> traffic_lib.PoolChunk:
  """Pool chunk ``j``: per variable the forecast and the target, (init,
  lead, [level,] latitude, longitude) on ``device``."""
  gen, chunk = traffic['generator'], traffic['chunk']
  ni, nl = chunk['init_times'], chunk['leads']
  e = _error_scale(config, traffic, device)
  forecast, target = {}, {}
  for var in config['variables']:
    if var in gen['speeds']:
      continue
    g = _generator(seed, j, var, device=device)
    extra = (1,) * len(_field_shape(config, var))
    el = e.reshape((1, nl) + extra)
    if var in gen['precipitation']:
      dry_m, scale_m = _metres(gen, var)
      p1 = _dry_fraction(config, gen, seed, var, device)
      shape = (ni, nl) + tuple(p1.shape)
      z = torch.randn(shape, generator=g, device=device)
      target[var] = _amount(z, _no_rain(p1, dry_m, scale_m), scale_m)
      z.add_(torch.randn(shape, generator=g, device=device).mul_(el))
      z.div_(torch.sqrt(1 + el * el))
      forecast[var] = _amount(
          z, _no_rain(p1 - gen['drizzle'], dry_m, scale_m), scale_m)
      del z
      continue
    f = gen['fields'][var]
    normal = _normal(config, gen, seed, var, device)
    sd = _per_level(config, var, f['anomaly_sd'], device)
    shape = (ni, nl) + tuple(normal.shape)
    t = torch.randn(shape, generator=g, device=device).mul_(sd).add_(normal)
    err = torch.randn(shape, generator=g, device=device).add_(gen['bias'])
    forecast[var] = err.mul_(el).mul_(sd).add_(t)
    target[var] = t
  for var, (u, v) in gen['speeds'].items():
    if var in config['variables']:
      forecast[var] = torch.hypot(forecast[u], forecast[v])
      target[var] = torch.hypot(target[u], target[v])
  order = config['variables']
  return traffic_lib.PoolChunk({v: forecast[v] for v in order},
                               {v: target[v] for v in order}, {})


def make_pool(config: dict, traffic: dict, seed: int, device,
              dtype=None) -> list:
  if config.get('mask') not in (None, 'none'):
    raise ValueError('the chunks of this configuration carry no validity '
                     f'mask; its mask is {config["mask"]!r}')
  return traffic_lib.pool_in(
      lambda j: make_chunk(config, traffic, seed, j, device),
      traffic['pool'], device, dtype)


def resources(config: dict, traffic: dict, seed: int, device) -> dict:
  """The climatology ({name: DimArray over dayofyear, hour, [level,]
  latitude, longitude}: every variable, and SEEPS's wet thresholds and dry
  fractions of each precipitation variable), float32 on ``device``, and
  the land-sea mask (a float32 DimArray on the host)."""
  from weatherbenchx_tpu_torch.darray import DimArray
  gen = traffic['generator']
  lat, lon = grid(config)
  days = config['climatology_days']
  slots = (days, len(HOURS))
  coords = {'dayofyear': np.arange(1, days + 1), 'hour': np.array(HOURS),
            'latitude': lat, 'longitude': lon}

  def wrap(var, data):
    levels = levels_of(config, var)
    return DimArray(data, ('dayofyear', 'hour')
                    + (('level',) if levels else ()) + GRID_DIMS,
                    dict(coords, **({'level': np.array(levels)}
                                    if levels else {})))
  clim = {}
  for var in config['variables']:
    if var in gen['speeds']:
      continue
    g = _generator(seed, 'climatology', var, device=device)
    shape = slots + _field_shape(config, var)
    noise = torch.randn(shape, generator=g, device=device)
    if var in gen['precipitation']:
      dry_m, scale_m = _metres(gen, var)
      p1 = _dry_fraction(config, gen, seed, var, device)
      clim[var] = noise.mul_(gen['slot_sd']).add_(1).mul_(
          (1 - _no_rain(p1, dry_m, scale_m)) * scale_m)
      clim[f'{var}_seeps_threshold'] = torch.randn(
          shape, generator=g, device=device).mul_(
              gen['threshold_slot_sd']).add_(1).mul_(
                  dry_m + scale_m * math.log(3))
      clim[f'{var}_seeps_dry_fraction'] = torch.randn(
          shape, generator=g, device=device).mul_(
              gen['dry_fraction_slot_sd']).add_(p1).clamp_(0.0, 1.0)
      continue
    f = gen['fields'][var]
    sd = _per_level(config, var, f['anomaly_sd'], device)
    clim[var] = noise.mul_(sd).mul_(gen['slot_sd']).add_(
        _normal(config, gen, seed, var, device))
  for var, (u, v) in gen['speeds'].items():
    if var in config['variables']:
      clim[var] = torch.hypot(clim[u], clim[v])
  if torch.device(device).type == 'cuda':
    torch.cuda.empty_cache()
  block = config['land_block_degrees']
  land = (np.floor(lat / block)[:, None]
          + np.floor(lon / block)[None, :]) % 2 == 0
  return {'climatology': {
              k: wrap(k.split('_seeps_')[0], x) for k, x in clim.items()},
          'land_sea_mask': DimArray(land.astype(np.float32), GRID_DIMS,
                                    {'latitude': lat, 'longitude': lon})}


def handover(config: dict, traffic: dict, pool_chunk, c: int,
             target_kind: str, mask) -> tuple:
  """Chunk ``c`` as fresh (predictions, targets) over ``pool_chunk``'s
  tensors: (init_time, lead_time, [level,] latitude, longitude), the
  targets at the predictions' valid times; no validity mask (``mask`` is
  the configuration's, every point)."""
  from weatherbenchx_tpu_torch.darray import DimArray
  del mask
  if target_kind != 'deterministic':
    raise ValueError(f'unknown target kind {target_kind!r}')
  lat, lon = grid(config)
  inits = FIRST_INIT + init_hours(config, traffic, c).astype('timedelta64[h]')
  coords = {
      'init_time': inits.astype('datetime64[ns]'),
      'lead_time': traffic_lib.lead_hours(config, traffic['chunk']).astype(
          'timedelta64[h]').astype('timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
  }

  def wrap(var, data):
    levels = levels_of(config, var)
    dims = DIMS + (('level',) if levels else ()) + GRID_DIMS
    return DimArray(data, dims, dict(coords, **(
        {'level': np.array(levels)} if levels else {})))
  return ({v: wrap(v, x) for v, x in pool_chunk.forecast.items()},
          {v: wrap(v, y) for v, y in pool_chunk.target.items()})
