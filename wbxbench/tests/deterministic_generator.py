"""A generator module of a deterministic configuration with levels and a
climatology (the contract is in ``spec.py``), for the tests' proof that a
configuration of another kind than an ensemble's comes in by new files
alone. The tests copy it into ``generators/`` of a copy of the benchmark.

Per variable (and level, for the configuration's ``upper_air_variables``
at its ``levels``), from the traffic's ``generator`` parameters:

  normal(y, x)      = climatology_mean + climatology_sd * N(0, 1)
  climatology(s)    = normal + slot_sd * N(0, 1)        s: (dayofyear, hour)
  target(i, l)      = normal + anomaly_sd * N(0, 1)
  forecast(i, l)    = target + bias + error_sd(l) * N(0, 1)

with error_sd = sd at lead 0 + growth a day * lead days. The climatology
covers the configuration's ``climatology_days`` from 1 January, 6-hourly;
chunk ``c``'s inits take position ``c % positions``, the last position
whose valid times all still fall inside it, so that a run of any length
stays inside the climatology. Chunk ``c``'s statistics depend on its pool
chunk and its init times: the chunk key is both. The land-sea mask is a
checkerboard of ``land_block_degrees`` squares.
"""

import numpy as np
import torch

from wbxbench import traffic as traffic_lib
from wbxbench.reference import grid

FIRST_INIT = np.datetime64('2020-01-01T00', 'ns')
HOURS = (0, 6, 12, 18)
DIMS = ('init_time', 'lead_time')
GRID_DIMS = ('latitude', 'longitude')

lead_hours = traffic_lib.lead_hours


def levels_of(config: dict, var: str) -> tuple:
  return (tuple(config['levels'])
          if var in config.get('upper_air_variables', ()) else ())


def positions(config: dict, traffic: dict) -> int:
  """Init positions a run cycles through: chunk ``k``'s inits are
  ``k * init_times ...`` steps of ``init_step_hours`` from 1 January, and
  its last valid time lies in the climatology's last slot or before it."""
  ni = traffic['chunk']['init_times']
  step = config['init_step_hours']
  last = (config['climatology_days'] * 24 - 6
          - lead_hours(config, traffic['chunk'])[-1] - (ni - 1) * step)
  if last < 0:
    raise ValueError('the climatology ends before the first chunk\'s last '
                     'valid time')
  return last // (ni * step) + 1


def init_hours(config: dict, traffic: dict, c: int) -> np.ndarray:
  ni = traffic['chunk']['init_times']
  k = c % positions(config, traffic)
  return (k * ni + np.arange(ni)) * config['init_step_hours']


def chunk_key(config: dict, traffic: dict, c: int, pool: int) -> tuple:
  """(pool chunk, the chunk's init hours from 1 January)."""
  return (c % pool, tuple(int(h) for h in init_hours(config, traffic, c)))


def _generator(seed: int, *parts, device) -> torch.Generator:
  g = torch.Generator(device=device)
  g.manual_seed(traffic_lib.mix(seed, *parts))
  return g


def _normal(config, gen, seed, var, device) -> torch.Tensor:
  shape = ((len(levels_of(config, var)),) if levels_of(config, var) else ()
           ) + (config['latitudes'], config['longitudes'])
  g = _generator(seed, 'normal', var, device=device)
  return (gen['climatology_mean'] + gen['climatology_sd']
          * torch.randn(shape, generator=g, device=device))


def make_chunk(config: dict, traffic: dict, seed: int, j: int,
               device) -> traffic_lib.PoolChunk:
  gen, chunk = traffic['generator'], traffic['chunk']
  ni, nl = chunk['init_times'], chunk['leads']
  sd0, per_day = gen['error_sd']
  error_sd = torch.from_numpy(sd0 + per_day * lead_hours(config, chunk)
                              / 24.0).to(device, torch.float32)
  out = traffic_lib.PoolChunk({}, {}, {})
  for var in config['variables']:
    normal = _normal(config, gen, seed, var, device)
    g = _generator(seed, j, var, device=device)
    shape = (ni, nl) + tuple(normal.shape)
    target = torch.randn(shape, generator=g, device=device)
    target.mul_(gen['anomaly_sd']).add_(normal)
    forecast = torch.randn(shape, generator=g, device=device)
    sd = error_sd.reshape((1, nl) + (1,) * normal.dim())
    forecast.mul_(sd).add_(target + gen['bias'])
    out.forecast[var], out.target[var] = forecast, target
  return out


def make_pool(config: dict, traffic: dict, seed: int, device,
              dtype=None) -> list:
  return traffic_lib.pool_in(
      lambda j: make_chunk(config, traffic, seed, j, device),
      traffic['pool'], device, dtype)


def resources(config: dict, traffic: dict, seed: int, device) -> dict:
  """The climatology ({variable: DimArray over dayofyear, hour, [level,]
  latitude, longitude}, float32 on the host, as a store's loader gives
  it) and the land-sea mask (a float32 DimArray on the host)."""
  from weatherbenchx_tpu_torch.darray import DimArray
  gen = traffic['generator']
  lat, lon = grid(config)
  days = config['climatology_days']
  climatology = {}
  for var in config['variables']:
    normal = _normal(config, gen, seed, var, device)
    g = _generator(seed, 'climatology', var, device=device)
    data = torch.randn((days, len(HOURS)) + tuple(normal.shape),
                       generator=g, device=device)
    data.mul_(gen['slot_sd']).add_(normal)
    levels = levels_of(config, var)
    coords = {'dayofyear': np.arange(1, days + 1), 'hour': np.array(HOURS),
              'latitude': lat, 'longitude': lon}
    if levels:
      coords['level'] = np.array(levels)
    climatology[var] = DimArray(
        data.cpu(), ('dayofyear', 'hour') + (('level',) if levels else ())
        + GRID_DIMS, coords)
  block = config['land_block_degrees']
  land = (np.floor((90 - lat) / block)[:, None]
          + np.floor(lon / block)[None, :]) % 2 == 0
  return {'climatology': climatology,
          'land_sea_mask': DimArray(land.astype(np.float32), GRID_DIMS,
                                    {'latitude': lat, 'longitude': lon})}


def handover(config: dict, traffic: dict, pool_chunk, c: int,
             target_kind: str, mask) -> tuple:
  """Chunk ``c`` as fresh (predictions, targets) over ``pool_chunk``'s
  tensors: (init_time, lead_time, [level,] latitude, longitude), the
  targets at the predictions' valid times."""
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  if target_kind != 'deterministic':
    raise ValueError(f'unknown target kind {target_kind!r}')
  lat, lon = grid(config)
  inits = FIRST_INIT + init_hours(config, traffic, c).astype('timedelta64[h]')
  coords = {
      'init_time': inits.astype('datetime64[ns]'),
      'lead_time': lead_hours(config, traffic['chunk']).astype(
          'timedelta64[h]').astype('timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
      'mask': Coord(GRID_DIMS, mask),
  }

  def wrap(var, data):
    levels = levels_of(config, var)
    dims = DIMS + (('level',) if levels else ()) + GRID_DIMS
    return DimArray(data, dims, dict(coords, **(
        {'level': np.array(levels)} if levels else {})))
  return ({v: wrap(v, x) for v, x in pool_chunk.forecast.items()},
          {v: wrap(v, y) for v, y in pool_chunk.target.items()})
