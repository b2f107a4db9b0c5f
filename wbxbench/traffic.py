"""The general generator of a cell's chunks, made on its device from the seed.

The recipe of ``tools/gen_demo_fixtures.py`` (climatology + an error the
forecast shares with the analysis + noise of its own), copied here and
given an ensemble's spread, with every parameter read from the traffic
file's ``generator``:

  base(v)           = clim(v) + shared(v)                  v: valid time
  target(i, l)      = base(v) + error_sd(i, l) * N(0, 1)
  member(m, i, l)   = base(v) + bias + spread_sd(i, l) * N(0, 1)
  analysis(k, i, l) = target(i, l) + analysis_sd * N(0, 1)

with clim = climatology_mean + climatology_sd * N(0, 1) and shared =
shared_sd * N(0, 1) per valid time and gridpoint, and spread_sd and
error_sd = f_i * (sd at lead 0 + growth a day * lead days), where f_i, an
init's predictability, is drawn uniform in ``predictability`` per init:
the chunks of a pool differ, so that a chunk lost or counted twice moves
the values.

A cell's pool holds ``pool`` such chunks of ``chunk['init_times']`` inits x
``chunk['leads']`` leads, every array drawn on the device by a
``torch.Generator`` seeded from (seed, chunk, variable), in a few large
calls. The same seed gives the same pool on any run; every seed gives the
same shapes. ``handover`` wraps a pool chunk into fresh ``DimArray``s with
an init time of its own for each chunk of the window.

This is the default generator module (``spec.py`` gives the contract): a
configuration that names no ``generator_module`` runs this one.
"""

import dataclasses
import hashlib

import numpy as np
import torch

# The grid (latitudes north to south, as ERA5 stores them), as the
# reference works it out from the configuration.
from wbxbench.reference import grid

ENSEMBLE_DIM = 'number'
DIMS = ('init_time', 'lead_time', 'latitude', 'longitude')
FIRST_INIT = np.datetime64('2020-01-01T00', 'ns')


def mix(*parts) -> int:
  """A 63-bit seed from any whole numbers and names (the CLI's seed may
  pass 2**31)."""
  digest = hashlib.sha256(repr(parts).encode()).digest()
  return int.from_bytes(digest[:8], 'little') >> 1


@dataclasses.dataclass
class PoolChunk:
  """One distinct chunk: per variable, the forecast ensemble (M, I, L, Y, X),
  the target (I, L, Y, X) and the analysis ensemble (A, I, L, Y, X) or
  None, on the device."""
  forecast: dict
  target: dict
  analysis: dict


def lead_hours(config: dict, chunk: dict) -> np.ndarray:
  return (config['first_lead_hours']
          + np.arange(chunk['leads']) * config['lead_step_hours'])


def _scales(gen: dict, factors: np.ndarray, leads_h: np.ndarray,
            key: str) -> torch.Tensor:
  sd0, per_day = gen[key]
  return torch.from_numpy(factors[:, None] * (sd0 + per_day * leads_h[None]
                                              / 24.0))


def make_chunk(config: dict, traffic: dict, seed: int, j: int,
               device) -> PoolChunk:
  """Pool chunk ``j`` of a cell, made on ``device`` from ``seed``."""
  gen, chunk = traffic['generator'], traffic['chunk']
  ni, nl = chunk['init_times'], chunk['leads']
  ny, nx = config['latitudes'], config['longitudes']
  leads_h = lead_hours(config, chunk)
  inits_h = (j * ni + np.arange(ni)) * config['init_step_hours']
  valid_h = inits_h[:, None] + leads_h[None]
  valid, vidx = np.unique(valid_h, return_inverse=True)
  vidx = torch.from_numpy(vidx.reshape(ni, nl)).to(device)
  lo, hi = gen['predictability']
  factors = np.random.default_rng(mix(seed, j, 'predictability')).uniform(
      lo, hi, ni)
  spread_sd = _scales(gen, factors, leads_h, 'spread_sd').to(device,
                                                              torch.float32)
  error_sd = _scales(gen, factors, leads_h, 'error_sd').to(device,
                                                            torch.float32)
  out = PoolChunk({}, {}, {})
  for var in config['variables']:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, j, var))
    field = (len(valid), ny, nx)
    base = (gen['climatology_mean'] + gen['climatology_sd']
            * torch.randn(field, generator=g, device=device))
    base += gen['shared_sd'] * torch.randn(field, generator=g, device=device)
    base = base[vidx]  # (I, L, Y, X)
    target = torch.randn((ni, nl, ny, nx), generator=g, device=device)
    target.mul_(error_sd[:, :, None, None]).add_(base)
    members = torch.randn((config['members'], ni, nl, ny, nx), generator=g,
                          device=device)
    members.mul_(spread_sd[None, :, :, None, None]).add_(base + gen['bias'])
    del base
    out.forecast[var], out.target[var] = members, target
    na = config.get('analysis_members', 0)
    if na:
      analysis = torch.randn((na, ni, nl, ny, nx), generator=g, device=device)
      analysis.mul_(gen['analysis_sd']).add_(target)
      out.analysis[var] = analysis
  return out


def pool_in(make, n: int, device, dtype=None) -> list:
  """``[make(j) for j in range(n)]``, the pool chunks. With a ``dtype``
  (the control's), each chunk is made in float32 and handed back to the
  device in that type before the next is made, so that its float32 arrays
  are freed."""
  if dtype is None:
    return [make(j) for j in range(n)]
  out = []
  for j in range(n):
    pc = make(j)
    out.append(PoolChunk(*({v: t.to(dtype) for v, t in side.items()}
                           for side in (pc.forecast, pc.target, pc.analysis))))
    del pc
    if torch.device(device).type == 'cuda':
      torch.cuda.empty_cache()
  return out


def make_pool(config: dict, traffic: dict, seed: int, device,
              dtype=None) -> list:
  """The cell's ``traffic['pool']`` distinct chunks (``pool_in``)."""
  return pool_in(lambda j: make_chunk(config, traffic, seed, j, device),
                 traffic['pool'], device, dtype)


def resources(config: dict, traffic: dict, seed: int, device) -> dict:
  """No resources: the ensemble scorings read no climatology and no
  land-sea mask."""
  del config, traffic, seed, device
  return {}


def chunk_key(config: dict, traffic: dict, c: int, pool: int) -> int:
  """A chunk's statistics depend on its pool chunk alone."""
  del config, traffic
  return c % pool


def handover(config: dict, traffic: dict, pool_chunk: PoolChunk, c: int,
             target_kind: str, mask) -> tuple:
  """Chunk ``c`` of a run as fresh (predictions, targets) ``DimArray``s over
  ``pool_chunk``'s tensors (no copy), its init times its own: inits
  ``c * init_times ...`` steps of ``init_step_hours`` from 2020-01-01.
  ``target_kind`` picks the deterministic target or the analysis
  ensemble; ``mask`` is the validity mask, a bool tensor on the device."""
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  chunk = traffic['chunk']
  lat, lon = grid(config)
  ni = chunk['init_times']
  inits = FIRST_INIT + ((c * ni + np.arange(ni)) * config['init_step_hours']
                        ).astype('timedelta64[h]')
  coords = {
      'init_time': inits.astype('datetime64[ns]'),
      'lead_time': lead_hours(config, chunk).astype('timedelta64[h]').astype(
          'timedelta64[ns]'),
      'latitude': lat, 'longitude': lon,
      'mask': Coord(('latitude', 'longitude'), mask),
  }

  def ensemble(data):
    return DimArray(data, (ENSEMBLE_DIM,) + DIMS,
                    dict(coords, number=np.arange(data.shape[0])))
  preds = {v: ensemble(x) for v, x in pool_chunk.forecast.items()}
  if target_kind == 'deterministic':
    tgts = {v: DimArray(y, DIMS, dict(coords))
            for v, y in pool_chunk.target.items()}
  elif target_kind == 'analysis_ensemble':
    tgts = {v: ensemble(a) for v, a in pool_chunk.analysis.items()}
  else:
    raise ValueError(f'unknown target kind {target_kind!r}')
  return preds, tgts
