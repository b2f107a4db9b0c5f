"""Generates the ``/tmp/demo`` fixtures for the canonical month drive.

The port of ``tools/gen_demo_fixtures.py``: the same construction from the
same numpy random stream, drawn in the same order, so the files hold the
same arrays. Construction (64x32 grid, January 2020, 12 h inits, 40 6-h
leads):
  target(valid)      = clim(doy, hour) + z_common(valid) + z_t(valid)
  prediction(i, l)   = clim(doy, hour) + z_common(i + l) + z_p(i, l)
with all z ~ N(0,1) iid. Then analytically:
  RMSE = sqrt(E[(z_p - z_t)^2]) = sqrt(2)
  ACC  = corr(z_c + z_p, z_c + z_t) = 1/2
Variables: geopotential (levels 500/700/850) and 2m_temperature, ECMWF
dim names (time / prediction_timedelta / latitude / longitude / level), so
the benchmark CLI's renaming path is exercised. The draws are made on the
host; the fields are assembled (climatology gathers and float32 sums, each
rounded as numpy rounds it) on ``--device``.

Usage:
  python -m weatherbenchx_tpu_torch.tools.gen_demo_fixtures [outdir]
      [--device cpu]
"""

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.apps import run_evaluation
from weatherbenchx_tpu_torch.darray import DimArray

N_INIT, N_LEAD = 62, 40
NLAT, NLON = 32, 64


def make_fixtures(device: torch.device | str) -> dict[str, dict]:
  """{'hres', 'era5', 'clim'}: the three datasets, arrays on ``device``."""
  rng = np.random.default_rng(20200101)

  lats = np.linspace(-90, 90, NLAT)
  lons = np.linspace(0, 360, NLON, endpoint=False)
  levels = np.array([500, 700, 850])

  init = (np.datetime64('2020-01-01', 'ns')
          + np.arange(N_INIT) * np.timedelta64(12, 'h'))
  lead = (np.arange(N_LEAD) * np.timedelta64(6, 'h')
          ).astype('timedelta64[ns]')
  valid = (np.datetime64('2020-01-01', 'ns')
           + np.arange(2 * N_INIT + N_LEAD) * np.timedelta64(6, 'h'))

  def field(shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)

  # Climatology keyed (dayofyear, hour).
  doy = np.arange(1, 367)
  hours = np.array([0, 6, 12, 18])
  clim_t2m = field((366, 4, NLAT, NLON))
  clim_z = field((366, 4, len(levels), NLAT, NLON))

  def clim_at(times, arr):
    d = ((times.astype('datetime64[D]')
          - times.astype('datetime64[Y]')).astype(int))
    h = (times.astype('datetime64[h]').astype(int)) % 24
    return arr[torch.from_numpy(d), torch.from_numpy(h // 6)]

  zc_t2m = field((len(valid), NLAT, NLON))
  zc_z = field((len(valid), len(levels), NLAT, NLON))

  tgt = {
      '2m_temperature': DimArray(
          clim_at(valid, clim_t2m) + zc_t2m
          + field((len(valid), NLAT, NLON)),
          ('time', 'latitude', 'longitude'),
          {'time': valid, 'latitude': lats, 'longitude': lons}),
      'geopotential': DimArray(
          clim_at(valid, clim_z) + zc_z
          + field((len(valid), len(levels), NLAT, NLON)),
          ('time', 'level', 'latitude', 'longitude'),
          {'time': valid, 'level': levels, 'latitude': lats,
           'longitude': lons}),
  }

  vt = init[:, None] + lead[None, :]
  flat = vt.reshape(-1)
  pos = torch.from_numpy(np.searchsorted(valid, flat).reshape(vt.shape))
  pred = {
      '2m_temperature': DimArray(
          clim_at(flat, clim_t2m).reshape(N_INIT, N_LEAD, NLAT, NLON)
          + zc_t2m[pos] + field((N_INIT, N_LEAD, NLAT, NLON)),
          ('time', 'prediction_timedelta', 'latitude', 'longitude'),
          {'time': init, 'prediction_timedelta': lead,
           'latitude': lats, 'longitude': lons}),
      'geopotential': DimArray(
          clim_at(flat, clim_z).reshape(
              N_INIT, N_LEAD, len(levels), NLAT, NLON)
          + zc_z[pos] + field((N_INIT, N_LEAD, len(levels), NLAT, NLON)),
          ('time', 'prediction_timedelta', 'level', 'latitude',
           'longitude'),
          {'time': init, 'prediction_timedelta': lead, 'level': levels,
           'latitude': lats, 'longitude': lons}),
  }

  clim = {
      '2m_temperature': DimArray(
          clim_t2m, ('dayofyear', 'hour', 'latitude', 'longitude'),
          {'dayofyear': doy, 'hour': hours, 'latitude': lats,
           'longitude': lons}),
      'geopotential': DimArray(
          clim_z, ('dayofyear', 'hour', 'level', 'latitude', 'longitude'),
          {'dayofyear': doy, 'hour': hours, 'level': levels,
           'latitude': lats, 'longitude': lons}),
  }
  return {'hres': pred, 'era5': tgt, 'clim': clim}


def main(argv: Optional[Sequence[str]] = None) -> dict[str, str]:
  """Writes ``<outdir>/{hres,era5,clim}.npz``; returns their paths."""
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('outdir', nargs='?', default='/tmp/demo')
  p.add_argument('--device', default='cuda',
                 help="where the fields are assembled: 'cuda' (the default; "
                      "raises without a GPU) or 'cpu'")
  args = p.parse_args(argv)
  device = run_evaluation.resolve_device(args.device)
  os.makedirs(args.outdir, exist_ok=True)
  paths = {}
  for name, ds in make_fixtures(device).items():
    paths[name] = os.path.join(args.outdir, f'{name}.npz')
    io_lib.save_dataset(paths[name], ds)
  print(f'wrote {args.outdir}/{{hres,era5,clim}}.npz')
  return paths


if __name__ == '__main__':
  main()
