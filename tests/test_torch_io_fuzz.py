"""Randomized round trips of the port's storage stack, against the JAX
package's.

The random datasets of ``test_io_fuzz.py`` (same seeds: mixed dtypes, NaNs,
non-dim string coords, ragged chunks, every compressor) are written by the
port through each container (npz, ``.wbx``, zarr v2, netCDF3) and by the
JAX package through the same one. Both writers give the same bytes; each
package reads the port's file back to the dataset, within each format's
documented losses (netCDF3 widens out-of-int32 int64 to float64 and
stores bool as int8); and the port reads the JAX package's file alike.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu import netcdf_io as j_netcdf_io
from weatherbenchx_tpu import zarr_io as j_zarr_io
from weatherbenchx_tpu_torch import darray, io, netcdf_io, zarr_io

DIM_POOL = ('time', 'level', 'latitude', 'longitude')
SIZES = {'time': 5, 'level': 3, 'latitude': 7, 'longitude': 9}


def _rand_dataset(rng, mod):
  n_vars = int(rng.integers(1, 4))
  ds = {}
  for v in range(n_vars):
    dims = tuple(d for d in DIM_POOL if rng.random() < 0.7) or ('latitude',)
    shape = tuple(SIZES[d] for d in dims)
    kind = rng.choice(['f4', 'f8', 'i4', 'i8', 'bool'])
    if kind == 'bool':
      data = rng.random(shape) > 0.5
    elif kind.startswith('i'):
      data = rng.integers(-1000, 1000, shape).astype(np.dtype(kind))
    else:
      data = rng.standard_normal(shape).astype(np.dtype(kind))
      if rng.random() < 0.4:
        flat = data.reshape(-1)
        flat[rng.integers(0, flat.size)] = np.nan
    coords = {}
    for d in dims:
      if d == 'time':
        coords[d] = (np.datetime64('2021-06-01', 'ns')
                     + np.arange(SIZES[d]) * np.timedelta64(12, 'h'))
      elif rng.random() < 0.7:
        coords[d] = np.linspace(-5, 5, SIZES[d])
    if len(dims) >= 2 and rng.random() < 0.3:
      coords[f'station_name{v}'] = mod.Coord(
          dims[:1], np.array([f's{i}' for i in range(shape[0])]))
    ds[f'var{v}'] = mod.DimArray(data, dims, coords)
  return ds


def _host(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, lossy_int64=False):
  assert set(got) == set(want)
  for name, w in want.items():
    g = got[name]
    assert tuple(g.dims) == tuple(w.dims), (name, g.dims, w.dims)
    gv, wv = _host(g.values), _host(w.values)
    if wv.dtype == bool and gv.dtype != bool:
      gv = gv.astype(bool)  # netCDF3 stores bool as int8 (documented)
    if wv.dtype.kind in 'iu' and gv.dtype.kind == 'f':
      assert lossy_int64, (name, wv.dtype, gv.dtype)
      gv = gv.astype(wv.dtype)
    if wv.dtype.kind == 'f':
      np.testing.assert_allclose(gv, wv, rtol=0, atol=0, equal_nan=True,
                                 err_msg=name)
    else:
      np.testing.assert_array_equal(gv, wv, err_msg=name)
    for cname, c in w.coords.items():
      assert g.coords.get(cname) is not None, (name, cname)
      gc, wc = _host(g.coords[cname].values), _host(c.values)
      if wc.dtype.kind == 'U' or gc.dtype.kind in 'SU':
        np.testing.assert_array_equal(gc.astype(str), wc.astype(str),
                                      err_msg=f'{name}:{cname}')
      else:
        np.testing.assert_array_equal(gc, wc, err_msg=f'{name}:{cname}')


def _files(path: str) -> dict:
  """{name relative to path: bytes} of a file, or of every file under a
  directory."""
  if not os.path.isdir(path):
    with open(path, 'rb') as f:
      return {'': f.read()}
  out = {}
  for root, _, names in os.walk(path):
    for name in names:
      full = os.path.join(root, name)
      with open(full, 'rb') as f:
        out[os.path.relpath(full, path)] = f.read()
  return out


def _both_ways(tmp_path, suffix, save, j_save, load, j_load, ds, j_ds,
               lossy_int64=False):
  port, jax_ = str(tmp_path / f'port{suffix}'), str(tmp_path / f'jax{suffix}')
  save(port, ds)
  j_save(jax_, j_ds)
  assert _files(port) == _files(jax_), suffix
  _assert_same(load(port), ds, lossy_int64)
  _assert_same(j_load(port), ds, lossy_int64)
  _assert_same(load(jax_), ds, lossy_int64)


@pytest.mark.parametrize('seed', range(20))
def test_roundtrip_all_backends_both_packages(seed, tmp_path):
  # Two generators of one seed draw the same dataset into each package.
  rng, j_rng = (np.random.default_rng(8800 + seed) for _ in range(2))
  ds, j_ds = _rand_dataset(rng, darray), _rand_dataset(j_rng, j_darray)

  _both_ways(tmp_path, '.npz', io.save_dataset, j_io.save_dataset,
             io.load_dataset, j_io.load_dataset, ds, j_ds)
  _both_ways(tmp_path, '.wbx', io.save_dataset_wbx, j_io.save_dataset_wbx,
             io.load_dataset_wbx, j_io.load_dataset_wbx, ds, j_ds)

  compressor = str(rng.choice(['none', 'zlib', 'blosc']))
  chunk_dim = str(rng.choice(DIM_POOL))
  chunks = {chunk_dim: int(rng.integers(1, SIZES[chunk_dim] + 1))}
  kw = dict(chunks=chunks,
            compressor=None if compressor == 'none' else compressor)
  _both_ways(tmp_path, '.zarr',
             lambda p, d: zarr_io.save_dataset_zarr(p, d, **kw),
             lambda p, d: j_zarr_io.save_dataset_zarr(p, d, **kw),
             zarr_io.open_dataset_zarr, j_zarr_io.open_dataset_zarr, ds, j_ds)

  with warnings.catch_warnings():
    warnings.simplefilter('ignore', UserWarning)  # documented widenings
    _both_ways(tmp_path, '.nc', netcdf_io.save_dataset_netcdf,
               j_netcdf_io.save_dataset_netcdf, netcdf_io.load_dataset_netcdf,
               j_netcdf_io.load_dataset_netcdf, ds, j_ds, lossy_int64=True)
