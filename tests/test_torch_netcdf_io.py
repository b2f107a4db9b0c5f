"""The port's netCDF reader and writer against the JAX package's, on the
CPU.

netCDF3 files written by either package (through scipy) have the same
bytes and read in the other to the same arrays and coords; netCDF4/HDF5
files laid out as netCDF4 and xarray write them (made here with h5py, as
the JAX suite makes its fixtures) read through the port's own HDF5 reader
(``hdf5_mini``) to what the JAX package reads; AggregationStates
round-trip; the writers refuse what netCDF3 cannot hold.
"""

import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import hdf5_mini as j_hdf5_mini
from weatherbenchx_tpu import netcdf_io as j_netcdf_io
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import hdf5_mini
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import netcdf_io

torch.set_num_threads(1)

h5py = pytest.importorskip('h5py')


def _dataset(mod):
  rng = np.random.default_rng(0)
  coords = {
      'init_time': np.array(['2020-01-01', '2020-01-02', '2020-01-03'],
                            dtype='datetime64[ns]'),
      'lead_time': (np.arange(3) * np.timedelta64(6, 'h')).astype(
          'timedelta64[ns]'),
      'latitude': np.linspace(-80, 80, 5),
      'longitude': np.linspace(0, 315, 8),
  }
  x = rng.standard_normal((3, 3, 5, 8)).astype(np.float32)
  x[1, 2, 3, 4] = np.nan
  return {
      'rmse.z500': mod.DimArray(
          x, ('init_time', 'lead_time', 'latitude', 'longitude'), coords),
      'seeps.precip': mod.DimArray(
          np.array([1.5, 2.5]), ('region',),
          {'region': np.array(['global', 'tropics']),
           'threshold': mod.Coord((), np.float64(0.5))}),
      'mask': mod.DimArray(np.array([1, 0, 1], np.int32), ('x',),
                           {'x': np.arange(3, dtype=np.int64)}),
  }


def _host(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == tuple(want[k].dims), k
    gv, wv = _host(got[k].data), _host(want[k].data)
    assert gv.dtype == wv.dtype, k
    np.testing.assert_array_equal(gv, wv, err_msg=k)
    assert sorted(got[k].coords) == sorted(want[k].coords), k
    for name, c in want[k].coords.items():
      assert got[k].coords[name].dims == tuple(c.dims), (k, name)
      np.testing.assert_array_equal(_host(got[k].coords[name].values),
                                    _host(c.values), err_msg=f'{k}.{name}')


def test_netcdf3_is_byte_identical_and_reads_both_ways(tmp_path):
  port, jax_ = str(tmp_path / 'port.nc'), str(tmp_path / 'jax.nc')
  netcdf_io.save_dataset_netcdf(port, _dataset(darray))
  j_netcdf_io.save_dataset_netcdf(jax_, _dataset(j_darray))
  with open(port, 'rb') as a, open(jax_, 'rb') as b:
    assert a.read() == b.read()
  want = j_netcdf_io.load_dataset_netcdf(jax_)
  _assert_same(netcdf_io.load_dataset_netcdf(jax_), want)
  _assert_same(j_netcdf_io.load_dataset_netcdf(port), want)
  assert netcdf_io.dumps_dataset_netcdf(_dataset(darray)) == (
      j_netcdf_io.dumps_dataset_netcdf(_dataset(j_darray)))
  got = netcdf_io.loads_dataset_netcdf(netcdf_io.dumps_dataset_netcdf(
      _dataset(darray)))
  _assert_same(got, want)
  # Found by its magic bytes, whatever the suffix.
  os.rename(port, str(tmp_path / 'renamed.dat'))
  _assert_same(io.load_dataset(str(tmp_path / 'renamed.dat')), want)


def _write_netcdf4_style(path):
  """An HDF5 file laid out as netCDF4/xarray write one: dimension scales,
  DIMENSION_LIST, CF time units, a bare dimension, a fill value."""
  t = np.array([0., 6., 12.])  # hours since 2020-01-01
  vals = np.arange(12, dtype=np.float32).reshape(3, 4)
  vals[1, 2] = -9999.0
  with h5py.File(path, 'w') as f:
    time = f.create_dataset('time', data=t)
    time.attrs['CLASS'] = np.bytes_('DIMENSION_SCALE')
    time.attrs['NAME'] = np.bytes_('time')
    time.attrs['units'] = np.bytes_('hours since 2020-01-01')
    time.attrs['calendar'] = np.bytes_('proleptic_gregorian')
    st = f.create_dataset('station', data=np.zeros(4))
    st.attrs['CLASS'] = np.bytes_('DIMENSION_SCALE')
    st.attrs['NAME'] = np.bytes_(
        'This is a netCDF dimension but not a netCDF variable.')
    v = f.create_dataset('t2m', data=vals, chunks=(2, 2), compression='gzip',
                         shuffle=True, fillvalue=-9999.0)
    v.attrs['_FillValue'] = np.float32(-9999.0)
    v.dims[0].attach_scale(time)
    v.dims[1].attach_scale(st)
    s = f.create_dataset('counts', data=np.arange(4, dtype=np.int16))
    s.dims[0].attach_scale(st)
  return t, vals


@pytest.mark.parametrize('source', ['path', 'bytes'])
def test_netcdf4_reads_as_the_jax_package_reads_it(tmp_path, source):
  path = str(tmp_path / 'ref.nc')
  t, vals = _write_netcdf4_style(path)
  if source == 'path':
    got = io.load_dataset(path)
  else:
    with open(path, 'rb') as f:
      got = netcdf_io.loads_dataset_netcdf(f.read())
  want = j_netcdf_io.load_dataset_netcdf(path)
  _assert_same(got, want)
  da = got['t2m']
  assert da.dims == ('time', 'station')
  assert np.isnan(da.values[1, 2])
  np.testing.assert_array_equal(
      da.coords['time'].values,
      np.datetime64('2020-01-01', 'ns') + (t * 3600e9).astype(
          'timedelta64[ns]'))


def test_hdf5_mini_reads_what_the_jax_copy_reads(tmp_path):
  path = str(tmp_path / 'ref.nc')
  _write_netcdf4_style(path)
  with open(path, 'rb') as f:
    data = f.read()
  got, want = hdf5_mini.read_flat(data), j_hdf5_mini.read_flat(data)
  assert sorted(got) == sorted(want)
  for name in want:
    np.testing.assert_array_equal(got[name].data, want[name].data)
  with pytest.raises(ValueError):
    hdf5_mini.read_flat(b'not an hdf5 file at all')


def test_aggregation_state_round_trips_through_netcdf(tmp_path):
  rng = np.random.default_rng(1)
  lead = np.array([0, 6], dtype='timedelta64[h]').astype('timedelta64[ns]')
  coords = {'lead_time': lead, 'region': np.array(['global', 'tropics'])}

  def state(mod):
    leaf = lambda: mod.DimArray(rng.random((2, 2)), ('lead_time', 'region'),
                                coords)
    return mod.AggregationState({'SquaredError': {'t2m': leaf()}},
                                {'SquaredError': {'t2m': leaf()}})

  port = state(aggregation)
  port.save(str(tmp_path / 'state.nc'))
  loaded = aggregation.AggregationState.load(str(tmp_path / 'state.nc'))
  j_loaded = j_aggregation.AggregationState.load(str(tmp_path / 'state.nc'))
  for k, da in port.to_dataset().items():
    np.testing.assert_array_equal(loaded.to_dataset()[k].values, da.values)
    np.testing.assert_array_equal(
        np.asarray(j_loaded.to_dataset()[k].values), da.values)


def test_writer_refusals_match_jax(tmp_path):
  for mod, nc, name in ((darray, netcdf_io, 'p'), (j_darray, j_netcdf_io,
                                                   'j')):
    big = {'big': mod.DimArray(np.array([2**60], np.int64), ('y',))}
    with pytest.raises(ValueError, match='2\\^53'):
      nc.save_dataset_netcdf(str(tmp_path / f'{name}1.nc'), big)
    clash = {'a': mod.DimArray(np.zeros(2, np.float32), ('x',),
                               {'x': np.arange(2)}),
             'b': mod.DimArray(np.zeros(2, np.float32), ('x',),
                               {'x': np.arange(2) + 1})}
    with pytest.raises(ValueError, match='differs between variables'):
      nc.save_dataset_netcdf(str(tmp_path / f'{name}2.nc'), clash)
  with pytest.raises(ValueError, match='not a netCDF file'):
    netcdf_io.loads_dataset_netcdf(b'plain bytes')
  with pytest.raises(ValueError, match='not a netCDF file'):
    path = str(tmp_path / 'plain.nc')
    with open(path, 'wb') as f:
      f.write(b'plain bytes')
    netcdf_io.load_dataset_netcdf(path)
