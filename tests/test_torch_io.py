"""The port's host I/O and bookkeeping against the JAX package, on the CPU.

Every container (``.npz``, ``.wbx``, netCDF, zarr) in both directions, the
same bytes from both packages, the lazy ``open_dataset``, fsspec
``memory://`` round trips (no test here reaches a remote host),
``AggregationState`` save/load, the zero-filled outer join of
``combining_sum``, the atomic file I/O and ``time_chunks``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import fileio as j_fileio
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import fileio
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import time_chunks

torch.set_num_threads(1)


def _dataset(mod, seed=0):
  """Float data with datetime64, timedelta64, string and 2-D coords."""
  rng = np.random.default_rng(seed)
  coords = {
      'init_time': np.array(['2020-01-01T00', '2020-01-01T12'],
                            dtype='datetime64[ns]'),
      'lead_time': np.array([0, 6, 12], dtype='timedelta64[h]').astype(
          'timedelta64[ns]'),
      'region': np.array(['global', 'tropics', 'extra-tropics']),
      'mask': mod.Coord(('lead_time', 'region'), rng.random((3, 3)) > 0.5),
  }
  dims = ('init_time', 'lead_time', 'region')
  return {
      't2m': mod.DimArray(rng.standard_normal((2, 3, 3)).astype(np.float32),
                          dims, coords),
      'count': mod.DimArray(np.arange(18, dtype=np.int64).reshape(2, 3, 3),
                            dims, coords),
      'scalar': mod.DimArray(np.float64(2.5)),
  }


def _host(values) -> np.ndarray:
  if isinstance(values, torch.Tensor):
    return values.numpy()
  return np.asarray(values)


def _assert_datasets_equal(got, want):
  assert list(got) == list(want)
  for k in want:
    assert got[k].dims == want[k].dims, k
    g, w = _host(got[k].data), _host(want[k].data)
    assert g.dtype == w.dtype, k
    np.testing.assert_array_equal(g, w, err_msg=k)
    assert list(got[k].coords) == list(want[k].coords), k
    for name, c in want[k].coords.items():
      gc = got[k].coords[name]
      assert gc.dims == c.dims, (k, name)
      gv, wv = _host(gc.values), _host(c.values)
      assert gv.dtype == wv.dtype, (k, name, gv.dtype, wv.dtype)
      np.testing.assert_array_equal(gv, wv, err_msg=f'{k}.{name}')


def test_npz_round_trip_keeps_time_and_string_coords(tmp_path):
  ds = _dataset(darray)
  path = str(tmp_path / 'ds.npz')
  io.save_dataset(path, ds)
  _assert_datasets_equal(io.load_dataset(path), ds)
  _assert_datasets_equal(io.loads_dataset(io.dumps_dataset(ds)), ds)


def test_npz_written_by_jax_reads_in_the_port(tmp_path):
  path = str(tmp_path / 'jax.npz')
  j_io.save_dataset(path, _dataset(j_darray))
  _assert_datasets_equal(io.load_dataset(path), _dataset(darray))


def test_npz_written_by_the_port_reads_in_jax(tmp_path):
  path = str(tmp_path / 'port.npz')
  io.save_dataset(path, _dataset(darray))
  _assert_datasets_equal(j_io.load_dataset(path), _dataset(j_darray))
  _assert_datasets_equal(
      j_io.loads_dataset(io.dumps_dataset(_dataset(darray))),
      _dataset(j_darray))


def test_bfloat16_is_written_widened():
  da = darray.DimArray(torch.tensor([1.5, -2.25], dtype=torch.bfloat16), 'x')
  got = io.loads_dataset(io.dumps_dataset({'v': da}))['v']
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.values, [1.5, -2.25])


CONTAINERS = ['.npz', '.wbx', '.nc', '.zarr']


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


@pytest.mark.parametrize('suffix', CONTAINERS)
def test_containers_are_byte_identical_and_read_alike(tmp_path, suffix):
  """Both packages write the same bytes (every file of a zarr store), and
  each reads the other's file to the same arrays and coords."""
  port, jax_ = str(tmp_path / f'port{suffix}'), str(tmp_path / f'jax{suffix}')
  io.save_dataset(port, _dataset(darray))
  j_io.save_dataset(jax_, _dataset(j_darray))
  assert _files(port) == _files(jax_)
  want = j_io.load_dataset(jax_)
  _assert_datasets_equal(io.load_dataset(jax_), want)
  _assert_datasets_equal(j_io.load_dataset(port), want)
  if suffix in ('.npz', '.wbx'):  # lossless for every dtype here
    _assert_datasets_equal(io.load_dataset(port), _dataset(darray))


@pytest.mark.parametrize('suffix', ['.npz', '.wbx'])
def test_open_dataset_is_lazy_and_reads_windows(tmp_path, suffix):
  path = str(tmp_path / f'ds{suffix}')
  io.save_dataset(path, _dataset(darray))
  opened = io.open_dataset(path)
  j_opened = j_io.open_dataset(path)
  t2m = opened['t2m']
  assert t2m.is_lazy and t2m.shape == (2, 3, 3) and t2m.dtype == torch.float32
  assert not any(c.values.__class__.__name__ == 'LazyArray'
                 for c in t2m.coords.values())
  window = t2m.isel(init_time=1).sel(region=['tropics', 'global'])
  assert window.is_lazy and window.shape == (3, 2)
  want = j_opened['t2m'].isel(init_time=1).sel(region=['tropics', 'global'])
  np.testing.assert_array_equal(window.values, np.asarray(want.data))
  taken = t2m.take('lead_time', np.array([[2, 0], [1, 1]]), ('a', 'b'))
  assert not taken.is_lazy and taken.dims == ('init_time', 'a', 'b', 'region')
  np.testing.assert_array_equal(
      taken.values, np.asarray(j_opened['t2m'].take(
          'lead_time', np.array([[2, 0], [1, 1]]), ('a', 'b')).data))
  _assert_datasets_equal(
      {k: v.copy(data=v.data) for k, v in opened.items()}, _dataset(darray))


@pytest.mark.parametrize('suffix', CONTAINERS)
def test_remote_round_trips_through_fsspec_memory(tmp_path, suffix):
  """A memory:// URL (fsspec, in this process) for each container; the
  JAX package reads the port's object to the same dataset."""
  url = f'memory://{tmp_path.name}/ds{suffix}'
  fileio.save_dataset_atomic(url, _dataset(darray))
  assert fileio.exists(url)
  got = fileio.load_dataset_any(url)
  _assert_datasets_equal(got, j_fileio.load_dataset_any(url))
  if suffix in ('.npz', '.wbx'):  # remote .wbx is the npz container's bytes
    _assert_datasets_equal(got, _dataset(darray))
  if suffix == '.nc':  # remote netCDF opens through xarray alone
    with pytest.raises(ImportError, match='xarray'):
      io.open_dataset_auto(url)
  else:
    assert sorted(io.open_dataset_auto(url)) == sorted(got)


def test_remote_bytes_and_directories_through_fsspec_memory(tmp_path):
  root = f'memory://{tmp_path.name}'
  fileio.makedirs(f'{root}/d')
  fileio.write_text_atomic(f'{root}/d/m.json', '{"a": 1}')
  fileio.write_bytes(f'{root}/d/b.bin', bytes(range(10)))
  assert fileio.read_text(f'{root}/d/m.json') == '{"a": 1}'
  assert fileio.read_byte_range(f'{root}/d/b.bin', 3, 4) == bytes([3, 4, 5, 6])
  assert fileio.read_byte_range(f'{root}/d/b.bin', -2, 2) == bytes([8, 9])
  assert fileio.listdir(f'{root}/d') == j_fileio.listdir(f'{root}/d') == [
      'b.bin', 'm.json']
  assert fileio.isdir(f'{root}/d') and not fileio.isdir(f'{root}/d/b.bin')
  assert fileio.is_remote(root) and not fileio.is_remote('file:///tmp/x.npz')


def test_optional_packages_load_only_where_they_are_used():
  """Importing every I/O module imports none of scipy, pyarrow, fsspec."""
  code = ('import sys\n'
          'from weatherbenchx_tpu_torch import io, fileio, zarr_io, '
          'netcdf_io, codecs, lazy, native, hdf5_mini, cf\n'
          'from weatherbenchx_tpu_torch.data import loaders\n'
          'from weatherbenchx_tpu_torch.apps import run_benchmark_evaluation\n'
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('scipy', 'pyarrow', 'fsspec', 'h5py', 'xarray'))\n"
          'assert not bad, bad\n')
  proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                        text=True, timeout=120, check=False,
                        cwd=os.path.dirname(os.path.dirname(__file__)))
  assert proc.returncode == 0, proc.stderr[-2000:]


def _state(mod, seed, lead_hours=(0, 6)):
  rng = np.random.default_rng(seed)
  lead = np.array(lead_hours, dtype='timedelta64[h]').astype(
      'timedelta64[ns]')
  coords = {'lead_time': lead, 'region': np.array(['global', 'tropics'])}
  def leaf():
    return mod.DimArray(rng.random((len(lead), 2)), ('lead_time', 'region'),
                        coords)
  return mod.AggregationState({'SquaredError': {'t2m': leaf()}},
                              {'SquaredError': {'t2m': leaf()}})


def test_aggregation_state_save_load(tmp_path):
  state = _state(aggregation, 0)
  path = str(tmp_path / 'state.npz')
  state.save(path)
  loaded = aggregation.AggregationState.load(path)
  _assert_datasets_equal(loaded.to_dataset(), state.to_dataset())
  # A state saved by the JAX package loads in the port.
  j_path = str(tmp_path / 'jax_state.npz')
  _state(j_aggregation, 0).save(j_path)
  _assert_datasets_equal(aggregation.AggregationState.load(j_path).to_dataset(),
                         state.to_dataset())


@pytest.mark.parametrize('leads', [
    ((0, 6), (12, 18)),          # disjoint: concatenation
    ((0, 6, 12), (6, 12, 18)),   # overlapping
    ((6, 0), (12,)),             # unsorted, ragged
])
def test_outer_join_combining_sum_matches_jax(leads):
  states = [_state(aggregation, s, l) for s, l in enumerate(leads)]
  j_states = [_state(j_aggregation, s, l) for s, l in enumerate(leads)]
  got = aggregation.AggregationState.sum(states)
  want = j_aggregation.AggregationState.sum(j_states)
  _assert_datasets_equal(got.to_dataset(), want.to_dataset())
  union = np.unique(np.concatenate(
      [np.array(l, dtype='timedelta64[h]') for l in leads]))
  assert len(got.sum_weights['SquaredError']['t2m'].coords['lead_time']
             .values) == len(union)


def test_combining_sum_of_host_float64_stays_float64():
  a = darray.DimArray(np.array([0.1, 0.2]), 'x', {'x': [0, 1]})
  got = aggregation.combining_sum([a, a, a])
  assert got.dtype == torch.float64 and got.device.type == 'cpu'
  np.testing.assert_array_equal(got.values, a.values + a.values + a.values)


def test_outer_join_needs_coords_on_ragged_dims():
  a = darray.DimArray(np.ones(2), 'x')
  b = darray.DimArray(np.ones(3), 'x')
  with pytest.raises(ValueError, match='without coordinates'):
    aggregation.combining_sum([a, b])
  with pytest.raises(ValueError, match='different dims'):
    aggregation.combining_sum([a, darray.DimArray(np.ones(2), 'y')])


def test_atomic_writes_leave_no_temporaries(tmp_path):
  path = str(tmp_path / 'out.npz')
  fileio.save_dataset_atomic(path, _dataset(darray))
  fileio.write_text_atomic(str(tmp_path / 'm.json'), '{"a": 1}')
  assert sorted(os.listdir(tmp_path)) == ['m.json', 'out.npz']
  assert fileio.read_text(str(tmp_path / 'm.json')) == '{"a": 1}'
  assert fileio.exists(path)
  _assert_datasets_equal(fileio.load_dataset_any(path), _dataset(darray))


def _init_times():
  return np.arange('2020-01-01T00', '2020-01-02T00', np.timedelta64(6, 'h'),
                   dtype='datetime64[h]')


LEADS = np.arange(0, 18, 6, dtype='timedelta64[h]')
SLICE = slice(np.timedelta64(0, 'h'), np.timedelta64(6, 'h'))


@pytest.mark.parametrize('lead_times,init_chunk,lead_chunk', [
    (LEADS, 2, 2), (LEADS, None, None), (LEADS, 3, 1), (LEADS, 1, None),
    (SLICE, 2, None), (SLICE, None, None)])
def test_time_chunks_enumerate_as_jax(lead_times, init_chunk, lead_chunk):
  got = time_chunks.TimeChunks(_init_times(), lead_times, init_chunk,
                               lead_chunk)
  want = j_time_chunks.TimeChunks(_init_times(), lead_times, init_chunk,
                                  lead_chunk)
  assert len(got) == len(want)
  for (go, (gi, gl)), (wo, (wi, wl)) in zip(got.iter_with_chunk_offsets(),
                                            want.iter_with_chunk_offsets()):
    assert (go.init_time, go.lead_time) == (wo.init_time, wo.lead_time)
    assert gi.dtype == wi.dtype == np.dtype('datetime64[ns]')
    np.testing.assert_array_equal(gi, wi)
    if isinstance(wl, slice):
      assert gl == wl
    else:
      assert gl.dtype == wl.dtype == np.dtype('timedelta64[ns]')
      np.testing.assert_array_equal(gl, wl)
  with pytest.raises(IndexError):
    got[len(got)]


@pytest.mark.parametrize('lead_times,kwargs', [
    (SLICE, {'lead_time_chunk_size': 2}),
    (slice(None, np.timedelta64(6, 'h')), {}),
    (slice(np.timedelta64(0, 'h'), np.timedelta64(6, 'h'),
           np.timedelta64(1, 'h')), {}),
    (LEADS, {'init_time_chunk_size': -1}),
    (LEADS, {'init_time_chunk_size': 0}),
    (list(LEADS), {}),
])
def test_time_chunks_reject_what_jax_rejects(lead_times, kwargs):
  with pytest.raises(ValueError):
    j_time_chunks.TimeChunks(_init_times(), lead_times, **kwargs)
  with pytest.raises(ValueError):
    time_chunks.TimeChunks(_init_times(), lead_times, **kwargs)
