"""The port's zarr v2/v3 reader and writer against the JAX package's, on the
CPU.

Stores written by either package have the same bytes (every metadata
document and every cell, for one codec and level) and read in the other
to the same arrays and coords; v3 stores hand-written from the spec (the
JAX test suite's recipe, encoded by the JAX package's codecs) read alike in
both, sharded ones with the index at either end, missing pieces and a
crc32c that does not match; windows read only the cells they touch,
through the native codec, whose reads equal the Python path's.
"""

import json
import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import codecs as j_codecs
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import zarr_io as j_zarr_io
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import native
from weatherbenchx_tpu_torch import zarr_io

torch.set_num_threads(1)


def _dataset(mod, seed=0, strings=True):
  """(time, level, lat, lon) float32 with datetime, int, float coords, a
  2-D non-dim coord, and (v2 only) a string coord and a 0-d variable."""
  rng = np.random.default_rng(seed)
  coords = {
      'time': np.arange('2020-01-01T00', '2020-01-03T00',
                        np.timedelta64(6, 'h'), dtype='datetime64[ns]'),
      'level': np.array([500, 700, 850]),
      'latitude': np.linspace(90, -90, 7),
      'longitude': np.arange(10) * 36.0,
      'land': mod.Coord(('latitude', 'longitude'), rng.random((7, 10)) > 0.5),
  }
  dims = ('time', 'level', 'latitude', 'longitude')
  x = rng.standard_normal((8, 3, 7, 10)).astype(np.float32)
  x[2, 1, 3, 4] = np.nan
  out = {'t': mod.DimArray(x, dims, coords),
         'lead': mod.DimArray(np.arange(8) * 6.0, ('time',),
                              {'time': coords['time']})}
  if strings:
    out['name'] = mod.DimArray(np.arange(3, dtype=np.int32), ('region',),
                               {'region': np.array(['a', 'bb', 'ccc'])})
    out['scalar'] = mod.DimArray(np.float64(2.5))
  return out


def _files(root: str) -> dict:
  out = {}
  for base, _, names in os.walk(root):
    for name in names:
      full = os.path.join(base, name)
      with open(full, 'rb') as f:
        out[os.path.relpath(full, root)] = f.read()
  return out


def _host(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got: dict, want: dict):
  """Same variables, dims, coords and values (NaN where NaN)."""
  assert sorted(got) == sorted(want)
  for k in want:
    g, w = got[k], want[k]
    assert g.dims == tuple(w.dims), k
    gv, wv = _host(g.data), _host(w.data)
    # The port's tensors hold native byte order (a big-endian v3 store).
    assert gv.dtype == wv.dtype.newbyteorder('='), k
    np.testing.assert_array_equal(gv, wv, err_msg=k)
    assert sorted(g.coords) == sorted(w.coords), k
    for name, c in w.coords.items():
      assert g.coords[name].dims == c.dims, (k, name)
      np.testing.assert_array_equal(_host(g.coords[name].values),
                                    _host(c.values), err_msg=f'{k}.{name}')


# (format, compressor, chunks, shards) of the writers' cases.
WRITE_CASES = {
    'v2_raw': (2, None, {'time': 3}, None),
    'v2_zlib': (2, 'zlib', {'time': 3, 'level': 2}, None),
    'v2_gzip': (2, 'gzip', {'time': 3}, None),
    'v2_zstd': (2, 'zstd', {'time': 1, 'level': 1}, None),
    'v2_blosc_field_cells': (2, 'blosc', {'time': 1, 'level': 1}, None),
    'v3_raw': (3, None, {'time': 3}, None),
    'v3_blosc': (3, 'blosc', {'time': 3, 'latitude': 4}, None),
    'v3_gzip': (3, 'gzip', {'time': 3}, None),
    'v3_sharded_zstd': (3, 'zstd', {'time': 1, 'level': 1}, {'time': 4}),
    'v3_sharded_blosc_ragged': (3, 'blosc', {'time': 3, 'latitude': 2},
                                {'time': 5, 'latitude': 4}),
}


@pytest.mark.parametrize('case', list(WRITE_CASES))
def test_stores_are_byte_identical_and_read_both_ways(tmp_path, case):
  fmt, comp, chunks, shards = WRITE_CASES[case]
  kwargs = dict(chunks=chunks, compressor=comp, zarr_format=fmt,
                shards=shards)
  port, jax_ = str(tmp_path / 'port.zarr'), str(tmp_path / 'jax.zarr')
  zarr_io.save_dataset_zarr(port, _dataset(darray, strings=fmt == 2),
                            **kwargs)
  j_zarr_io.save_dataset_zarr(jax_, _dataset(j_darray, strings=fmt == 2),
                              **kwargs)
  got_files, want_files = _files(port), _files(jax_)
  assert sorted(got_files) == sorted(want_files)
  for name, data in want_files.items():
    if comp == 'gzip' and not name.endswith(('.zarray', '.zattrs', 'json',
                                             '.zgroup', '.zmetadata')):
      continue  # the gzip member header can differ by writer; decode below
    assert got_files[name] == data, name
  want = {k: v.copy(data=np.asarray(v.data))
          for k, v in j_zarr_io.open_dataset_zarr(jax_).items()}
  port_reads_jax = zarr_io.open_dataset_zarr(jax_)
  assert port_reads_jax['t'].is_lazy
  _assert_same(port_reads_jax, want)
  _assert_same({k: v.copy(data=np.asarray(v.data))
                for k, v in j_zarr_io.open_dataset_zarr(port).items()}, want)
  _assert_same(zarr_io.open_dataset_zarr(port), want)


WINDOWS = [
    {'time': slice(2, 7), 'level': 1},
    {'time': np.array([6, 0, 3]), 'latitude': slice(1, 6, 2)},
    {'latitude': slice(None, None, -1), 'longitude': np.array([9, 0])},
    {'time': 5, 'level': slice(0, 3), 'latitude': 3, 'longitude': 7},
]


@pytest.mark.parametrize('case', ['v2_blosc_field_cells', 'v3_sharded_zstd',
                                  'v3_sharded_blosc_ragged'])
@pytest.mark.parametrize('window', range(len(WINDOWS)))
def test_lazy_windows_match_eager_reads_and_jax(tmp_path, case, window):
  fmt, comp, chunks, shards = WRITE_CASES[case]
  root = str(tmp_path / 's.zarr')
  zarr_io.save_dataset_zarr(root, _dataset(darray, strings=False),
                            chunks=chunks, compressor=comp, zarr_format=fmt,
                            shards=shards)
  eager = _dataset(darray, strings=False)['t']
  lazy_t = zarr_io.open_dataset_zarr(root)['t']
  j_t = j_zarr_io.open_dataset_zarr(root)['t']
  indexers = WINDOWS[window]
  got = lazy_t.isel(indexers)
  assert got.is_lazy
  want = eager.isel(indexers)
  assert got.dims == want.dims and got.shape == want.shape
  np.testing.assert_array_equal(got.values, want.values)
  np.testing.assert_array_equal(
      got.values, np.asarray(np.asarray(j_t.isel(indexers).data)))
  # sel and take on the view; take reads only the gathered rows.
  lat = eager.coord_values('latitude')[[4, 1]]
  np.testing.assert_array_equal(lazy_t.sel(latitude=lat).values,
                                eager.sel(latitude=lat).values)
  idx = np.array([[7, 1], [2, 2]])
  np.testing.assert_array_equal(
      lazy_t.take('time', idx, ('a', 'b')).values,
      eager.take('time', idx, ('a', 'b')).values)


def test_a_window_reads_only_the_cells_it_touches(tmp_path):
  root = str(tmp_path / 's.zarr')
  zarr_io.save_dataset_zarr(root, _dataset(darray, strings=False),
                            chunks={'time': 1, 'level': 1},
                            compressor='blosc')
  t = zarr_io.open_dataset_zarr(root)['t']
  source = t._data.source
  read = []
  load_cells = source._load_cells
  source._load_cells = lambda cells: read.append(list(cells)) or load_cells(
      cells)
  window = t.isel(time=slice(2, 4), level=1)
  assert not read  # composing reads nothing
  window.values
  assert read == [[(2, 1, 0, 0), (3, 1, 0, 0)]]


@pytest.mark.parametrize('case', ['v2_zstd', 'v3_sharded_zstd'])
def test_native_reads_equal_the_python_path(tmp_path, case, monkeypatch):
  fmt, comp, chunks, shards = WRITE_CASES[case]
  root = str(tmp_path / 's.zarr')
  zarr_io.save_dataset_zarr(root, _dataset(darray, strings=False),
                            chunks=chunks, compressor=comp, zarr_format=fmt,
                            shards=shards)
  native.reset_call_counts()
  fast = zarr_io.open_dataset_zarr(root)['t'].values
  calls = dict(native.CALLS)
  assert calls['decode_ranges' if shards else 'decode_cells'] > 0
  monkeypatch.setattr(native, 'zarrcodec_available', lambda: False)
  native.reset_call_counts()
  slow = zarr_io.open_dataset_zarr(root)['t'].values
  assert native.CALLS['decode_cells'] == native.CALLS['decode_ranges'] == 0
  np.testing.assert_array_equal(fast, slow)


def test_python_fallback_writes_the_same_store(tmp_path, monkeypatch):
  kwargs = dict(chunks={'time': 1, 'level': 1}, compressor='zstd',
                zarr_format=3, shards={'time': 4})
  zarr_io.save_dataset_zarr(str(tmp_path / 'native.zarr'),
                            _dataset(darray, strings=False), **kwargs)
  monkeypatch.setattr(native, 'zarrcodec_available', lambda: False)
  native.reset_call_counts()
  zarr_io.save_dataset_zarr(str(tmp_path / 'python.zarr'),
                            _dataset(darray, strings=False), **kwargs)
  assert native.CALLS['encode_buffers'] == native.CALLS['encode_cells'] == 0
  assert _files(str(tmp_path / 'native.zarr')) == _files(
      str(tmp_path / 'python.zarr'))


# -- v3 stores written from the spec ---------------------------------------------


def _write_v3_store(root, arrays, *, codec=None, key_encoding='default',
                    separator=None, endian='little', shards=None,
                    index_location='end', skip_inner=(), corrupt_index=False):
  """A spec-conformant zarr v3 store written by hand with the JAX
  package's codecs (``tests/test_zarr_io.py``'s recipe): ``arrays`` maps
  name -> (values, dims, chunks, attrs); ``shards`` switches the
  ``sharding_indexed`` codec on, with its (offset, nbytes) index and
  crc32c at ``index_location``; ``skip_inner`` cells get the missing
  sentinel."""
  os.makedirs(root, exist_ok=True)
  with open(os.path.join(root, 'zarr.json'), 'w') as f:
    json.dump({'zarr_format': 3, 'node_type': 'group', 'attributes': {}}, f)
  sep = separator or ('/' if key_encoding == 'default' else '.')
  for name, (values, dims, chunks, attrs) in arrays.items():
    values = np.asarray(values)
    adir = os.path.join(root, name)
    os.makedirs(adir, exist_ok=True)
    store_dtype = (values.dtype.newbyteorder('>' if endian == 'big' else '<')
                   if values.dtype.itemsize > 1 else values.dtype)
    chain = [{'name': 'bytes', 'configuration': {'endian': endian}}]
    if codec == 'blosc':
      chain.append({'name': 'blosc', 'configuration': {
          'cname': 'lz4', 'clevel': 5, 'shuffle': 'shuffle',
          'typesize': values.dtype.itemsize, 'blocksize': 0}})
    elif codec == 'zstd':
      chain.append({'name': 'zstd', 'configuration': {'level': 3}})
    elif codec == 'gzip':
      chain.append({'name': 'gzip', 'configuration': {'level': 5}})
    sharded = shards is not None and name == 't2m'
    if sharded:
      grid_chunks = list(shards)
      chain = [{'name': 'sharding_indexed', 'configuration': {
          'chunk_shape': list(chunks), 'codecs': chain,
          'index_codecs': [{'name': 'bytes',
                            'configuration': {'endian': 'little'}},
                           {'name': 'crc32c'}],
          'index_location': index_location}}]
    else:
      grid_chunks = list(chunks)
    meta = {
        'zarr_format': 3, 'node_type': 'array', 'shape': list(values.shape),
        'data_type': values.dtype.name,
        'chunk_grid': {'name': 'regular',
                       'configuration': {'chunk_shape': grid_chunks}},
        'chunk_key_encoding': {'name': key_encoding,
                               'configuration': {'separator': sep}},
        'fill_value': 'NaN' if values.dtype.kind == 'f' else 0,
        'codecs': chain, 'attributes': dict(attrs or {}),
        'dimension_names': list(dims)}
    with open(os.path.join(adir, 'zarr.json'), 'w') as f:
      json.dump(meta, f)

    def block_bytes(cell):
      block = values[tuple(slice(i * c, (i + 1) * c)
                           for i, c in zip(cell, chunks))]
      if block.shape != tuple(chunks):  # edge cells store full extent
        full = np.full(chunks, np.nan if values.dtype.kind == 'f' else 0,
                       values.dtype)
        full[tuple(slice(0, s) for s in block.shape)] = block
        block = full
      raw = np.ascontiguousarray(block.astype(store_dtype)).tobytes()
      return j_codecs.encode_cell(raw, codec, values.dtype.itemsize)

    def cell_key(cell):
      if key_encoding == 'default':
        return 'c' + ''.join(f'{sep}{i}' for i in cell) if cell else 'c'
      return sep.join(str(i) for i in cell) if cell else '0'

    def write(cell, blob):
      path = os.path.join(adir, cell_key(cell))
      os.makedirs(os.path.dirname(path), exist_ok=True)
      with open(path, 'wb') as f:
        f.write(blob)

    if not sharded:
      for cell in np.ndindex(*[max(-(-s // c), 1)
                               for s, c in zip(values.shape, chunks)]):
        write(cell, block_bytes(cell))
      continue
    spc = [s // c for s, c in zip(grid_chunks, chunks)]
    base = 16 * int(np.prod(spc)) + 4 if index_location == 'start' else 0
    for shard in np.ndindex(*[max(-(-s // c), 1)
                              for s, c in zip(values.shape, grid_chunks)]):
      entries, payload = [], b''
      for within in np.ndindex(*spc):
        cell = tuple(s * n + w for s, n, w in zip(shard, spc, within))
        if cell in set(skip_inner) or any(
            i * c >= values.shape[d] for d, (i, c) in enumerate(
                zip(cell, chunks))):
          entries.append((2**64 - 1, 2**64 - 1))
          continue
        enc = block_bytes(cell)
        entries.append((base + len(payload), len(enc)))
        payload += enc
      index = np.asarray(entries, '<u8').tobytes()
      index += j_codecs.crc32c(index).to_bytes(4, 'little')
      if corrupt_index:
        index = index[:-1] + bytes([index[-1] ^ 0xFF])
      write(shard, index + payload if index_location == 'start'
            else payload + index)


def _v3_arrays():
  rng = np.random.default_rng(7)
  data = rng.standard_normal((10, 5, 6)).astype(np.float32)
  return data, {
      'valid_time': ((np.arange(10) * 6 * 3600 * 10**9).astype(np.int64),
                     ('valid_time',), [4],
                     {'units': 'nanoseconds since 1970-01-01'}),
      'latitude': (np.linspace(-90, 90, 5), ('latitude',), [5], {}),
      'longitude': (np.linspace(0, 360, 6, endpoint=False), ('longitude',),
                    [6], {}),
      't2m': (data, ('valid_time', 'latitude', 'longitude'), [4, 3, 6], {}),
  }


def _read_both(root):
  got = zarr_io.open_dataset_zarr(root)
  want = {k: v.copy(data=np.asarray(v.data))
          for k, v in j_zarr_io.open_dataset_zarr(root).items()}
  _assert_same(got, want)
  return got['t2m']


@pytest.mark.parametrize('codec', [None, 'blosc', 'zstd', 'gzip'])
@pytest.mark.parametrize('key_encoding', ['default', 'v2'])
def test_spec_written_v3_stores_read_alike(tmp_path, codec, key_encoding):
  data, arrays = _v3_arrays()
  root = str(tmp_path / 'v3.zarr')
  _write_v3_store(root, arrays, codec=codec, key_encoding=key_encoding)
  t2m = _read_both(root)
  np.testing.assert_array_equal(t2m.values, data)
  np.testing.assert_array_equal(
      t2m.isel(valid_time=slice(3, 9), latitude=slice(2, 5)).values,
      data[3:9, 2:5])


def test_spec_written_v3_big_endian_and_dot_keys(tmp_path):
  data, arrays = _v3_arrays()
  _write_v3_store(str(tmp_path / 'be.zarr'), {'t2m': arrays['t2m']},
                  endian='big')
  np.testing.assert_array_equal(
      _read_both(str(tmp_path / 'be.zarr')).values.astype(np.float32), data)
  _write_v3_store(str(tmp_path / 'dot.zarr'), arrays, separator='.')
  np.testing.assert_array_equal(_read_both(str(tmp_path / 'dot.zarr')).values,
                                data)


@pytest.mark.parametrize('codec', [None, 'blosc', 'zstd'])
@pytest.mark.parametrize('index_location', ['end', 'start'])
def test_spec_written_v3_shards_read_alike(tmp_path, codec, index_location):
  data, arrays = _v3_arrays()
  root = str(tmp_path / 'v3shard.zarr')
  _write_v3_store(root, arrays, codec=codec, shards=[8, 3, 12],
                  index_location=index_location)
  t2m = _read_both(root)
  np.testing.assert_array_equal(t2m.values, data)
  np.testing.assert_array_equal(
      t2m.isel(valid_time=slice(3, 9), latitude=slice(2, 5),
               longitude=slice(1, 5)).values, data[3:9, 2:5, 1:5])


def test_spec_written_v3_missing_pieces_fill(tmp_path):
  data, arrays = _v3_arrays()
  root = str(tmp_path / 'fill.zarr')
  _write_v3_store(root, arrays, codec='zstd', shards=[8, 3, 12],
                  skip_inner=[(0, 0, 0)])
  os.remove(os.path.join(root, 't2m', 'c', '1', '0', '0'))
  got = _read_both(root).values
  assert np.isnan(got[:4, :3, :6]).all()  # the sentinel inner cell
  assert np.isnan(got[8:, :3, :]).all()  # the missing shard object
  np.testing.assert_array_equal(got[4:8], data[4:8])
  np.testing.assert_array_equal(got[:8, 3:], data[:8, 3:])


@pytest.mark.parametrize('read_path', ['native', 'python'])
def test_a_shard_index_crc32c_that_does_not_match_raises(tmp_path, read_path,
                                                         monkeypatch):
  _, arrays = _v3_arrays()
  root = str(tmp_path / 'bad.zarr')
  _write_v3_store(root, arrays, codec='zstd', shards=[8, 3, 12],
                  corrupt_index=True)
  if read_path == 'python':
    monkeypatch.setattr(native, 'zarrcodec_available', lambda: False)
  t2m = zarr_io.open_dataset_zarr(root)['t2m']
  with pytest.raises(ValueError, match='crc32c'):
    t2m.values
  with pytest.raises(ValueError, match='crc32c'):
    np.asarray(j_zarr_io.open_dataset_zarr(root)['t2m'].data)


def test_partial_shards_flush_with_the_missing_sentinel(tmp_path):
  root = str(tmp_path / 'partial.zarr')
  x = np.arange(24, dtype=np.float32).reshape(6, 4)
  for mod, path in ((zarr_io, root), (j_zarr_io, root + '.jax')):
    w = mod.ZarrArrayWriter(path, 'x', x.shape, (2, 4), x.dtype, ('a', 'b'),
                            compressor='zstd', zarr_format=3, shards=(4, 4))
    w.write_block((0, 0), x[:2])
    w.write_block((2, 0), x[4:])
    w.close()
  assert _files(root) == _files(root + '.jax')
  source = zarr_io.ZarrChunkSource(
      os.path.join(root, 'x'),
      zarr_io._normalize_v3_array(
          json.load(open(os.path.join(root, 'x', 'zarr.json'))), 'x')[0])
  got = source.read((slice(None), slice(None)))
  np.testing.assert_array_equal(got[:2], x[:2])
  assert np.isnan(got[2:4]).all()
  np.testing.assert_array_equal(got[4:], x[4:])


def test_writer_refusals_match_jax(tmp_path):
  ds = _dataset(darray)
  for kwargs, match in (
      ({'zarr_format': 3}, 'no zarr v3 core data type'),
      ({'zarr_format': 2, 'shards': {'time': 2}}, 'requires zarr_format=3'),
      ({'zarr_format': 3, 'compressor': 'zlib'}, 'cannot be written')):
    for mod, dmod in ((zarr_io, darray), (j_zarr_io, j_darray)):
      data = (_dataset(dmod) if 'compressor' not in kwargs
              else _dataset(dmod, strings=False))
      with pytest.raises(ValueError, match=match):
        mod.save_dataset_zarr(str(tmp_path / f'{mod.__name__}.zarr'), data,
                              **kwargs)


def test_remote_v3_sharded_store_through_fsspec_memory(tmp_path):
  """memory:// goes through fsspec and the Python codecs (the native codec
  reads local files only); the JAX package reads the port's store."""
  url = f'memory://{tmp_path.name}/s.zarr'
  zarr_io.save_dataset_zarr(url, _dataset(darray, strings=False),
                            chunks={'time': 1, 'level': 1},
                            compressor='zstd', zarr_format=3,
                            shards={'time': 4})
  got = zarr_io.open_dataset_zarr(url)
  want = {k: v.copy(data=np.asarray(v.data))
          for k, v in j_zarr_io.open_dataset_zarr(url).items()}
  _assert_same(got, want)
  np.testing.assert_array_equal(
      got['t'].isel(time=slice(3, 6)).values,
      _dataset(darray, strings=False)['t'].isel(time=slice(3, 6)).values)


def test_cf_time_decoding_matches_jax():
  for values, attrs in (
      (np.array([0.0, 0.25, np.nan]), {'units': 'days since 2020-01-01'}),
      (np.array([0, 86400], np.int64), {'units': 'seconds since 1970-01-01'}),
      (np.array([1.5, 3.0]), {'units': 'hours'})):
    got = zarr_io._decode_cf_time(values, attrs)
    want = j_zarr_io._decode_cf_time(values, attrs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view('i8'), want.view('i8'))
  with pytest.raises(OverflowError):
    zarr_io._decode_cf_time(np.array([0, 10**10], np.int64),
                            {'units': 'seconds since 1970-01-01'})
