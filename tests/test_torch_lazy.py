"""The port's lazy windowed reads against eager reads and the JAX package's
``LazyArray``, on the CPU.

Stores open without reading their data; selections (int, slice, array
indexers, composed) compose on the view; materialising reads only the
selected window, through the native pread where it builds; the loaders'
chunks from a lazily opened store equal those of the in-memory store.
"""

import json

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu import lazy as j_lazy
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import lazy
from weatherbenchx_tpu_torch import native
from weatherbenchx_tpu_torch.data import loaders

torch.set_num_threads(1)


def _store(mod, path, n_time=64, n_lat=9, n_lon=12, seed=3):
  rng = np.random.default_rng(seed)
  t = (np.datetime64('2020-01-01', 'ns')
       + np.arange(n_time) * np.timedelta64(6, 'h'))
  ds = {'t2m': mod.DimArray(
      rng.standard_normal((n_time, n_lat, n_lon)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': t, 'latitude': np.linspace(90, -90, n_lat),
       'longitude': np.linspace(0, 360, n_lon, endpoint=False)})}
  mod_io = io if mod is darray else j_io
  mod_io.save_dataset(path, ds)
  return ds, t


def _random_chain(rng, shape):
  """1-3 indexers (int, slice or array) applied one axis at a time."""
  keys = []
  shape = list(shape)
  for _ in range(int(rng.integers(1, 4))):
    if not shape:
      break
    ax = int(rng.integers(0, len(shape)))
    n = shape[ax]
    kind = rng.integers(0, 4)
    if kind == 0:
      lo = int(rng.integers(0, n))
      idx = slice(lo, int(rng.integers(lo, n + 1)))
      shape[ax] = len(range(n)[idx])
    elif kind == 1:
      idx = rng.integers(-n, n, size=int(rng.integers(1, n + 1)))
      shape[ax] = len(idx)
    elif kind == 2:
      idx = slice(None, None, -int(rng.integers(1, 3)))
      shape[ax] = len(range(n)[idx])
    else:
      idx = int(rng.integers(0, n))
      del shape[ax]
    keys.append((slice(None),) * ax + (idx,))
  return keys


@pytest.mark.parametrize('ext', ['npz', 'wbx'])
def test_random_index_chains_match_numpy_and_jax(tmp_path, ext):
  path = str(tmp_path / f's.{ext}')
  ds, _ = _store(darray, path)
  full = ds['t2m'].values
  view = io.open_dataset(path)['t2m']._data
  j_view = j_io.open_dataset(path)['t2m'].data
  assert isinstance(view.source, lazy.BlockSource)
  rng = np.random.default_rng(7)
  for _ in range(40):
    got, j_got, want = view, j_view, full
    for key in _random_chain(rng, full.shape):
      got, j_got, want = got[key], j_got[key], want[key]
    assert got.shape == want.shape == j_got.shape
    np.testing.assert_array_equal(got.read(), want)
    np.testing.assert_array_equal(got.read(), np.asarray(j_got))


def test_compressed_npz_members_load_whole(tmp_path):
  path = str(tmp_path / 'c.npz')
  arr = np.arange(24, dtype=np.float32).reshape(4, 6)
  meta, arrays = io._collect({'x': darray.DimArray(
      arr, ('a', 'b'), {'a': np.arange(4), 'b': np.arange(6)})})
  arrays['__meta__'] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
  np.savez_compressed(path, **arrays)
  opened = io.open_dataset(path)['x']
  assert isinstance(opened._data.source, lazy.EagerSource)
  np.testing.assert_array_equal(opened.isel(a=slice(1, 3)).values, arr[1:3])
  assert lazy.locate_npz_members(path).keys() == j_lazy.locate_npz_members(
      path).keys()


@pytest.mark.parametrize('ext', ['npz', 'wbx'])
def test_dim_array_selections_compose_without_reading(tmp_path, ext,
                                                      monkeypatch):
  path = str(tmp_path / f's.{ext}')
  ds, t = _store(darray, path)
  opened = io.open_dataset(path)['t2m']
  read = []
  orig = lazy.BlockSource.read
  monkeypatch.setattr(lazy.BlockSource, 'read',
                      lambda self, idx: read.append(idx) or orig(self, idx))
  window = (opened.sel(valid_time=t[[5, 9, 7]])
            .isel(latitude=slice(2, 7), longitude=np.array([0, 11, 3]))
            .sel(latitude=slice(60, -30)).isel(valid_time=1))
  assert window.is_lazy and not read
  assert window.dims == ('latitude', 'longitude') and window.shape == (4, 3)
  assert window.dtype == torch.float32 and window.device.type == 'cpu'
  want = (ds['t2m'].sel(valid_time=t[[5, 9, 7]])
          .isel(latitude=slice(2, 7), longitude=np.array([0, 11, 3]))
          .sel(latitude=slice(60, -30)).isel(valid_time=1))
  np.testing.assert_array_equal(window.values, want.values)
  assert len(read) == 1
  # Anything else materialises once, into a CPU tensor the array keeps.
  data = window.data
  assert isinstance(data, torch.Tensor) and not window.is_lazy
  assert window.data is data and len(read) == 1


@pytest.mark.parametrize('ext', ['npz', 'wbx'])
def test_targets_loader_reads_only_the_chunks_window(tmp_path, ext,
                                                     monkeypatch):
  """8 inits x 2 leads on a 64-time store: the gather reads the 16 rows it
  takes, not 64; the chunk equals the in-memory store's and the JAX
  loader's."""
  path = str(tmp_path / f's.{ext}')
  ds, t = _store(darray, path)
  loader = loaders.TargetsFromDataset(path=path, rename_dimensions=None)
  loader.maybe_prepare_dataset()  # coords are read here
  counted = []
  orig = lazy.BlockSource._pread_runs
  monkeypatch.setattr(
      lazy.BlockSource, '_pread_runs',
      lambda self, runs, flat, itemsize: counted.append(
          sum(n for _, _, n in runs) * itemsize) or orig(
              self, runs, flat, itemsize))
  native.reset_call_counts()
  leads = np.array([0, 6], 'timedelta64[h]').astype('timedelta64[ns]')
  chunk = loader.load_chunk(t[:8], leads)['t2m']
  assert sum(counted) == 16 * ds['t2m'].values[0].nbytes
  assert native.CALLS['pread_blocks'] == 1  # 16 rows in 9 coalesced runs
  assert isinstance(chunk.data, torch.Tensor) and not chunk.is_lazy
  assert chunk.data.is_contiguous()
  want = loaders.TargetsFromDataset(ds=ds, rename_dimensions=None).load_chunk(
      t[:8], leads)['t2m']
  torch.testing.assert_close(chunk.data, want.data, rtol=0, atol=0)
  j_store, _ = _store(j_darray, str(tmp_path / f'j.{ext}'))
  from weatherbenchx_tpu.data import loaders as j_loaders
  j_chunk = j_loaders.TargetsFromDataset(
      path=str(tmp_path / f'j.{ext}'), rename_dimensions=None).load_chunk(
          t[:8], leads)['t2m']
  np.testing.assert_array_equal(chunk.values, np.asarray(j_chunk.data))


def test_the_python_read_path_equals_the_native_one(tmp_path, monkeypatch):
  path = str(tmp_path / 's.wbx')
  ds, t = _store(darray, path)
  sel = {'valid_time': np.array([40, 3, 17]), 'longitude': slice(2, 9)}
  fast = io.open_dataset(path)['t2m'].isel(sel).values
  monkeypatch.setattr(native, 'blockstore_available', lambda: False)
  native.reset_call_counts()
  slow = io.open_dataset(path)['t2m'].isel(sel).values
  assert native.CALLS['pread_blocks'] == 0
  np.testing.assert_array_equal(fast, slow)
  np.testing.assert_array_equal(fast, ds['t2m'].isel(sel).values)
  # The .wbx container without the native blockstore: the same file bytes.
  io.save_dataset(str(tmp_path / 'python.wbx'), ds)
  with open(path, 'rb') as a, open(tmp_path / 'python.wbx', 'rb') as b:
    assert a.read() == b.read()
  got = io.load_dataset(str(tmp_path / 'python.wbx'))['t2m']
  np.testing.assert_array_equal(got.values, ds['t2m'].values)


# -- A descending latitude (a store's north-to-south grid sorted ascending)
# -- composes to a negative-step slice that the sources write in place.

_CONTAINERS = {'wbx': {}, 'npz': {},
               'zarr2': {'zarr_format': 2, 'compressor': 'blosc'},
               'zarr3': {'zarr_format': 3, 'compressor': 'zstd'}}


def _flip_store(tmp_path, container: str):
  """(path, store): 6 inits x 2 leads x 9 descending latitudes x 12,
  zarr in cells of 4 inits x 4 latitudes (a flip that crosses cells)."""
  rng = np.random.default_rng(11)
  ds = {'t2m': darray.DimArray(
      rng.standard_normal((6, 2, 9, 12)).astype(np.float32),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': (np.datetime64('2020-01-01', 'ns')
                     + np.arange(6) * np.timedelta64(6, 'h')),
       'lead_time': np.arange(2) * np.timedelta64(6, 'h'),
       'latitude': np.linspace(90, -90, 9),
       'longitude': np.linspace(0, 360, 12, endpoint=False)})}
  if container.startswith('zarr'):
    from weatherbenchx_tpu_torch import zarr_io
    path = str(tmp_path / f's.{container}.zarr')
    zarr_io.save_dataset_zarr(path, ds, chunks={'init_time': 4,
                                                'latitude': 4},
                              **_CONTAINERS[container])
  else:
    path = str(tmp_path / f's.{container}')
    io.save_dataset(path, ds)
  return path, ds


@pytest.mark.parametrize('container', sorted(_CONTAINERS))
@pytest.mark.parametrize('select', [
    {}, {'init_time': slice(1, 5)}, {'init_time': np.array([4, 0, 4])},
    {'latitude': slice(2, 8)}, {'latitude': slice(7, 0, -2)},
    {'longitude': slice(None, None, -1), 'init_time': 3}])
def test_descending_latitude_reads_as_the_jax_package_does(
    tmp_path, container, select):
  path, ds = _flip_store(tmp_path, container)
  got = io.open_dataset_auto(path)['t2m'].sortby('latitude')
  assert got.is_lazy
  assert got._data._index[2] == slice(8, None, -1)
  got = got.isel(select)
  assert got.is_lazy
  want = j_io.open_dataset_auto(path)['t2m'].sortby('latitude').isel(select)
  values = got.values
  np.testing.assert_array_equal(values, np.asarray(want.data))
  np.testing.assert_array_equal(
      values, ds['t2m'].sortby('latitude').isel(select).values)
  assert values.flags.c_contiguous


@pytest.mark.parametrize('cur,new,n,step', [
    (slice(None), np.arange(9)[::-1], 9, -1),
    (slice(None), np.array([7, 5, 3, 1]), 9, -2),
    (slice(2, 8), np.array([5, 4, 3, 2, 1, 0]), 9, -1),
    (slice(8, None, -1), np.arange(9)[::-1], 9, 1),
    (slice(8, None, -1), np.array([1, 2, 3]), 9, -1),
    (np.array([3, 8, 1]), np.array([2, 0]), 9, 2),
])
def test_compose_one_gives_a_slice_for_an_evenly_spaced_range(cur, new, n,
                                                             step):
  got = lazy._compose_one(cur, new, n)
  assert isinstance(got, slice) and got.step == step
  np.testing.assert_array_equal(np.arange(n)[got],
                                np.arange(n)[cur][new])


def test_compose_one_keeps_an_uneven_index_an_array():
  got = lazy._compose_one(slice(None), np.array([5, 3, 0]), 9)
  np.testing.assert_array_equal(got, [5, 3, 0])


@pytest.mark.parametrize('container', ['wbx', 'zarr2'])
def test_a_flipped_read_makes_no_copy_of_its_own(tmp_path, container,
                                                 monkeypatch):
  """The source writes the flip into the array it returns (the block
  source flips in place, the zarr source scatters cell slices into its
  output with a negative step), and LazyArray.read returns that array."""
  path, ds = _flip_store(tmp_path, container)
  view = io.open_dataset_auto(path)['t2m'].sortby('latitude')._data
  returned = []
  source_cls = type(view.source)
  orig = source_cls.read
  monkeypatch.setattr(source_cls, 'read', lambda self, idx: returned.append(
      orig(self, idx)) or returned[-1])
  if container.startswith('zarr'):
    plans = view.source._axis_plan(slice(8, None, -1), 9, 4)
    assert all(isinstance(src, slice) and isinstance(dst, slice)
               for _, src, dst in plans)
  out = view.read()
  assert out is returned[0] and out.flags.c_contiguous
  np.testing.assert_array_equal(out, ds['t2m'].values[:, :, ::-1])


@pytest.mark.parametrize('container', ['zarr2', 'zarr3'])
@pytest.mark.parametrize('inits,whole', [
    (slice(0, 4), True), (slice(4, 8), True), (slice(2, 6), False),
    (np.array([3, 2, 1, 0]), True), (np.array([0, 2, 1, 3]), False)])
def test_a_whole_cell_window_decodes_into_the_output(tmp_path, container,
                                                     inits, whole,
                                                     monkeypatch):
  """A window that is one whole cell, latitudes flipped, is decoded into
  the array returned (the month's chunk: one cell of 4 inits x every
  member); any other window goes through a staging block."""
  from weatherbenchx_tpu_torch import zarr_io
  rng = np.random.default_rng(5)
  ds = {'t': darray.DimArray(
      rng.standard_normal((5, 8, 1, 7, 6)).astype(np.float32),
      ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(5), 'init_time': np.arange(8),
       'lead_time': np.arange(1), 'latitude': np.linspace(90, -90, 7),
       'longitude': np.arange(6.0)})}
  path = str(tmp_path / 's.zarr')
  zarr_io.save_dataset_zarr(path, ds, chunks={'init_time': 4, 'number': 5},
                            **_CONTAINERS[container])
  view = io.open_dataset_auto(path)['t'].sortby('latitude').isel(
      init_time=inits)._data
  given = []
  orig = zarr_io.ZarrChunkSource._load_cells
  monkeypatch.setattr(zarr_io.ZarrChunkSource, '_load_cells',
                      lambda self, cells, blocks=None: given.append(
                          blocks) or orig(self, cells, blocks))
  out = view.read()
  np.testing.assert_array_equal(
      out, ds['t'].values[:, inits][:, :, :, ::-1])
  assert out.flags.c_contiguous
  assert (given == [[out]]) if whole else all(b is None for b in given)
