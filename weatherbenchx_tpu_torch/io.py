"""Dataset (de)serialization: the ``.npz`` and ``.wbx`` containers, and the
dispatch to zarr and netCDF.

The port of ``weatherbenchx_tpu/io.py:24-370``, byte for byte the same
formats in both directions:

* ``.npz``: every data and coord array plus a JSON structure record under
  ``__meta__``; datetime64, timedelta64 and string coords round-trip
  exactly;
* ``.wbx``: the block container (raw 4096-aligned blocks and a JSON
  manifest), written and read by the native parallel blockstore where it
  builds (``native/``), else by plain file I/O, the same bytes either way;
* ``.zarr`` directories (``zarr_io``) and ``.nc`` files (``netcdf_io``).

``open_dataset`` and ``open_dataset_auto`` open stores LAZILY: coordinates
are read, data stays on disk as ``lazy.LazyArray`` views, and each chunk's
compute step reads its window alone. Data is read into CPU tensors; tensors
are written from wherever they live (bfloat16, which numpy lacks, is
written widened to float32). The JAX package's xarray-backed paths (GRIB,
remote netCDF, ``to_xarray_dataset``) need xarray, which the port's
machines lack: they raise ImportError, as the JAX package does without it.
"""

import io as _pyio
import json
import os
from typing import Hashable, Mapping

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import Coord, DimArray

Dataset = Mapping[Hashable, DimArray]

_NETCDF_LIKE = ('.nc', '.nc4', '.h5', '.grib', '.grib2')


def _host(values) -> np.ndarray:
  if isinstance(values, torch.Tensor):
    values = values.detach().cpu()
    if values.dtype == torch.bfloat16:
      values = values.float()
    return values.numpy()
  return np.asarray(values)


def _collect(dataset: Dataset) -> tuple[dict, dict[str, np.ndarray]]:
  """Structure record + flat key→array map, shared by both containers."""
  arrays: dict[str, np.ndarray] = {}
  meta: dict = {'version': 1, 'variables': {}}
  for i, (var, da) in enumerate(dataset.items()):
    key = f'v{i}'
    meta['variables'][str(var)] = {
        'key': key,
        'dims': list(da.dims),
        'coords': {
            str(name): {'key': f'{key}.c{j}', 'dims': list(c.dims)}
            for j, (name, c) in enumerate(da.coords.items())
        },
    }
    arrays[key] = _host(da.data)
    for j, c in enumerate(da.coords.values()):
      arrays[f'{key}.c{j}'] = _host(c.values)
  return meta, arrays


def _assemble(meta: dict, get) -> dict[str, DimArray]:
  out: dict[str, DimArray] = {}
  for var, spec in meta['variables'].items():
    coords = {
        name: Coord(tuple(cspec['dims']), get(cspec['key']))
        for name, cspec in spec['coords'].items()
    }
    out[var] = DimArray(get(spec['key']), tuple(spec['dims']), coords)
  return out


def _savez(file, dataset: Dataset) -> None:
  meta, arrays = _collect(dataset)
  arrays['__meta__'] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
  np.savez(file, **arrays)


def save_dataset(path: str, dataset: Dataset) -> None:
  """Writes a dict[var, DimArray] dataset, the container by suffix:
  ``.wbx`` the block container, ``.zarr`` a zarr v2 store, ``.nc``
  netCDF3; anything else the portable .npz container."""
  if path.endswith('.wbx'):
    save_dataset_wbx(path, dataset)
  elif path.rstrip('/').endswith('.zarr'):
    from weatherbenchx_tpu_torch import zarr_io
    zarr_io.save_dataset_zarr(path.rstrip('/'), dataset)
  elif path.endswith('.nc'):
    from weatherbenchx_tpu_torch import netcdf_io
    netcdf_io.save_dataset_netcdf(path, dataset)
  else:
    with open(path, 'wb') as f:
      _savez(f, dataset)


def dumps_dataset(dataset: Dataset) -> bytes:
  """Serializes a dataset to portable .npz bytes (in memory)."""
  buf = _pyio.BytesIO()
  _savez(buf, dataset)
  return buf.getvalue()


def loads_dataset(data: bytes) -> dict[str, DimArray]:
  """Inverse of dumps_dataset; also parses .wbx container bytes (a remote
  ``.wbx`` is fetched whole)."""
  if data[:8] == _WBX_MAGIC:
    manifest_offset = int(np.frombuffer(data[8:16], np.uint64)[0])
    manifest = json.loads(data[manifest_offset:].decode())

    def get(key):
      b = manifest['blocks'][key]
      n = int(np.prod(b['shape'], dtype=np.int64))
      arr = np.frombuffer(data, _block_dtype(b['dtype'], key, '.wbx bytes'),
                          count=n, offset=b['offset'])
      return arr.reshape(tuple(b['shape'])).copy()  # writable

    return _assemble(manifest, get)
  with np.load(_pyio.BytesIO(data), allow_pickle=False) as npz:
    meta = json.loads(bytes(npz['__meta__']).decode())
    return _assemble(meta, lambda key: npz[key])


def _looks_like_zarr(path: str) -> bool:
  """A directory is a zarr store if it carries store or array metadata."""
  if any(os.path.exists(os.path.join(path, f))
         for f in ('.zmetadata', '.zgroup', 'zarr.json')):
    return True
  try:
    entries = os.listdir(path)
  except OSError:
    return False
  return any(os.path.exists(os.path.join(path, e, '.zarray'))
             for e in entries)


def load_dataset(path: str) -> dict[str, DimArray]:
  """Reads a dataset whole: a zarr store, ``.wbx``, netCDF (by suffix or
  magic bytes) or ``.npz``, written by either package."""
  if path.rstrip('/').endswith('.zarr') or os.path.isdir(path):
    if os.path.isdir(path) and not _looks_like_zarr(path):
      raise ValueError(
          f'{path!r} is a directory but not a zarr store (no '
          '.zmetadata/.zgroup/zarr.json or */.zarray inside)')
    from weatherbenchx_tpu_torch import zarr_io
    ds = zarr_io.open_dataset_zarr(path.rstrip('/'))
    return {k: v.copy(data=v.data) for k, v in ds.items()}
  if path.endswith('.wbx') or _is_wbx(path):
    return load_dataset_wbx(path)
  if path.endswith('.nc') or _is_netcdf(path):
    from weatherbenchx_tpu_torch import netcdf_io
    return netcdf_io.load_dataset_netcdf(path)
  with np.load(path, allow_pickle=False) as npz:
    meta = json.loads(bytes(npz['__meta__']).decode())
    return _assemble(meta, lambda key: npz[key])


# ---------------------------------------------------------------------------
# .wbx block container
#
# Layout: | magic (8B) | u64 manifest_offset | 4096-aligned raw blocks ... |
#         | manifest JSON |
# The manifest records each block's offset/nbytes/dtype/shape plus the
# dataset structure. Reads/writes go through the native parallel blockstore
# when it builds, else plain Python file I/O; the format is identical
# either way.
# ---------------------------------------------------------------------------

_WBX_MAGIC = b'WBXBLK01'
_ALIGN = 4096


def _is_wbx(path: str) -> bool:
  try:
    with open(path, 'rb') as f:
      return f.read(8) == _WBX_MAGIC
  except OSError:
    return False


def is_netcdf_bytes(data: bytes) -> bool:
  """True for netCDF3 (CDF-1/2/5) or netCDF4/HDF5 leading bytes: the one
  magic check that path- and bytes-level dispatchers both go through."""
  return data[:3] == b'CDF' or data[:8] == b'\x89HDF\r\n\x1a\n'


def _is_netcdf(path: str) -> bool:
  try:
    with open(path, 'rb') as f:
      return is_netcdf_bytes(f.read(8))
  except OSError:
    return False


def _block_dtype(dtype, key: str, path: str) -> np.dtype:
  """A .wbx block's dtype; object arrays are refused: their bytes are the
  objects' addresses in the writing process, which another process would
  read as objects and crash on."""
  dtype = np.dtype(dtype)
  if dtype.hasobject:
    raise ValueError(f'{path}: block {key!r} is an object array; the .wbx '
                     'container stores numeric, bool and string arrays only')
  return dtype


def save_dataset_wbx(path: str, dataset: Dataset, threads: int = 8) -> None:
  from weatherbenchx_tpu_torch import native

  meta, arrays = _collect(dataset)
  blocks: dict = {}
  offset = _ALIGN  # first block after the (padded) header
  buffers, offsets = [], []
  for key, arr in arrays.items():
    _block_dtype(arr.dtype, key, path)
    if not arr.flags.c_contiguous:
      # (conditional: ascontiguousarray would promote 0-d arrays to 1-d)
      arr = np.ascontiguousarray(arr).reshape(arr.shape)
    blocks[key] = {
        'offset': offset,
        'nbytes': int(arr.nbytes),
        'dtype': arr.dtype.str,
        'shape': list(arr.shape),
    }
    buffers.append(arr)
    offsets.append(offset)
    offset += -(-max(arr.nbytes, 1) // _ALIGN) * _ALIGN
  manifest = json.dumps({**meta, 'blocks': blocks}).encode()

  with open(path, 'wb') as f:
    f.write(_WBX_MAGIC)
    f.write(np.uint64(offset).tobytes())
    f.truncate(offset)
    f.seek(offset)
    f.write(manifest)
  if buffers and native.blockstore_available():
    native.pwrite_blocks(path, buffers, offsets, threads=threads)
  else:
    with open(path, 'r+b') as f:
      for arr, off in zip(buffers, offsets):
        f.seek(off)
        f.write(arr.tobytes())


def _read_wbx_manifest(path: str) -> dict:
  with open(path, 'rb') as f:
    if f.read(8) != _WBX_MAGIC:
      raise ValueError(f'{path} is not a .wbx container')
    manifest_offset = int(np.frombuffer(f.read(8), np.uint64)[0])
    f.seek(manifest_offset)
    return json.loads(f.read().decode())


def load_dataset_wbx(path: str, threads: int = 8) -> dict[str, DimArray]:
  from weatherbenchx_tpu_torch import native

  manifest = _read_wbx_manifest(path)
  blocks = manifest['blocks']
  buffers = {
      key: np.empty(tuple(b['shape']), dtype=_block_dtype(b['dtype'], key,
                                                          path))
      for key, b in blocks.items()
  }
  nonempty = [k for k in blocks if buffers[k].nbytes > 0]
  if nonempty and native.blockstore_available():
    native.pread_blocks(
        path, [buffers[k] for k in nonempty],
        [blocks[k]['offset'] for k in nonempty], threads=threads)
  else:
    with open(path, 'rb') as f:
      for k in nonempty:
        f.seek(blocks[k]['offset'])
        # readinto the preallocated buffer: writable, and one copy fewer.
        got = f.readinto(buffers[k].reshape(-1).view(np.uint8))
        if got != buffers[k].nbytes:
          raise ValueError(
              f'{path}: block {k!r} truncated '
              f'({got} of {buffers[k].nbytes} bytes)')
  return _assemble(manifest, lambda key: buffers[key])


def open_dataset(path: str) -> dict[str, DimArray]:
  """Opens a dataset LAZILY: coords read, variable data as windowed views.

  The streaming analog of :func:`load_dataset`, the reference's lazy Zarr
  open + per-chunk ``.compute()`` (``data_loaders/base.py:146-153``).
  Selections on the returned DimArrays compose index metadata; the
  per-chunk compute step in ``data/base.py`` reads only the selected window
  from disk (threaded positional reads for ``.wbx`` blocks and uncompressed
  ``.npz`` members; compressed members load whole). Bounded memory
  regardless of store size.
  """
  from weatherbenchx_tpu_torch import lazy

  if path.rstrip('/').endswith('.zarr') or os.path.isdir(path):
    from weatherbenchx_tpu_torch import zarr_io
    return zarr_io.open_dataset_zarr(path.rstrip('/'))

  def is_coord(key: str) -> bool:
    return '.c' in key  # f'{var key}.c{j}', as _collect names them

  if path.endswith('.wbx') or _is_wbx(path):
    manifest = _read_wbx_manifest(path)

    def get(key):
      b = manifest['blocks'][key]
      view = lazy.LazyArray(lazy.BlockSource(
          path, b['offset'], b['shape'], _block_dtype(b['dtype'], key, path)))
      # Coordinates are read now: they are small, and selection needs them.
      return view.read() if is_coord(key) else view

    return _assemble(manifest, get)
  sources = lazy.locate_npz_members(path)
  with np.load(path, allow_pickle=False) as npz:
    meta = json.loads(bytes(npz['__meta__']).decode())

    def get(key):
      src = sources.get(key)
      if src is None:  # compressed or Fortran-ordered: read whole
        return npz[key] if is_coord(key) else lazy.LazyArray(
            lazy.EagerSource(npz[key]))
      view = lazy.LazyArray(src)
      return view.read() if is_coord(key) else view

    return _assemble(meta, get)


def open_dataset_auto(path: str) -> dict[str, DimArray]:
  """Opens a store lazily by extension and protocol.

  The one place that decides how a store path opens (the data loaders and
  the CLIs go through it), with the JAX package's rules as they run where
  xarray is not installed:

  * local ``.npz`` / ``.wbx`` → windowed views (``open_dataset``);
  * remote ``.npz`` / ``.wbx`` → one whole-object fetch;
  * ``.zarr`` (local or fsspec URL), or any remote URL that is not a
    netCDF/HDF/GRIB file → the self-contained zarr reader, lazily;
  * local netCDF (``.nc``, ``.nc4``, ``.h5``, or netCDF magic bytes) → the
    self-contained netCDF reader, whole;
  * anything else (GRIB, remote netCDF) needs xarray: ImportError.
  """
  from weatherbenchx_tpu_torch import fileio  # fileio imports this module

  stripped = path.rstrip('/')
  remote = fileio.is_remote(path)
  if stripped.endswith(('.npz', '.wbx')):
    return fileio.load_dataset_any(path) if remote else open_dataset(path)
  netcdf_like = stripped.endswith(_NETCDF_LIKE)
  if stripped.endswith('.zarr') or (remote and not netcdf_like):
    from weatherbenchx_tpu_torch import zarr_io
    return zarr_io.open_dataset_zarr(stripped)
  if not remote and (stripped.endswith(('.nc', '.nc4', '.h5'))
                     or _is_netcdf(path)):
    from weatherbenchx_tpu_torch import netcdf_io
    return netcdf_io.load_dataset_netcdf(path)
  raise ImportError(
      f'opening {path!r} needs xarray (GRIB/remote netCDF), which is '
      'not installed; .npz/.wbx/.zarr/.nc open self-contained')
