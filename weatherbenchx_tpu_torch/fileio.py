"""Filesystem-agnostic atomic dataset and bytes I/O.

The port of ``weatherbenchx_tpu/fileio.py``. Local paths use plain os I/O
(keeping the native ``.wbx`` path); URLs with a scheme (``gs://``,
``s3://``, ``memory://``, ...) go through fsspec, imported where it is
used, so a run has somewhere durable to write metrics, aggregation states
and checkpoints. Writes are atomic (a uniquely named temporary, then a
rename or move), so duplicate or straggling writers cannot leave a torn
file, as the reference's ``beam_utils.atomic_write``
(``beam_utils.py:64-101``).

Remote datasets are the portable npz container's bytes, or a zarr store
or netCDF bytes (the ``.wbx`` block layout relies on positional local
reads).
"""

import os
import uuid
from typing import Mapping

from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.darray import DimArray

Dataset = Mapping[str, DimArray]


def is_remote(path: str) -> bool:
  scheme, sep, _ = str(path).partition('://')
  return bool(sep) and scheme not in ('file', 'local')


def _strip_scheme(path: str):
  import fsspec

  fs, _, paths = fsspec.get_fs_token_paths(path)
  return fs, paths[0]


def exists(path: str) -> bool:
  if not is_remote(path):
    return os.path.exists(path)
  fs, p = _strip_scheme(path)
  return fs.exists(p)


def read_bytes(path: str) -> bytes:
  if not is_remote(path):
    with open(path, 'rb') as f:
      return f.read()
  fs, p = _strip_scheme(path)
  with fs.open(p, 'rb') as f:
    return f.read()


def read_byte_range(path: str, offset: int, length: int) -> bytes:
  """Reads ``length`` bytes at ``offset`` (negative = from the file end).

  The building block of zarr v3 sharded stores: the shard index and each
  inner chunk are byte ranges inside one shard object, so a windowed read
  never pulls the whole (possibly GB-sized) shard.
  """
  if not is_remote(path):
    with open(path, 'rb') as f:
      f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
      return f.read(length)
  fs, p = _strip_scheme(path)
  with fs.open(p, 'rb') as f:
    f.seek(offset, 2 if offset < 0 else 0)
    return f.read(length)


def write_bytes(path: str, data: bytes) -> None:
  """Plain (non-atomic) write; any filesystem."""
  if not is_remote(path):
    with open(path, 'wb') as f:
      f.write(data)
    return
  fs, p = _strip_scheme(path)
  with fs.open(p, 'wb') as f:
    f.write(data)


def makedirs(path: str) -> None:
  if not is_remote(path):
    os.makedirs(path, exist_ok=True)
    return
  fs, p = _strip_scheme(path)
  fs.makedirs(p, exist_ok=True)


def listdir(path: str) -> list:
  """Child basenames of a directory; any filesystem."""
  if not is_remote(path):
    return sorted(os.listdir(path))
  fs, p = _strip_scheme(path)
  return sorted(entry.rstrip('/').rsplit('/', 1)[-1]
                for entry in fs.ls(p, detail=False))


def isdir(path: str) -> bool:
  if not is_remote(path):
    return os.path.isdir(path)
  fs, p = _strip_scheme(path)
  return fs.isdir(p)


def _tmp_suffix() -> str:
  # A uuid, not the pid: duplicate writers on different hosts (or in
  # identical containers, where pids collide) each get their own temporary,
  # so one writer's rename cannot take another's.
  return f'.tmp.{uuid.uuid4().hex[:12]}'


def write_bytes_atomic(path: str, data: bytes) -> None:
  """tmp + rename write; concurrent or duplicate writers cannot corrupt."""
  if not is_remote(path):
    tmp = path + _tmp_suffix()
    with open(tmp, 'wb') as f:
      f.write(data)
    os.replace(tmp, path)
    return
  fs, p = _strip_scheme(path)
  tmp = p + _tmp_suffix()
  with fs.open(tmp, 'wb') as f:
    f.write(data)
  # Object stores: mv (server-side copy+delete) overwrites in place on
  # gcs/s3/memory: either the old or the new complete object is visible,
  # never a torn one. Filesystems whose mv refuses to overwrite get one
  # rm+retry (a momentary missing-destination window, duplicate-writer
  # safe because each writer owns a distinct tmp).
  try:
    fs.mv(tmp, p)
  except (OSError, FileExistsError):
    try:
      fs.rm(p)
    except FileNotFoundError:
      pass
    fs.mv(tmp, p)


def save_dataset_atomic(path: str, dataset: Dataset) -> None:
  """Atomic dataset write, any filesystem.

  The container comes from the suffix: ``.zarr`` a zarr store (written in
  place: its per-file writes are atomic enough for a fresh store, and no
  single rename exists for a directory), ``.wbx`` the block container
  (local) and ``.nc`` netCDF3; else the portable npz container, which is
  also what a remote ``.wbx`` path gets.
  """
  if path.rstrip('/').endswith('.zarr'):
    from weatherbenchx_tpu_torch import zarr_io
    zarr_io.save_dataset_zarr(path.rstrip('/'), dataset)
    return
  if is_remote(path):
    if path.endswith('.nc'):
      from weatherbenchx_tpu_torch import netcdf_io
      write_bytes_atomic(path, netcdf_io.dumps_dataset_netcdf(dataset))
      return
    write_bytes_atomic(path, io_lib.dumps_dataset(dataset))
    return
  ext = next((e for e in ('.wbx', '.nc') if path.endswith(e)), '')
  tmp = path + _tmp_suffix() + ext
  io_lib.save_dataset(tmp, dataset)
  os.replace(tmp, path)


def load_dataset_any(path: str) -> dict[str, DimArray]:
  """Reads a dataset whole from a local path or a URL: a remote zarr store
  through fsspec, else the object's bytes by their magic (netCDF, ``.wbx``
  or npz)."""
  if is_remote(path):
    if path.rstrip('/').endswith('.zarr'):
      from weatherbenchx_tpu_torch import zarr_io
      ds = zarr_io.open_dataset_zarr(path.rstrip('/'))
      return {k: v.copy(data=v.data) for k, v in ds.items()}
    data = read_bytes(path)
    if io_lib.is_netcdf_bytes(data):
      from weatherbenchx_tpu_torch import netcdf_io
      return netcdf_io.loads_dataset_netcdf(data)
    return io_lib.loads_dataset(data)
  return io_lib.load_dataset(path)


def write_text_atomic(path: str, text: str) -> None:
  write_bytes_atomic(path, text.encode())


def read_text(path: str) -> str:
  return read_bytes(path).decode()
