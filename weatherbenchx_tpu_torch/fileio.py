"""Atomic dataset and text I/O on local paths.

The port of ``weatherbenchx_tpu/fileio.py:25-196`` for local files. Writes
are atomic (a uniquely named temporary file, then ``os.replace``), so
duplicate or straggling writers cannot leave a torn file. Remote URLs
(``gs://``, ``s3://``, ``memory://``, ...), which the JAX package reaches
through fsspec, are not ported yet and raise NotImplementedError.
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


def _local(path: str) -> str:
  if is_remote(path):
    raise NotImplementedError(
        f'{path!r}: remote paths (fsspec) are not ported to '
        'weatherbenchx_tpu_torch yet; use a local path')
  return path


def exists(path: str) -> bool:
  return os.path.exists(_local(path))


def read_bytes(path: str) -> bytes:
  with open(_local(path), 'rb') as f:
    return f.read()


def _tmp_name(path: str) -> str:
  # A uuid, not the pid: duplicate writers on different hosts over a
  # shared filesystem can collide on pid.
  return f'{path}.tmp.{uuid.uuid4().hex[:12]}'


def write_bytes_atomic(path: str, data: bytes) -> None:
  """tmp + rename write; concurrent or duplicate writers cannot corrupt."""
  tmp = _tmp_name(_local(path))
  with open(tmp, 'wb') as f:
    f.write(data)
  os.replace(tmp, path)


def save_dataset_atomic(path: str, dataset: Dataset) -> None:
  """Atomic ``io.save_dataset``; the temporary keeps the path's suffix, so
  the container is chosen (or refused) by the final name."""
  tmp = _tmp_name(_local(path)) + os.path.splitext(path.rstrip('/'))[1]
  io_lib.save_dataset(tmp, dataset)
  os.replace(tmp, path)


def load_dataset_any(path: str) -> dict[str, DimArray]:
  return io_lib.load_dataset(_local(path))


def write_text_atomic(path: str, text: str) -> None:
  write_bytes_atomic(path, text.encode())


def read_text(path: str) -> str:
  return read_bytes(path).decode()
