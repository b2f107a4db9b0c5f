"""Dataset (de)serialization: the portable ``.npz`` container.

The port of ``weatherbenchx_tpu/io.py:24-147``, byte for byte the same
format: one ``.npz`` file holding every data and coord array plus a JSON
structure record under ``__meta__``. Datetime64, timedelta64 and string
coords round-trip exactly, and a file written by either package reads in
the other.

Data is read into CPU tensors; tensors are written from wherever they
live (bfloat16, which numpy lacks, is written widened to float32). The
JAX package's other containers (``.wbx``, ``.zarr``, netCDF) are not
ported yet: their paths raise NotImplementedError.
"""

import io as _pyio
import json
from typing import Hashable, Mapping

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import Coord, DimArray

Dataset = Mapping[Hashable, DimArray]

_UNPORTED_SUFFIXES = ('.wbx', '.zarr', '.nc')


def _host(values) -> np.ndarray:
  if isinstance(values, torch.Tensor):
    values = values.detach().cpu()
    if values.dtype == torch.bfloat16:
      values = values.float()
    return values.numpy()
  return np.asarray(values)


def _collect(dataset: Dataset) -> tuple[dict, dict[str, np.ndarray]]:
  """Structure record + flat key→array map."""
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


def _check_portable(path: str) -> None:
  if str(path).rstrip('/').endswith(_UNPORTED_SUFFIXES):
    raise NotImplementedError(
        f'{path!r}: weatherbenchx_tpu_torch reads and writes only the .npz '
        'container; .wbx, .zarr and netCDF are not ported yet')


def _savez(file, dataset: Dataset) -> None:
  meta, arrays = _collect(dataset)
  arrays['__meta__'] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
  np.savez(file, **arrays)


def dumps_dataset(dataset: Dataset) -> bytes:
  """Serializes a dataset to portable .npz bytes (in memory)."""
  buf = _pyio.BytesIO()
  _savez(buf, dataset)
  return buf.getvalue()


def loads_dataset(data: bytes) -> dict[str, DimArray]:
  """Inverse of dumps_dataset."""
  with np.load(_pyio.BytesIO(data), allow_pickle=False) as npz:
    meta = json.loads(bytes(npz['__meta__']).decode())
    return _assemble(meta, lambda key: npz[key])


def save_dataset(path: str, dataset: Dataset) -> None:
  """Writes a dict[var, DimArray] dataset as an .npz container."""
  _check_portable(path)
  with open(path, 'wb') as f:
    _savez(f, dataset)


def load_dataset(path: str) -> dict[str, DimArray]:
  """Reads a dataset written by save_dataset (of either package)."""
  _check_portable(path)
  with np.load(path, allow_pickle=False) as npz:
    meta = json.loads(bytes(npz['__meta__']).decode())
    return _assemble(meta, lambda key: npz[key])
