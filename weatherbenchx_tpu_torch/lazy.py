"""Lazy windowed array views for streaming chunk reads.

The port of ``weatherbenchx_tpu/lazy.py``. The reference opens Zarr stores
lazily (dask) and ``.compute()``s only each chunk's selection
(``weatherbenchX/data_loaders/base.py:146-153``,
``xarray_loaders.py:116-141``), which is what lets it evaluate multi-TB
stores with bounded worker memory. This module gives the same contract for
the port's containers without dask or xarray:

* a store opens as :class:`LazyArray` views: coordinates eager (small),
  variable data lazy;
* selections (``isel``/``sel`` on :class:`~darray.DimArray`) compose
  *index metadata* on the view, reading nothing; ``take`` reads only the
  gathered rows;
* materialization (``np.asarray``, ``DimArray.data``, the per-chunk compute
  step in ``data/base.py``) reads only the selected window from disk, as
  coalesced positional block reads (threaded native ``pread`` when built).

Indexing semantics are orthogonal (outer) per axis: each axis is indexed
independently, like zarr/xarray ``isel``, which matches how DimArray
applies indexers one dim at a time. (The JAX package's ``XarraySource``,
over an xarray-opened store, waits for xarray on the port's machines.)
"""

from __future__ import annotations

import abc
import threading
from typing import Optional, Sequence, Union

import numpy as np

Indexer = Union[slice, np.ndarray, int]

# Upper bound on positional-read runs per window; beyond this the split
# point moves outward and inner axes are read full-extent then subset in
# memory (trading extra bytes for fewer syscalls).
_MAX_RUNS = 32768


class ArraySource(abc.ABC):
  """A (shape, dtype) array that can serve orthogonal windowed reads."""

  shape: tuple[int, ...]
  dtype: np.dtype

  @abc.abstractmethod
  def read(self, indexers: tuple[Indexer, ...]) -> np.ndarray:
    """Reads the orthogonal window; one indexer (slice or 1-D intp array)
    per axis, in axis order. Never drops axes."""


def _normalize_axis_index(e: Indexer, n: int) -> Optional[np.ndarray]:
  """Index array for one axis, or None if it spans the full axis in order."""
  if isinstance(e, slice):
    r = range(n)[e]
    if r == range(n):
      return None
    return np.fromiter(r, np.intp, len(r))
  e = np.asarray(e, np.intp).reshape(-1)
  e = np.where(e < 0, e + n, e)
  if e.size == n and e.size and e[0] == 0 and e[-1] == n - 1 and np.array_equal(
      e, np.arange(n, dtype=np.intp)):
    return None
  return e


class BlockSource(ArraySource):
  """Windowed reads from one contiguous C-ordered block in a local file.

  Covers both containers: a ``.wbx`` variable block, and an uncompressed
  (ZIP_STORED) ``.npy`` member inside an ``.npz`` archive.
  """

  def __init__(self, path: str, data_offset: int,
               shape: Sequence[int], dtype) -> None:
    self.path = path
    self.data_offset = int(data_offset)
    self.shape = tuple(int(s) for s in shape)
    self.dtype = np.dtype(dtype)

  def read(self, indexers: tuple[Indexer, ...]) -> np.ndarray:
    shape, dtype = self.shape, self.dtype
    itemsize = dtype.itemsize
    norm = [_normalize_axis_index(e, n) for e, n in zip(indexers, shape)]
    out_shape = tuple(n if x is None else len(x)
                      for n, x in zip(shape, norm))
    if 0 in out_shape or itemsize == 0:
      return np.empty(out_shape, dtype)

    # Split point: everything at/after `t` is read as one contiguous span
    # per outer-index combination. Start just past the last non-full axis,
    # then widen the span (reading full extent + in-memory subset) while
    # the run count exceeds the budget.
    nonfull = [a for a, x in enumerate(norm) if x is not None]
    t = (nonfull[-1] + 1) if nonfull else 0

    def n_runs(tt: int) -> int:
      r = 1
      for a in range(tt):
        r *= out_shape[a] if norm[a] is not None else shape[a]
      return r

    while t > 0 and n_runs(t) > _MAX_RUNS:
      t -= 1

    outer_idx = [
        norm[a] if norm[a] is not None else np.arange(shape[a], dtype=np.intp)
        for a in range(t)
    ]
    strides = np.ones(len(shape), np.int64)
    for a in range(len(shape) - 2, -1, -1):
      strides[a] = strides[a + 1] * shape[a + 1]
    unit_elems = int(np.prod(shape[t:], dtype=np.int64)) if t < len(
        shape) else 1
    unit_bytes = unit_elems * itemsize

    offsets = np.zeros((), np.int64)
    for a in range(t):
      offsets = np.add.outer(offsets, outer_idx[a] * strides[a])
    flat_offsets = (offsets.reshape(-1) * itemsize) + self.data_offset

    read_shape = tuple(len(x) for x in outer_idx) + shape[t:]
    buf = np.empty(read_shape, dtype)
    flat = buf.reshape(-1)

    # Coalesce runs that are consecutive in the file (dest order is already
    # consecutive by construction).
    runs: list[tuple[int, int, int]] = []  # (file_off, dest_elem, n_elems)
    for i, off in enumerate(flat_offsets):
      off = int(off)
      if runs and runs[-1][0] + runs[-1][2] * itemsize == off:
        runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + unit_elems)
      else:
        runs.append((off, i * unit_elems, unit_elems))

    self._pread_runs(runs, flat, itemsize)

    # In-memory subset of the non-full axes inside the span [t, end).
    for a in range(t, len(shape)):
      if norm[a] is not None:
        buf = buf[(slice(None),) * a + (norm[a],)]
    return buf

  def _pread_runs(self, runs, flat: np.ndarray, itemsize: int) -> None:
    from weatherbenchx_tpu_torch import native

    views = [flat[d:d + n] for _, d, n in runs]
    if len(runs) > 1 and native.blockstore_available():
      native.pread_blocks(self.path, views, [o for o, _, _ in runs])
      return
    with open(self.path, 'rb') as f:
      for (off, _, _), v in zip(runs, views):
        f.seek(off)
        got = f.readinto(v.view(np.uint8))  # byte view: datetime64 etc.
        if got != v.nbytes:
          raise OSError(
              f'short read at {off} in {self.path}: {got} != {v.nbytes}')


class EagerSource(ArraySource):
  """Orthogonal-read adapter over an in-memory array (compressed npz
  members, test fixtures)."""

  def __init__(self, array: np.ndarray) -> None:
    self.array = np.asarray(array)
    self.shape = self.array.shape
    self.dtype = self.array.dtype

  def read(self, indexers: tuple[Indexer, ...]) -> np.ndarray:
    out = self.array
    for a, e in enumerate(indexers):
      out = out[(slice(None),) * a + (e,)]
    return out


def _compose_one(cur: Indexer, new, n: int) -> Indexer:
  """Composes a new indexer (over the current view) onto a base-axis one."""
  base = np.arange(n, dtype=np.intp)[cur]
  if isinstance(new, (int, np.integer)):
    return int(base[new])
  if isinstance(new, np.ndarray) and new.dtype == bool:
    new = np.nonzero(new)[0]
  composed = base[new]
  # Re-simplify to a slice when contiguous ascending (keeps windows
  # coalescible and composition cheap).
  if composed.size > 1:
    step = composed[1] - composed[0]
    if step > 0 and np.array_equal(
        composed, np.arange(composed[0], composed[-1] + 1, step)):
      return slice(int(composed[0]), int(composed[-1]) + 1, int(step))
  elif composed.size == 1:
    return slice(int(composed[0]), int(composed[0]) + 1)
  return composed


class LazyArray:
  """A windowed view over an :class:`ArraySource`.

  Supports the indexing DimArray performs (one int / slice / 1-D integer
  array per axis, orthogonal semantics), composing lazily; ``np.asarray``
  triggers the windowed read. Marked host-side for DimArray via
  ``__wbx_lazy__``, which ``DimArray`` reads to keep the view lazy.
  """

  __wbx_lazy__ = True
  __slots__ = ('source', '_index')

  def __init__(self, source: ArraySource,
               index: Optional[tuple[Indexer, ...]] = None) -> None:
    self.source = source
    self._index = (tuple(index) if index is not None
                   else tuple(slice(None) for _ in source.shape))

  # -- shape metadata ---------------------------------------------------------

  @property
  def shape(self) -> tuple[int, ...]:
    out = []
    for e, n in zip(self._index, self.source.shape):
      if isinstance(e, (int, np.integer)):
        continue
      if isinstance(e, slice):
        out.append(len(range(n)[e]))
      else:
        out.append(len(e))
    return tuple(out)

  @property
  def ndim(self) -> int:
    return len(self.shape)

  @property
  def dtype(self) -> np.dtype:
    return self.source.dtype

  @property
  def size(self) -> int:
    return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

  @property
  def nbytes(self) -> int:
    return self.size * self.dtype.itemsize

  def __len__(self) -> int:
    if not self.shape:
      raise TypeError('len() of a 0-d LazyArray')
    return self.shape[0]

  def __repr__(self) -> str:
    return (f'LazyArray(shape={self.shape}, dtype={self.dtype}, '
            f'source={type(self.source).__name__})')

  # -- lazy composition -------------------------------------------------------

  def __getitem__(self, key) -> 'LazyArray':
    if not isinstance(key, tuple):
      key = (key,)
    if any(k is Ellipsis or k is None for k in key):
      raise IndexError('LazyArray does not support Ellipsis/newaxis')
    out_axes = [a for a, e in enumerate(self._index)
                if not isinstance(e, (int, np.integer))]
    if len(key) > len(out_axes):
      raise IndexError(
          f'too many indices: {len(key)} for {len(out_axes)} axes')
    new_index = list(self._index)
    for k, a in zip(key, out_axes):
      if isinstance(k, slice) and k == slice(None):
        continue
      if not isinstance(k, (slice, int, np.integer)):
        k = np.asarray(k)
        if k.ndim != 1:
          raise IndexError('LazyArray only supports 1-D array indexers')
      new_index[a] = _compose_one(self._index[a], k, self.source.shape[a])
    return LazyArray(self.source, tuple(new_index))

  # -- materialization --------------------------------------------------------

  def read(self) -> np.ndarray:
    idx: list[Indexer] = []
    dropped: list[int] = []
    for a, e in enumerate(self._index):
      if isinstance(e, (int, np.integer)):
        idx.append(np.array([e], np.intp))
        dropped.append(a)
      else:
        idx.append(e)
    out = self.source.read(tuple(idx))
    if dropped:
      out = out.reshape(
          [s for a, s in enumerate(out.shape) if a not in dropped])
    # (conditional: ascontiguousarray would promote 0-d arrays to 1-d)
    return np.ascontiguousarray(out) if out.ndim else np.asarray(out)

  def __array__(self, dtype=None, copy=None) -> np.ndarray:
    out = self.read()
    if dtype is not None:
      out = out.astype(dtype, copy=False)
    return out


def is_lazy(x) -> bool:
  return getattr(x, '__wbx_lazy__', False)


# ---------------------------------------------------------------------------
# npz (zip) member location — np.savez writes uncompressed (ZIP_STORED)
# .npy members, so their raw bytes can be windowed-read in place.
# ---------------------------------------------------------------------------


def locate_npz_members(path: str) -> dict[str, Union[BlockSource, None]]:
  """Maps each npz member name (sans .npy) to a BlockSource, or None when it
  cannot be windowed (compressed or Fortran-ordered) and must load eagerly."""
  import zipfile

  out: dict[str, Union[BlockSource, None]] = {}
  with zipfile.ZipFile(path) as zf, open(path, 'rb') as f:
    for zinfo in zf.infolist():
      name = zinfo.filename
      key = name[:-4] if name.endswith('.npy') else name
      if zinfo.compress_type != zipfile.ZIP_STORED:
        out[key] = None
        continue
      # Local file header: the extra field can differ from the central
      # directory's, so parse it to find the member's data start.
      f.seek(zinfo.header_offset)
      hdr = f.read(30)
      if hdr[:4] != b'PK\x03\x04':
        out[key] = None
        continue
      n_name = int.from_bytes(hdr[26:28], 'little')
      n_extra = int.from_bytes(hdr[28:30], 'little')
      member_off = zinfo.header_offset + 30 + n_name + n_extra
      f.seek(member_off)
      try:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
          shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
          shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
      except ValueError:
        out[key] = None
        continue
      if fortran or dtype.hasobject:
        out[key] = None
        continue
      out[key] = BlockSource(path, f.tell(), shape, dtype)
  return out
