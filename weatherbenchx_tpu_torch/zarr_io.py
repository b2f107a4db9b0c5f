"""Self-contained Zarr v2/v3 directory-store reader/writer.

The port of ``weatherbenchx_tpu/zarr_io.py``: the same stores, byte for
byte, in both directions. Zarr is the lingua franca of the reference's
ecosystem: ERA5 and every WeatherBench 2 model output are zarr stores
(reference ``xarray_loaders.py:55-141``). This module implements the
directory formats directly:

* :func:`save_dataset_zarr` writes a store any xarray/zarr install can open
  (``_ARRAY_DIMENSIONS`` convention, CF-encoded datetime64/timedelta64
  coordinates, optional consolidated metadata; raw, zlib, zstd, gzip or
  blosc-lz4 chunks). ``zarr_format=3`` emits the v3 layout instead
  (per-node ``zarr.json``, ``dimension_names``, bytes+compressor codec
  chains, ``c/``-prefixed chunk keys), with ``shards`` the
  ``sharding_indexed`` codec;
* :func:`open_dataset_zarr` opens a local or fsspec store LAZILY: each
  variable is a :class:`~weatherbenchx_tpu_torch.lazy.LazyArray` over a
  chunk-grid source, so per-chunk evaluation windows read only the zarr
  chunks they intersect. Both **v2** and **v3** stores are readable (v3:
  ``zarr.json`` metadata, regular chunk grids, default/v2 chunk key
  encodings, bytes codec either endian, blosc/zstd/gzip compression, and
  one level of the ``sharding_indexed`` codec: inner chunks resolve
  through the per-shard index via ranged reads, with crc32c index
  verification).

Cells are encoded and decoded by the native codec (``native/zarrcodec.cpp``)
where it builds, thread-parallel and straight into numpy buffers, v3 shard
cells as byte ranges; the Python codecs (``codecs.py``) are the fallback,
on a thread pool. Windows scatter via strided slice copies.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import os
import threading
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import cf
from weatherbenchx_tpu_torch import codecs as wbx_codecs
from weatherbenchx_tpu_torch import fileio
from weatherbenchx_tpu_torch import lazy
from weatherbenchx_tpu_torch.darray import Coord, DimArray

Dataset = Mapping[str, DimArray]

_TIME_EPOCH = np.datetime64('1970-01-01T00:00:00', 'ns')
_NS_UNITS = 'nanoseconds since 1970-01-01'


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _json_default(x):
  if isinstance(x, (np.integer,)):
    return int(x)
  if isinstance(x, (np.floating,)):
    return float(x)
  raise TypeError(f'not JSON-serializable: {type(x)}')


def _encode_cf_time(values: np.ndarray) -> tuple[np.ndarray, dict]:
  """datetime64/timedelta64 → int64 + CF attrs (what xarray's decoder
  expects for zarr stores)."""
  if values.dtype.kind == 'M':
    ints = (values.astype('datetime64[ns]') - _TIME_EPOCH).astype(np.int64)
    return ints, {'units': _NS_UNITS, 'calendar': 'proleptic_gregorian'}
  if values.dtype.kind == 'm':
    ints = values.astype('timedelta64[ns]').astype(np.int64)
    return ints, {'units': 'nanoseconds'}
  return values, {}


def _fill_value_json(dtype: np.dtype):
  if dtype.kind == 'f':
    return 'NaN'
  return None


def _v3_data_type(dtype: np.dtype) -> str:
  """numpy dtype → zarr v3 core data type name."""
  if dtype.kind == 'b':
    return 'bool'
  if dtype.kind in 'iuf':
    return f'{np.dtype(dtype).name}'  # int32/uint8/float64/...
  raise ValueError(
      f'dtype {dtype} has no zarr v3 core data type (strings and '
      'structured dtypes are v2-only in this writer)')


_V3_SHUFFLE_NAMES = {0: 'noshuffle', 1: 'shuffle', 2: 'bitshuffle'}


def _v3_codec_chain(comp: Optional[dict], typesize: int) -> list:
  """The v3 'codecs' list for a v2-style compressor config (the inverse
  of :func:`_parse_v3_codecs`, which round-trips it on read)."""
  chain: list = [{'name': 'bytes', 'configuration': {'endian': 'little'}}]
  if comp is None:
    return chain
  cid = comp.get('id')
  if cid == 'blosc':
    chain.append({'name': 'blosc', 'configuration': {
        'cname': comp.get('cname', 'lz4'),
        'clevel': comp.get('clevel', 5),
        'shuffle': _V3_SHUFFLE_NAMES.get(comp.get('shuffle', 0),
                                         'noshuffle'),
        'typesize': typesize,
        'blocksize': comp.get('blocksize', 0)}})
  elif cid == 'zstd':
    chain.append({'name': 'zstd', 'configuration': {
        'level': comp.get('level', 3), 'checksum': False}})
  elif cid == 'gzip':
    chain.append({'name': 'gzip', 'configuration': {
        'level': comp.get('level', 5)}})
  else:
    # v2's raw-zlib codec has no v3 equivalent (v3 gzip framing differs).
    raise ValueError(
        f'compressor {cid!r} cannot be written to a zarr v3 store '
        "(use 'zstd', 'blosc', 'gzip' or None)")
  return chain


class ZarrArrayWriter:
  """Incremental writer for one zarr v2 array.

  Metadata is written at construction; chunk blocks stream in afterwards
  via :meth:`write_block` — the building block for the unaggregated
  pipeline's chunk-at-a-time store writes (the xarray_beam
  template+ChunksToZarr analog, reference ``beam_pipeline.py:543-681``).

  ``shards`` (v3 only) writes the ``sharding_indexed`` codec layout
  zarr-python 3 defaults to for many-small-chunk stores: ``chunks`` stays
  the logical (inner) cell grid ``write_block`` addresses, but cells are
  packed into shard objects of ``shards`` elements per axis (rounded up
  to a chunk multiple) with an end-located ``(offset, nbytes)`` uint64
  index + crc32c. Encoded cells buffer in memory until their shard is
  complete; :meth:`close` flushes partial shards with the spec's
  missing-chunk sentinel (readers substitute the fill value).
  """

  _MISSING = 0xFFFFFFFFFFFFFFFF  # spec sentinel for an absent inner cell

  def __init__(self, root: str, name: str, shape: Sequence[int],
               chunks: Sequence[int], dtype, dims: Sequence[str],
               extra_attrs: Optional[dict] = None,
               compressor: Optional[str] = None,
               compression_level: Optional[int] = None,
               zarr_format: int = 2,
               shards: Optional[Sequence[int]] = None) -> None:
    self._adir = os.path.join(root, name)
    fileio.makedirs(self._adir)
    self.shape = tuple(int(s) for s in shape)
    self.chunks = tuple(min(int(c), max(int(s), 1)) or 1
                        for c, s in zip(chunks, self.shape))
    self.dtype = np.dtype(dtype)
    if zarr_format == 3 and self.dtype.byteorder == '>':
      self.dtype = self.dtype.newbyteorder('<')  # chain declares little
    self._codec = compressor
    self._level = compression_level
    self._format = int(zarr_format)
    if self._format not in (2, 3):
      raise ValueError(f'zarr_format must be 2 or 3, got {zarr_format}')
    self._comp = wbx_codecs.compressor_config(
        compressor, self.dtype.itemsize, compression_level)
    self.shards = None
    if shards is not None:
      if self._format != 3:
        raise ValueError('sharding (shards=) requires zarr_format=3')
      if len(tuple(shards)) != len(self.shape):
        raise ValueError(f'shards {tuple(shards)} rank != shape '
                         f'{self.shape} rank')
      norm = []
      for s, c in zip(shards, self.chunks):
        if int(s) <= 0:
          raise ValueError(f'shard sizes must be positive, got {shards}')
        norm.append(-(-int(s) // c) * c)  # round UP to a chunk multiple
      if tuple(norm) != self.chunks:  # shard == one cell: plain store
        self.shards = tuple(norm)
    if self.shards is not None:
      self._cells_per_shard = tuple(
          s // c for s, c in zip(self.shards, self.chunks))
      # inner chunk grid (what write_block addresses)
      self._inner_grid = tuple(
          max(-(-s // c), 1) for s, c in zip(self.shape, self.chunks))
      # encoded-cell staging: shard cell -> {flat inner index: bytes}
      self._shard_parts: dict[tuple, dict[int, bytes]] = {}
      self._shard_lock = threading.Lock()
    if self._format == 3:
      if self.shards is not None:
        grid_shape = list(self.shards)
        codec_chain = [{
            'name': 'sharding_indexed',
            'configuration': {
                'chunk_shape': list(self.chunks),
                'codecs': _v3_codec_chain(self._comp, self.dtype.itemsize),
                'index_codecs': [
                    {'name': 'bytes',
                     'configuration': {'endian': 'little'}},
                    {'name': 'crc32c'},
                ],
                'index_location': 'end',
            }}]
      else:
        grid_shape = list(self.chunks)
        codec_chain = _v3_codec_chain(self._comp, self.dtype.itemsize)
      zarray = {
          'zarr_format': 3,
          'node_type': 'array',
          'shape': list(self.shape),
          'data_type': _v3_data_type(self.dtype),
          'chunk_grid': {'name': 'regular',
                         'configuration': {'chunk_shape': grid_shape}},
          'chunk_key_encoding': {'name': 'default',
                                 'configuration': {'separator': '/'}},
          'fill_value': (
              'NaN' if self.dtype.kind == 'f'
              else False if self.dtype.kind == 'b' else 0),
          'codecs': codec_chain,
          'dimension_names': list(dims),
          'attributes': dict(extra_attrs or {}),
      }
      fileio.write_bytes_atomic(
          os.path.join(self._adir, 'zarr.json'),
          json.dumps(zarray, default=_json_default).encode())
      # Normalized v2-shaped entries so in-process consumers (store
      # readers, tests) see one metadata schema for both formats.
      norm, attrs = _normalize_v3_array(zarray, name)
      self.metadata = {f'{name}/.zarray': norm, f'{name}/.zattrs': attrs}
      return
    zarray = {
        'zarr_format': 2,
        'shape': list(self.shape),
        'chunks': list(self.chunks),
        'dtype': self.dtype.str,
        'compressor': self._comp,
        'fill_value': _fill_value_json(self.dtype),
        'order': 'C',
        'filters': None,
        'dimension_separator': '.',
    }
    zattrs = {'_ARRAY_DIMENSIONS': list(dims), **(extra_attrs or {})}
    # Atomic metadata writes: concurrent writers (multi-process pipelines
    # owning disjoint cells) emit identical content; tmp+rename keeps the
    # overlap from tearing the JSON.
    for fname, payload in (('.zarray', zarray), ('.zattrs', zattrs)):
      fileio.write_bytes_atomic(
          os.path.join(self._adir, fname),
          json.dumps(payload, default=_json_default).encode())
    self.metadata = {f'{name}/.zarray': zarray, f'{name}/.zattrs': zattrs}

  def _cell_key(self, cell: Sequence[int]) -> str:
    if self._format == 3:  # default v3 encoding: c/i/j/... ('c' for 0-d)
      return 'c' + ''.join(f'/{int(i)}' for i in cell) if cell else 'c'
    return '.'.join(str(int(i)) for i in cell) or '0'

  def write_block(self, cell: Sequence[int], block: np.ndarray) -> None:
    """Writes one (inner) chunk-grid cell. Ragged edge blocks are padded
    to full chunk extent with fill (the v2/v3 storage contract). In
    sharded mode the encoded cell is staged and its shard object is
    written once every in-bounds cell of the shard has arrived."""
    block = self._pad_to_cell(block)
    raw = np.ascontiguousarray(block).tobytes()
    raw = bytes(wbx_codecs.encode_cell(raw, self._codec,
                                       self.dtype.itemsize, self._level))
    if self.shards is not None:
      self._stash_sharded(tuple(int(i) for i in cell), raw)
      return
    path = os.path.join(self._adir, self._cell_key(cell))
    if self._format == 3 and cell:
      fileio.makedirs(os.path.dirname(path))
    fileio.write_bytes(path, raw)

  def _stash_sharded(self, cell: tuple[int, ...], raw: bytes) -> None:
    spc = self._cells_per_shard
    shard = tuple(c // n for c, n in zip(cell, spc))
    flat = 0  # C-order position in the shard's inner grid
    for c, n in zip(cell, spc):
      flat = flat * n + (c % n)
    with self._shard_lock:
      parts = self._shard_parts.setdefault(shard, {})
      parts[flat] = raw
      if len(parts) < self._expected_cells(shard):
        return
      del self._shard_parts[shard]
    self._write_shard(shard, parts)

  def _expected_cells(self, shard: tuple[int, ...]) -> int:
    """Inner cells of this shard that intersect the array shape (edge
    shards extend past it; out-of-bounds cells stay missing-sentinel)."""
    n = 1
    for sh, spc, grid in zip(shard, self._cells_per_shard,
                             self._inner_grid):
      n *= max(min((sh + 1) * spc, grid) - sh * spc, 0)
    return n

  def _write_shard(self, shard: tuple[int, ...],
                   parts: Mapping[int, bytes]) -> None:
    """Assembles payload + end-located uint64-le (offset, nbytes) index
    + crc32c and writes the shard object atomically."""
    n = int(np.prod(self._cells_per_shard, dtype=np.int64))
    index = np.full((n, 2), self._MISSING, dtype='<u8')
    chunks_out = []
    offset = 0
    for flat in sorted(parts):
      raw = parts[flat]
      index[flat, 0] = offset
      index[flat, 1] = len(raw)
      chunks_out.append(raw)
      offset += len(raw)
    index_bytes = index.tobytes()
    crc = wbx_codecs.crc32c(index_bytes).to_bytes(4, 'little')
    path = os.path.join(self._adir, self._cell_key(shard))
    if shard:
      fileio.makedirs(os.path.dirname(path))
    fileio.write_bytes_atomic(path, b''.join(chunks_out) + index_bytes + crc)

  def close(self) -> None:
    """Flushes partial shards (skip-failed / ragged coverage): absent
    cells keep the missing sentinel, so readers see the fill value. A
    no-op for unsharded writers and complete shards."""
    if self.shards is None:
      return
    with self._shard_lock:
      pending = self._shard_parts
      self._shard_parts = {}
    for shard, parts in pending.items():
      self._write_shard(shard, parts)

  def _pad_to_cell(self, block: np.ndarray) -> np.ndarray:
    block = np.asarray(block).astype(self.dtype, copy=False)
    if block.shape == self.chunks:
      return np.ascontiguousarray(block)
    full = np.full(self.chunks, np.nan if self.dtype.kind == 'f' else 0,
                   dtype=self.dtype)
    full[tuple(slice(0, s) for s in block.shape)] = block
    return full

  def write_full(self, values: np.ndarray) -> None:
    """Writes every cell, thread-parallel. Where the native codec builds
    (any codec but gzip; files on a local store, or cells of shards in
    memory) it encodes in batches of at most 512 MB of padded cells (window
    slices copy, so staging every cell at once would duplicate the array);
    else the Python codecs run on the read pool (file writes and every
    compressor release the GIL). Shards are written as their last cell
    lands, partial ones at close()."""
    grid = [max(-(-s // c), 1) for s, c in zip(self.shape, self.chunks)]
    cells = list(np.ndindex(*grid))
    if self._native_ok():
      cell_nbytes = int(np.prod(self.chunks, dtype=np.int64)
                        ) * self.dtype.itemsize
      batch = max(int((512 << 20) // max(cell_nbytes, 1)), 1)
      for i in range(0, len(cells), batch):
        write_cells([(self, c, values[self._cell_window(c)])
                     for c in cells[i:i + batch]])
    else:
      list(_read_pool().map(
          lambda c: self.write_block(c, values[self._cell_window(c)]),
          cells))
    self.close()

  def _cell_window(self, cell) -> tuple:
    return tuple(slice(i * c, (i + 1) * c)
                 for i, c in zip(cell, self.chunks))

  def _native_ok(self) -> bool:
    from weatherbenchx_tpu_torch import native
    return (self._codec != 'gzip'
            and (self.shards is not None or not fileio.is_remote(self._adir))
            and native.zarrcodec_available())


def write_cells(items: Sequence[tuple]) -> None:
  """Writes ``(writer, cell, block)`` items, the same bytes as each
  writer's ``write_block``, encoded in parallel by the native codec where
  it serves (cells of one codec, level and size in one call, across
  writers), else one by one."""
  from weatherbenchx_tpu_torch import native

  groups: dict = {}
  for writer, cell, block in items:
    if not writer._native_ok():
      writer.write_block(cell, block)
      continue
    block = writer._pad_to_cell(block)
    key = (writer._codec, writer._level, writer.dtype.itemsize, block.nbytes,
           writer.shards is not None)
    groups.setdefault(key, []).append((writer, tuple(int(i) for i in cell),
                                       block))
  for (codec, level, itemsize, _, sharded), group in groups.items():
    blocks = [b for _, _, b in group]
    if sharded:
      encoded = native.encode_buffers(codec, blocks, itemsize, level,
                                      threads=_READ_THREADS)
      for (writer, cell, _), raw in zip(group, encoded):
        writer._stash_sharded(cell, raw)
      continue
    paths = [os.path.join(w._adir, w._cell_key(c)) for w, c, _ in group]
    for path in {os.path.dirname(p) for (w, c, _), p in zip(group, paths)
                 if w._format == 3 and c}:
      fileio.makedirs(path)
    native.encode_cells(paths, codec, blocks, itemsize, level,
                        threads=_READ_THREADS)


def _write_array(root: str, name: str, values: np.ndarray,
                 dims: Sequence[str], chunks: Sequence[int],
                 extra_attrs: Optional[dict] = None,
                 compressor: Optional[str] = None,
                 zarr_format: int = 2,
                 shards: Optional[Sequence[int]] = None) -> dict:
  """Writes one complete zarr array; returns its .zmetadata entries."""
  values, time_attrs = _encode_cf_time(np.asarray(values))
  if not values.flags.c_contiguous:
    values = np.ascontiguousarray(values)
  writer = ZarrArrayWriter(
      root, name, values.shape, chunks, values.dtype, dims,
      extra_attrs={**time_attrs, **(extra_attrs or {})},
      compressor=compressor, zarr_format=zarr_format, shards=shards)
  writer.write_full(values)
  return writer.metadata


def save_dataset_zarr(
    path: str,
    dataset: Dataset,
    chunks: Optional[Mapping[str, int]] = None,
    compressor: Optional[str] = None,
    consolidated: bool = True,
    zarr_format: int = 2,
    shards: Optional[Mapping[str, int]] = None,
) -> None:
  """Writes a dict[var, DimArray] dataset as a Zarr directory store.

  ``chunks`` maps dim name → chunk length (default: whole dim). Non-dim
  coordinates are recorded per variable via the CF ``coordinates`` attr.
  ``zarr_format=3`` writes the v3 layout (per-node ``zarr.json``, regular
  chunk grid, default ``c/``-prefixed chunk keys, bytes+compressor codec
  chain, ``dimension_names``) that zarr-python 3 / new public stores use;
  v3 has no core fixed-length string data type, so string coordinates
  (sparse station ids) require the default v2.

  ``shards`` (v3 only) maps dim name → shard length in elements; arrays
  with at least one dim in the mapping are written with the
  ``sharding_indexed`` codec (inner chunks from ``chunks``, shard lengths
  rounded up to a chunk multiple; unmapped dims shard at one chunk).
  """
  if zarr_format not in (2, 3):
    raise ValueError(f'zarr_format must be 2 or 3, got {zarr_format}')
  if shards and zarr_format != 3:
    raise ValueError('shards= (sharding_indexed) requires zarr_format=3')
  fileio.makedirs(path)
  metadata: dict[str, Any] = {'.zgroup': {'zarr_format': 2}, '.zattrs': {}}
  if zarr_format == 3:
    fileio.write_bytes(
        os.path.join(path, 'zarr.json'),
        json.dumps({'zarr_format': 3, 'node_type': 'group',
                    'attributes': {}}).encode())
  else:
    fileio.write_bytes(os.path.join(path, '.zgroup'),
                       json.dumps(metadata['.zgroup']).encode())
    fileio.write_bytes(os.path.join(path, '.zattrs'), b'{}')

  chunks = dict(chunks or {})
  written: dict[str, tuple] = {}  # coord name -> (dims, id of values)

  shards = dict(shards or {})

  def chunk_spec(dims, shape):
    return [chunks.get(d, s) for d, s in zip(dims, shape)]

  def shard_spec(dims, cspec):
    if not shards or not any(d in shards for d in dims):
      return None
    return [shards.get(d, c) for d, c in zip(dims, cspec)]

  for var, da in dataset.items():
    aux = []
    for cname, c in da.coords.items():
      cvals = np.asarray(c.values)
      if cname not in tuple(da.dims):
        aux.append(str(cname))
      if not cf.check_shared_coord(written, cname, c.dims, cvals, 'zarr'):
        continue
      cspec = chunk_spec(c.dims, cvals.shape)
      metadata.update(_write_array(
          path, str(cname), cvals, c.dims,
          cspec, compressor=compressor,
          zarr_format=zarr_format, shards=shard_spec(c.dims, cspec)))
    extra = {'coordinates': ' '.join(aux)} if aux else None
    cspec = chunk_spec(da.dims, da.shape)
    metadata.update(_write_array(
        path, str(var), np.asarray(da.values), da.dims,
        cspec, extra_attrs=extra,
        compressor=compressor, zarr_format=zarr_format,
        shards=shard_spec(da.dims, cspec)))

  if consolidated and zarr_format == 2:
    fileio.write_bytes_atomic(
        os.path.join(path, '.zmetadata'),
        json.dumps({'metadata': metadata, 'zarr_consolidated_format': 1},
                   default=_json_default).encode())


# ---------------------------------------------------------------------------
# reading (lazy)
# ---------------------------------------------------------------------------


_READ_POOL = None
_READ_POOL_LOCK = threading.Lock()
_READ_THREADS = 16


def _read_pool():
  global _READ_POOL
  with _READ_POOL_LOCK:
    if _READ_POOL is None:
      _READ_POOL = concurrent.futures.ThreadPoolExecutor(
          max_workers=_READ_THREADS, thread_name_prefix='wbx-zarr-read')
    return _READ_POOL


class ZarrChunkSource(lazy.ArraySource):
  """Windowed reads over a zarr v2 array's chunk grid.

  Materializing a window reads only the chunk files it intersects — the
  store-native analog of :class:`lazy.BlockSource`'s coalesced preads.
  Cell files are read+decoded concurrently (file I/O and all codecs
  release the GIL); slice windows scatter as strided copies rather than
  fancy indexing.
  """

  def __init__(self, adir: str, zarray: dict) -> None:
    self._adir = adir
    self.shape = tuple(int(s) for s in zarray['shape'])
    self.dtype = np.dtype(zarray['dtype'])
    self._chunks = tuple(int(c) for c in zarray['chunks'])
    self._sep = zarray.get('dimension_separator', '.')
    # v3 stores ('key_encoding' set by _normalize_v3_array): 'default'
    # prefixes chunk keys with 'c' (`c/0/1` …), 'v2' keeps the v2 scheme.
    self._key_style = zarray.get('key_encoding', 'v2')
    self._codec = wbx_codecs.codec_from_config(zarray.get('compressor'))
    if zarray.get('filters'):
      raise ValueError(f'{adir}: zarr filters are not supported by the '
                       'self-contained reader')
    if zarray.get('order', 'C') != 'C':
      raise ValueError(
          f"{adir}: zarr chunk order {zarray.get('order')!r} is not "
          "supported by the self-contained reader (C order only)")
    fv = zarray.get('fill_value')
    self._fill = np.array(
        np.nan if fv == 'NaN' else (fv if fv is not None else 0),
        dtype=self.dtype)
    self._cell_nbytes = int(np.prod(self._chunks, dtype=np.int64)
                            ) * self.dtype.itemsize
    # zarr v3 sharding: self._chunks is the INNER chunk grid; cell loads
    # resolve (shard file, byte range) through the shard's trailing (or
    # leading) index instead of per-cell files.
    sharding = zarray.get('sharding')
    self._cells_per_shard = None
    if sharding is not None:
      self._cells_per_shard = tuple(
          s // c for s, c in zip(sharding['shard_chunks'], self._chunks))
      self._index_location = sharding['index_location']
      self._index_checksum = bool(sharding['index_checksum'])
      n_entries = int(np.prod(self._cells_per_shard, dtype=np.int64))
      self._index_nbytes = 16 * n_entries + (4 if self._index_checksum
                                             else 0)
      self._shard_index_cache: dict = {}
      self._shard_index_lock = threading.Lock()

  def _cell_path(self, cell: tuple[int, ...]) -> str:
    if self._key_style == 'default':  # zarr v3 default chunk key encoding
      key = 'c' + ''.join(f'{self._sep}{i}' for i in cell) if cell else 'c'
    else:
      key = self._sep.join(str(i) for i in cell) if cell else '0'
    return os.path.join(self._adir, key)

  def _shard_index(self, shard: tuple[int, ...]):
    """The shard's (offset, nbytes) index as a (n, 2) uint64 array, or
    None when the shard object does not exist. Cached (sequential
    windows revisit the same shard for every inner cell)."""
    with self._shard_index_lock:
      if shard in self._shard_index_cache:
        return self._shard_index_cache[shard]
    path = self._cell_path(shard)
    try:
      raw = fileio.read_byte_range(
          path, -self._index_nbytes if self._index_location == 'end'
          else 0, self._index_nbytes)
    except FileNotFoundError:
      raw = None
    if raw is not None:
      if len(raw) != self._index_nbytes:
        raise ValueError(f'{path}: shard shorter than its index '
                         f'({len(raw)} < {self._index_nbytes} bytes)')
      if self._index_checksum:
        body, want = raw[:-4], int.from_bytes(raw[-4:], 'little')
        got = wbx_codecs.crc32c(body)
        if got != want:
          raise ValueError(f'{path}: shard index crc32c mismatch '
                           f'(got {got:#x}, want {want:#x})')
        raw = body
      index = np.frombuffer(raw, '<u8').reshape(-1, 2)
    else:
      index = None
    with self._shard_index_lock:
      if len(self._shard_index_cache) >= 256:
        self._shard_index_cache.pop(next(iter(self._shard_index_cache)))
      self._shard_index_cache[shard] = index
    return index

  _MISSING_CHUNK = 0xFFFFFFFFFFFFFFFF  # spec sentinel for an absent cell

  def _shard_range(self, cell: tuple[int, ...]):
    """(shard path, offset, nbytes) of an inner cell, or None when the
    shard or the cell is missing."""
    spc = self._cells_per_shard
    shard = tuple(c // n for c, n in zip(cell, spc))
    within = tuple(c % n for c, n in zip(cell, spc))
    index = self._shard_index(shard)
    if index is None:
      return None
    flat = 0  # C-order (row-major) position in the shard's inner grid
    for w, n in zip(within, spc):
      flat = flat * n + w
    offset, nbytes = int(index[flat, 0]), int(index[flat, 1])
    if offset == self._MISSING_CHUNK and nbytes == self._MISSING_CHUNK:
      return None
    return self._cell_path(shard), offset, nbytes

  def _load_sharded_cell(self, cell: tuple[int, ...]) -> np.ndarray:
    located = self._shard_range(cell)
    if located is None:
      return np.broadcast_to(self._fill, self._chunks)
    path, offset, nbytes = located
    raw = fileio.read_byte_range(path, offset, nbytes)
    if len(raw) != nbytes:
      raise ValueError(f'{path}: truncated inner chunk '
                       f'at {offset} ({len(raw)} < {nbytes} bytes)')
    raw = wbx_codecs.decode_cell(raw, self._codec, self._cell_nbytes)
    return np.frombuffer(raw, self.dtype).reshape(self._chunks)

  def _load_cell(self, cell: tuple[int, ...]) -> np.ndarray:
    if self._cells_per_shard is not None:
      return self._load_sharded_cell(cell)
    try:
      raw = fileio.read_bytes(self._cell_path(cell))
    except FileNotFoundError:
      return np.broadcast_to(self._fill, self._chunks)
    raw = wbx_codecs.decode_cell(raw, self._codec, self._cell_nbytes)
    return np.frombuffer(raw, self.dtype).reshape(self._chunks)

  def _load_cells(self, cells: list[tuple[int, ...]],
                  blocks: Optional[list[np.ndarray]] = None
                  ) -> list[np.ndarray]:
    """Batch cell load: native threaded read+decode where it builds (a
    local store with a codec; v3 shard cells as byte ranges through the
    shard index), else the Python codec path on a thread pool. ``blocks``
    (C-contiguous, one cell's shape each) receive the cells, decoded
    straight into them on the native path."""
    from weatherbenchx_tpu_torch import native

    # Raw cells stay on the Python path: frombuffer is zero-copy there,
    # while the native path would pay an extra staging copy.
    if (cells and self._cell_nbytes > 0 and self._codec is not None
        and not fileio.is_remote(self._adir)
        and native.zarrcodec_available()):
      if blocks is None:
        blocks = [np.empty(self._chunks, self.dtype) for _ in cells]
      if self._cells_per_shard is not None:
        ranges = [self._shard_range(c) for c in cells]
        for b, r in zip(blocks, ranges):
          if r is None:
            b[...] = self._fill
        native.decode_ranges(
            [r and r[0] for r in ranges], [r[1] if r else 0 for r in ranges],
            [r[2] if r else 0 for r in ranges], self._codec, blocks,
            threads=_READ_THREADS)
        return blocks
      paths = [self._cell_path(c) for c in cells]
      exists = [os.path.exists(p) for p in paths]
      for b, ok in zip(blocks, exists):
        if not ok:
          b[...] = self._fill
      native.decode_cells(
          [p if ok else None for p, ok in zip(paths, exists)],
          self._codec, blocks, threads=_READ_THREADS)
      return blocks
    loaded = ([self._load_cell(cells[0])] if len(cells) == 1
              else list(_read_pool().map(self._load_cell, cells)))
    if blocks is None:
      return loaded
    for block, cell in zip(blocks, loaded):
      block[...] = cell
    return blocks

  def _axis_plan(self, e, n: int, c: int) -> list[tuple]:
    """Per-cell (cell_id, within-cell sel, dest sel) for one axis.

    Selections are slices whenever the axis indexer is a slice — the
    streaming case, and a flipped axis (a descending slice) — keeping the
    scatter a strided copy straight into the output.
    """
    if isinstance(e, slice):
      r = range(n)[e]
      if len(r) == 0:
        return []
      if r.step == 1:
        start, stop = r.start, r.stop
        plan = []
        for cell in range(start // c, (stop - 1) // c + 1):
          lo, hi = max(start, cell * c), min(stop, (cell + 1) * c)
          plan.append((cell, slice(lo - cell * c, hi - cell * c),
                       slice(lo - start, hi - start)))
        return plan
      # Any other step: the positions that fall in one cell are a run of
      # the output and evenly spaced within the cell.
      idx = np.asarray(r, np.intp)
      cells = idx // c
      cuts = np.flatnonzero(np.diff(cells)) + 1
      plan = []
      for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(idx)]):
        cell = int(cells[lo])
        first, last = int(idx[lo]) - cell * c, int(idx[hi - 1]) - cell * c
        stop = last + r.step
        plan.append((cell, slice(first, stop if stop >= 0 else None, r.step),
                     slice(int(lo), int(hi))))
      return plan
    e = np.asarray(e, np.intp)
    e = np.where(e < 0, e + n, e)
    cells = e // c
    plan = []
    for cell in np.unique(cells):
      dest = np.flatnonzero(cells == cell)
      plan.append((int(cell), e[dest] - int(cell) * c, dest))
    return plan

  def read(self, indexers: tuple) -> np.ndarray:
    plans = [self._axis_plan(e, n, c)
             for e, n, c in zip(indexers, self.shape, self._chunks)]
    out_shape = tuple(
        sum((s.stop - s.start) if isinstance(s, slice) else len(s)
            for _, _, s in plan)
        for plan in plans)
    out = np.empty(out_shape, self.dtype)
    if 0 in out_shape:
      return out

    combos = list(itertools.product(*plans))
    if (len(combos) == 1 and out_shape == self._chunks
        and all(isinstance(src, slice) and abs(src.step or 1) == 1
                for _, src, _ in combos[0])):
      # The window is one whole cell (each axis its full extent, in order
      # or reversed): decoded straight into the output, a reversed axis
      # then flipped in place, with no staging block.
      (combo,) = combos
      self._load_cells([tuple(x[0] for x in combo)], [out])
      for axis, (_, src, _) in enumerate(combo):
        if (src.step or 1) < 0:
          lazy.flip_in_place(out, axis)
      return out
    blocks = self._load_cells([tuple(x[0] for x in combo)
                               for combo in combos])
    for combo, block in zip(combos, blocks):
      src = tuple(x[1] for x in combo)
      dst = tuple(x[2] for x in combo)
      if all(isinstance(s, slice) for s in src):
        out[dst] = block[src]
      else:
        # Rare non-contiguous axes: orthogonal fancy scatter.
        to_idx = lambda s, m: (np.arange(m, dtype=np.intp)[s]
                               if isinstance(s, slice) else s)
        src_ix = np.ix_(*[to_idx(s, m) for s, m in zip(src, self._chunks)])
        dst_ix = np.ix_(*[to_idx(d, m) for d, m in zip(dst, out_shape)])
        out[dst_ix] = block[src_ix]
    return out


def _decode_cf_time(values: np.ndarray, attrs: dict) -> np.ndarray:
  units = attrs.get('units', '')
  scale = {'nanoseconds': 1, 'microseconds': 10**3, 'milliseconds': 10**6,
           'seconds': 10**9, 'minutes': 60 * 10**9, 'hours': 3600 * 10**9,
           'days': 86400 * 10**9}

  def to_ns(vals, unit):
    # Float-encoded CF time (xarray frequently writes e.g. float64 'days
    # since ...'). Scale the integer part in int64 — multiplying e.g.
    # microseconds-since-epoch by 1000 in float64 exceeds 2^53 and
    # perturbs timestamps by hundreds of ns — and the fractional part
    # (0.25 days etc.) in float with rounding.
    if vals.dtype.kind == 'f':
      nat = np.int64(np.iinfo(np.int64).min)  # NaT encodes as min-int64
      # NaN is how xarray encodes NaT in float 'units since' coords; mask
      # it out explicitly — floor(NaN).astype(int64) is a platform-defined
      # cast (RuntimeWarnings, wrong epoch for scale-1 'nanoseconds').
      nan_mask = np.isnan(vals)
      finite = np.where(nan_mask, 0.0, vals)
      whole = np.floor(finite)
      frac_ns = np.rint((finite - whole) * float(scale[unit]))
      out = (whole.astype(np.int64) * scale[unit]
             + frac_ns.astype(np.int64))
      return np.where(nan_mask | (whole == np.float64(nat)), nat, out)
    ints = vals.astype(np.int64)
    s = scale[unit]
    if s > 1 and ints.size:
      # Coarse units far from the epoch overflow int64 nanoseconds; raise
      # (like xarray's out-of-range ns conversion) rather than silently
      # wrapping into wrong-era timestamps. min-int64 is the NaT sentinel
      # and passes through.
      nat = np.int64(np.iinfo(np.int64).min)
      finite = np.where(ints == nat, 0, ints)
      lim = np.iinfo(np.int64).max // s
      if int(finite.max()) > lim or int(finite.min()) < -lim:
        raise OverflowError(
            f'CF time values in {unit!r} exceed the datetime64[ns] range '
            '(~years 1678-2262); cannot decode without overflow')
      return np.where(ints == nat, nat, finite * s)
    return ints * s

  if ' since ' in units:
    unit, origin = units.split(' since ', 1)
    if unit not in scale:
      return values
    base = np.datetime64(origin.strip().replace(' ', 'T'), 'ns')
    return base + to_ns(values, unit) * np.timedelta64(1, 'ns')
  if units in scale and values.dtype.kind in 'iuf':
    return to_ns(values, units) * np.timedelta64(1, 'ns')
  return values


_V3_BLOSC_SHUFFLE = {'noshuffle': 0, 'shuffle': 1, 'bitshuffle': 2}


def _parse_v3_codecs(codec_list: list, name: str,
                     in_shard: bool = False) -> tuple:
  """(compressor-config, endian, sharding-config|None) for a v3 codec
  chain. ``in_shard`` parses a sharding codec's INNER chain, where a
  nested sharding level is rejected (one level covers the public stores;
  the spec allows arbitrary nesting)."""
  comp = None
  endian = 'little'
  sharding = None
  for codec in codec_list:
    cname, cfg = codec.get('name'), codec.get('configuration') or {}
    if cname == 'bytes':
      endian = cfg.get('endian', 'little')
    elif cname == 'blosc':
      comp = {'id': 'blosc', 'cname': cfg.get('cname', 'lz4'),
              'clevel': cfg.get('clevel', 5),
              'shuffle': _V3_BLOSC_SHUFFLE.get(cfg.get('shuffle'), 0),
              'blocksize': cfg.get('blocksize', 0)}
    elif cname == 'zstd':
      comp = {'id': 'zstd', 'level': cfg.get('level', 0)}
    elif cname == 'gzip':
      comp = {'id': 'gzip', 'level': cfg.get('level', 5)}
    elif cname == 'sharding_indexed':
      if in_shard:
        raise ValueError(f'{name}: nested zarr v3 sharding is not '
                         'supported (one level only)')
      comp, endian, _ = _parse_v3_codecs(cfg.get('codecs', []), name,
                                         in_shard=True)
      # Index codecs: 16-byte little-endian (offset, nbytes) pairs per
      # inner chunk, optionally followed by a crc32c checksum — the
      # zarr-python default chain is ["bytes", "crc32c"].
      checksum = False
      for icodec in cfg.get('index_codecs', [{'name': 'bytes'}]):
        iname = icodec.get('name')
        icfg = icodec.get('configuration') or {}
        if iname == 'bytes':
          if icfg.get('endian', 'little') != 'little':
            raise ValueError(f'{name}: big-endian shard index')
        elif iname == 'crc32c':
          checksum = True
        else:
          raise ValueError(
              f'{name}: shard index codec {iname!r} is not supported')
      loc = cfg.get('index_location', 'end')
      if loc not in ('start', 'end'):
        raise ValueError(f'{name}: bad shard index_location {loc!r}')
      sharding = {'inner_chunks': [int(c) for c in cfg['chunk_shape']],
                  'index_location': loc, 'index_checksum': checksum}
    else:
      raise ValueError(f'{name}: zarr v3 codec {cname!r} is not supported')
  return comp, endian, sharding


def _normalize_v3_array(meta: dict, name: str) -> tuple[dict, dict]:
  """Maps zarr v3 array metadata (<array>/zarr.json) onto the v2-shaped
  dict ZarrChunkSource consumes, plus xarray-convention attrs.

  Covers the v3 core spec surface new public stores actually use: regular
  chunk grids, default/v2 chunk key encodings, the bytes codec (either
  endian), one optional blosc/zstd/gzip compression codec, and the
  ``sharding_indexed`` codec (one level): the inner chunk grid becomes the
  effective read grid, and cell loads resolve through the per-shard index
  (see :class:`ZarrChunkSource`).
  """
  grid = meta.get('chunk_grid', {})
  if grid.get('name') != 'regular':
    raise ValueError(f'{name}: zarr v3 chunk grid {grid.get("name")!r} is '
                     'not supported (regular only)')
  dtype = np.dtype(meta['data_type'])
  comp, endian, sharding = _parse_v3_codecs(meta.get('codecs', []), name)
  if endian == 'big' and dtype.itemsize > 1:
    dtype = dtype.newbyteorder('>')
  kce = meta.get('chunk_key_encoding', {}) or {}
  kce_name = kce.get('name', 'default')
  kce_cfg = kce.get('configuration') or {}
  if kce_name not in ('default', 'v2'):
    raise ValueError(f'{name}: unknown chunk key encoding {kce_name!r}')
  outer_chunks = [int(c) for c in grid['configuration']['chunk_shape']]
  if sharding is not None:
    inner = sharding['inner_chunks']
    if len(inner) != len(outer_chunks) or any(
        o % i for o, i in zip(outer_chunks, inner)):
      raise ValueError(
          f'{name}: shard shape {outer_chunks} is not a multiple of the '
          f'inner chunk shape {inner}')
    sharding = dict(sharding, shard_chunks=outer_chunks)
    chunks = inner  # the grid windows actually read
  else:
    chunks = outer_chunks
  zarray = {
      'zarr_format': 3,
      'shape': list(meta['shape']),
      'chunks': chunks,
      'dtype': dtype.str,
      'compressor': comp,
      'fill_value': meta.get('fill_value'),
      'order': 'C',
      'filters': None,
      'dimension_separator': kce_cfg.get(
          'separator', '/' if kce_name == 'default' else '.'),
      'key_encoding': kce_name,
  }
  if sharding is not None:
    zarray['sharding'] = sharding
  attrs = dict(meta.get('attributes') or {})
  dim_names = meta.get('dimension_names')
  if dim_names and '_ARRAY_DIMENSIONS' not in attrs:
    attrs['_ARRAY_DIMENSIONS'] = [
        d if d is not None else f'dim_{i}' for i, d in enumerate(dim_names)]
  return zarray, attrs


def _read_v3_store_metadata(path: str) -> dict[str, dict]:
  metadata: dict[str, dict] = {}
  for entry in fileio.listdir(path):
    adir = os.path.join(path, entry)
    zjson = os.path.join(adir, 'zarr.json')
    if not fileio.isdir(adir) or not fileio.exists(zjson):
      continue
    meta = json.loads(fileio.read_text(zjson))
    if meta.get('node_type') != 'array':
      continue
    zarray, attrs = _normalize_v3_array(meta, entry)
    metadata[f'{entry}/.zarray'] = zarray
    metadata[f'{entry}/.zattrs'] = attrs
  return metadata


def _read_store_metadata(path: str) -> dict[str, dict]:
  v3_root = os.path.join(path, 'zarr.json')
  if fileio.exists(v3_root):
    root = json.loads(fileio.read_text(v3_root))
    if root.get('zarr_format') == 3:
      return _read_v3_store_metadata(path)
  zmeta = os.path.join(path, '.zmetadata')
  if fileio.exists(zmeta):
    return json.loads(fileio.read_text(zmeta))['metadata']
  metadata: dict[str, dict] = {}
  for entry in fileio.listdir(path):
    adir = os.path.join(path, entry)
    zarray = os.path.join(adir, '.zarray')
    if not fileio.isdir(adir) or not fileio.exists(zarray):
      continue
    metadata[f'{entry}/.zarray'] = json.loads(fileio.read_text(zarray))
    zattrs = os.path.join(adir, '.zattrs')
    if fileio.exists(zattrs):
      metadata[f'{entry}/.zattrs'] = json.loads(fileio.read_text(zattrs))
  return metadata


def open_dataset_zarr(path: str) -> dict[str, DimArray]:
  """Opens a Zarr v2 or v3 store lazily (coords eager, data windowed):
  a local path or an fsspec URL.

  Dimension names come from the xarray ``_ARRAY_DIMENSIONS`` convention;
  arrays named after one of their dims (or referenced via a ``coordinates``
  attr) become coordinates, everything else a data variable.
  """
  metadata = _read_store_metadata(path)
  arrays: dict[str, tuple[ZarrChunkSource, tuple, dict]] = {}
  for key, zarray in metadata.items():
    if not key.endswith('/.zarray'):
      continue
    name = key[:-len('/.zarray')]
    attrs = metadata.get(f'{name}/.zattrs', {})
    dims = tuple(attrs.get('_ARRAY_DIMENSIONS',
                           [f'dim_{i}' for i in range(len(zarray['shape']))]))
    arrays[name] = (ZarrChunkSource(os.path.join(path, name), zarray),
                    dims, attrs)

  coord_names = cf.infer_coord_names(arrays)
  coords_all = {}
  for cname in coord_names:
    src, cdims, cattrs = arrays[cname]
    vals = _decode_cf_time(np.asarray(lazy.LazyArray(src)), cattrs)
    coords_all[cname] = Coord(cdims, vals)

  out: dict[str, DimArray] = {}
  for name, (src, dims, attrs) in arrays.items():
    if name in coord_names:
      continue
    out[name] = DimArray(lazy.LazyArray(src), dims,
                         cf.subset_coords(coords_all, dims))
  return out
