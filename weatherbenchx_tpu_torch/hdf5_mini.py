"""Minimal pure-Python HDF5 reader for netCDF4-flavored flat files.

The port of ``weatherbenchx_tpu/hdf5_mini.py``. The reference serializes
AggregationStates and metric results as netCDF, commonly netCDF4, i.e.
HDF5 (reference ``aggregation.py:227-258`` via xarray/netCDF4). The port's
``netcdf_io`` reads those through this module alone, so reference-written
``.nc`` files load without h5py.

Scope (sufficient for libnetcdf/h5py-written flat datasets; anything
outside it raises a clear error rather than guessing):

* superblock v0/v1 (symbol-table root group) and v2/v3 (root object
  header address);
* object headers v1 and v2 ('OHDR'), with continuation blocks;
* old-style groups (v1 B-tree + SNOD symbol nodes + local heap) and
  compact new-style groups (link messages; dense fractal-heap groups are
  rejected);
* dataspace v1/v2; datatypes: fixed-point, IEEE float, fixed and vlen
  strings, object references; fill value ignored (datasets written by
  the targeted writers are fully materialized);
* data layout v3: compact, contiguous, and chunked (v1 B-tree), with
  deflate and shuffle filters (+ fletcher32 checksum stripping);
* attributes v1/v2/v3 including vlen payloads through the global heap
  (DIMENSION_LIST's vlen-of-object-references in particular).

Only little-endian files are supported (HDF5 metadata is always LE;
big-endian DATA elements are byteswapped on read).
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Optional

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEFINED = 0xFFFFFFFFFFFFFFFF


class Hdf5FormatError(ValueError):
  pass


class _Buf:
  """Cursor-free little-endian struct reads over the whole file bytes."""

  def __init__(self, data: bytes):
    self.data = data

  def u(self, off: int, size: int) -> int:
    return int.from_bytes(self.data[off:off + size], 'little')

  def bytes(self, off: int, size: int) -> bytes:
    return self.data[off:off + size]

  def cstr(self, off: int) -> bytes:
    end = self.data.index(b'\x00', off)
    return self.data[off:end]


class Dataset:
  """One decoded dataset: lazy-ish value + raw attribute mapping."""

  def __init__(self, name: str, data: np.ndarray, attrs: dict,
               header_addr: int):
    self.name = name
    self.data = data
    self.attrs = attrs
    self.header_addr = header_addr


class _ObjectHeader:
  __slots__ = ('messages',)

  def __init__(self):
    self.messages: list[tuple[int, bytes]] = []  # (type, body)


def _parse_v1_header(buf: _Buf, addr: int, so: int, sl: int):
  hdr = _ObjectHeader()
  nmsgs = buf.u(addr + 2, 2)
  block_size = buf.u(addr + 8, 4)
  blocks = [(addr + 16, block_size)]
  got = 0
  while blocks and got < nmsgs:
    off, size = blocks.pop(0)
    end = off + size
    while off + 8 <= end and got < nmsgs:
      mtype = buf.u(off, 2)
      msize = buf.u(off + 2, 2)
      body = buf.bytes(off + 8, msize)
      off += 8 + msize
      off = (off + 7) & ~7 if False else off  # v1 sizes are pre-aligned
      got += 1
      if mtype == 0x10:  # continuation
        blocks.append((int.from_bytes(body[:so], 'little'),
                       int.from_bytes(body[so:so + sl], 'little')))
      else:
        hdr.messages.append((mtype, body))
  return hdr


def _parse_v2_header(buf: _Buf, addr: int, so: int, sl: int):
  if buf.bytes(addr, 4) != b'OHDR':
    raise Hdf5FormatError(f'bad v2 object header at {addr:#x}')
  flags = buf.u(addr + 5, 1)
  off = addr + 6
  if flags & 0x20:
    off += 16  # access/mod/change/birth times (4 x 4 bytes)
  if flags & 0x10:
    off += 4  # max compact / min dense attributes
  chunk0_len_size = 1 << (flags & 0x3)
  chunk0 = buf.u(off, chunk0_len_size)
  off += chunk0_len_size
  hdr = _ObjectHeader()
  creation_tracked = bool(flags & 0x4)
  blocks = [(off, chunk0)]
  while blocks:
    off, size = blocks.pop(0)
    end = off + size
    while off + 4 <= end:
      mtype = buf.u(off, 1)
      msize = buf.u(off + 1, 2)
      off += 4
      if creation_tracked:
        off += 2
      body = buf.bytes(off, msize)
      off += msize
      if mtype == 0x10:
        caddr = int.from_bytes(body[:so], 'little')
        clen = int.from_bytes(body[so:so + sl], 'little')
        if buf.bytes(caddr, 4) != b'OCHK':
          raise Hdf5FormatError('bad continuation block signature')
        blocks.append((caddr + 4, clen - 8))  # minus signature + checksum
      else:
        hdr.messages.append((mtype, body))
  return hdr


def _parse_header(buf: _Buf, addr: int, so: int, sl: int) -> _ObjectHeader:
  if buf.bytes(addr, 4) == b'OHDR':
    return _parse_v2_header(buf, addr, so, sl)
  if buf.u(addr, 1) == 1:
    return _parse_v1_header(buf, addr, so, sl)
  raise Hdf5FormatError(f'unknown object header version at {addr:#x}')


class _Datatype:
  __slots__ = ('cls', 'size', 'dtype', 'vlen_base', 'vlen_is_string',
               'str_pad')

  def __init__(self):
    self.cls = -1
    self.size = 0
    self.dtype: Optional[np.dtype] = None
    self.vlen_base: Optional['_Datatype'] = None
    self.vlen_is_string = False
    self.str_pad = 0


def _parse_datatype(body: bytes) -> _Datatype:
  dt = _Datatype()
  cls_ver = body[0]
  dt.cls = cls_ver & 0x0F
  bits0 = body[1]
  dt.size = int.from_bytes(body[4:8], 'little')
  if dt.cls == 0:  # fixed-point
    signed = bool(bits0 & 0x08)
    endian = '>' if (bits0 & 0x01) else '<'
    dt.dtype = np.dtype(f'{endian}{"i" if signed else "u"}{dt.size}')
  elif dt.cls == 1:  # IEEE float
    endian = '>' if (bits0 & 0x01) else '<'
    dt.dtype = np.dtype(f'{endian}f{dt.size}')
  elif dt.cls == 3:  # fixed-length string
    dt.dtype = np.dtype(f'S{dt.size}')
    dt.str_pad = bits0 & 0x0F
  elif dt.cls == 7:  # reference
    dt.dtype = np.dtype(f'<u{dt.size}')
  elif dt.cls == 9:  # variable-length
    dt.vlen_is_string = (bits0 & 0x0F) == 1
    dt.vlen_base = _parse_datatype(body[8:])
  else:
    raise Hdf5FormatError(f'unsupported HDF5 datatype class {dt.cls}')
  return dt


def _parse_dataspace(body: bytes, sl: int) -> tuple:
  version = body[0]
  rank = body[1]
  if version == 1:
    off = 8
  elif version == 2:
    off = 4
  else:
    raise Hdf5FormatError(f'unsupported dataspace version {version}')
  dims = tuple(int.from_bytes(body[off + i * sl: off + (i + 1) * sl],
                              'little') for i in range(rank))
  return dims


def _read_global_heap_object(buf: _Buf, collection_addr: int, index: int,
                             sl: int) -> bytes:
  if buf.bytes(collection_addr, 4) != b'GCOL':
    raise Hdf5FormatError(f'bad global heap at {collection_addr:#x}')
  total = buf.u(collection_addr + 8, sl)
  off = collection_addr + 8 + sl
  end = collection_addr + total
  while off + 8 + sl <= end:
    obj_index = buf.u(off, 2)
    obj_size = buf.u(off + 8, sl)
    data_off = off + 8 + sl
    if obj_index == 0:  # free space object terminates the walk
      break
    if obj_index == index:
      return buf.bytes(data_off, obj_size)
    off = data_off + ((obj_size + 7) & ~7)
  raise Hdf5FormatError(
      f'global heap object {index} not found at {collection_addr:#x}')


def _decode_vlen(buf: _Buf, raw: bytes, dt: _Datatype, count: int,
                 so: int, sl: int) -> list:
  out = []
  for i in range(count):
    off = i * (4 + so + 4)
    n = int.from_bytes(raw[off:off + 4], 'little')
    coll = int.from_bytes(raw[off + 4:off + 4 + so], 'little')
    idx = int.from_bytes(raw[off + 4 + so:off + 8 + so], 'little')
    if coll in (0, UNDEFINED) and idx == 0:
      out.append(b'' if dt.vlen_is_string else np.array([]))
      continue
    payload = _read_global_heap_object(buf, coll, idx, sl)
    if dt.vlen_is_string:
      out.append(payload[:n])
    else:
      base = dt.vlen_base
      out.append(np.frombuffer(payload, base.dtype, count=n)
                 if base.dtype else payload)
  return out


def _decode_elements(buf: _Buf, raw: bytes, dt: _Datatype, dims: tuple,
                     so: int, sl: int):
  count = int(np.prod(dims, dtype=np.int64)) if dims else 1
  if dt.cls == 9:
    vals = _decode_vlen(buf, raw, dt, count, so, sl)
    if dt.vlen_is_string:
      arr = np.array([v.decode('utf-8', 'replace') for v in vals],
                     dtype=object)
    else:
      arr = np.empty(count, dtype=object)
      for i, v in enumerate(vals):
        arr[i] = v
    return arr.reshape(dims)
  arr = np.frombuffer(raw, dt.dtype, count=count).reshape(dims)
  if arr.dtype.byteorder == '>':
    arr = arr.astype(arr.dtype.newbyteorder('='))
  return arr


def _parse_attribute(buf: _Buf, body: bytes, so: int, sl: int):
  version = body[0]
  if version == 1:
    name_size = int.from_bytes(body[2:4], 'little')
    dt_size = int.from_bytes(body[4:6], 'little')
    ds_size = int.from_bytes(body[6:8], 'little')
    off = 8
    pad = lambda n: (n + 7) & ~7
    name = body[off:off + name_size].split(b'\x00')[0]
    off += pad(name_size)
    dt = _parse_datatype(body[off:off + dt_size])
    off += pad(dt_size)
    dims = _parse_dataspace(body[off:off + ds_size], sl)
    off += pad(ds_size)
  elif version in (2, 3):
    name_size = int.from_bytes(body[2:4], 'little')
    dt_size = int.from_bytes(body[4:6], 'little')
    ds_size = int.from_bytes(body[6:8], 'little')
    off = 8 + (1 if version == 3 else 0)
    name = body[off:off + name_size].split(b'\x00')[0]
    off += name_size
    dt = _parse_datatype(body[off:off + dt_size])
    off += dt_size
    dims = _parse_dataspace(body[off:off + ds_size], sl)
    off += ds_size
  else:
    raise Hdf5FormatError(f'unsupported attribute version {version}')
  value = _decode_elements(buf, body[off:], dt, dims, so, sl)
  if dt.cls == 3 and value.shape == ():
    value = value[()]  # scalar bytes
  elif value.shape == ():
    value = value[()]
  return name.decode(), value, dt


def _parse_filters(body: bytes) -> list[tuple[int, list[int]]]:
  version = body[0]
  nfilters = body[1]
  filters = []
  if version == 1:
    off = 8
  else:
    off = 2
  for _ in range(nfilters):
    fid = int.from_bytes(body[off:off + 2], 'little')
    off += 2
    name_len = 0
    if version == 1 or fid >= 256:
      # v2 omits the name length (and name) for built-in filters (<256).
      name_len = int.from_bytes(body[off:off + 2], 'little')
      off += 2
    ncv = int.from_bytes(body[off + 2:off + 4], 'little')
    off += 4  # flags + number of client values
    if name_len:
      off += (name_len + 7) & ~7 if version == 1 else name_len
    cvals = [int.from_bytes(body[off + 4 * i:off + 4 * i + 4], 'little')
             for i in range(ncv)]
    off += 4 * ncv
    if version == 1 and ncv % 2 == 1:
      off += 4
    filters.append((fid, cvals))
  return filters


def _apply_filters(raw: bytes, filters, itemsize: int) -> bytes:
  # Stored order is forward; decoding applies them in reverse.
  for fid, cvals in reversed(filters):
    if fid == 1:  # deflate
      raw = zlib.decompress(raw)
    elif fid == 2:  # shuffle
      n = cvals[0] if cvals else itemsize
      arr = np.frombuffer(raw, np.uint8)
      extra = len(raw) % n
      body = arr[:len(raw) - extra].reshape(n, -1).T.reshape(-1)
      raw = body.tobytes() + raw[len(raw) - extra:]
    elif fid == 3:  # fletcher32: payload + 4-byte checksum
      raw = raw[:-4]
    else:
      raise Hdf5FormatError(f'unsupported HDF5 filter id {fid}')
  return raw


def _walk_chunk_btree(buf: _Buf, addr: int, ndim: int, so: int, sl: int):
  """Yields (chunk_offsets, filtered_size, filter_mask, data_addr)."""
  if addr == UNDEFINED:
    return
  if buf.bytes(addr, 4) != b'TREE':
    raise Hdf5FormatError(f'bad chunk B-tree node at {addr:#x}')
  level = buf.u(addr + 5, 1)
  nentries = buf.u(addr + 6, 2)
  off = addr + 8 + 2 * so  # skip left/right sibling
  # key: chunk size(4) + filter mask(4) + ndim 8-byte offsets (the caller
  # passes dimensionality INCLUDING the trailing element-size dimension).
  key_size = 8 + 8 * ndim
  for _ in range(nentries):
    chunk_size = buf.u(off, 4)
    fmask = buf.u(off + 4, 4)
    offsets = tuple(buf.u(off + 8 + 8 * i, 8) for i in range(ndim))
    child = buf.u(off + key_size, so)
    if level == 0:
      yield offsets, chunk_size, fmask, child
    else:
      yield from _walk_chunk_btree(buf, child, ndim, so, sl)
    off += key_size + so


def _read_dataset_data(buf: _Buf, hdr: _ObjectHeader, dt: _Datatype,
                       dims: tuple, so: int, sl: int) -> np.ndarray:
  layout = None
  filters: list = []
  for mtype, body in hdr.messages:
    if mtype == 0x0008:
      layout = body
    elif mtype == 0x000B:
      filters = _parse_filters(body)
  if layout is None:
    raise Hdf5FormatError('dataset without a data layout message')
  version = layout[0]
  if version == 4:
    return _read_v4_layout(buf, layout, dt, dims, filters, so, sl)
  if version != 3:
    raise Hdf5FormatError(f'unsupported data layout version {version} '
                          '(v3 expected; rewrite with default settings)')
  lclass = layout[1]
  if dt.cls == 9:
    if lclass != 1:
      raise Hdf5FormatError('vlen datasets supported as contiguous only')
  itemsize = dt.size
  count = int(np.prod(dims, dtype=np.int64)) if dims else 1
  if lclass == 0:  # compact
    size = int.from_bytes(layout[2:4], 'little')
    raw = layout[4:4 + size]
    return _decode_elements(buf, raw, dt, dims, so, sl)
  if lclass == 1:  # contiguous
    addr = int.from_bytes(layout[2:2 + so], 'little')
    if addr == UNDEFINED:
      raise Hdf5FormatError('contiguous dataset with no allocated storage')
    raw = buf.bytes(addr, count * itemsize)
    return _decode_elements(buf, raw, dt, dims, so, sl)
  if lclass == 2:  # chunked, v1 B-tree indexed
    ndim_plus1 = layout[2]
    btree = int.from_bytes(layout[3:3 + so], 'little')
    cdims = tuple(int.from_bytes(
        layout[3 + so + 4 * i:3 + so + 4 * (i + 1)], 'little')
        for i in range(ndim_plus1))
    chunk_shape = cdims[:-1]  # last entry is the element size
    out = np.zeros(dims, dt.dtype)
    for offsets, csize, fmask, daddr in _walk_chunk_btree(
        buf, btree, ndim_plus1, so, sl):
      raw = buf.bytes(daddr, csize)
      if filters and fmask != (1 << len(filters)) - 1:
        active = [f for i, f in enumerate(filters) if not (fmask >> i) & 1]
        raw = _apply_filters(raw, active, itemsize)
      block = np.frombuffer(raw, dt.dtype,
                            count=int(np.prod(chunk_shape))
                            ).reshape(chunk_shape)
      sel = tuple(slice(o, min(o + c, s))
                  for o, c, s in zip(offsets[:-1], chunk_shape, dims))
      out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    if out.dtype.byteorder == '>':
      out = out.astype(out.dtype.newbyteorder('='))
    return out
  raise Hdf5FormatError(f'unsupported data layout class {lclass}')


def _read_v4_layout(buf: _Buf, layout: bytes, dt: _Datatype, dims: tuple,
                    filters, so: int, sl: int) -> np.ndarray:
  """Data layout message v4 (written with libver='latest'): contiguous,
  single-chunk, and implicit chunk indexes. Fixed/extensible-array and
  v2-B-tree chunk indexes are rejected with a pointer to default
  settings (libnetcdf and default h5py write v3)."""
  lclass = layout[1]
  count = int(np.prod(dims, dtype=np.int64)) if dims else 1
  if lclass == 0:
    size = int.from_bytes(layout[2:4], 'little')
    return _decode_elements(buf, layout[4:4 + size], dt, dims, so, sl)
  if lclass == 1:
    addr = int.from_bytes(layout[2:2 + so], 'little')
    raw = buf.bytes(addr, count * dt.size)
    return _decode_elements(buf, raw, dt, dims, so, sl)
  if lclass != 2:
    raise Hdf5FormatError(f'unsupported v4 layout class {lclass}')
  flags = layout[2]
  ndims = layout[3]
  enc = layout[4]
  off = 5
  cdims = tuple(int.from_bytes(layout[off + i * enc:off + (i + 1) * enc],
                               'little') for i in range(ndims))
  off += ndims * enc
  index_type = layout[off]
  off += 1
  chunk_shape = cdims[:-1] if len(cdims) == len(dims) + 1 else cdims
  if index_type == 1:  # single chunk
    filtered_size = None
    if flags & 0x2:
      filtered_size = int.from_bytes(layout[off:off + sl], 'little')
      off += sl + 4  # + filter mask
    addr = int.from_bytes(layout[off:off + so], 'little')
    nbytes = filtered_size if filtered_size is not None else \
        int(np.prod(chunk_shape, dtype=np.int64)) * dt.size
    raw = buf.bytes(addr, nbytes)
    if filters and filtered_size is not None:
      raw = _apply_filters(raw, filters, dt.size)
    block = np.frombuffer(raw, dt.dtype,
                          count=int(np.prod(chunk_shape))).reshape(
                              chunk_shape)
    out = block[tuple(slice(0, s) for s in dims)]
    if out.dtype.byteorder == '>':
      out = out.astype(out.dtype.newbyteorder('='))
    return np.ascontiguousarray(out)
  if index_type == 2:  # implicit: dense chunk grid, unfiltered
    addr = int.from_bytes(layout[off:off + so], 'little')
    out = np.zeros(dims, dt.dtype)
    grid = [max(-(-d // c), 1) for d, c in zip(dims, chunk_shape)]
    chunk_nbytes = int(np.prod(chunk_shape, dtype=np.int64)) * dt.size
    for i, cell in enumerate(np.ndindex(*grid)):
      raw = buf.bytes(addr + i * chunk_nbytes, chunk_nbytes)
      block = np.frombuffer(raw, dt.dtype).reshape(chunk_shape)
      sel = tuple(slice(o * c, min((o + 1) * c, s))
                  for o, c, s in zip(cell, chunk_shape, dims))
      out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    if out.dtype.byteorder == '>':
      out = out.astype(out.dtype.newbyteorder('='))
    return out
  if index_type == 3:  # fixed array
    off += 1  # page bits
    addr = int.from_bytes(layout[off:off + so], 'little')
    out = np.zeros(dims, dt.dtype)
    grid = [max(-(-d // c), 1) for d, c in zip(dims, chunk_shape)]
    chunk_nbytes = int(np.prod(chunk_shape, dtype=np.int64)) * dt.size
    entries = _read_fixed_array(buf, addr, so, sl)
    for cell, (caddr, csize, fmask) in zip(np.ndindex(*grid), entries):
      if caddr == UNDEFINED:
        continue
      raw = buf.bytes(caddr, csize if csize else chunk_nbytes)
      if filters and csize:
        active = [f for i, f in enumerate(filters) if not (fmask >> i) & 1]
        raw = _apply_filters(raw, active, dt.size)
      block = np.frombuffer(raw, dt.dtype,
                            count=int(np.prod(chunk_shape))).reshape(
                                chunk_shape)
      sel = tuple(slice(o * c, min((o + 1) * c, s))
                  for o, c, s in zip(cell, chunk_shape, dims))
      out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    if out.dtype.byteorder == '>':
      out = out.astype(out.dtype.newbyteorder('='))
    return out
  raise Hdf5FormatError(
      f'unsupported v4 chunk index type {index_type} (extensible '
      'arrays, v2 B-trees); rewrite with default library settings')


def _read_fixed_array(buf: _Buf, addr: int, so: int, sl: int):
  """Fixed Array chunk index: [(chunk addr, filtered size or 0, mask)].

  Unpaged data blocks only (paged blocks appear above 2^page_bits
  entries; the targeted writers stay far below that for typical stores).
  """
  if buf.bytes(addr, 4) != b'FAHD':
    raise Hdf5FormatError(f'bad fixed-array header at {addr:#x}')
  client_id = buf.u(addr + 5, 1)
  entry_size = buf.u(addr + 6, 1)
  page_bits = buf.u(addr + 7, 1)
  nentries = buf.u(addr + 8, sl)
  dblock = buf.u(addr + 8 + sl, so)
  if buf.bytes(dblock, 4) != b'FADB':
    raise Hdf5FormatError(f'bad fixed-array data block at {dblock:#x}')
  if nentries > (1 << page_bits):
    raise Hdf5FormatError('paged fixed-array chunk index not supported')
  off = dblock + 6 + so
  out = []
  for _ in range(nentries):
    caddr = buf.u(off, so)
    if client_id == 0:  # non-filtered: address only
      out.append((caddr, 0, 0))
      off += entry_size
    else:  # filtered: address + chunk size + filter mask
      size_len = entry_size - so - 4
      csize = buf.u(off + so, size_len)
      fmask = buf.u(off + so + size_len, 4)
      out.append((caddr, csize, fmask))
      off += entry_size
  return out


def _iter_group_links(buf: _Buf, hdr: _ObjectHeader, so: int, sl: int):
  """Yields (name, object header address) for a group's children."""
  for mtype, body in hdr.messages:
    if mtype == 0x0011:  # symbol table (old-style group)
      btree = int.from_bytes(body[:so], 'little')
      heap = int.from_bytes(body[so:2 * so], 'little')
      yield from _iter_symbol_btree(buf, btree, heap, so, sl)
    elif mtype == 0x0006:  # link message (compact new-style group)
      version, flags = body[0], body[1]
      off = 2
      if flags & 0x08:
        ltype = body[off]
        off += 1
        if ltype != 0:
          continue  # only hard links carry a header address
      if flags & 0x04:
        off += 8  # creation order
      if flags & 0x10:
        off += 1  # charset
      lsize = 1 << (flags & 0x3)
      name_len = int.from_bytes(body[off:off + lsize], 'little')
      off += lsize
      name = body[off:off + name_len]
      off += name_len
      addr = int.from_bytes(body[off:off + so], 'little')
      yield name.decode(), addr
    elif mtype == 0x0002:  # link info: dense storage unsupported
      fheap = int.from_bytes(body[2 + (8 if body[1] & 1 else 0):][:so],
                             'little')
      if fheap != UNDEFINED:
        raise Hdf5FormatError(
            'dense (fractal-heap) group links are not supported by the '
            'fallback reader')


def _iter_symbol_btree(buf: _Buf, addr: int, heap: int, so: int, sl: int):
  if addr == UNDEFINED:
    return
  if buf.bytes(addr, 4) != b'TREE':
    raise Hdf5FormatError(f'bad group B-tree node at {addr:#x}')
  level = buf.u(addr + 5, 1)
  nentries = buf.u(addr + 6, 2)
  off = addr + 8 + 2 * so
  # entries: key(len), child(so), ..., key — children are SNOD or subtree
  for i in range(nentries):
    child = buf.u(off + sl, so)
    if level == 0:
      yield from _iter_symbol_node(buf, child, heap, so, sl)
    else:
      yield from _iter_symbol_btree(buf, child, heap, so, sl)
    off += sl + so


def _iter_symbol_node(buf: _Buf, addr: int, heap: int, so: int, sl: int):
  if buf.bytes(addr, 4) != b'SNOD':
    raise Hdf5FormatError(f'bad symbol node at {addr:#x}')
  nsyms = buf.u(addr + 6, 2)
  heap_data = _local_heap_data(buf, heap, so, sl)
  off = addr + 8
  entry_size = 2 * so + 4 + 4 + 16
  for _ in range(nsyms):
    name_off = buf.u(off, so)
    obj_addr = buf.u(off + so, so)
    name = buf.cstr(heap_data + name_off).decode()
    yield name, obj_addr
    off += entry_size


def _local_heap_data(buf: _Buf, addr: int, so: int, sl: int) -> int:
  if buf.bytes(addr, 4) != b'HEAP':
    raise Hdf5FormatError(f'bad local heap at {addr:#x}')
  return buf.u(addr + 8 + 2 * sl, so)


def read_flat(data: bytes) -> dict[str, Dataset]:
  """Decodes all root-level datasets of an HDF5 file given its bytes.

  Returns name → :class:`Dataset`; attrs hold decoded values, with
  object-reference attributes (e.g. DIMENSION_LIST) resolved to the
  NAMES of the referenced datasets.
  """
  buf = _Buf(data)
  if buf.bytes(0, 8) != SIGNATURE:
    raise Hdf5FormatError('not an HDF5 file')
  version = buf.u(8, 1)
  if version in (0, 1):
    so = buf.u(13, 1)
    sl = buf.u(14, 1)
    entry = 24 + 4 * so + (4 if version == 1 else 0)
    root_addr = buf.u(entry + so, so)
  elif version in (2, 3):
    so = buf.u(9, 1)
    sl = buf.u(10, 1)
    root_addr = buf.u(12 + 3 * so, so)
  else:
    raise Hdf5FormatError(f'unsupported superblock version {version}')

  root = _parse_header(buf, root_addr, so, sl)
  children = list(_iter_group_links(buf, root, so, sl))

  datasets: dict[str, Dataset] = {}
  addr_to_name: dict[int, str] = {}
  raw_attrs: dict[str, list] = {}
  for name, addr in children:
    hdr = _parse_header(buf, addr, so, sl)
    dt = dims = None
    attrs = []
    for mtype, body in hdr.messages:
      if mtype == 0x0003:
        dt = _parse_datatype(body)
      elif mtype == 0x0001:
        dims = _parse_dataspace(body, sl)
      elif mtype == 0x000C:
        try:
          attrs.append(_parse_attribute(buf, body, so, sl))
        except Hdf5FormatError:
          # Attributes with exotic datatypes (e.g. REFERENCE_LIST's
          # compound) aren't needed for netCDF semantics — skip them.
          pass
      elif mtype == 0x0015:  # attribute info: dense attributes unsupported
        fheap = int.from_bytes(body[2 + (2 if body[1] & 1 else 0):][:so],
                               'little')
        if fheap != UNDEFINED:
          raise Hdf5FormatError(
              'dense attribute storage is not supported by the fallback '
              'reader')
    if dt is None or dims is None:
      continue  # sub-group or datatype object: flat files only
    values = _read_dataset_data(buf, hdr, dt, dims, so, sl)
    datasets[name] = Dataset(name, values, {}, addr)
    addr_to_name[addr] = name
    raw_attrs[name] = attrs

  # Resolve attributes, mapping object references to dataset names.
  for name, ds in datasets.items():
    for aname, value, dt in raw_attrs[name]:
      if dt.cls == 7:  # direct reference array/scalar
        refs = np.atleast_1d(value)
        value = [addr_to_name.get(int(r), int(r)) for r in refs]
      elif dt.cls == 9 and not dt.vlen_is_string and dt.vlen_base is not None \
          and dt.vlen_base.cls == 7:
        flat = np.atleast_1d(value).ravel()
        value = [[addr_to_name.get(int(r), int(r)) for r in np.atleast_1d(v)]
                 for v in flat]
      ds.attrs[aname] = value
  return datasets


def read_flat_file(path: str) -> dict[str, Dataset]:
  with open(path, 'rb') as f:
    return read_flat(f.read())
