"""Chunk compression codecs for the self-contained Zarr reader/writer.

The port of ``weatherbenchx_tpu/codecs.py``, the same bytes in both
directions. The reference ecosystem's stores (ERA5, the WeatherBench model
outputs at gs://weatherbench2/...) are zarr v2 with numcodecs Blosc
compression (typically blosc-lz4 + byte shuffle), and the port needs
neither zarr nor numcodecs, so it carries its own codec layer:

* ``zlib``/``gzip`` via the stdlib;
* ``zstd`` via pyarrow's bundled codec (imported where it is used);
* ``blosc`` (the c-blosc1 chunk format used by numcodecs.Blosc): own
  framing (header parse, block starts, per-block split streams, byte
  shuffle), with the inner streams (lz4, zstd, zlib, snappy) delegated to
  pyarrow/stdlib.

Both directions are implemented so blosc round-trips are testable without
c-blosc itself. The native (C++) path, ``native/zarrcodec.cpp``, encodes
and decodes cells wherever it builds; this module is its reference form
and the fallback of a machine without a toolchain.

Blosc chunk format (c-blosc1 README_CHUNK_FORMAT.rst):
  header[16] = version, versionlz, flags, typesize,
               nbytes:i32le, blocksize:i32le, cbytes:i32le
  flags: 0x1 byte-shuffled | 0x2 pure-memcpy | 0x4 bit-shuffled |
         0x10 blocks-not-split | bits 5-7 = compressor
         (0 blosclz, 1 lz4/lz4hc, 2 snappy, 3 zlib, 4 zstd)
  non-memcpy payload: i32le bstarts[nblocks] (absolute chunk offsets),
  each block = concatenated streams, each stream = i32le csize + data
  (csize == uncompressed size marks a stored/uncompressed stream).
  A block is split into `typesize` streams when the not-split flag is
  clear; the trailing partial block is never split. Byte shuffle is
  applied per block: stream j holds byte-plane j of the block's elements.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

# c-blosc1 constants governing the historical (pre-flag) split rule.
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128

_BLOSC_COMPRESSORS = {0: 'blosclz', 1: 'lz4', 2: 'snappy', 3: 'zlib',
                      4: 'zstd'}
_BLOSC_CODES = {v: k for k, v in _BLOSC_COMPRESSORS.items()}

_FLAG_SHUFFLE = 0x1
_FLAG_MEMCPY = 0x2
_FLAG_BITSHUFFLE = 0x4
_FLAG_NOSPLIT = 0x10


_CRC32C_TABLE = None


def crc32c(data: bytes, crc: int = 0) -> int:
  """CRC-32C (Castagnoli, the zarr v3 `crc32c` codec / shard-index
  checksum). Table-driven pure Python — only ever run over tiny shard
  indexes (16 bytes per inner chunk + 4), never over chunk payloads."""
  global _CRC32C_TABLE
  if _CRC32C_TABLE is None:
    poly = 0x82F63B78  # reflected 0x1EDC6F41
    table = []
    for i in range(256):
      c = i
      for _ in range(8):
        c = (c >> 1) ^ poly if c & 1 else c >> 1
      table.append(c)
    _CRC32C_TABLE = table
  crc ^= 0xFFFFFFFF
  for b in data:
    crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _pa_codec(name: str):
  import pyarrow as pa
  return pa.Codec(name)


def _inner_decompress(name: str, data: bytes, out_size: int) -> bytes:
  if name == 'zlib':
    return zlib.decompress(data)
  if name == 'lz4':
    return _pa_codec('lz4_raw').decompress(data, out_size).to_pybytes()
  if name == 'zstd':
    return _pa_codec('zstd').decompress(data, out_size).to_pybytes()
  if name == 'snappy':
    return _pa_codec('snappy').decompress(data, out_size).to_pybytes()
  raise ValueError(f'blosc inner compressor {name!r} is not supported '
                   '(blosclz needs the real c-blosc)')


def _inner_compress(name: str, data: bytes, level: int) -> bytes:
  if name == 'zlib':
    return zlib.compress(data, level)
  if name == 'lz4':
    return _pa_codec('lz4_raw').compress(data).to_pybytes()
  if name == 'zstd':
    import pyarrow as pa
    return pa.Codec('zstd', compression_level=level).compress(
        data).to_pybytes()
  raise ValueError(f'unsupported blosc inner compressor {name!r}')


def _unshuffle(block: bytes, typesize: int) -> bytes:
  """Inverse byte shuffle: byte-planes back to interleaved elements."""
  n = len(block) // typesize
  planes = np.frombuffer(block[:n * typesize], np.uint8)
  out = planes.reshape(typesize, n).T.tobytes()
  return out + block[n * typesize:]


def _shuffle(block: bytes, typesize: int) -> bytes:
  n = len(block) // typesize
  elems = np.frombuffer(block[:n * typesize], np.uint8)
  out = elems.reshape(n, typesize).T.tobytes()
  return out + block[n * typesize:]


def blosc_decompress(chunk: bytes) -> bytes:
  """Decodes one c-blosc1 chunk (the numcodecs.Blosc payload)."""
  if len(chunk) < 16:
    raise ValueError('blosc chunk shorter than its 16-byte header')
  flags, typesize = chunk[2], chunk[3]
  nbytes, blocksize, cbytes = struct.unpack_from('<iii', chunk, 4)
  if flags & _FLAG_BITSHUFFLE:
    raise ValueError('blosc bit-shuffle filter is not supported')
  if nbytes == 0:
    return b''
  if flags & _FLAG_MEMCPY:
    return bytes(chunk[16:16 + nbytes])

  compressor = _BLOSC_COMPRESSORS.get((flags >> 5) & 0x7, 'unknown')
  nblocks = -(-nbytes // blocksize)
  bstarts = struct.unpack_from(f'<{nblocks}i', chunk, 16)
  shuffled = bool(flags & _FLAG_SHUFFLE) and typesize > 1

  out = bytearray(nbytes)
  for b in range(nblocks):
    bsize = min(blocksize, nbytes - b * blocksize)
    leftover = bsize != blocksize
    nsplits = _decode_nsplits(flags, typesize, bsize, leftover)
    neblock = bsize // nsplits
    pos = bstarts[b]
    parts = []
    for _ in range(nsplits):
      (csize,) = struct.unpack_from('<i', chunk, pos)
      pos += 4
      stream = chunk[pos:pos + csize]
      pos += csize
      if csize == neblock:
        parts.append(bytes(stream))
      else:
        parts.append(_inner_decompress(compressor, bytes(stream), neblock))
    block = b''.join(parts)
    if shuffled:
      block = _unshuffle(block, typesize)
    out[b * blocksize:b * blocksize + bsize] = block
  return out


def _decode_nsplits(flags: int, typesize: int, bsize: int,
                    leftover: bool) -> int:
  """Number of per-block streams, mirroring c-blosc1's decoder.

  Chunks that were written without splitting set flag 0x10; absence of
  the flag means split whenever the block was big enough to have been
  (which is also the rule ancient pre-flag writers followed)."""
  if leftover or typesize <= 1 or flags & _FLAG_NOSPLIT:
    return 1
  if typesize <= _MAX_SPLITS and bsize // typesize >= _MIN_BUFFERSIZE:
    return typesize
  return 1


def _choose_blocksize(nbytes: int, typesize: int) -> int:
  """A power-of-two-ish multiple of typesize; ~256 KB like c-blosc L2."""
  target = 1 << 18
  if nbytes <= target:
    bs = nbytes
  else:
    bs = target
  bs = max(bs - bs % typesize, typesize)
  return bs


def blosc_compress(data: bytes, typesize: int, cname: str = 'lz4',
                   level: int = 5, shuffle: bool = True) -> bytes:
  """Encodes one c-blosc1 chunk (decodable by real c-blosc/numcodecs)."""
  if cname not in _BLOSC_CODES or cname in ('blosclz', 'snappy'):
    raise ValueError(f'unsupported blosc compressor {cname!r}')
  nbytes = len(data)
  typesize = typesize if 0 < typesize <= 255 else 1
  if nbytes == 0:
    return struct.pack('<BBBBiii', 2, 0, _FLAG_MEMCPY, typesize, 0, 0, 16)

  blocksize = _choose_blocksize(nbytes, typesize)
  nblocks = -(-nbytes // blocksize)
  do_shuffle = shuffle and typesize > 1
  split = (cname == 'lz4' and typesize <= _MAX_SPLITS
           and blocksize // typesize >= _MIN_BUFFERSIZE)

  flags = (_BLOSC_CODES[cname] << 5)
  if do_shuffle:
    flags |= _FLAG_SHUFFLE
  if not split:
    flags |= _FLAG_NOSPLIT

  body = bytearray()
  bstarts = []
  header_size = 16 + 4 * nblocks
  for b in range(nblocks):
    bsize = min(blocksize, nbytes - b * blocksize)
    block = data[b * blocksize:b * blocksize + bsize]
    if do_shuffle:
      block = _shuffle(block, typesize)
    nsplits = typesize if (split and bsize == blocksize) else 1
    neblock = bsize // nsplits
    bstarts.append(header_size + len(body))
    for s in range(nsplits):
      stream = block[s * neblock:(s + 1) * neblock]
      comp = _inner_compress(cname, stream, level)
      if len(comp) >= neblock:
        comp = stream  # stored: csize == neblock marks uncompressed
      body += struct.pack('<i', len(comp))
      body += comp
  cbytes = header_size + len(body)
  if cbytes >= nbytes + 16:
    # Incompressible: plain memcpy chunk (stored unshuffled).
    return struct.pack('<BBBBiii', 2, 0, _FLAG_MEMCPY, typesize, nbytes,
                       blocksize, nbytes + 16) + data
  header = struct.pack('<BBBBiii', 2, 0, flags, typesize, nbytes,
                       blocksize, cbytes)
  return header + struct.pack(f'<{nblocks}i', *bstarts) + bytes(body)


# ---------------------------------------------------------------------------
# Uniform codec entry points for zarr cells
# ---------------------------------------------------------------------------

SUPPORTED_DECODERS = ('zlib', 'gzip', 'zstd', 'blosc')
SUPPORTED_ENCODERS = ('zlib', 'gzip', 'zstd', 'blosc')


def decode_cell(raw: bytes, codec: Optional[str], out_nbytes: int):
  """Decompresses one zarr cell payload to exactly ``out_nbytes`` bytes.

  Returns a buffer-protocol object (bytes, bytearray, or pyarrow Buffer —
  deliberately NOT always bytes, to avoid an extra copy of every cell)."""
  if codec is None:
    out = raw
  elif codec == 'zlib':
    out = zlib.decompress(raw, zlib.MAX_WBITS)
  elif codec == 'gzip':
    out = zlib.decompress(raw, zlib.MAX_WBITS | 32)
  elif codec == 'zstd':
    out = _pa_codec('zstd').decompress(raw, out_nbytes)
  elif codec == 'blosc':
    out = blosc_decompress(raw)
  else:
    raise ValueError(f'unsupported zarr codec {codec!r}')
  got = memoryview(out).nbytes
  if got != out_nbytes:
    raise ValueError(f'cell decoded to {got} bytes, expected {out_nbytes}')
  return out


def encode_cell(raw: bytes, codec: Optional[str], typesize: int,
                level: Optional[int] = None) -> bytes:
  """Compresses one zarr cell payload; inverse of decode_cell."""
  if codec is None:
    return raw
  if codec == 'zlib':
    return zlib.compress(raw, 1 if level is None else level)
  if codec == 'gzip':
    co = zlib.compressobj(5 if level is None else level,
                          zlib.DEFLATED, zlib.MAX_WBITS | 16)
    return co.compress(raw) + co.flush()
  if codec == 'zstd':
    import pyarrow as pa
    return pa.Codec('zstd', compression_level=3 if level is None
                    else level).compress(raw).to_pybytes()
  if codec == 'blosc':
    return blosc_compress(raw, typesize,
                          level=5 if level is None else level)
  raise ValueError(f'unsupported zarr codec {codec!r}')


def compressor_config(codec: Optional[str], typesize: int,
                      level: Optional[int] = None) -> Optional[dict]:
  """The .zarray 'compressor' JSON for a codec written by encode_cell."""
  if codec is None:
    return None
  if codec == 'zlib':
    return {'id': 'zlib', 'level': 1 if level is None else level}
  if codec == 'gzip':
    return {'id': 'gzip', 'level': 5 if level is None else level}
  if codec == 'zstd':
    return {'id': 'zstd', 'level': 3 if level is None else level}
  if codec == 'blosc':
    return {'id': 'blosc', 'cname': 'lz4',
            'clevel': 5 if level is None else level, 'shuffle': 1,
            'blocksize': 0}
  raise ValueError(f'unsupported zarr codec {codec!r}')


def codec_from_config(comp: Optional[dict]) -> Optional[str]:
  """Maps a .zarray 'compressor' JSON object to a codec name we can read."""
  if comp is None:
    return None
  cid = comp.get('id')
  if cid in ('zlib', 'gzip', 'zstd'):
    return cid
  if cid == 'blosc':
    return 'blosc'
  raise ValueError(
      f'zarr compressor {cid!r} is not supported by the self-contained '
      'reader (supported: null/zlib/gzip/zstd/blosc)')
