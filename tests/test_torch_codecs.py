"""The port's codecs and native I/O cores against the JAX package's, on the
CPU.

The Python codecs (``codecs.py``, the reference form and fallback) encode
to the same bytes as the JAX package's and decode each other's cells; the
port's native library (``native/zarrcodec.cpp``, built with g++ at first
use into ``build/wbx_torch_native/``) encodes to the same bytes as the
Python codecs and decodes theirs, whole cells and byte ranges of shards;
the blockstore writes and reads ``.wbx`` blocks; every native call is
counted.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import codecs as j_codecs
from weatherbenchx_tpu_torch import codecs
from weatherbenchx_tpu_torch import native

torch.set_num_threads(1)


def _raw(n: int, dtype=np.float32, seed=0) -> bytes:
  """Compressible bytes: a smooth field with noise in the low bits."""
  rng = np.random.default_rng(seed)
  x = np.cumsum(rng.standard_normal(n)).astype(dtype)
  return x.tobytes()


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int16,
                                   np.uint8])
@pytest.mark.parametrize('n', [0, 1, 7, 5000, 70000])
def test_blosc_matches_jax_both_ways(dtype, n):
  raw = _raw(n, dtype, seed=n)
  typesize = np.dtype(dtype).itemsize
  chunk = codecs.blosc_compress(raw, typesize)
  assert chunk == j_codecs.blosc_compress(raw, typesize)
  assert bytes(codecs.blosc_decompress(chunk)) == raw
  assert bytes(j_codecs.blosc_decompress(chunk)) == raw


@pytest.mark.parametrize('cname', ['lz4', 'zstd', 'zlib'])
@pytest.mark.parametrize('shuffle', [True, False])
def test_blosc_compressors_match_jax(cname, shuffle):
  raw = np.arange(300000, dtype=np.float32).tobytes()  # several blocks
  chunk = codecs.blosc_compress(raw, 4, cname=cname, shuffle=shuffle)
  assert chunk == j_codecs.blosc_compress(raw, 4, cname=cname,
                                          shuffle=shuffle)
  assert bytes(j_codecs.blosc_decompress(chunk)) == raw


def test_blosc_memcpy_chunk_and_bitshuffle():
  payload = bytes(range(256)) * 4
  header = struct.pack('<BBBBiii', 2, 0, 0x2, 1, len(payload), len(payload),
                       len(payload) + 16)
  assert bytes(codecs.blosc_decompress(header + payload)) == payload
  hdr = struct.pack('<BBBBiii', 2, 0, 0x4, 4, 16, 16, 32) + b'\0' * 16
  with pytest.raises(ValueError, match='bit-shuffle'):
    codecs.blosc_decompress(hdr)


@pytest.mark.parametrize('codec', [None, 'zlib', 'gzip', 'zstd', 'blosc'])
def test_cells_match_jax(codec):
  raw = _raw(30000)
  enc = codecs.encode_cell(raw, codec, 4)
  if codec != 'gzip':  # gzip headers carry a time stamp
    assert enc == j_codecs.encode_cell(raw, codec, 4)
  assert bytes(memoryview(codecs.decode_cell(enc, codec, len(raw)))) == raw
  assert bytes(memoryview(j_codecs.decode_cell(enc, codec, len(raw)))) == raw
  assert codecs.compressor_config(codec, 4) == j_codecs.compressor_config(
      codec, 4)


def test_config_and_size_checks_match_jax():
  for comp in (None, {'id': 'zlib', 'level': 1}, {'id': 'blosc', 'cname':
                                                   'lz4'}):
    assert codecs.codec_from_config(comp) == j_codecs.codec_from_config(comp)
  with pytest.raises(ValueError, match='not supported'):
    codecs.codec_from_config({'id': 'bz2'})
  with pytest.raises(ValueError, match='expected'):
    codecs.decode_cell(zlib.compress(b'abc'), 'zlib', 5)


def test_crc32c_matches_jax_and_the_known_vector():
  # RFC 3720's test vector: 32 bytes of zeros.
  assert codecs.crc32c(bytes(32)) == 0x8A9136AA
  data = np.random.default_rng(0).bytes(1000)
  assert codecs.crc32c(data) == j_codecs.crc32c(data)


# -- the native cores -------------------------------------------------------


@pytest.fixture
def zarrcodec():
  if not native.zarrcodec_available():
    pytest.fail('the native zarr codec did not build (g++, zlib, zstd and '
                'lz4 runtime libraries)')
  return native


def test_native_libraries_build_into_the_build_directory(zarrcodec):
  assert native.blockstore_available()
  for module in (native.BLOCKSTORE, native.ZARRCODEC):
    path = module.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith(f'lib{module.name}_')
    assert os.path.exists(path)
  assert native.BUILD_DIR.endswith(os.path.join('build', 'wbx_torch_native'))


@pytest.mark.parametrize('codec', [None, 'zlib', 'zstd', 'blosc'])
def test_native_cells_are_the_python_codecs_bytes(zarrcodec, tmp_path,
                                                  codec):
  """encode_cells and encode_buffers write what codecs.encode_cell writes;
  decode_cells and decode_ranges read it back."""
  cells = [np.frombuffer(_raw(3000, seed=i), np.float32).copy()
           for i in range(5)]
  want = [codecs.encode_cell(c.tobytes(), codec, 4) for c in cells]
  paths = [str(tmp_path / f'c{i}') for i in range(5)]
  native.reset_call_counts()
  native.encode_cells(paths, codec, cells, 4, threads=3)
  for path, w in zip(paths, want):
    with open(path, 'rb') as f:
      assert f.read() == w
  assert native.encode_buffers(codec, cells, 4, threads=3) == want
  if codec is None:
    return
  out = [np.empty_like(c) for c in cells]
  native.decode_cells(paths[:4] + [None], codec, out, threads=3)
  for c, o in zip(cells[:4], out):
    np.testing.assert_array_equal(o, c)
  # The same cells as byte ranges of one file, as in a v3 shard.
  blob = b''.join(want)
  offsets = np.cumsum([0] + [len(w) for w in want])[:-1]
  with open(tmp_path / 'shard', 'wb') as f:
    f.write(blob)
  out = [np.empty_like(c) for c in cells]
  native.decode_ranges([str(tmp_path / 'shard')] * 5, offsets,
                       [len(w) for w in want], codec, out, threads=3)
  for c, o in zip(cells, out):
    np.testing.assert_array_equal(o, c)
  assert native.CALLS['encode_cells'] == 1
  assert native.CALLS['encode_buffers'] == 1
  assert native.CALLS['decode_cells'] == 1
  assert native.CALLS['decode_ranges'] == 1


def _reversed_blocks(frame: bytes) -> bytes:
  """The same blosc frame with its blocks stored last to first."""
  nbytes, blocksize = struct.unpack('<ii', frame[4:12])
  nblocks = -(-nbytes // blocksize)
  starts = list(struct.unpack(f'<{nblocks}i', frame[16:16 + 4 * nblocks]))
  ends = starts[1:] + [len(frame)]
  body_at = 16 + 4 * nblocks
  body, new_starts = b'', [0] * nblocks
  for b in reversed(range(nblocks)):
    new_starts[b] = body_at + len(body)
    body += frame[starts[b]:ends[b]]
  return (frame[:16] + struct.pack(f'<{nblocks}i', *new_starts) + body)


@pytest.mark.parametrize('cname,shuffle', [('lz4', True), ('zstd', True),
                                           ('zlib', False), ('zstd', False)])
@pytest.mark.parametrize('layout', ['in_order', 'reversed', 'truncated'])
def test_native_blosc_cells_decode_a_block_at_a_time(zarrcodec, tmp_path,
                                                     cname, shuffle, layout):
  """A many-block blosc cell file decodes block by block into its buffer;
  blocks stored out of order are read whole and decoded; a truncated file
  is refused."""
  cell = np.frombuffer(_raw(300_000, seed=4), np.float32).copy()
  frame = codecs.blosc_compress(cell.tobytes(), 4, cname=cname,
                                shuffle=shuffle)
  nbytes, blocksize = struct.unpack('<ii', frame[4:12])
  assert -(-nbytes // blocksize) > 2 and not frame[2] & 0x2  # compressed
  if layout == 'reversed':
    frame = _reversed_blocks(frame)
    assert bytes(codecs.blosc_decompress(frame)) == cell.tobytes()
  elif layout == 'truncated':
    frame = frame[:-7]
  path = str(tmp_path / 'cell')
  with open(path, 'wb') as f:
    f.write(frame)
  out = np.empty_like(cell)
  if layout == 'truncated':
    with pytest.raises(OSError, match='cell'):
      native.decode_cells([path], 'blosc', [out])
    return
  native.decode_cells([path], 'blosc', [out])
  np.testing.assert_array_equal(out, cell)


def test_native_blosc_memcpy_cell_reads_into_its_buffer(zarrcodec, tmp_path):
  payload = np.random.default_rng(0).integers(0, 255, 4096, np.uint8)
  header = bytes([2, 1, 0x2, 1]) + struct.pack('<iii', 4096, 4096, 4096 + 16)
  path = str(tmp_path / 'cell')
  with open(path, 'wb') as f:
    f.write(header + payload.tobytes())
  out = np.empty_like(payload)
  native.decode_cells([path], 'blosc', [out])
  np.testing.assert_array_equal(out, payload)


@pytest.mark.parametrize('level', [0, 1, 9])
def test_native_levels_decode_as_the_python_codecs(zarrcodec, level):
  """Every level gives a cell the Python codecs decode; the bytes are the
  Python codec's at the writers' default levels (zlib 1, zstd 3). zlib's
  stored blocks (level 0) and zstd's higher levels may frame differently
  in the machine's libraries than in Python's zlib and pyarrow."""
  cell = np.frombuffer(_raw(20000), np.float32).copy()
  for codec in ('zlib', 'zstd'):
    got = native.encode_buffers(codec, [cell], 4, level=level)[0]
    assert bytes(memoryview(codecs.decode_cell(got, codec, cell.nbytes))) == (
        cell.tobytes())
    assert native.encode_buffers(codec, [cell], 4)[0] == codecs.encode_cell(
        cell.tobytes(), codec, 4)


def test_native_decode_errors_name_the_cell(zarrcodec, tmp_path):
  cell = np.zeros(1000, np.float32)
  path = str(tmp_path / 'bad')
  with open(path, 'wb') as f:
    f.write(b'not a zstd frame')
  with pytest.raises(OSError, match='bad'):
    native.decode_cells([path], 'zstd', [cell])
  with pytest.raises(OSError, match='open failed'):
    native.decode_cells([str(tmp_path / 'missing')], 'zlib', [cell])
  # A corrupt (negative) blosc block start is refused, not read past.
  raw = codecs.blosc_compress(np.arange(70000, dtype=np.float32).tobytes(), 4)
  raw = raw[:16] + struct.pack('<i', -8) + raw[20:]
  with open(path, 'wb') as f:
    f.write(raw)
  with pytest.raises(OSError, match='malformed'):
    native.decode_cells([path], 'blosc', [np.empty(70000, np.float32)])
  with pytest.raises(ValueError, match='same size'):
    native.decode_cells([path, path], 'zlib',
                        [cell, np.zeros(3, np.float32)])


def test_blockstore_writes_and_reads_blocks(tmp_path):
  assert native.blockstore_available()
  path = str(tmp_path / 'blocks')
  a = np.arange(5000, dtype=np.float64)
  b = np.array(['2020-01-01', '2021-06-01'], dtype='datetime64[ns]')
  native.reset_call_counts()
  native.pwrite_blocks(path, [a, b], [4096, 4096 + a.nbytes], threads=2)
  got_a, got_b = np.empty_like(a), np.empty_like(b)
  native.pread_blocks(path, [got_b, got_a], [4096 + a.nbytes, 4096])
  np.testing.assert_array_equal(got_a, a)
  np.testing.assert_array_equal(got_b, b)
  assert native.CALLS['pwrite_blocks'] == native.CALLS['pread_blocks'] == 1
  assert native.BYTES['pread_blocks'] == a.nbytes + b.nbytes
  assert native.SECONDS['pread_blocks'] > 0
  native.reset_call_counts()
  assert native.SECONDS['pread_blocks'] == native.BYTES['pread_blocks'] == 0
  with pytest.raises(OSError):
    native.pread_blocks(path, [np.empty(10 ** 6)], [0])  # past the end


def test_a_failed_build_leaves_the_python_path(tmp_path, monkeypatch):
  """Without a toolchain the module reports itself unavailable (and the
  containers use plain file I/O and codecs.py); the native functions then
  raise instead of guessing."""
  module = native._Module('zarrcodec', native.ZARRCODEC._link,
                          native._configure_zarrcodec)
  monkeypatch.setenv('PATH', str(tmp_path))
  monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
  assert module.load() is None
  monkeypatch.setattr(native, 'ZARRCODEC', module)
  assert not native.zarrcodec_available()
  with pytest.raises(RuntimeError, match='unavailable'):
    native.encode_buffers('zstd', [np.zeros(4, np.float32)], 4)
