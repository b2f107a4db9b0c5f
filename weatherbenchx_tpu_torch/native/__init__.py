"""Native (C++) I/O cores, built with g++ at first use and bound via ctypes.

The port of ``weatherbenchx_tpu/native/__init__.py``:

* ``blockstore``: parallel pwrite/pread of raw array blocks, the I/O core of
  the ``.wbx`` container (``io.py``) and of the lazy reader's windowed
  block reads (``lazy.BlockSource``);
* ``zarrcodec``: parallel zarr cell read+decode and encode+write (raw,
  zlib, gzip, zstd, blosc), and the same for byte ranges and in-memory
  cells of zarr v3 shards, the codec core of ``zarr_io.py``.

Each library is compiled at first use into ``build/wbx_torch_native/``
beside the package (a directory git ignores), under a name that carries a
hash of its source and flags, so an edited source builds anew. zstd and lz4
are linked by soname, as machines may lack the unversioned ``.so`` link.
Every consumer keeps the pure-Python path of ``codecs.py`` and plain file
I/O for a machine without a toolchain: a failed build logs a warning, and
``blockstore_available()`` / ``zarrcodec_available()`` say which path runs.
That path serves CPU runs only: the CLIs given a GPU raise without both
libraries (``apps.run_evaluation.resolve_device``).

``CALLS`` counts the calls into each native function, so that a run can
show its I/O went through them, ``BYTES`` the array bytes they moved
(decoded or encoded cell bytes, block bytes read or written) and
``SECONDS`` the wall time spent inside them, so that a load's time can be
split into the native read and decode and the Python around it.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
import uuid

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'wbx_torch_native')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-pthread', '-std=c++17')

CALLS = {'pwrite_blocks': 0, 'pread_blocks': 0, 'encode_cells': 0,
         'decode_cells': 0, 'encode_buffers': 0, 'decode_ranges': 0}
BYTES = dict.fromkeys(CALLS, 0)
SECONDS = dict.fromkeys(CALLS, 0.0)
_calls_lock = threading.Lock()


def reset_call_counts() -> None:
  with _calls_lock:
    for k in CALLS:
      CALLS[k] = BYTES[k] = 0
      SECONDS[k] = 0.0


def _count(name: str, buffers, t0: float) -> None:
  """Counts one call of ``name`` that started at ``time.perf_counter()``
  ``t0``."""
  seconds = time.perf_counter() - t0
  with _calls_lock:
    CALLS[name] += 1
    BYTES[name] += sum(b.nbytes for b in buffers)
    SECONDS[name] += seconds


class _Module:
  """One shared library compiled at first use."""

  def __init__(self, name: str, link: tuple, configure) -> None:
    self.name = name
    self.source = os.path.join(_HERE, f'{name}.cpp')
    self._link = link
    self._configure = configure
    self._lock = threading.Lock()
    self._lib = None
    self._failed = False

  def library_path(self) -> str:
    """build/wbx_torch_native/lib<name>_<hash>.so, the hash over the source
    and the flags."""
    digest = hashlib.sha256(' '.join(CXX_FLAGS + self._link).encode())
    with open(self.source, 'rb') as f:
      digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f'lib{self.name}_{digest.hexdigest()[:16]}.so')

  def _build(self, path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A unique temporary: concurrent first builds (pytest-xdist workers,
    # prefetch threads of several processes) must not interleave writes.
    tmp = f'{path}.tmp.{uuid.uuid4().hex[:12]}'
    try:
      subprocess.run(['g++', *CXX_FLAGS, self.source, '-o', tmp,
                      *self._link], check=True, capture_output=True,
                     timeout=300)
      os.replace(tmp, path)
    finally:
      if os.path.exists(tmp):
        os.unlink(tmp)

  def load(self):
    """The loaded library, or None where it cannot be built or loaded."""
    with self._lock:
      if self._lib is not None or self._failed:
        return self._lib
      try:
        path = self.library_path()
        if not os.path.exists(path):
          self._build(path)
        lib = ctypes.CDLL(path)
        self._configure(lib)
      except (subprocess.SubprocessError, OSError, AttributeError) as e:
        err = getattr(e, 'stderr', b'') or b''
        logger.warning('native %s unavailable (%s %s); using the '
                       'pure-Python path', self.name, e,
                       err.decode(errors='replace')[-500:])
        self._failed = True
        return None
      self._lib = lib
      return lib


_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)
_voidpp = ctypes.POINTER(ctypes.c_void_p)
_charpp = ctypes.POINTER(ctypes.c_char_p)
_int = ctypes.c_int


def _configure_blockstore(lib) -> None:
  for fn in (lib.bs_pwrite_blocks, lib.bs_pread_blocks):
    fn.argtypes = [ctypes.c_char_p, _i64, _voidpp, _i64p, _i64p, _int]
    fn.restype = _int


def _configure_zarrcodec(lib) -> None:
  signatures = {
      'wbx_decode_cells': [_int, _charpp, _int, _voidpp, _i64, _int],
      'wbx_encode_cells': [_int, _charpp, _int, _voidpp, _i64, _int, _int,
                           _int],
      'wbx_decode_ranges': [_int, _charpp, _i64p, _i64p, _int, _voidpp, _i64,
                            _int],
      'wbx_encode_buffers': [_int, _int, _voidpp, _i64, _int, _int, _voidpp,
                             _i64, _i64p, _int],
  }
  for name, argtypes in signatures.items():
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = _int
  lib.wbx_encode_bound.argtypes = [_i64]
  lib.wbx_encode_bound.restype = _i64


BLOCKSTORE = _Module('blockstore', (), _configure_blockstore)
ZARRCODEC = _Module('zarrcodec', ('-lz', '-l:libzstd.so.1', '-l:liblz4.so.1'),
                    _configure_zarrcodec)


def blockstore_available() -> bool:
  return BLOCKSTORE.load() is not None


def zarrcodec_available() -> bool:
  return ZARRCODEC.load() is not None


def _loaded(module: _Module):
  lib = module.load()
  if lib is None:
    raise RuntimeError(f'native {module.name} unavailable')
  return lib


def _void_pp(addresses):
  return (ctypes.c_void_p * len(addresses))(*addresses)


def _int64_p(values):
  return (ctypes.c_int64 * len(values))(*(int(v) for v in values))


def _check_buffers(buffers, same_size: bool) -> None:
  for b in buffers:
    if not (isinstance(b, np.ndarray) and b.flags.c_contiguous):
      raise ValueError('native I/O takes C-contiguous numpy buffers')
  if same_size and len({b.nbytes for b in buffers}) > 1:
    raise ValueError('every cell buffer must have the same size')


def pwrite_blocks(path: str, buffers, offsets, threads: int = 8) -> None:
  """Parallel positional write of C-contiguous numpy buffers to path."""
  lib = _loaded(BLOCKSTORE)
  _check_buffers(buffers, same_size=False)
  t0 = time.perf_counter()
  err = lib.bs_pwrite_blocks(
      path.encode(), len(buffers), _void_pp([b.ctypes.data for b in buffers]),
      _int64_p([b.nbytes for b in buffers]), _int64_p(offsets), threads)
  _count('pwrite_blocks', buffers, t0)
  if err != 0:
    raise OSError(err, os.strerror(err), path)


def pread_blocks(path: str, buffers, offsets, threads: int = 8) -> None:
  """Parallel positional read into preallocated numpy buffers."""
  lib = _loaded(BLOCKSTORE)
  _check_buffers(buffers, same_size=False)
  for b in buffers:
    if not b.flags.writeable:
      raise ValueError('native reads need writable buffers')
  t0 = time.perf_counter()
  err = lib.bs_pread_blocks(
      path.encode(), len(buffers), _void_pp([b.ctypes.data for b in buffers]),
      _int64_p([b.nbytes for b in buffers]), _int64_p(offsets), threads)
  _count('pread_blocks', buffers, t0)
  if err != 0:
    raise OSError(err, os.strerror(err), path)


_CODEC_IDS = {None: 0, 'zlib': 1, 'gzip': 2, 'zstd': 3, 'blosc': 4}

_ERRORS = {1: 'open failed', 2: 'short read', 3: 'malformed chunk',
           4: 'decode error', 5: 'size mismatch', 6: 'unsupported feature',
           7: 'write failed', 8: 'encode error'}

# "Use the codec default" level (zarrcodec.cpp kDefaultLevel): explicit 0
# (zlib stored) and negative values (zstd fast levels) are valid settings
# that pass through, as in codecs.py.
_LEVEL_DEFAULT = -(2**31)


def _raise_cell_error(rc: int, what: str, names) -> None:
  if rc != 0:
    i, err = divmod(rc - 1, 16)
    raise OSError(f'{what}: cell {names[i]!r}: {_ERRORS.get(err, err)}')


def _c_paths(paths):
  return (ctypes.c_char_p * len(paths))(
      *[p.encode() if p is not None else None for p in paths])


def decode_cells(paths, codec, buffers, threads: int = 8) -> None:
  """Parallel read+decode of zarr cell files into preallocated buffers.

  ``paths[i] is None`` marks a missing cell: skipped, the caller pre-fills.
  Every buffer is C-contiguous with the cell's size.
  """
  if not paths:
    return
  lib = _loaded(ZARRCODEC)
  _check_buffers(buffers, same_size=True)
  t0 = time.perf_counter()
  rc = lib.wbx_decode_cells(
      len(paths), _c_paths(paths), _CODEC_IDS[codec],
      _void_pp([b.ctypes.data for b in buffers]), buffers[0].nbytes, threads)
  _count('decode_cells', buffers, t0)
  _raise_cell_error(rc, 'decode_cells', paths)


def decode_ranges(paths, offsets, sizes, codec, buffers,
                  threads: int = 8) -> None:
  """Parallel read of ``sizes[i]`` bytes at ``offsets[i]`` of ``paths[i]``
  and decode into preallocated buffers: the inner cells of v3 shards.
  ``paths[i] is None`` marks a missing cell, as in ``decode_cells``."""
  if not paths:
    return
  lib = _loaded(ZARRCODEC)
  _check_buffers(buffers, same_size=True)
  t0 = time.perf_counter()
  rc = lib.wbx_decode_ranges(
      len(paths), _c_paths(paths), _int64_p(offsets), _int64_p(sizes),
      _CODEC_IDS[codec], _void_pp([b.ctypes.data for b in buffers]),
      buffers[0].nbytes, threads)
  _count('decode_ranges', buffers, t0)
  _raise_cell_error(rc, 'decode_ranges', paths)


def _level(level) -> int:
  return _LEVEL_DEFAULT if level is None else int(level)


def encode_cells(paths, codec, buffers, typesize: int, level=None,
                 threads: int = 8) -> None:
  """Parallel encode+write of cell buffers (inverse of decode_cells).

  Codecs None/'zlib'/'zstd'/'blosc' (blosc is lz4 + byte shuffle,
  numcodecs-compatible); ``level=None`` is the codec's default (zlib 1,
  zstd 3, as ``codecs.encode_cell``).
  """
  if codec == 'gzip':
    raise ValueError('gzip is decode-only')
  if not paths:
    return
  lib = _loaded(ZARRCODEC)
  _check_buffers(buffers, same_size=True)
  t0 = time.perf_counter()
  rc = lib.wbx_encode_cells(
      len(paths), _c_paths(paths), _CODEC_IDS[codec],
      _void_pp([b.ctypes.data for b in buffers]), buffers[0].nbytes,
      typesize, _level(level), threads)
  _count('encode_cells', buffers, t0)
  _raise_cell_error(rc, 'encode_cells', paths)


def encode_buffers(codec, buffers, typesize: int, level=None,
                   threads: int = 8) -> list:
  """Parallel encode of cell buffers into memory; returns one ``bytes``
  per buffer, as ``codecs.encode_cell`` would (the v3 shard writer's
  cells)."""
  if codec == 'gzip':
    raise ValueError('gzip is decode-only')
  if not buffers:
    return []
  lib = _loaded(ZARRCODEC)
  _check_buffers(buffers, same_size=True)
  capacity = int(lib.wbx_encode_bound(buffers[0].nbytes))
  out = np.empty((len(buffers), max(capacity, 1)), np.uint8)
  sizes = (ctypes.c_int64 * len(buffers))()
  t0 = time.perf_counter()
  rc = lib.wbx_encode_buffers(
      len(buffers), _CODEC_IDS[codec],
      _void_pp([b.ctypes.data for b in buffers]), buffers[0].nbytes,
      typesize, _level(level), _void_pp([row.ctypes.data for row in out]),
      capacity, sizes, threads)
  _count('encode_buffers', buffers, t0)
  _raise_cell_error(rc, 'encode_buffers', list(range(len(buffers))))
  return [out[i, :sizes[i]].tobytes() for i in range(len(buffers))]
