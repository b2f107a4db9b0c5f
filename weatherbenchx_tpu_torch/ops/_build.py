"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

At first use, ``load_library`` compiles ``csrc/crps_pairwise.cu`` into a
shared library with a plain C interface, for Hopper (``sm_90a``), into
``build/wbx_torch_kernels/`` beside the package (a directory git ignores).
The file name carries a hash of the source and flags, so an edited source
builds anew and an unchanged one loads from the cache. There is no
fallback: without nvcc this raises, and CPU tensors never reach here.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'csrc', 'crps_pairwise.cu')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'wbx_torch_kernels')
DEFAULT_CUDA_HOME = '/usr/local/cuda'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_library = None


def find_nvcc() -> str:
  """Path of nvcc: $CUDA_HOME/bin, then PATH, then the default toolkit."""
  candidates = []
  if os.environ.get('CUDA_HOME'):
    candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
  on_path = shutil.which('nvcc')
  if on_path:
    candidates.append(on_path)
  candidates.append(os.path.join(DEFAULT_CUDA_HOME, 'bin', 'nvcc'))
  for path in candidates:
    if os.path.isfile(path) and os.access(path, os.X_OK):
      return path
  raise RuntimeError(
      'nvcc not found (looked in $CUDA_HOME/bin, PATH and '
      f'{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of weatherbenchx_tpu_torch '
      'need the CUDA toolkit to build')


def build() -> str:
  """Compiles the kernel source if needed; returns the library path."""
  nvcc = find_nvcc()
  with open(SOURCE, 'rb') as f:
    digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
  lib_path = os.path.join(BUILD_DIR, f'libwbx_kernels_{digest.hexdigest()[:16]}.so')
  if os.path.exists(lib_path):
    return lib_path
  os.makedirs(BUILD_DIR, exist_ok=True)
  # A unique temporary name: concurrent first builds must not interleave
  # their writes into one file.
  tmp = f'{lib_path}.tmp.{uuid.uuid4().hex[:12]}'
  proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, SOURCE],
                        capture_output=True, text=True, timeout=600,
                        check=False)
  with open(lib_path + '.log', 'w') as f:
    f.write(proc.stdout + proc.stderr)
  if proc.returncode != 0:
    raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                       f'{(proc.stdout + proc.stderr)[-4000:]}')
  os.replace(tmp, lib_path)
  return lib_path


def load_library() -> ctypes.CDLL:
  """The built kernel library, compiled at first use and then cached."""
  global _library
  with _lock:
    if _library is None:
      lib = ctypes.CDLL(build())
      p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
      lib.wbx_fused_ensemble_stats.argtypes = [
          p, p, p, p, p, p, i64, i64, i32, i32, p]
      lib.wbx_fused_ensemble_stats.restype = i32
      lib.wbx_pairwise_spread_sum.argtypes = [p, p, i64, i64, i32, i32, p]
      lib.wbx_pairwise_spread_sum.restype = i32
      lib.wbx_pairwise_cross_sum.argtypes = [p, p, p, i64, i64, i64, i32, i32,
                                             p]
      lib.wbx_pairwise_cross_sum.restype = i32
      _library = lib
    return _library
