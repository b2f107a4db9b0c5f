"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

At first use, ``load_library`` compiles the sources in ``csrc/`` into one
shared library with a plain C interface, for Hopper (``sm_90a``), into
``build/wbx_torch_kernels/`` beside the package (a directory git ignores):

* ``csrc/crps_pairwise.cu``: the cross kernel;
* ``csrc/blocksort_stats.cu``: the fused and spread-only kernels' block
  sorts (257..58,112 members), and their run mode;
* ``csrc/mergesort_stats.cu``: their merge sort past 58,112 members, of
  runs sorted by the block sort's run mode;
* the register form (``csrc/register_stats.cuh``), one entry point per M
  of ``crps_pairwise.REGISTER_MEMBERS``, and the sorted-runs form
  (``csrc/sorted_stats.cuh``), one entry point per run size of
  ``crps_pairwise.SORTED_RUN_SIZES``, spread over ``PARTS`` generated
  translation units so that nvcc compiles them in parallel. The sorting
  networks are generated too: ``wbx_sort_networks.cuh`` writes
  ``crps_pairwise.sort_network(M)`` out as straight-line compare-exchanges.

The file name carries a hash of the sources, the generated files and the
flags, so an edited source or network builds anew and an unchanged one
loads from the cache. There is no fallback: without nvcc this raises, and
CPU tensors never reach here.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
SOURCE = os.path.join(CSRC, 'crps_pairwise.cu')
BLOCKSORT_SOURCE = os.path.join(CSRC, 'blocksort_stats.cu')
MERGESORT_SOURCE = os.path.join(CSRC, 'mergesort_stats.cu')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'wbx_torch_kernels')
DEFAULT_CUDA_HOME = '/usr/local/cuda'
GENCODE = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = (*GENCODE, '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')
# Generated translation units of register kernels, compiled in parallel.
PARTS = 8
NETWORK_HEADER = 'wbx_sort_networks.cuh'

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


def register_symbol(m: int) -> str:
  """The C entry point of the register kernels of M members."""
  return f'wbx_ensemble_stats_registers_{m}'


def sorted_symbol(run_size: int) -> str:
  """The C entry point of the sorted-runs kernels of runs of run_size."""
  return f'wbx_ensemble_stats_sorted_{run_size}'


def network_header() -> str:
  """``wbx_sort_networks.cuh``: ``sort_network<M>`` for every M of
  ``REGISTER_MEMBERS``, one compare-exchange per line in list order."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise
  lines = ['// Generated by weatherbenchx_tpu_torch/ops/_build.py from',
           '// crps_pairwise.sort_network; do not edit.', '#pragma once', '',
           'namespace wbx {']
  for m in crps_pairwise.REGISTER_MEMBERS:
    lines += ['', 'template <>',
              f'__device__ __forceinline__ void sort_network<{m}>'
              f'(float (&v)[{m}]) {{']
    lines += [f'  compare_exchange(v[{lo}], v[{hi}]);'
              for lo, hi in crps_pairwise.sort_network(m)]
    lines.append('}')
  lines += ['', '}  // namespace wbx', '']
  return '\n'.join(lines)


def _kernel_cost(m: int) -> int:
  """Instructions per gridpoint of a network of m wires and its loads,
  roughly: what a part's compile time grows with."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise
  return 2 * len(crps_pairwise.sort_network(m)) + 8 * m


def part_entries() -> list:
  """Every generated entry line: ``WBX_REGISTER_ENTRY(M)`` per M of
  ``REGISTER_MEMBERS`` and ``WBX_SORTED_ENTRY(R)`` per run size of
  ``SORTED_RUN_SIZES``, with its ``_kernel_cost``."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise
  return ([(f'WBX_REGISTER_ENTRY({m})', _kernel_cost(m))
           for m in crps_pairwise.REGISTER_MEMBERS]
          + [(f'WBX_SORTED_ENTRY({r})', _kernel_cost(r))
             for r in crps_pairwise.SORTED_RUN_SIZES])


def part_sources() -> dict:
  """{file name: text} of the PARTS translation units of register and
  sorted-runs kernels, each entry in one of them, balanced by
  ``_kernel_cost``."""
  parts = [[] for _ in range(PARTS)]
  loads = [0] * PARTS
  for line, cost in sorted(part_entries(), key=lambda e: -e[1]):
    i = loads.index(min(loads))
    parts[i].append(line)
    loads[i] += cost
  return {f'wbx_register_part{i}.cu': '\n'.join(
      ['// Generated by weatherbenchx_tpu_torch/ops/_build.py; do not edit.',
       '#include "sorted_stats.cuh"', ''] + sorted(part) + [''])
          for i, part in enumerate(parts)}


def generated_sources() -> dict:
  """{file name: text} of every generated file of the build."""
  return {NETWORK_HEADER: network_header(), **part_sources()}


def library_name(generated: dict) -> str:
  """libwbx_kernels_<hash>.so, the hash over csrc/, the generated files and
  the flags."""
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for name in sorted(os.listdir(CSRC)):
    if not name.endswith(('.cu', '.cuh')):
      continue
    with open(os.path.join(CSRC, name), 'rb') as f:
      digest.update(name.encode() + b'\0' + f.read() + b'\0')
  for name, text in sorted(generated.items()):
    digest.update(name.encode() + b'\0' + text.encode() + b'\0')
  return f'libwbx_kernels_{digest.hexdigest()[:16]}.so'


def _compile_all(nvcc: str, units: list, work: str) -> tuple:
  """Compiles every unit to an object, all at once; returns (objects,
  log). Raises if any fails."""
  procs = []
  for unit in units:
    obj = os.path.join(work, os.path.basename(unit) + '.o')
    cmd = [nvcc, *NVCC_FLAGS, '-I', CSRC, '-I', work, '-c', unit, '-o', obj]
    procs.append((unit, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  log, failed = [], []
  try:
    for unit, _, proc in procs:
      out, _ = proc.communicate(timeout=600)
      log.append(f'== {os.path.basename(unit)} ==\n{out}')
      if proc.returncode != 0:
        failed.append(f'{os.path.basename(unit)} ({proc.returncode}):\n'
                      f'{out[-4000:]}')
  finally:
    for _, _, proc in procs:  # after a timeout, stop the rest
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  if failed:
    raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
  return [obj for _, obj, _ in procs], ''.join(log)


def build() -> str:
  """Compiles the kernel sources if needed; returns the library path.

  The log of the build (nvcc's ``-Xptxas -v`` lines, one ``== unit ==``
  section per translation unit) is written beside the library as
  ``<library>.log``.
  """
  nvcc = find_nvcc()
  generated = generated_sources()
  lib_path = os.path.join(BUILD_DIR, library_name(generated))
  if os.path.exists(lib_path):
    return lib_path
  # A unique working directory and temporary name: concurrent first builds
  # must not interleave their writes.
  work = os.path.join(BUILD_DIR, f'work.{uuid.uuid4().hex[:12]}')
  os.makedirs(work)
  try:
    for name, text in generated.items():
      with open(os.path.join(work, name), 'w') as f:
        f.write(text)
    units = [SOURCE, BLOCKSORT_SOURCE, MERGESORT_SOURCE] + [
        os.path.join(work, name) for name in generated if name.endswith('.cu')]
    objects, log = _compile_all(nvcc, units, work)
    tmp = os.path.join(work, os.path.basename(lib_path))
    proc = subprocess.run([nvcc, *GENCODE, '-shared', '-o', tmp, *objects],
                          capture_output=True, text=True, timeout=600,
                          check=False)
    log += f'== link ==\n{proc.stdout}{proc.stderr}'
    with open(lib_path + '.log', 'w') as f:
      f.write(log)
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n'
                         f'{(proc.stdout + proc.stderr)[-4000:]}')
    os.replace(tmp, lib_path)
  finally:
    shutil.rmtree(work, ignore_errors=True)
  return lib_path


def load_library() -> ctypes.CDLL:
  """The built kernel library, compiled at first use and then cached."""
  global _library
  with _lock:
    if _library is None:
      from weatherbenchx_tpu_torch.ops import crps_pairwise
      lib = ctypes.CDLL(build())
      p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
      entries = {
          'wbx_ensemble_stats_mergesort': [p] * 7 + [i64] * 3 + [i32]
                                          + [i64] + [i32] * 7 + [p],
          'wbx_ensemble_stats_blocksort': [p] * 7 + [i64, i64] + [i32] * 5
                                          + [p],
          'wbx_pairwise_cross_sum': [p, p, p, i64, i64, i64, i32, i32, p],
      }
      for m in crps_pairwise.REGISTER_MEMBERS:
        entries[register_symbol(m)] = [p] * 6 + [i64, i32, i32, i32, p]
      for r in crps_pairwise.SORTED_RUN_SIZES:
        entries[sorted_symbol(r)] = [p] * 6 + [i64, i64, i32, i32, i32, p]
      for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
      lib.wbx_mergesort_scratch_words.argtypes = [i64, i32]
      lib.wbx_mergesort_scratch_words.restype = i64
      _library = lib
    return _library
