"""Writes docs/torch/api.md, the port's API page, from its docstrings.

The port of ``tools/gen_api_doc.py``: one line per public class and
function, the modules of the JAX package's page in its order, then the
port's own modules, then the JAX package's public names that the port
deliberately does not have, each with its reason.

Usage:
  python -m weatherbenchx_tpu_torch.tools.gen_api_doc
"""

import argparse
import importlib
import inspect
import io
import os
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, 'docs', 'torch', 'api.md')

# The JAX package's page, module for module.
MODULES = [
    'weatherbenchx_tpu_torch.darray',
    'weatherbenchx_tpu_torch.time_chunks',
    'weatherbenchx_tpu_torch.tree',
    'weatherbenchx_tpu_torch.io',
    'weatherbenchx_tpu_torch.lazy',
    'weatherbenchx_tpu_torch.zarr_io',
    'weatherbenchx_tpu_torch.codecs',
    'weatherbenchx_tpu_torch.netcdf_io',
    'weatherbenchx_tpu_torch.fileio',
    'weatherbenchx_tpu_torch.aggregation',
    'weatherbenchx_tpu_torch.weighting',
    'weatherbenchx_tpu_torch.binning',
    'weatherbenchx_tpu_torch.interpolations',
    'weatherbenchx_tpu_torch.metrics.base',
    'weatherbenchx_tpu_torch.metrics.deterministic',
    'weatherbenchx_tpu_torch.metrics.probabilistic',
    'weatherbenchx_tpu_torch.metrics.categorical',
    'weatherbenchx_tpu_torch.metrics.spatial',
    'weatherbenchx_tpu_torch.metrics.wrappers',
    'weatherbenchx_tpu_torch.data.base',
    'weatherbenchx_tpu_torch.data.loaders',
    'weatherbenchx_tpu_torch.data.sparse_parquet',
    'weatherbenchx_tpu_torch.data.latency_wrappers',
    'weatherbenchx_tpu_torch.parallel.evaluator',
    'weatherbenchx_tpu_torch.parallel.pipeline',
    'weatherbenchx_tpu_torch.parallel.unaggregated',
    'weatherbenchx_tpu_torch.inference.base',
    'weatherbenchx_tpu_torch.inference.autodiff',
    'weatherbenchx_tpu_torch.inference.t_test',
    'weatherbenchx_tpu_torch.inference.bootstrap',
    'weatherbenchx_tpu_torch.inference.block_length',
    'weatherbenchx_tpu_torch.inference.baseline_comparison',
    'weatherbenchx_tpu_torch.ops.conv',
    'weatherbenchx_tpu_torch.ops.interp',
    'weatherbenchx_tpu_torch.ops.crps_pairwise',
    'weatherbenchx_tpu_torch.native',
    'weatherbenchx_tpu_torch.observability',
    'weatherbenchx_tpu_torch.test_utils',
]

# Modules the JAX package has no counterpart of.
PORT_MODULES = [
    'weatherbenchx_tpu_torch.convert',
    'weatherbenchx_tpu_torch.multichip',
    'weatherbenchx_tpu_torch.parallel.distributed',
    'weatherbenchx_tpu_torch.parity_fuzz',
    'weatherbenchx_tpu_torch.bench_families',
    'weatherbenchx_tpu_torch.ops._build',
    'weatherbenchx_tpu_torch.tools.gen_demo_fixtures',
    'weatherbenchx_tpu_torch.tools.stream_scale_demo',
    'weatherbenchx_tpu_torch.tools.sparse_scale_demo',
    'weatherbenchx_tpu_torch.tools.rss_breakdown',
    'weatherbenchx_tpu_torch.tools.make_notebooks',
    'weatherbenchx_tpu_torch.tools.gen_api_doc',
    'weatherbenchx_tpu_torch.examples',
    'weatherbenchx_tpu_torch.examples.quickstart',
    'weatherbenchx_tpu_torch.examples.significance_testing',
    'weatherbenchx_tpu_torch.examples.ensemble_zarr_pipeline',
]

_XARRAY = ('needs xarray, which neither the port\'s machines nor its '
           'dependencies have; the port raises the JAX package\'s '
           'ImportError in that branch')
_FITS = ('TPU-only: whether a member count fits VMEM. The port\'s kernels '
         'take 1 to 2^20 members on any shape, routed by '
         '`crps_pairwise.spread_form`')

# (JAX package name, reason): its public names the port does not have.
OMITTED = [
    ('weatherbenchx_tpu.io.open_xarray_dataset', _XARRAY),
    ('weatherbenchx_tpu.io.to_xarray_dataset', _XARRAY),
    ('weatherbenchx_tpu.io.from_xarray_dataset', _XARRAY),
    ('weatherbenchx_tpu.lazy.XarraySource', _XARRAY),
    ('weatherbenchx_tpu.darray.dot_regime',
     'TPU-only: the VPU/MXU routing of `dot`; the port contracts with '
     '`torch.einsum` in float32'),
    ('weatherbenchx_tpu.aggregation.AggregationState.block_until_ready',
     'a JAX dispatch barrier; the port synchronizes with '
     '`torch.cuda.synchronize` where it times'),
    ('weatherbenchx_tpu.parallel.evaluator.ChunkEvaluator.lean_pair',
     'drops host coords from a jitted step\'s inputs; the port keeps every '
     'coord, so the sink sees them all'),
    ('weatherbenchx_tpu.parallel.pipeline._InflightWindow',
     'bounds staged bytes for asynchronous remote dispatch; eager PyTorch '
     'blocks the host on each pageable host-to-device copy, so no backlog '
     'builds up'),
    ('weatherbenchx_tpu.ops.crps_pairwise.supported', _FITS),
    ('weatherbenchx_tpu.ops.crps_pairwise.cross_supported', _FITS),
    ('weatherbenchx_tpu.ops.crps_pairwise.fused_supported', _FITS),
    ('weatherbenchx_tpu.parallel.evaluator.prepare_chunk',
     'turns time coords into int64-second device leaves so that a jitted '
     'step does not retrace; the port keeps datetime64 and timedelta64 '
     'coords, and `ChunkEvaluator.prepare_host` runs the statistics\' '
     '`prepare_chunk`'),
    ('weatherbenchx_tpu.parallel.evaluator.restore_time_coords',
     'the inverse of `prepare_chunk`; the port\'s coords need no '
     'restoring'),
    ('weatherbenchx_tpu.parallel.pipeline.atomic_write_dataset',
     'a one-line alias; the port calls `fileio.save_dataset_atomic`'),
    ('weatherbenchx_tpu.native.available',
     'the port names each library: `native.blockstore_available` and '
     '`native.zarrcodec_available`'),
]


def _first_line(obj) -> str:
  doc = inspect.getdoc(obj) or ''
  return doc.split('\n')[0].strip()


def _escape(text: str) -> str:
  return text.replace('|', '\\|')


def _module_section(out: io.StringIO, name: str) -> None:
  module = importlib.import_module(name)
  out.write(f'\n## `{name}`\n\n')
  module_doc = inspect.getdoc(module)
  if module_doc:
    out.write(module_doc.split('\n')[0].strip() + '\n\n')
  rows = []
  for sym in sorted(vars(module)):
    obj = vars(module)[sym]
    if (sym.startswith('_') or inspect.ismodule(obj)
        or getattr(obj, '__module__', None) != name):
      continue
    if inspect.isclass(obj):
      rows.append((sym, 'class', _first_line(obj)))
    elif inspect.isfunction(obj):
      rows.append((sym, 'fn', _first_line(obj)))
  if rows:
    out.write('| Symbol | Kind | Summary |\n|---|---|---|\n')
    for sym, kind, summary in rows:
      out.write(f'| `{sym}` | {kind} | {_escape(summary)} |\n')


def render() -> str:
  """The page's text."""
  out = io.StringIO()
  out.write('# API reference: weatherbenchx_tpu_torch\n\n')
  out.write('One line per public symbol of the PyTorch/CUDA port, generated '
            'from docstrings (`python -m '
            'weatherbenchx_tpu_torch.tools.gen_api_doc`). The modules of '
            'the JAX package\'s page (`docs/api.md`) come first, in its '
            'order; then the port\'s own modules; then the JAX package\'s '
            'public names the port does not have, and why.\n')
  for name in MODULES:
    _module_section(out, name)
  out.write('\n# Modules of the port alone\n')
  for name in PORT_MODULES:
    _module_section(out, name)
  out.write('\n# Not in the port\n\n'
            'Public names of the JAX package that the port deliberately '
            'does not have.\n\n'
            '| JAX package name | Reason |\n|---|---|\n')
  for name, reason in OMITTED:
    out.write(f'| `{name}` | {_escape(reason)} |\n')
  return out.getvalue()


def main(argv: Optional[Sequence[str]] = None) -> str:
  """Writes the page; returns its path."""
  argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
      argv)
  text = render()
  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  with open(OUT, 'w') as f:
    f.write(text)
  print(f'Wrote {OUT} ({len(text)} bytes)')
  return OUT


if __name__ == '__main__':
  main()
