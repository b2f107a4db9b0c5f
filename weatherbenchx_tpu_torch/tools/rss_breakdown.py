"""Host RSS of a process that runs the port, taken apart step by step.

Steps: the interpreter with numpy; ``import torch``; the device's context
(``torch.zeros((), device=...)``); ``import weatherbenchx_tpu_torch``; then
each module that ``tools/stream_scale_demo.py`` imports, in its order. At
each step it reads the RSS (``/proc/self/statm``) and, where the kernel
gives them, ``RssAnon``/``RssFile``/``RssShmem`` from
``/proc/self/status``. At the end, if ``/proc/self/smaps`` exists, the
resident bytes per mapping: anonymous against each mapped file, largest
first, with the shared libraries' sum.

Run it by path, not with ``-m``: ``-m`` imports the package, and with it
torch, before the first step.

  python weatherbenchx_tpu_torch/tools/rss_breakdown.py [--device cpu]
      [--top 25]

``--device cuda``, the default, raises without a GPU. Prints one line per
step, then one JSON line with every number.
"""

import argparse
import importlib
import json
import os
import sys
import time
from typing import Optional, Sequence

# The modules tools/stream_scale_demo.py imports, in its order.
STREAM_MODULES = (
    'weatherbenchx_tpu_torch.aggregation',
    'weatherbenchx_tpu_torch.binning',
    'weatherbenchx_tpu_torch.native',
    'weatherbenchx_tpu_torch.observability',
    'weatherbenchx_tpu_torch.io',
    'weatherbenchx_tpu_torch.time_chunks',
    'weatherbenchx_tpu_torch.weighting',
    'weatherbenchx_tpu_torch.zarr_io',
    'weatherbenchx_tpu_torch.apps.run_evaluation',
    'weatherbenchx_tpu_torch.darray',
    'weatherbenchx_tpu_torch.data.loaders',
    'weatherbenchx_tpu_torch.metrics.deterministic',
    'weatherbenchx_tpu_torch.metrics.probabilistic',
    'weatherbenchx_tpu_torch.metrics.wrappers',
    'weatherbenchx_tpu_torch.ops.crps_pairwise',
    'weatherbenchx_tpu_torch.parallel.pipeline',
    'weatherbenchx_tpu_torch.tools.stream_scale_demo',
)
# Run by path, the script's directory is on sys.path, not the repository.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_STATUS_FIELDS = ('VmRSS', 'RssAnon', 'RssFile', 'RssShmem', 'VmHWM')


def rss_gb() -> float:
  with open('/proc/self/statm') as f:
    pages = int(f.read().split()[1])
  return pages * os.sysconf('SC_PAGE_SIZE') / 1e9


def status_gb() -> dict:
  """The RSS fields of /proc/self/status that this kernel gives, in GB."""
  out = {}
  with open('/proc/self/status') as f:
    for line in f:
      key, _, rest = line.partition(':')
      if key in _STATUS_FIELDS:
        out[key] = int(rest.split()[0]) * 1024 / 1e9
  return out


def smaps_gb(top: int) -> Optional[dict]:
  """Resident GB per mapping from /proc/self/smaps (None without it):
  anonymous (no path, [heap], [stack], ...) against each file."""
  try:
    f = open('/proc/self/smaps')
  except OSError:
    return None
  per_path: dict[str, float] = {}
  path = None
  with f:
    for line in f:
      head = line.split(None, 5)
      if len(head) >= 5 and '-' in head[0] and ':' in head[3]:
        path = head[5].strip() if len(head) == 6 else ''
        continue
      if line.startswith('Rss:'):
        gb = int(line.split()[1]) * 1024 / 1e9
        key = path if path and not path.startswith('[') else (
            f'[anon]{path}' if path else '[anon]')
        per_path[key] = per_path.get(key, 0.0) + gb
  anon = sum(v for k, v in per_path.items() if k.startswith('[anon]'))
  libs = sum(v for k, v in per_path.items() if '.so' in k)
  files = sum(per_path.values()) - anon
  ranked = sorted(per_path.items(), key=lambda kv: -kv[1])
  return {'total': sum(per_path.values()), 'anonymous': anon,
          'files': files, 'shared_libraries': libs,
          'mappings': len(per_path), 'top': ranked[:top]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default; raises without a GPU) or 'cpu'")
  p.add_argument('--top', type=int, default=25,
                 help='mappings to list, largest first')
  args = p.parse_args(argv)
  if REPO not in sys.path:
    sys.path.insert(0, REPO)
  steps = []

  def step(name: str) -> None:
    steps.append({'step': name, 'rss_gb': rss_gb(), **status_gb()})
    s = steps[-1]
    print(f'{name}: RSS {s["rss_gb"]:.4f} GB '
          + ' '.join(f'{k} {s[k]:.4f}' for k in _STATUS_FIELDS if k in s),
          flush=True)

  import numpy  # noqa: F401
  step('python + numpy')
  t0 = time.perf_counter()
  import torch
  step('import torch')
  device = torch.device(args.device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'--device={args.device}: no CUDA device is '
                       'available (pass --device=cpu)')
  torch.zeros((), device=device)
  step(f'context on {device}')
  import weatherbenchx_tpu_torch  # noqa: F401
  step('import weatherbenchx_tpu_torch')
  for name in STREAM_MODULES:
    importlib.import_module(name)
    step(f'import {name}')
  smaps = smaps_gb(args.top)
  if smaps is None:
    print('no /proc/self/smaps')
  else:
    print(f'smaps: {smaps["total"]:.4f} GB resident in {smaps["mappings"]} '
          f'mappings: anonymous {smaps["anonymous"]:.4f}, files '
          f'{smaps["files"]:.4f} (shared libraries '
          f'{smaps["shared_libraries"]:.4f})')
    for path, gb in smaps['top']:
      print(f'  {gb:.4f} GB  {path}')
  report = {
      'device': str(device),
      'device_name': (torch.cuda.get_device_name(device)
                      if device.type == 'cuda' else 'cpu'),
      'torch': torch.__version__, 'cuda': torch.version.cuda,
      'cuda_module_loading': os.environ.get('CUDA_MODULE_LOADING'),
      'seconds': time.perf_counter() - t0, 'steps': steps, 'smaps': smaps,
      'modules_loaded': len(sys.modules),
  }
  print(json.dumps(report), flush=True)
  return report


if __name__ == '__main__':
  main()
