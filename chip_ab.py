#!/usr/bin/env python3
"""Times the port's CUDA kernels of two checkouts in one call, in turns.

Run from the repository root on a machine with one GPU:

    python3 chip_ab.py ROOT_A ROOT_B

ROOT_A and ROOT_B are checkouts of this repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory, and this
one). Each turn runs in a process of its own, with the checkout as its
working directory and first on ``sys.path``: it builds that checkout's
kernels and calls its ``chip_smoke.time_kernels`` at the paths' shapes
(fused and spread at M = 50, spread at M = 10, cross 50 x 10, float32,
N = 4,152,960) on inputs made on the card from one seed, then times the
fused and spread-only kernels past the register kernels' 64 members,
which those shapes do not reach, at each member count of ``SORTED_M``
over the same 4,152,960 gridpoints (iid N(0, 1)). The turns go A, B, B,
A, so that drift of the card or its host weighs on both alike. Prints
each turn's medians (ms) with the card's name and power limit, then per
kernel B's median over A's and, past 64 members, each median's share of
its bytes bound (each input read once, each output written once, at
3.35 TB/s).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# The member counts timed past 64: both ends of the sorted runs, a count
# whose last run is padded most (67), the paths' 100 and 101, and the
# first and last count of two, three and four runs, and 150 and 200 (full
# runs of 50).
SORTED_M = (65, 67, 100, 101, 128, 129, 150, 192, 193, 200, 256)
HBM_BYTES_PER_S = 3.35e12
N_POINTS = 4 * 721 * 1440

_TURN = r'''
import json, sys
import torch
sys.path.insert(0, '.')
import chip_smoke as cs
from weatherbenchx_tpu_torch.ops import _build
_build.load_library()
gen = torch.Generator(device='cuda')
gen.manual_seed(0)
shape = (1, 4, 721, 1440)
x = torch.randn((50,) + shape, generator=gen, device='cuda')
y = torch.randn(shape, generator=gen, device='cuda')
yt = torch.randn((10,) + shape, generator=gen, device='cuda')
res = cs.time_kernels(x, y, yt, cs.card_line())
# Past the register kernels, which those shapes do not reach.
from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
del x, yt
n = y.numel()
for m in SORTED_M:
  xs = torch.randn((m, n), generator=gen, device='cuda')
  res.update(cs.time_cuda({
      f'fused_m{m}_kernel': lambda: cp._launch_stats(xs, y.reshape(n)),
      f'spread_m{m}_kernel': lambda: cp._launch_stats(xs, None),
  }, rounds=12, reps=20))
  del xs
print('TURN ' + json.dumps({k: v[0] for k, v in res.items()}), flush=True)
'''


def bytes_bound_ms(key: str):
  """The bytes bound of a timed kernel past 64 members, else None."""
  parts = key.split('_')
  if len(parts) != 3 or not parts[1].startswith('m'):
    return None
  name, m = parts[0], int(parts[1][1:])
  outputs = 4 if name == 'fused' else 1
  inputs = m + (1 if name == 'fused' else 0)
  return 1e3 * 4 * N_POINTS * (inputs + outputs) / HBM_BYTES_PER_S


def run_turn(root: str) -> dict:
  code = f'SORTED_M = {SORTED_M!r}\n' + _TURN
  proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                        capture_output=True, text=True, timeout=900,
                        check=False)
  if proc.returncode != 0:
    raise RuntimeError(f'{root}: turn failed ({proc.returncode}):\n'
                       f'{(proc.stdout + proc.stderr)[-4000:]}')
  line = [l for l in proc.stdout.splitlines() if l.startswith('TURN ')][-1]
  return json.loads(line.removeprefix('TURN '))


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('root_a')
  parser.add_argument('root_b')
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print('chip_ab: no CUDA device', file=sys.stderr)
    return 1
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
  roots = {'A': os.path.abspath(args.root_a), 'B': os.path.abspath(args.root_b)}
  turns = {'A': [], 'B': []}
  for name in ('A', 'B', 'B', 'A'):
    res = run_turn(roots[name])
    turns[name].append(res)
    print(f'turn {name} ({roots[name]}): {json.dumps(res)}; card {card}',
          flush=True)
  summary = {}
  for key in turns['A'][0]:
    a = float(np.median([t[key] for t in turns['A']]))
    b = float(np.median([t[key] for t in turns['B']]))
    summary[key] = {'A_ms': a, 'B_ms': b, 'B_over_A': b / a}
    bound = bytes_bound_ms(key)
    if bound is not None:
      summary[key].update(bytes_bound_ms=bound, A_share=bound / a,
                          B_share=bound / b)
  print(json.dumps({'card': card, 'kernels': summary}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
