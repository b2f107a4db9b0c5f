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
fused and spread-only kernels past the register kernels' 64 members at
each member count of ``SORTED_M`` and ``WIDE_M`` over the same 4,152,960
gridpoints, at each of ``HENS_M`` over 1,038,240 (one 0.25-degree field),
and the cross kernel at each shape of ``CROSSES`` (iid N(0, 1) each), in
whatever form the checkout routes them to. A call's samples adapt to its
length: about 50 ms of calls a sample, 12 samples; 2 samples of one call
past 300 ms a call; one call past 2 s (the pair form past 1,000 members,
up to 39 s a call at 7,424). Where the checkout's ``_launch_stats`` takes a
``form``, it also times the block sort at ``FORCED_M`` (the sorted runs'
counts). Past one point's block sort it times both checkouts at each of
``MERGE_M`` over ``MERGE_POINTS`` points (a pair loop there, 5 to 9 s a
call, takes one sample), and where the checkout has the merge sort
(``MERGESORT_MEMBERS``) also at ``MERGE_WIDE_M``. The turns go A, B, B,
A, so that drift of the card or its host weighs on both alike. Prints each
turn's medians (ms) with the card's name and power limit, then per kernel
B's median over A's and, for the ensemble statistics and crosses, each
median's share of its bytes bound (each input read once, each output
written once, at 3.35 TB/s).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

# The member counts timed past 64 over 4,152,960 points: both ends of the
# sorted runs, a count whose last run is padded most (67), the paths' 100
# and 101, and the first and last count of two, three and four runs, and
# 150 and 200 (full runs of 50).
SORTED_M = (65, 67, 100, 101, 128, 129, 150, 192, 193, 200, 256)
# Past 256 over 4,152,960 points: the block sort's first count, 300, 512,
# 1,024 and 1,816 (the tiled pair form's one tile).
WIDE_M = (257, 300, 512, 1024, 1816)
# Over 1,038,240 points: 4,000 and HENS's 7,424.
HENS_M = (4000, 7424)
# (Mx, My, points): two large ensembles, and phase 4c's 7,424 x 10.
CROSSES = ((64, 64, 4152960), (256, 256, 4152960), (1816, 1819, 1038240),
           (7424, 10, 1038240))
# The block sort forced where the sorted runs serve.
FORCED_M = (129, 192, 256)
# Past one point's block sort, over MERGE_POINTS points: its first count
# and phase 4d's 59,392 in both checkouts; 131,072 and 2^20 where the
# checkout has the merge sort (a pair form would take minutes).
MERGE_M = (58113, 59392)
MERGE_WIDE_M = (131072, 1 << 20)
MERGE_POINTS = 1024
HBM_BYTES_PER_S = 3.35e12
N_POINTS = 4 * 721 * 1440

_TURN = r'''
import inspect, json, sys
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
res = {k: v[0] for k, v in cs.time_kernels(x, y, yt, cs.card_line()).items()}
from weatherbenchx_tpu_torch.ops import crps_pairwise as cp
del x, yt
forms = 'form' in inspect.signature(cp._launch_stats).parameters


def timed(fns):
  """Median ms per call: one call first, timed by CUDA events, which is the
  one sample past 2 s a call (the pair form past 1,000 members); then about
  50 ms of calls a sample, 12 samples, or 2 samples of one call past 300
  ms a call."""
  out = {}
  for name, fn in fns.items():
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    if ms > 2000:
      out[name] = ms
      continue
    reps = max(1, min(20, int(50 / max(ms, 1e-3))))
    rounds = 12 if ms < 300 else 2
    out[name] = cs.time_cuda({name: fn}, rounds=rounds, reps=reps)[name][0]
  return out


def stats_turn(m, n, form=None):
  xs = torch.randn((m, n), generator=gen, device='cuda')
  ys = torch.randn(n, generator=gen, device='cuda')
  kw = {'form': form} if form else {}
  tag = f'm{m}_n{n}' + (f'_{form}' if form else '')
  got = timed({f'fused_{tag}': lambda: cp._launch_stats(xs, ys, **kw),
               f'spread_{tag}': lambda: cp._launch_stats(xs, None, **kw)})
  del xs, ys
  return got


def cross_turn(mx, my, n):
  xs = torch.randn((mx, n), generator=gen, device='cuda')
  ys = torch.randn((my, n), generator=gen, device='cuda')
  got = timed({f'cross_{mx}x{my}_n{n}': lambda: cp._launch_cross(xs, ys)})
  del xs, ys
  return got


n = y.numel()
for m in SORTED_M + WIDE_M:
  res.update(stats_turn(m, n))
for m in HENS_M:
  res.update(stats_turn(m, n // 4))
for mx, my, points in CROSSES:
  res.update(cross_turn(mx, my, points))
if forms:
  for m in FORCED_M:
    res.update(stats_turn(m, n, 'blocksort'))
del y
for m in MERGE_M:
  res.update(stats_turn(m, MERGE_POINTS))
if hasattr(cp, 'MERGESORT_MEMBERS'):
  for m in MERGE_WIDE_M:
    res.update(stats_turn(m, MERGE_POINTS))
print('TURN ' + json.dumps(res), flush=True)
'''


def bytes_bound_ms(key: str):
  """The bytes bound of a timed statistic or cross, else None: keys
  '{fused|spread}_m{M}_n{N}[_form]' and 'cross_{Mx}x{My}_n{N}'."""
  parts = key.split('_')
  if len(parts) < 3 or not parts[2].startswith('n'):
    return None
  name, n = parts[0], int(parts[2][1:])
  if name == 'cross':
    mx, my = (int(v) for v in parts[1].split('x'))
    inputs, outputs = mx + my, 1
  else:
    m = int(parts[1][1:])
    outputs = 4 if name == 'fused' else 1
    inputs = m + (1 if name == 'fused' else 0)
  return 1e3 * 4 * n * (inputs + outputs) / HBM_BYTES_PER_S


def run_turn(root: str) -> dict:
  code = (f'SORTED_M = {SORTED_M!r}\nWIDE_M = {WIDE_M!r}\n'
          f'HENS_M = {HENS_M!r}\nCROSSES = {CROSSES!r}\n'
          f'FORCED_M = {FORCED_M!r}\nMERGE_M = {MERGE_M!r}\n'
          f'MERGE_WIDE_M = {MERGE_WIDE_M!r}\n'
          f'MERGE_POINTS = {MERGE_POINTS!r}\n' + _TURN)
  proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                        capture_output=True, text=True, timeout=1500,
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
  for key in sorted(set(turns['A'][0]) | set(turns['B'][0])):
    row = {}
    for side in ('A', 'B'):
      if key in turns[side][0]:
        row[f'{side}_ms'] = float(np.median([t[key] for t in turns[side]]))
    if 'A_ms' in row and 'B_ms' in row:
      row['B_over_A'] = row['B_ms'] / row['A_ms']
    bound = bytes_bound_ms(key)
    if bound is not None:
      row['bytes_bound_ms'] = bound
      for side in ('A', 'B'):
        if f'{side}_ms' in row:
          row[f'{side}_share'] = bound / row[f'{side}_ms']
    summary[key] = row
  print(json.dumps({'card': card, 'kernels': summary}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
