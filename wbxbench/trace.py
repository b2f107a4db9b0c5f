"""Reduces a traced stretch's ``torch.profiler`` trace to what the per-layer
readers read.

The harness profiles a short steady stretch of chunks inside a
``bench.traced`` range, each chunk's calls inside ``bench.prepare_pair``
and ``bench.eval_accum`` ranges and the wait for the card inside
``bench.wait``. The port names each call of a kernel wrapper
``wbx.<kernel>`` (``ops/crps_pairwise``) and each statistic
``wbx.statistic.<name>`` (``parallel/evaluator``).

A device kernel belongs to the ``wbx.<kernel>`` range whose host interval
holds the call that launched it (the ``LAUNCH_CATEGORIES`` event of the same
``correlation``); where the trace carries no launch event for it, to the
``gpu_user_annotation`` of that name whose device interval holds it.
Device operations are kernels, copies and fills; the device is busy over
the union of their intervals.
"""

import collections
import dataclasses
import json

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')
WINDOW_RANGE = 'bench.traced'
# Device-operation names in the breakdown are cut to this many characters.
NAME_CHARS = 160
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Kernel:
  name: str
  dur: float  # microseconds
  range: str  # the wbx.<kernel> range's kernel name, or ''


@dataclasses.dataclass
class Context:
  """What a per-layer reader reads.

  chunks: chunks in the traced stretch; window_s: the stretch's length;
  busy_s: the union of device operations in it; kernels: its device
  kernels; ranges: {kernel: count of ``wbx.<kernel>`` calls in it};
  calls: {kernel: (members, points, itemsize)} of one call in this cell;
  host_chunk_s: the host seconds of each chunk of the untraced window
  (prepare_pair + eval_accum of every scoring); bytes_moved: {kernel:
  counts/<kernel>.py's function}; hbm_bytes_per_s: the card's peak.
  """
  chunks: int
  window_s: float
  busy_s: float
  kernels: list
  ranges: dict
  calls: dict
  host_chunk_s: list
  bytes_moved: dict
  hbm_bytes_per_s: float


def _interval(e) -> tuple:
  t = float(e['ts'])
  return t, t + float(e.get('dur', 0.0))


def _union(intervals) -> list:
  out = []
  for t0, t1 in sorted(intervals):
    if out and t0 <= out[-1][1]:
      out[-1][1] = max(out[-1][1], t1)
    else:
      out.append([t0, t1])
  return out


def _holder(spans: list, t: float) -> str:
  """The name of the innermost of ``spans`` [(start, end, name)] that
  holds time t, or ''."""
  best = None
  for t0, t1, name in spans:
    if t0 <= t <= t1 and (best is None or t1 - t0 < best[1] - best[0]):
      best = (t0, t1, name)
  return best[2] if best else ''


def reduce(path: str, kernels_of_interest) -> dict:
  """{'window_s', 'busy_s', 'kernels': [Kernel], 'ranges': {kernel:
  calls}, 'device_ops': [[name, seconds]], 'idle_gaps': [[host range,
  seconds]]} of the trace at ``path``."""
  with open(path) as f:
    events = json.load(f).get('traceEvents', [])
  xs = [e for e in events if e.get('ph') == 'X' and 'ts' in e]
  windows = [_interval(e) for e in xs if e.get('name') == WINDOW_RANGE
             and e.get('cat') == 'user_annotation']
  if not windows:
    raise ValueError(f'no {WINDOW_RANGE} range in the trace')
  w0, w1 = windows[0]
  names = {f'wbx.{k}': k for k in kernels_of_interest}
  host_ranges = collections.defaultdict(list)  # kernel -> host intervals
  gpu_ranges = collections.defaultdict(list)
  host_spans = []  # every user range: what the host was doing
  launches = {}
  ops = []
  for e in xs:
    cat, name = e.get('cat', ''), e.get('name', '')
    if cat == 'user_annotation':
      host_spans.append((*_interval(e), name))
      if name in names:
        host_ranges[names[name]].append(_interval(e))
    elif cat == 'gpu_user_annotation' and name in names:
      gpu_ranges[names[name]].append(_interval(e))
    elif cat in LAUNCH_CATEGORIES:
      corr = (e.get('args') or {}).get('correlation')
      if corr is not None:
        launches[corr] = float(e['ts'])
    elif cat in DEVICE_CATEGORIES:
      ops.append(e)
  ranges = {k: sum(1 for t0, _ in v if w0 <= t0 <= w1)
            for k, v in host_ranges.items()}

  def owner(e) -> str:
    t = launches.get((e.get('args') or {}).get('correlation'))
    pools, at = (host_ranges, t) if t is not None else (gpu_ranges,
                                                        float(e['ts']))
    for kernel, spans in pools.items():
      if any(t0 <= at <= t1 for t0, t1 in spans):
        return kernel
    return ''
  kernels, device_time = [], collections.Counter()
  intervals = []
  for e in ops:
    t0, t1 = _interval(e)
    if t1 < w0 or t0 > w1:
      continue
    t0, t1 = max(t0, w0), min(t1, w1)
    intervals.append((t0, t1))
    device_time[e['name'][:NAME_CHARS]] += (t1 - t0) * 1e-6
    if e.get('cat') == 'kernel':
      kernels.append(Kernel(e['name'], t1 - t0, owner(e)))
  busy = _union(intervals)
  gaps, prev = [], w0
  for t0, t1 in busy + [[w1, w1]]:
    if t0 > prev:
      gaps.append((prev, t0))
    prev = max(prev, t1)
  host_spans.sort()
  named = [[_holder(host_spans, g0) or 'none', (g1 - g0) * 1e-6]
           for g0, g1 in gaps]
  named.sort(key=lambda g: -g[1])
  return {
      'window_s': (w1 - w0) * 1e-6,
      'busy_s': sum(t1 - t0 for t0, t1 in busy) * 1e-6,
      'kernels': kernels,
      'ranges': ranges,
      'device_ops': [[n, s] for n, s in device_time.most_common(
          BREAKDOWN_ENTRIES)],
      'idle_gaps': named[:BREAKDOWN_ENTRIES],
  }


def roofline_pct(ctx: Context, kernel: str):
  """100 x the bytes bound of the stretch's calls of ``kernel`` over the
  device time of the kernels launched inside them; None where none ran."""
  calls = ctx.ranges.get(kernel, 0)
  seconds = sum(k.dur for k in ctx.kernels if k.range == kernel) * 1e-6
  if not calls or seconds <= 0 or kernel not in ctx.calls:
    return None
  nbytes = calls * ctx.bytes_moved[kernel](*ctx.calls[kernel])
  return 100.0 * nbytes / ctx.hbm_bytes_per_s / seconds

