"""Reads a traced stretch by the port's own spans.

``trace.reduce`` names a device kernel by the ``wbx.<kernel>`` range that
launched it, and an idle gap by the innermost user range that holds the
host at the gap's start. This module reads the same ``torch.profiler``
trace by every ``wbx.*`` span of the port (``observability`` in the port
lists them): each kernel of the stretch with the spans that hold its launch
(the ``trace.LAUNCH_CATEGORIES`` event of the same ``correlation``; where
the trace has none, the ``gpu_user_annotation`` spans whose device interval
holds the kernel), and each synchronizing CUDA runtime call with the user
range that holds it.

From that: the device time a chunk of the kernels launched inside
``wbx.aggregate`` (the masked contraction), of those launched inside a
``wbx.statistic.*`` span but outside ``wbx.aggregate``, ``wbx.operands``
and every ``wbx.<kernel>`` range (the statistics' own torch ops), the
torch ops' device time by the innermost span that launched them, and the
host's waits a chunk outside the harness's own ``bench.wait`` and
``bench.sync``. ``run.py`` does not call this module: a per-layer reader
sees only ``trace.Context``, which carries none of it.
"""

import collections
import dataclasses
import json

from wbxbench import trace

# pylint: disable=protected-access

SPAN_PREFIX = 'wbx.'
STATISTIC_PREFIX = 'wbx.statistic.'
CONTRACTION = 'wbx.aggregate'
OPERANDS = 'wbx.operands'
# CUDA runtime calls that hold the host until the device has caught up.
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy')
# The harness's own waits for the card.
HARNESS_WAITS = ('bench.wait', 'bench.sync')
# The harness's ranges around the port's calls of a chunk.
HOST_CALLS = ('bench.prepare_pair', 'bench.eval_accum')


@dataclasses.dataclass
class SpanKernel:
  name: str
  dur: float  # microseconds inside the stretch
  spans: tuple  # names of the wbx.* spans holding its launch, outermost first


def _holding(spans: list, t: float) -> tuple:
  """Names of the spans [(start, end, name)] that hold time t, outermost
  (longest) first."""
  held = [s for s in spans if s[0] <= t <= s[1]]
  held.sort(key=lambda s: s[0] - s[1])
  return tuple(s[2] for s in held)


def reduce(path: str) -> dict:
  """{'kernels': [SpanKernel], 'host_waits': [the innermost user range
  holding each synchronizing runtime call outside HARNESS_WAITS, '' for
  none], 'host_s': seconds of the HOST_CALLS ranges} of the stretch of the
  trace at ``path``."""
  with open(path) as f:
    events = json.load(f).get('traceEvents', [])
  xs = [e for e in events if e.get('ph') == 'X' and 'ts' in e]
  windows = [trace._interval(e) for e in xs
             if e.get('name') == trace.WINDOW_RANGE
             and e.get('cat') == 'user_annotation']
  if not windows:
    raise ValueError(f'no {trace.WINDOW_RANGE} range in the trace')
  w0, w1 = windows[0]
  host, gpu, launches, syncs, ops = [], [], {}, [], []
  for e in xs:
    cat, name = e.get('cat', ''), e.get('name', '')
    if cat == 'user_annotation':
      host.append((*trace._interval(e), name))
    elif cat == 'gpu_user_annotation' and name.startswith(SPAN_PREFIX):
      gpu.append((*trace._interval(e), name))
    elif cat in trace.LAUNCH_CATEGORIES:
      corr = (e.get('args') or {}).get('correlation')
      if corr is not None:
        launches[corr] = float(e['ts'])
      if name in SYNC_CALLS and w0 <= float(e['ts']) <= w1:
        syncs.append(float(e['ts']))
    elif cat == 'kernel':
      ops.append(e)
  port = [s for s in host if s[2].startswith(SPAN_PREFIX)]
  kernels = []
  for e in ops:
    t0, t1 = trace._interval(e)
    if t1 < w0 or t0 > w1:
      continue
    at = launches.get((e.get('args') or {}).get('correlation'))
    spans = _holding(port, at) if at is not None else _holding(gpu, t0)
    kernels.append(SpanKernel(e['name'], min(t1, w1) - max(t0, w0), spans))
  waits = []
  for t in syncs:
    holders = _holding(host, t)
    if not set(holders) & set(HARNESS_WAITS):
      waits.append(holders[-1] if holders else '')
  host_s = sum(t1 - t0 for t0, t1, name in host
               if name in HOST_CALLS and w0 <= t0 <= w1) * 1e-6
  return {'kernels': kernels, 'host_waits': waits, 'host_s': host_s}


def _ms_per_chunk(kernels, chunks: int):
  if not chunks:
    return None
  return 1e-3 * sum(k.dur for k in kernels) / chunks


def contraction_ms_per_chunk(r: dict, chunks: int):
  """Device ms a chunk of the kernels launched inside ``wbx.aggregate``;
  None where the stretch has no kernel."""
  if not r['kernels']:
    return None
  return _ms_per_chunk([k for k in r['kernels'] if CONTRACTION in k.spans],
                       chunks)


def statistics_ms_per_chunk(r: dict, chunks: int, kernel_names):
  """Device ms a chunk of the kernels launched inside a
  ``wbx.statistic.*`` span but outside ``wbx.aggregate``, ``wbx.operands``
  and the ``wbx.<kernel>`` range of each of ``kernel_names``; None where
  the stretch has no kernel."""
  if not r['kernels']:
    return None
  outside = {CONTRACTION, OPERANDS} | {f'wbx.{k}' for k in kernel_names}
  return _ms_per_chunk(
      [k for k in r['kernels']
       if any(s.startswith(STATISTIC_PREFIX) for s in k.spans)
       and not outside & set(k.spans)], chunks)


def host_waits_per_chunk(r: dict, chunks: int):
  """Synchronizing runtime calls a chunk outside the harness's waits; None
  where the stretch has no kernel (no device traced)."""
  if not r['kernels'] or not chunks:
    return None
  return len(r['host_waits']) / chunks


def torch_ops_by_span(r: dict, chunks: int, kernel_names) -> dict:
  """{innermost wbx.* span ('' for none): device ms a chunk} of the
  kernels launched outside every ``wbx.<kernel>`` range: the split of
  ``torch_ops_ms_per_chunk``."""
  ranges = {f'wbx.{k}' for k in kernel_names}
  out = collections.Counter()
  for k in r['kernels']:
    if not ranges & set(k.spans):
      out[k.spans[-1] if k.spans else ''] += 1e-3 * k.dur / chunks
  return dict(out.most_common())
