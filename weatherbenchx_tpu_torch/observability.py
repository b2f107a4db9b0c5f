"""Stage timers and counters that the pipeline reports into; spans.

The port of ``weatherbenchx_tpu/observability.py:21-104`` (host-only code,
copied): a thread-safe ``Metrics`` registry of counters and timing
distributions, and a process-global default registry; and
``maybe_profile``, the JAX package's ``jax.profiler`` trace as a
``torch.profiler`` trace, with ``trace_summary`` to read one back.

Counters the pipeline records: ``chunks_done``, ``load_retries``,
``chunks_failed``, ``signature_splits`` (batches flushed early because the
next chunk's signature differed). Counters the port records in
``default_metrics`` whatever registry a pipeline has: ``eval_passes``
(``ChunkEvaluator`` compute passes, one a ``wbx.eval``),
``climatology_gather_bytes`` (bytes the climatology gathers write on the
evaluator's device) and ``climatology_host_gather_bytes`` (bytes the host
gathers of non-resident climatologies write, ``metrics/base``).
Timings (seconds): ``load_targets_seconds``, ``load_predictions_seconds``
(which includes the statistics' host preparation of the chunk:
climatology alignment indices and host-gathered climatology slices),
``eval_chunk_seconds`` (host clock
around one dispatch's device copies and the launch of its evaluation, one
chunk or a batch of ``chunks_per_dispatch``; device work may still be
running when it stops), ``checkpoint_seconds``,
``chunk_stats_sink_seconds``.

Spans (``span``): ``torch.profiler`` ranges that cost a flag check when no
profile records. ``parallel/evaluator`` opens ``wbx.prepare_host``,
``wbx.to_device`` (also around ``place`` and ``to_device_stacked``),
``wbx.eval`` (one compute pass), inside it ``wbx.statistic.<name>`` per
statistic holding ``wbx.operands`` (the weights and bin masks) and
``wbx.aggregate`` (the masked contraction), and ``wbx.state_add`` (a
chunk's state added to the running one in ``eval_accum``);
``metrics/base`` opens ``wbx.climatology`` around each gather of a
climatology at a chunk's valid times on the device (inside the
statistic's ``wbx.statistic.<name>``) and ``wbx.climatology_host`` around
each gather on the host in a statistic's ``prepare_chunk`` (inside
``wbx.prepare_host``);
``ops/crps_pairwise`` opens ``wbx.<kernel>`` around each kernel wrapper
call.
"""

import collections
import contextlib
import dataclasses
import glob
import json
import math
import os
import threading
import time
from typing import Iterator, Mapping

import torch


@dataclasses.dataclass
class Distribution:
  """Streaming distribution (count/sum/min/max)."""

  count: int = 0
  total: float = 0.0
  min: float = math.inf
  max: float = -math.inf

  def update(self, value: float) -> None:
    self.count += 1
    self.total += value
    self.min = min(self.min, value)
    self.max = max(self.max, value)

  @property
  def mean(self) -> float:
    return self.total / self.count if self.count else 0.0

  def __repr__(self):
    return (f'n={self.count} mean={self.mean * 1e3:.1f}ms '
            f'min={self.min * 1e3:.1f}ms max={self.max * 1e3:.1f}ms')


class Metrics:
  """Thread-safe counters and timing distributions, keyed by name."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counters: dict[str, int] = collections.defaultdict(int)
    self._timings: dict[str, Distribution] = collections.defaultdict(
        Distribution)

  def counter(self, name: str, increment: int = 1) -> None:
    with self._lock:
      self._counters[name] += increment

  @contextlib.contextmanager
  def timed(self, name: str) -> Iterator[None]:
    t0 = time.monotonic()
    try:
      yield
    finally:
      self.record(name, time.monotonic() - t0)

  def record(self, name: str, seconds: float) -> None:
    with self._lock:
      self._timings[name].update(seconds)

  @property
  def counters(self) -> Mapping[str, int]:
    with self._lock:
      return dict(self._counters)

  @property
  def timings(self) -> Mapping[str, Distribution]:
    # Snapshots: a live Distribution could be updated field by field under
    # a reader computing the mean from a torn pair.
    with self._lock:
      return {name: dataclasses.replace(dist)
              for name, dist in self._timings.items()}

  def summary(self) -> str:
    lines = [f'{name}: {value}'
             for name, value in sorted(self.counters.items())]
    lines += [f'{name}: {dist!r}'
              for name, dist in sorted(self.timings.items())]
    return '\n'.join(lines)


# Process-global default registry, for pipelines given none.
default_metrics = Metrics()

# What ``span`` returns while no profile records: one context for every
# span, so that an untraced run builds nothing.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
  """A profiler range ``name`` while a profile records, else a no-op.

  ``torch.profiler.record_function(name)`` while a ``torch.profiler``
  profile records on this thread, otherwise one shared
  ``contextlib.nullcontext()``.

  ``record_function`` builds its record even with no profiler running,
  some microseconds a call; this costs a flag check. A profile
  records only the ranges of the thread that started it, and the flag is
  that thread's.
  """
  if torch._C._autograd._profiler_enabled():  # pylint: disable=protected-access
    return torch.profiler.record_function(name)
  return _NO_SPAN


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None,
                  device: torch.device | str | None = None) -> Iterator[None]:
  """A ``torch.profiler`` trace when a directory is given, no-op otherwise.

  CPU activity, and CUDA activity when ``device`` is a CUDA device; the
  trace is written into ``trace_dir`` as a Chrome/TensorBoard JSON file
  (``*.pt.trace.json``) when the context exits. The port's spans (the
  module's docstring lists them) appear in it.
  """
  if not trace_dir:
    yield
    return
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device is not None and torch.device(device).type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(trace_dir, exist_ok=True)
  with torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir)):
    yield


def trace_summary(trace_dir: str) -> dict:
  """Reads the newest trace ``maybe_profile`` wrote into ``trace_dir``.

  Returns ``{'path', 'ranges': {name: count} of the user ranges,
  'cpu_ops': the count of eager operator calls, 'kernel_names': {name:
  count} of the device kernels, 'kernels': their count,
  'kernel_seconds': their summed time, 'busy_seconds': the union of their
  intervals, 'span_seconds': first kernel start to last kernel end}``.
  """
  path = max(glob.glob(os.path.join(trace_dir, '*.pt.trace.json')),
             key=os.path.getmtime)
  with open(path) as f:
    events = json.load(f).get('traceEvents', [])
  ranges: dict[str, int] = collections.Counter()
  kernel_names: dict[str, int] = collections.Counter()
  intervals = []
  cpu_ops = 0
  for e in events:
    cat = e.get('cat', '')
    if cat == 'cpu_op':
      cpu_ops += 1
    elif cat == 'user_annotation':
      ranges[e['name']] += 1
    elif cat == 'kernel' and e.get('ph') == 'X':
      kernel_names[e['name']] += 1
      intervals.append((float(e['ts']), float(e['ts']) + float(e['dur'])))
  intervals.sort()
  busy, end = 0.0, -math.inf
  for t0, t1 in intervals:
    if t1 > end:
      busy += t1 - max(t0, end)
      end = t1
  span = end - intervals[0][0] if intervals else 0.0
  return {'path': path, 'ranges': dict(ranges), 'cpu_ops': cpu_ops,
          'kernel_names': dict(kernel_names), 'kernels': len(intervals),
          'kernel_seconds': sum(t1 - t0 for t0, t1 in intervals) * 1e-6,
          'busy_seconds': busy * 1e-6, 'span_seconds': span * 1e-6}
