"""Stage timers and counters that the pipeline reports into.

The port of ``weatherbenchx_tpu/observability.py:21-104`` (host-only code,
copied): a thread-safe ``Metrics`` registry of counters and timing
distributions, and a process-global default registry. The JAX package's
``maybe_profile`` (a ``jax.profiler`` trace) is not ported yet.

Counters the pipeline records: ``chunks_done``, ``load_retries``,
``chunks_failed``. Timings (seconds): ``load_targets_seconds``,
``load_predictions_seconds``, ``eval_chunk_seconds`` (host clock around
one chunk's device copy and the launch of its evaluation; device work may
still be running when it stops), ``checkpoint_seconds``.
"""

import collections
import contextlib
import dataclasses
import math
import threading
import time
from typing import Iterator, Mapping


@dataclasses.dataclass
class Distribution:
  """Streaming distribution (count/sum/min/max + sum of squares)."""

  count: int = 0
  total: float = 0.0
  min: float = math.inf
  max: float = -math.inf
  total_sq: float = 0.0

  def update(self, value: float) -> None:
    self.count += 1
    self.total += value
    self.total_sq += value * value
    self.min = min(self.min, value)
    self.max = max(self.max, value)

  @property
  def mean(self) -> float:
    return self.total / self.count if self.count else 0.0

  @property
  def std(self) -> float:
    if self.count < 2:
      return 0.0
    var = self.total_sq / self.count - self.mean ** 2
    return math.sqrt(max(var, 0.0))

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
    # a reader computing mean/std from a torn pair.
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
