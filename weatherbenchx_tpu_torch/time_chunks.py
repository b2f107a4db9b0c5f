"""Evaluation-time chunking: the Cartesian grid of (init_time, lead_time) chunks.

A copy of ``weatherbenchx_tpu/time_chunks.py`` (numpy only; the port
cannot import the JAX package, every module of which needs jax). The
iterator yields the product of init_time chunks x lead_time chunks; lead
times are either an exact np.timedelta64 array (chunkable) or a slice
interval (kept whole, inclusive end: loaders window it). Chunk offsets
locate each chunk inside the full arrays for result assembly, and key the
pipeline's buckets.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Iterator

import numpy as np

TimeChunk = tuple[np.ndarray, "np.ndarray | slice"]


@dataclasses.dataclass(frozen=True)
class TimeChunkOffsets:
  """Element offsets of one chunk within the full init/lead arrays."""

  init_time: int
  lead_time: int


def _check_chunk_size(name: str, size: int | None) -> None:
  # 0 is rejected rather than treated as falsy/None: a caller that computed
  # a zero chunk size has a bug, and truthiness-based guards downstream
  # (the slice-incompatibility check) would silently bypass it.
  if size is not None and size < 1:
    raise ValueError(f'{name} must be a positive int or None; got {size}')


def _split(values: np.ndarray, size: int | None) -> tuple[list, int]:
  """Consecutive pieces of at most ``size`` elements (one piece if falsy)."""
  if not size:
    size = max(len(values), 1)
  pieces = [values[lo:lo + size] for lo in range(0, len(values), size)]
  return pieces, size


def _as_lead_interval(interval: slice) -> slice:
  """Validates a lead-time interval: closed range, no step, both ends set."""
  if interval.step is not None:
    raise ValueError(
        f'a lead_times interval takes no step; got step={interval.step}')
  if interval.start is None or interval.stop is None:
    raise ValueError(
        'a lead_times interval needs both ends; got '
        f'slice({interval.start}, {interval.stop})')
  return interval


class TimeChunks(Iterable[TimeChunk]):
  """Iterable over (init_times, lead_times) chunk tuples.

  Iteration order is init-major / lead-minor, so ``__getitem__(index)``
  decomposes as ``index = init_chunk_index * num_lead_chunks +
  lead_chunk_index`` — the layout the pipeline's modulo sharding and the
  offset bookkeeping rely on.
  """

  def __init__(
      self,
      init_times: np.ndarray,
      lead_times: "np.ndarray | slice",
      init_time_chunk_size: int | None = None,
      lead_time_chunk_size: int | None = None,
  ):
    _check_chunk_size('init_time_chunk_size', init_time_chunk_size)
    _check_chunk_size('lead_time_chunk_size', lead_time_chunk_size)

    self._init_times = np.asarray(init_times).astype('datetime64[ns]')
    self._init_chunks, self._init_time_chunk_size = _split(
        self._init_times, init_time_chunk_size)

    if isinstance(lead_times, slice):
      # An interval stays one chunk: its extent in the source data is
      # unknown until a loader windows it, so there is nothing to split.
      if lead_time_chunk_size:
        raise ValueError(
            'lead_time_chunk_size cannot be combined with a lead_times '
            'interval (slice) — an interval is always a single chunk')
      self._lead_times: np.ndarray | slice = _as_lead_interval(
          lead_times)
      self._lead_chunks: list = [self._lead_times]
      self._lead_time_chunk_size = lead_time_chunk_size
    elif isinstance(lead_times, np.ndarray):
      self._lead_times = lead_times.astype('timedelta64[ns]')
      self._lead_chunks, self._lead_time_chunk_size = _split(
          self._lead_times, lead_time_chunk_size)
    else:
      raise ValueError(
          'lead_times must be an np.ndarray of timedeltas or a slice '
          f'interval; got {type(lead_times).__name__}')

  @property
  def init_times(self) -> np.ndarray:
    return self._init_times

  @property
  def lead_times(self) -> "np.ndarray | slice":
    return self._lead_times

  @property
  def init_time_chunk_size(self) -> int:
    return self._init_time_chunk_size

  @property
  def lead_time_chunk_size(self) -> int | None:
    return self._lead_time_chunk_size

  def __len__(self) -> int:
    return len(self._init_chunks) * len(self._lead_chunks)

  def _decompose(self, index: int) -> tuple[int, int]:
    return divmod(index, len(self._lead_chunks))

  def __getitem__(self, index: int) -> TimeChunk:
    if not 0 <= index < len(self):
      raise IndexError(
          f'chunk index {index} outside [0, {len(self)})')
    i, j = self._decompose(index)
    return self._init_chunks[i], self._lead_chunks[j]

  def __iter__(self) -> Iterator[TimeChunk]:
    for index in range(len(self)):
      yield self[index]

  def iter_with_chunk_offsets(
      self,
  ) -> Iterator[tuple[TimeChunkOffsets, TimeChunk]]:
    """Yields (offsets, chunk) pairs locating each chunk in the full arrays."""
    for index in range(len(self)):
      i, j = self._decompose(index)
      offsets = TimeChunkOffsets(
          init_time=i * self._init_time_chunk_size,
          lead_time=j * (self._lead_time_chunk_size or 0))
      yield offsets, self[index]
