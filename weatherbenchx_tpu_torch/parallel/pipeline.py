"""The chunked evaluation loop: TimeChunks → load → eval → reduce → write.

The port of ``weatherbenchx_tpu/parallel/pipeline.py:52-204, 262-652,
696-790`` to one device:

* host enumeration of ``TimeChunks``, with threaded prefetch: loader
  threads do host work only (selection, gathers, numpy, and the
  statistics' host preparation ``ChunkEvaluator.prepare_host``, i.e.
  climatology alignment indices and host-gathered climatology slices);
  every device operation runs on the calling thread;
* per chunk, ``ChunkEvaluator.eval_host_prepared`` on the pipeline's
  device, its state added to a running bucket per (init_time, lead_time)
  offset of the dims the aggregator keeps;
* at the end, the buckets on the host in float64, combined by the
  zero-filled outer join of ``aggregation.combining_sum`` (preserved
  chunked dims concatenate);
* atomic writes of the metric values and the state (the container by
  suffix) and of checkpoints: ``.wbx`` bucket files locally, the portable
  npz container's bytes on a remote path. Checkpoints alternate two
  generations of bucket files under an atomic manifest, and record each
  leaf's live dtype, so a resumed run restores the float32 sums exactly and
  ends bit-identical to an uninterrupted one.

* optionally, ``chunk_stats_sink(i, offsets, {'<stat>.<var>': DimArray})``
  per chunk, with host copies of the very statistics the aggregated step
  consumed (computed once; ``ChunkEvaluator.eval_with_statistics``), their
  coords intact, station names of a sparse chunk included: unaggregated
  output (``parallel/unaggregated.ZarrStatsStore.write_chunk``) streams
  from the same pass.

Not ported: the device mesh and multi-process (``mesh``, ``dim_to_axis``,
``distributed``) and ``chunks_per_dispatch`` are queued;
``compilation_cache_dir``, ``WBX_FUSED_ACCUM`` and the in-flight byte
window are XLA and remote-accelerator machinery with nothing to do here
(eager PyTorch blocks the host on each pageable host→device copy, so no
staged-byte backlog builds up).
"""

import dataclasses
import json
import logging
import time
from concurrent import futures
from typing import Callable, Mapping, Optional

import torch

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch import fileio
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks as time_chunks_lib
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.data import base as data_base
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from weatherbenchx_tpu_torch.parallel import evaluator as evaluator_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
  """Transient-failure policy for chunk loads.

  Each chunk load retries transient errors with exponential backoff and,
  opt-in, chunks that still fail are skipped and reported instead of
  failing the run. The accumulated state is a monoid, so a run with
  skipped chunks is exactly recoverable: re-run the failed chunks (listed
  in the failures sidecar of ``run_and_write``) and sum the saved states.

  Attributes:
    retries: max re-attempts per chunk load after the first failure.
    backoff_s: first retry delay; attempt k sleeps ``backoff_s * 2**k``.
    max_backoff_s: delay cap.
    retryable: exception classes classified as transient (by default the
      I/O family). Programming errors (KeyError, shape mismatches, ...)
      are never retried or skipped.
    skip_failed: if True, a chunk whose retries are exhausted is dropped
      (recorded in the pipeline's ``failed_chunks`` and the counter
      ``chunks_failed``) instead of raising.
  """
  retries: int = 3
  backoff_s: float = 1.0
  max_backoff_s: float = 30.0
  retryable: tuple = (OSError,)
  skip_failed: bool = False


def _load_with_retries(load_fn, chunk, retry: RetryPolicy, obs=None):
  attempt = 0
  while True:
    try:
      return load_fn(chunk)
    except retry.retryable as e:
      if attempt >= retry.retries:
        raise
      delay = min(retry.backoff_s * (2 ** attempt), retry.max_backoff_s)
      attempt += 1
      if obs is not None:
        obs.counter('load_retries')
      logger.warning('chunk load failed (%s: %s); retry %d/%d in %.1fs',
                     type(e).__name__, e, attempt, retry.retries, delay)
      time.sleep(delay)


def load_chunk_pair(
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    chunk: time_chunks_lib.TimeChunk,
    obs: Optional[observability.Metrics] = None,
    prepare: Optional[Callable] = None,
):
  """Loads one (predictions, targets) chunk pair on the host.

  ``prepare(predictions, targets)``, host work on the loaded pair (the
  evaluator's ``prepare_host``), runs as the last step of loading the
  predictions and is timed with them.
  """
  init_times, lead_times = chunk
  t0 = time.monotonic()
  targets = targets_loader.load_chunk(init_times, lead_times)
  t1 = time.monotonic()
  predictions = predictions_loader.load_chunk(
      init_times, lead_times, reference=targets)
  if prepare is not None:
    predictions, targets = prepare(predictions, targets)
  t2 = time.monotonic()
  if obs is not None:
    obs.record('load_targets_seconds', t1 - t0)
    obs.record('load_predictions_seconds', t2 - t1)
  logger.info('loaded chunk: targets %.0fms predictions %.0fms',
              (t1 - t0) * 1e3, (t2 - t1) * 1e3)
  return predictions, targets


def stream_chunk_pairs(
    load_fn: Callable,
    times: time_chunks_lib.TimeChunks,
    prefetch: int = 2,
    start_chunk: int = 0,
    retry: Optional[RetryPolicy] = None,
    obs: Optional[observability.Metrics] = None,
    on_failure: Optional[Callable] = None,
):
  """Yields (index, offsets, load_fn(chunk)) in order, ``prefetch`` ahead.

  ``retry`` applies :class:`RetryPolicy` to each load; with
  ``retry.skip_failed`` a chunk whose transient-classified failure survives
  all retries is reported via ``on_failure(index, offsets, exc)`` and
  dropped from the stream instead of raising.
  """
  if retry is not None and retry.retries > 0:
    inner, load_fn = load_fn, (
        lambda chunk: _load_with_retries(inner, chunk, retry, obs))
  # Only transient-classified failures are skippable: a bug that skipped
  # every chunk would masquerade as a clean empty result.
  skippable = retry.retryable if retry is not None and retry.skip_failed else ()
  items = [it for it in enumerate(times.iter_with_chunk_offsets())
           if it[0] >= start_chunk]
  if not items:
    return
  depth = max(prefetch, 1)
  with futures.ThreadPoolExecutor(max_workers=depth) as ex:
    pending = [(i, offsets, ex.submit(load_fn, chunk))
               for i, (offsets, chunk) in items[:depth]]
    queued = iter(items[depth:])
    while pending:
      i, offsets, fut = pending.pop(0)
      try:
        result = fut.result()
      except skippable as e:
        logger.error('chunk %d failed after %d retries, skipping: %s: %s',
                     i, retry.retries, type(e).__name__, e)
        if obs is not None:
          obs.counter('chunks_failed')
        if on_failure is not None:
          on_failure(i, offsets, e)
        result = None
      nxt = next(queued, None)
      if nxt is not None:
        j, (offs, chunk) = nxt
        pending.append((j, offs, ex.submit(load_fn, chunk)))
      if result is not None:
        yield i, offsets, result


@dataclasses.dataclass
class EvaluationPipeline:
  """Chunked, restartable evaluation on one device.

  Attributes:
    metrics: metric name → Metric.
    aggregator: the Aggregator.
    predictions_loader / targets_loader: DataLoaders (host chunks).
    times: TimeChunks enumeration.
    device: the device chunks are evaluated on, e.g. 'cuda' or 'cpu'.
    prefetch: number of chunks loaded ahead of the device (host threads).
    checkpoint_path: if set, running state is saved here every
      ``checkpoint_every`` chunks and resumed from on restart.
    retry: transient-failure policy for chunk loads. After a run with
      ``retry.skip_failed``, the dropped chunks are listed in
      ``failed_chunks`` as (chunk index, offsets, error string), and
      ``run_and_write`` writes them beside the metrics output.
    metrics_registry: counters and timers (``observability``); the
      process-global default if None.
    chunk_stats_sink: optional, called per chunk as ``sink(i, offsets,
      {'<stat>.<var>': DimArray})`` with host copies of the statistics the
      aggregated step consumed (timed as ``chunk_stats_sink_seconds``).
  """

  metrics: Mapping[str, metrics_base.Metric]
  aggregator: aggregation_lib.Aggregator
  predictions_loader: data_base.DataLoader
  targets_loader: data_base.DataLoader
  times: time_chunks_lib.TimeChunks
  device: torch.device | str
  prefetch: int = 2
  checkpoint_path: Optional[str] = None
  checkpoint_every: int = 0
  retry: Optional[RetryPolicy] = None
  metrics_registry: Optional[observability.Metrics] = None
  chunk_stats_sink: Optional[Callable] = None
  failed_chunks: list = dataclasses.field(default_factory=list, init=False)

  def __post_init__(self):
    self.device = torch.device(self.device)
    self._obs = self.metrics_registry or observability.default_metrics
    self._evaluator = evaluator_lib.ChunkEvaluator(
        metrics=self.metrics, aggregator=self.aggregator, device=self.device)
    reduce_dims = set(self.aggregator.reduce_dims)
    self._bucket_dims = tuple(
        d for d in ('init_time', 'lead_time') if d not in reduce_dims)
    self._ckpt_gen = 1

  # -- chunk loading ---------------------------------------------------------

  def _load(self, chunk: time_chunks_lib.TimeChunk):
    return load_chunk_pair(self.predictions_loader, self.targets_loader,
                           chunk, obs=self._obs,
                           prepare=self._evaluator.prepare_host)

  def _chunk_stream(self, start_chunk: int = 0):
    """Yields (index, offsets, (predictions, targets)), host chunks
    already through the evaluator's host preparation.

    ``start_chunk`` drops completed chunks before their loads are
    submitted, so a resumed run does not re-read them.
    """
    # self._load looked up per call so tests/wrappers can substitute it.
    yield from stream_chunk_pairs(
        lambda chunk: self._load(chunk), self.times,
        prefetch=self.prefetch, start_chunk=start_chunk, retry=self.retry,
        obs=self._obs,
        on_failure=lambda i, offsets, e: self.failed_chunks.append(
            (i, offsets, f'{type(e).__name__}: {e}')))

  def _bucket_key(self, offsets: time_chunks_lib.TimeChunkOffsets) -> tuple:
    return tuple(getattr(offsets, d) if d in self._bucket_dims else -1
                 for d in ('init_time', 'lead_time'))

  # -- checkpointing -----------------------------------------------------------

  def _ckpt_manifest(self) -> str:
    return f'{self.checkpoint_path}.manifest.json'

  def _save_checkpoint(self, buckets, next_chunk: int) -> None:
    # Bucket files alternate between two generations, so a save never
    # overwrites the files the CURRENT manifest points at: a crash anywhere
    # before the manifest's atomic replace leaves the previous (manifest,
    # buckets) set intact. Overwriting in place would let a crash between
    # the bucket writes and the manifest write pair the OLD next_chunk with
    # NEW sums, and resume would count chunks twice.
    gen = 1 - self._ckpt_gen
    manifest = {'next_chunk': next_chunk, 'generation': gen, 'buckets': []}
    for k, (key, state) in enumerate(sorted(buckets.items())):
      # .wbx: thread-parallel raw block writes (the native blockstore);
      # checkpoints are the pipeline's hottest host I/O. On a remote path
      # save_dataset_atomic writes portable npz bytes through fsspec.
      path = f'{self.checkpoint_path}.g{gen}.bucket{k}.wbx'
      fileio.save_dataset_atomic(path, state.to_host().to_dataset())
      # Live (pre-float64) dtypes, so resume restores exactly.
      dtypes = {name: str(da.dtype).removeprefix('torch.')
                for name, da in state.to_dataset().items()}
      manifest['buckets'].append(
          {'key': list(key), 'path': path, 'dtypes': dtypes})
    fileio.write_text_atomic(self._ckpt_manifest(), json.dumps(manifest))
    self._ckpt_gen = gen  # flip only once the manifest commit succeeded

  def _load_checkpoint(self):
    if not self.checkpoint_path or not fileio.exists(self._ckpt_manifest()):
      return {}, 0
    manifest = json.loads(fileio.read_text(self._ckpt_manifest()))
    # The next save writes the OTHER generation, preserving the files this
    # manifest references until the new manifest lands.
    self._ckpt_gen = manifest['generation']
    buckets = {}
    for b in manifest['buckets']:
      # Each leaf back on the device in its recorded live dtype (float32
      # sums round-trip float64 exactly), so accumulation resumes
      # bit-identical to an uninterrupted run. Coords stay on the host, as
      # the evaluator makes them.
      buckets[tuple(b['key'])] = (
          aggregation_lib.AggregationState.from_dataset({
              name: da.copy(data=da.data.to(
                  self.device, getattr(torch, b['dtypes'][name])))
              for name, da in fileio.load_dataset_any(b['path']).items()}))
    logger.info('resuming from checkpoint at chunk %d', manifest['next_chunk'])
    return buckets, manifest['next_chunk']

  # -- main loop -----------------------------------------------------------------

  def run(self) -> aggregation_lib.AggregationState:
    """Evaluates all chunks; returns the total AggregationState (host)."""
    self.failed_chunks = []
    buckets, start_chunk = self._load_checkpoint()
    done = 0
    for i, offsets, (predictions, targets) in self._chunk_stream(start_chunk):
      key = self._bucket_key(offsets)
      with self._obs.timed('eval_chunk_seconds'):
        if self.chunk_stats_sink is None:
          state = self._evaluator.eval_host_prepared(predictions, targets)
        else:
          state, stats = self._evaluator.eval_with_statistics(
              predictions, targets)
        buckets[key] = buckets[key] + state if key in buckets else state
      if self.chunk_stats_sink is not None:
        with self._obs.timed('chunk_stats_sink_seconds'):
          self.chunk_stats_sink(i, offsets, {
              f'{stat_name}.{var}': da
              for stat_name, per_var in stats.items()
              for var, da in per_var.items()})
      self._obs.counter('chunks_done')
      done += 1
      if (self.checkpoint_path and self.checkpoint_every
          and done % self.checkpoint_every == 0):
        with self._obs.timed('checkpoint_seconds'):
          self._save_checkpoint(buckets, i + 1)
      logger.info('chunk %d/%d done', i + 1, len(self.times))
    # Final cross-bucket combine on the host, in float64: the outer join
    # concatenates the preserved chunked dims.
    return aggregation_lib.AggregationState.sum(
        [s.to_host() for s in buckets.values()])

  def run_and_write(
      self,
      out_path: Optional[str] = None,
      aggregation_state_out_path: Optional[str] = None,
  ) -> dict[str, DimArray]:
    """Runs the pipeline, writes metric values (and optionally the state)."""
    state = self.run()
    values = state.metric_values(self.metrics)
    if out_path:
      fileio.save_dataset_atomic(out_path, values)
      if self.failed_chunks:
        # Sidecar listing the skipped chunks, so that the failed slice can
        # be re-run and monoid-summed into the saved state.
        fileio.write_text_atomic(
            f'{out_path}.failures.json',
            json.dumps([{'chunk': i, 'offsets': dataclasses.asdict(o),
                         'error': err}
                        for i, o, err in self.failed_chunks],
                       indent=2, default=str))
    if aggregation_state_out_path:
      fileio.save_dataset_atomic(aggregation_state_out_path,
                                 state.to_dataset())
    return values


def evaluate(
    metrics: Mapping[str, metrics_base.Metric],
    aggregator: aggregation_lib.Aggregator,
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    times: time_chunks_lib.TimeChunks,
    out_path: Optional[str] = None,
    aggregation_state_out_path: Optional[str] = None,
    **kwargs,
) -> dict[str, DimArray]:
  """One-call evaluation: an EvaluationPipeline, run and written.

  ``kwargs`` go to :class:`EvaluationPipeline`; ``device`` is required.
  """
  pipe = EvaluationPipeline(
      metrics=metrics, aggregator=aggregator,
      predictions_loader=predictions_loader, targets_loader=targets_loader,
      times=times, **kwargs)
  return pipe.run_and_write(out_path, aggregation_state_out_path)
