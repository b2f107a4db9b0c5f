"""The chunked evaluation loop: TimeChunks → load → eval → reduce → write.

The port of ``weatherbenchx_tpu/parallel/pipeline.py:52-204, 262-652,
659-790``, one process per device:

* host enumeration of ``TimeChunks``, with threaded prefetch: loader
  threads do the host work (selection, gathers, numpy, and the
  statistics' host preparation ``ChunkEvaluator.prepare_host``, i.e.
  climatology alignment indices and host-gathered climatology slices)
  and, off a mesh, copy each side of a chunk to the device as soon as it
  is ready (``ChunkEvaluator.place``), so that the host holds at most one
  side per loader; the evaluation runs on the calling thread;
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
* ``chunks_per_dispatch`` > 1: host-prepared chunks are buffered and
  evaluated together (``ChunkEvaluator.eval_prepared``), the buffer
  flushed when the next chunk's ``batchable_signature`` differs (counted
  as ``signature_splits``), when it is full, and at the end; each chunk's
  state then goes to its own bucket, and the checkpoint cadence counts
  chunks. A sink turns batching off, as in the JAX package.
* ``profile_dir``: a ``torch.profiler`` trace of the run
  (``observability.maybe_profile``).

* ``distributed``: one process per device, each a rank of the default
  ``torch.distributed`` process group that the caller initialised. Each
  rank keeps the chunks with ``index % ranks == rank``, checkpoints under
  its own prefix (``<checkpoint_path>.p<rank>``, the manifest recording
  ``process_index`` and ``process_count``; resuming with another count
  raises), and at the end the ranks' states are all-gathered as bytes and
  summed (``distributed.allgather_sum_states``), so every rank returns the
  total.
* ``mesh`` and ``dim_to_axis``: each chunk sharded over a
  ``DeviceMesh`` (``ChunkEvaluator``), every rank of the mesh holding the
  whole chunk state; only the mesh's first rank calls the sink. With
  ``distributed`` too, the world is split into groups of ``mesh.size()``
  consecutive ranks (``distributed.group_mesh``), the chunks are
  partitioned over the groups, and only each group's first rank gives its
  state to the cross-group sum.

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
from weatherbenchx_tpu_torch.parallel import distributed as distributed_lib
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


def loader_device(device) -> torch.device:
  """``device`` with its card named: the loader threads place chunks, and
  a new thread starts on card 0, so a bare 'cuda' becomes the card the
  calling thread has current."""
  device = torch.device(device)
  if device.type == 'cuda' and device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  return device


def load_chunk_pair(
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    chunk: time_chunks_lib.TimeChunk,
    obs: Optional[observability.Metrics] = None,
    prepare: Optional[Callable] = None,
    place: Optional[Callable] = None,
):
  """Loads one (predictions, targets) chunk pair.

  ``prepare(predictions, targets)``, host work on the loaded pair (the
  evaluator's ``prepare_host``), runs as the last step of loading the
  predictions and is timed with them. ``place(side)`` (the evaluator's
  ``place``) copies each side to the device as soon as it is ready, the
  targets before the predictions are read, so that the host holds one side
  of the chunk at a time, not both (as the JAX package's worker thread
  places each prepared pair, ``_prepared_stream``); its seconds are
  ``to_device_seconds``, and not in the load timers. Without it the pair
  stays on the host.
  """
  init_times, lead_times = chunk
  placing = 0.0

  def placed(side):
    nonlocal placing
    if place is None:
      return side
    t = time.monotonic()
    side = place(side)
    placing += time.monotonic() - t
    return side

  t0 = time.monotonic()
  targets = targets_loader.load_chunk(init_times, lead_times)
  load_targets = time.monotonic() - t0
  targets = placed(targets)
  t1 = time.monotonic()
  predictions = predictions_loader.load_chunk(
      init_times, lead_times, reference=targets)
  if prepare is not None:
    predictions, targets = prepare(predictions, targets)
  load_predictions = time.monotonic() - t1
  predictions = placed(predictions)
  if obs is not None:
    obs.record('load_targets_seconds', load_targets)
    obs.record('load_predictions_seconds', load_predictions)
    if place is not None:
      obs.record('to_device_seconds', placing)
  logger.info('loaded chunk: targets %.0fms predictions %.0fms placed '
              '%.0fms', load_targets * 1e3, load_predictions * 1e3,
              placing * 1e3)
  return predictions, targets


def stream_chunk_pairs(
    load_fn: Callable,
    times: time_chunks_lib.TimeChunks,
    prefetch: int = 2,
    start_chunk: int = 0,
    retry: Optional[RetryPolicy] = None,
    obs: Optional[observability.Metrics] = None,
    on_failure: Optional[Callable] = None,
    distributed: bool = False,
    mesh=None,
):
  """Yields (index, offsets, load_fn(chunk)) in order, ``prefetch`` ahead:
  the chunk the consumer holds and the loads in flight are at most
  ``prefetch`` together.

  ``retry`` applies :class:`RetryPolicy` to each load; with
  ``retry.skip_failed`` a chunk whose transient-classified failure survives
  all retries is reported via ``on_failure(index, offsets, exc)`` and
  dropped from the stream instead of raising. With ``distributed`` each
  rank keeps the chunks with ``index % ranks == rank``; with a ``mesh``
  too, each group of ``mesh.size()`` ranks keeps ``index % groups ==
  group``.
  """
  if retry is not None and retry.retries > 0:
    inner, load_fn = load_fn, (
        lambda chunk: _load_with_retries(inner, chunk, retry, obs))
  # Only transient-classified failures are skippable: a bug that skipped
  # every chunk would masquerade as a clean empty result.
  skippable = retry.retryable if retry is not None and retry.skip_failed else ()
  items = list(enumerate(times.iter_with_chunk_offsets()))
  if distributed:
    part, parts = _partition(mesh)
    items = [it for it in items if it[0] % parts == part]
  items = [it for it in items if it[0] >= start_chunk]
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
      if result is not None:
        yield i, offsets, result
      # As in the JAX package, the next load starts once the consumer is
      # done with this chunk; dropped first (the future holds it too), so
      # that at most ``prefetch`` chunks are alive, the consumer's included.
      result = fut = None
      nxt = next(queued, None)
      if nxt is not None:
        j, (offs, chunk) = nxt
        pending.append((j, offs, ex.submit(load_fn, chunk)))


def _partition(mesh=None) -> tuple[int, int]:
  """(this rank's share, number of shares) of the chunks under
  ``distributed``: per rank, or per mesh group."""
  if mesh is None:
    return distributed_lib.rank(), distributed_lib.world_size()
  return distributed_lib.mesh_group(mesh)


def first_of_mesh(mesh) -> bool:
  """Whether this rank is the first of its mesh (or there is no mesh)."""
  if mesh is None:
    return True
  return distributed_lib.rank() == min(int(r) for r in
                                       mesh.mesh.reshape(-1).tolist())


@dataclasses.dataclass
class EvaluationPipeline:
  """Chunked, restartable evaluation on one device, a mesh, or many ranks.

  Attributes:
    metrics: metric name → Metric.
    aggregator: the Aggregator.
    predictions_loader / targets_loader: DataLoaders (host chunks).
    times: TimeChunks enumeration.
    device: the device chunks are evaluated on, e.g. 'cuda' or 'cpu'.
    prefetch: loader threads; the host chunks in flight (loading, and the
      one the device works on) are at most this many.
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
    chunks_per_dispatch: chunks of one signature evaluated together,
      stacked on the device (each flush timed as ``eval_chunk_seconds``).
      Ignored (1) when a sink is set.
    profile_dir: if set, the run is traced by ``torch.profiler`` into this
      directory (CPU, and CUDA on a CUDA device).
    mesh / dim_to_axis: optional ``DeviceMesh`` each chunk is sharded over
      (see ChunkEvaluator); ``device`` is then this rank's device.
    distributed: chunk-parallel ranks of the default process group (module
      docstring); raises without an initialised group.
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
  chunks_per_dispatch: int = 1
  profile_dir: Optional[str] = None
  mesh: Optional[object] = None
  dim_to_axis: Optional[Mapping[str, str]] = None
  distributed: bool = False
  failed_chunks: list = dataclasses.field(default_factory=list, init=False)

  def __post_init__(self):
    self.device = loader_device(self.device)
    if self.distributed:
      _partition(self.mesh)  # raises without a process group or a bad mesh
    self._obs = self.metrics_registry or observability.default_metrics
    self._evaluator = evaluator_lib.ChunkEvaluator(
        metrics=self.metrics, aggregator=self.aggregator, device=self.device,
        mesh=self.mesh, dim_to_axis=self.dim_to_axis)
    reduce_dims = set(self.aggregator.reduce_dims)
    self._bucket_dims = tuple(
        d for d in ('init_time', 'lead_time') if d not in reduce_dims)
    self._ckpt_gen = 1

  # -- chunk loading ---------------------------------------------------------

  def _load(self, chunk: time_chunks_lib.TimeChunk):
    # Off a mesh each side goes to the device in the loader thread; on a
    # mesh the two sides are cut by one shard, so they stay on the host
    # until the evaluator places them together.
    return load_chunk_pair(
        self.predictions_loader, self.targets_loader, chunk, obs=self._obs,
        prepare=self._evaluator.prepare_host,
        place=self._evaluator.place if self.mesh is None else None)

  def _chunk_stream(self, start_chunk: int = 0):
    """Yields (index, offsets, (predictions, targets)), chunks already
    through the evaluator's host preparation and, off a mesh, on the
    device.

    ``start_chunk`` drops completed chunks before their loads are
    submitted, so a resumed run does not re-read them.
    """
    # self._load looked up per call so tests/wrappers can substitute it.
    yield from stream_chunk_pairs(
        lambda chunk: self._load(chunk), self.times,
        prefetch=self.prefetch, start_chunk=start_chunk, retry=self.retry,
        obs=self._obs,
        on_failure=lambda i, offsets, e: self.failed_chunks.append(
            (i, offsets, f'{type(e).__name__}: {e}')),
        distributed=self.distributed, mesh=self.mesh)

  def _bucket_key(self, offsets: time_chunks_lib.TimeChunkOffsets) -> tuple:
    return tuple(getattr(offsets, d) if d in self._bucket_dims else -1
                 for d in ('init_time', 'lead_time'))

  # -- checkpointing -----------------------------------------------------------

  def _processes(self) -> tuple[int, int]:
    """(process_index, process_count) that a checkpoint records."""
    if not self.distributed:
      return 0, 1
    return distributed_lib.rank(), distributed_lib.world_size()

  def _ckpt_prefix(self) -> str:
    """The checkpoint prefix; a rank's own under ``distributed``: each rank
    holds the partial state of its own chunks, so a shared checkpoint would
    make every rank resume from one rank's sums."""
    index, count = self._processes()
    if count > 1:
      return f'{self.checkpoint_path}.p{index}'
    return self.checkpoint_path

  def _ckpt_manifest(self) -> str:
    return f'{self._ckpt_prefix()}.manifest.json'

  def _save_checkpoint(self, buckets, next_chunk: int,
                       batch_start: Optional[int] = None) -> None:
    """Saves the buckets, which hold exactly the chunks before
    ``next_chunk``. ``batch_start`` (default ``next_chunk``) is the first
    chunk of the batch that ``next_chunk`` belongs to: a resumed run
    evaluates that batch again as it was and adds only its chunks from
    ``next_chunk`` on, so it ends bit-identical to an uninterrupted run."""
    # Bucket files alternate between two generations, so a save never
    # overwrites the files the CURRENT manifest points at: a crash anywhere
    # before the manifest's atomic replace leaves the previous (manifest,
    # buckets) set intact. Overwriting in place would let a crash between
    # the bucket writes and the manifest write pair the OLD next_chunk with
    # NEW sums, and resume would count chunks twice.
    gen = 1 - self._ckpt_gen
    index, count = self._processes()
    manifest = {'next_chunk': next_chunk, 'generation': gen,
                'batch_start': next_chunk if batch_start is None
                else batch_start, 'process_index': index,
                'process_count': count, 'buckets': []}
    for k, (key, state) in enumerate(sorted(buckets.items())):
      # .wbx: thread-parallel raw block writes (the native blockstore);
      # checkpoints are the pipeline's hottest host I/O. On a remote path
      # save_dataset_atomic writes portable npz bytes through fsspec.
      path = f'{self._ckpt_prefix()}.g{gen}.bucket{k}.wbx'
      fileio.save_dataset_atomic(path, state.to_host().to_dataset())
      # Live (pre-float64) dtypes, so resume restores exactly.
      dtypes = {name: str(da.dtype).removeprefix('torch.')
                for name, da in state.to_dataset().items()}
      manifest['buckets'].append(
          {'key': list(key), 'path': path, 'dtypes': dtypes})
    fileio.write_text_atomic(self._ckpt_manifest(), json.dumps(manifest))
    self._ckpt_gen = gen  # flip only once the manifest commit succeeded

  def _load_checkpoint(self):
    """(buckets, next_chunk) of the checkpoint, or ({}, 0); also sets
    ``_batch_start``, where the resumed run's chunk stream begins."""
    self._batch_start = 0
    if not self.checkpoint_path or not fileio.exists(self._ckpt_manifest()):
      return {}, 0
    manifest = json.loads(fileio.read_text(self._ckpt_manifest()))
    have, want = manifest.get('process_count', 1), self._processes()[1]
    if have != want:
      raise ValueError(
          f'checkpoint {self._ckpt_manifest()} was written by a run of {have} '
          f'processes, and this run has {want}: the chunks would be assigned '
          'to other processes (index % process_count), so resuming would '
          'count some chunks twice and drop others. Restart with the same '
          'process count, or remove the checkpoint.')
    self._batch_start = manifest.get('batch_start', manifest['next_chunk'])
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
    buckets, next_chunk = self._load_checkpoint()
    if self.checkpoint_path and self.mesh is not None and not self.distributed:
      # The mesh's ranks share one checkpoint: each has read it before the
      # first rank writes the next.
      distributed_lib.barrier()
    done = 0

    def add(offsets, state):
      key = self._bucket_key(offsets)
      buckets[key] = buckets[key] + state if key in buckets else state

    def bookkeeping(i, batch_start=None):
      """Once chunk i is in its bucket: a checkpoint here holds exactly the
      chunks up to i."""
      nonlocal done
      self._obs.counter('chunks_done')
      done += 1
      # On a mesh every rank holds the same state: without distributed
      # they share one checkpoint, which the mesh's first rank writes.
      if (self.checkpoint_path and self.checkpoint_every
          and done % self.checkpoint_every == 0
          and (self.distributed or first_of_mesh(self.mesh))):
        with self._obs.timed('checkpoint_seconds'):
          self._save_checkpoint(buckets, i + 1, batch_start)
      logger.info('chunk %d/%d done', i + 1, len(self.times))

    batch: list = []  # buffered (i, offsets, host-prepared pair)

    def flush():
      if not batch:
        return
      with self._obs.timed('eval_chunk_seconds'):
        states = self._evaluator.eval_prepared([pair for _, _, pair in batch])
      last = batch[-1][0]
      for (i, offsets, _), state in zip(batch, states):
        if i < next_chunk:
          continue  # already in a resumed checkpoint's buckets
        add(offsets, state)
        bookkeeping(i, batch[0][0] if i < last else None)
      batch.clear()

    group = (1 if self.chunk_stats_sink is not None
             else max(int(self.chunks_per_dispatch), 1))
    batch_sig = None
    # A batched run resumes at the start of the interrupted batch.
    start = min(self._batch_start, next_chunk) if group > 1 else next_chunk
    with observability.maybe_profile(self.profile_dir, self.device):
      for i, offsets, pair in self._chunk_stream(start):
        if group > 1:
          sig = self._evaluator.signature(*pair)
          if batch and sig != batch_sig:
            self._obs.counter('signature_splits')
            flush()  # the layout changed (e.g. a ragged tail chunk)
          batch_sig = sig
          batch.append((i, offsets, pair))
          if len(batch) >= group:
            flush()
          continue
        stats = None
        with self._obs.timed('eval_chunk_seconds'):
          if self.chunk_stats_sink is None:
            state = self._evaluator.eval_host_prepared(*pair)
          else:
            state, stats = self._evaluator.eval_with_statistics(*pair)
          add(offsets, state)
        if stats is not None and first_of_mesh(self.mesh):
          with self._obs.timed('chunk_stats_sink_seconds'):
            self.chunk_stats_sink(i, offsets, {
                f'{stat_name}.{var}': da
                for stat_name, per_var in stats.items()
                for var, da in per_var.items()})
        del pair, stats  # the host chunk, before the next load is awaited
        bookkeeping(i)
      flush()
    # Final cross-bucket combine on the host, in float64: the outer join
    # concatenates the preserved chunked dims.
    total = aggregation_lib.AggregationState.sum(
        [s.to_host() for s in buckets.values()])
    if self.distributed:
      # Every rank of a mesh holds its group's whole state: the group's
      # first rank alone gives it to the sum.
      total = distributed_lib.allgather_sum_states(
          total, contribute=first_of_mesh(self.mesh))
    return total

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
