"""Unaggregated statistics: stream raw per-point statistics out.

The port of ``weatherbenchx_tpu/parallel/unaggregated.py``: the
reference's ``define_unaggregated_pipeline``
(``beam_pipeline.py:610-681``) without Beam. Chunks are loaded and
host-prepared like the aggregated pipeline's, their statistics computed on
the device, copied to the host and streamed into a store:

* ``*.zarr``: each chunk into its cells of a Zarr v2 store (or v3, with
  shards), written through ``zarr_io.ZarrArrayWriter``; TimeChunks offsets
  map 1:1 onto the zarr chunk grid, so no rechunk shuffle is needed, and
  ``zarr_chunks`` larger than a compute chunk assemble in host buffers;
* anything else: a directory of per-chunk ``.wbx`` shards and a manifest,
  for ragged (sparse) statistics that fit no fixed grid.

``ZarrStatsStore.write_chunk`` is also the aggregated pipeline's
``chunk_stats_sink``: the statistics then stream out of the same pass that
accumulates the state. Time coords stay datetime64/timedelta64 throughout
the port, so nothing is converted back before writing.

Many processes, over ``torch.distributed``: with ``distributed`` every rank
of the default group writes the cells of its own chunks into one zarr
store (output chunks and v3 shards must divide the compute chunk, so that
no cell spans two ranks' chunks), then all wait at a barrier and rank 0
writes the metadata; the shard-directory mode, with its one manifest,
refuses it. With a ``mesh`` the statistics are gathered whole on the mesh
and only its first rank writes them.
"""

import dataclasses
import itertools
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import fileio
from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import time_chunks as time_chunks_lib
from weatherbenchx_tpu_torch import zarr_io
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.data import base as data_base
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from weatherbenchx_tpu_torch.parallel import distributed as distributed_lib
from weatherbenchx_tpu_torch.parallel import evaluator as evaluator_lib
from weatherbenchx_tpu_torch.parallel import pipeline as pipeline_lib


def canonical_order(flat_stats: Mapping[str, DimArray]) -> dict:
  """``flat_stats`` in the order the JAX package's pipelines hand them to a
  store: statistics by (statistic, variable) name, and in each array its
  time coords first, then the other coords, each group by name (the order
  its pytrees leave them in). The stores' metadata lists arrays in the
  order they are first written, so this order makes the two packages'
  stores the same bytes."""
  def reorder(da: DimArray) -> DimArray:
    def is_time(c):
      return not c.is_host or np.asarray(c.values).dtype.kind in 'Mm'
    names = (sorted(n for n, c in da.coords.items() if is_time(c))
             + sorted(n for n, c in da.coords.items() if not is_time(c)))
    return DimArray(da.data, da.dims, {n: da.coords[n] for n in names})
  return {k: reorder(flat_stats[k])
          for k in sorted(flat_stats, key=lambda k: k.split('.', 1))}


class ZarrStatsStore:
  """Streaming '<stat>.<var>' Zarr store writer keyed by TimeChunks cells.

  The template (shapes, dtypes, coords) comes from the first chunk with
  init/lead expanded to the full evaluation extent — the reference's
  ``_get_template_dataset`` (``beam_pipeline.py:543-605``). Usable either
  through :class:`UnaggregatedPipeline` (its own storage pass) or as the
  aggregated pipeline's ``chunk_stats_sink`` (statistics stream out of the
  SAME pass that accumulates the aggregation state — one storage scan, one
  set of device transfers).

  With ``distributed`` the store is written by every rank of the default
  process group (chunk-parallel ranks, or the ranks of a mesh, whose first
  rank alone writes cells): each writes its own cells, and ``finalize``
  waits at a barrier before rank 0 writes the metadata.
  """

  def __init__(self, times: time_chunks_lib.TimeChunks, path: str,
               compressor: Optional[str] = None,
               distributed: bool = False,
               zarr_chunks: Optional[Mapping[str, int]] = None,
               zarr_format: int = 2,
               zarr_shards: Optional[Mapping[str, int]] = None) -> None:
    if distributed:
      distributed_lib.require_process_group()
    if isinstance(times.lead_times, slice):
      raise ValueError(
          'Zarr unaggregated output needs exact lead_times: a lead '
          'interval has unknown extent until load time')
    self._path = path.rstrip('/')
    fileio.makedirs(self._path)
    self._init_times = times.init_times
    self._lead_times = times.lead_times
    self._init_chunk = times.init_time_chunk_size
    self._lead_chunk = (times.lead_time_chunk_size
                        or max(len(times.lead_times), 1))
    # Output (store) chunking decoupled from the COMPUTE chunking — the
    # reference rechunks per-chunk statistics to user-chosen zarr chunks
    # before writing (beam_pipeline.py:671-677, xbeam.Rechunk(...
    # zarr_chunks ...)). Without this, init_chunk=1 runs write one-init
    # zarr chunks: pathological for downstream readers. Compute blocks
    # whose extent doesn't cover a whole output cell are assembled in
    # host-side buffers and flushed when the cell completes.
    self._zarr_chunks = {k: int(v) for k, v in (zarr_chunks or {}).items()}
    # v3 sharding_indexed output: shards group output cells into shard
    # objects; a shard, like a straddling output cell, must be assembled
    # by one process/writer (encoded cells buffer until it completes).
    self._zarr_shards = {k: int(v) for k, v in (zarr_shards or {}).items()}
    if self._zarr_shards and int(zarr_format) != 3:
      raise ValueError('zarr_shards (sharding_indexed) needs zarr_format=3')
    if distributed:
      for d, cc in (('init_time', self._init_chunk),
                    ('lead_time', self._lead_chunk)):
        for what, sizes in (('zarr_chunks', self._zarr_chunks),
                            ('zarr_shards', self._zarr_shards)):
          z = sizes.get(d)
          if z is not None and (z > cc or cc % z != 0):
            raise ValueError(
                f'distributed zarr output needs {what}[{d!r}]={z} to divide '
                f'the compute chunk size {cc}: otherwise one output '
                f'{"cell" if what == "zarr_chunks" else "shard object"} '
                'spans compute chunks owned by different processes and no '
                'single process can assemble it')
    self._compressor = compressor
    self._zarr_format = int(zarr_format)
    self._distributed = distributed
    if self._zarr_format == 3:
      # v3 root node, written eagerly for the same crash-resume reason as
      # the coordinates below. v3 has no consolidated-metadata file; the
      # reader scans per-array zarr.json nodes.
      fileio.write_bytes(
          os.path.join(self._path, 'zarr.json'),
          json.dumps({'zarr_format': 3, 'node_type': 'group',
                      'attributes': {}}).encode())
    self._writers: dict[str, zarr_io.ZarrArrayWriter] = {}
    # (key, cell) -> [partial ndarray buffer, covered element count]
    self._buffers: dict = {}
    self._coord_arrays: dict[str, Coord] = {}
    self._coord_meta: dict[str, dict] = {}
    # Coordinate arrays are written EAGERLY (here and in _make_writer), not
    # in finalize: a run that crashes after all cells are written and then
    # resumes replaying zero chunks has empty _writers/_coord_arrays, and
    # finalize must still be able to consolidate a complete store from
    # disk.
    self._write_coord('init_time', Coord(('init_time',), self._init_times))
    self._write_coord('lead_time', Coord(('lead_time',), self._lead_times))

  def _out_chunk(self, dim: str, default: int) -> int:
    return self._zarr_chunks.get(dim, default)

  def _write_coord(self, cname: str, c: Coord) -> None:
    self._coord_meta.update(zarr_io._write_array(
        self._path, cname, np.asarray(c.values), c.dims,
        [self._out_chunk(d, self._init_chunk) if d == 'init_time' else
         self._out_chunk(d, self._lead_chunk) if d == 'lead_time' else
         self._out_chunk(d, s)
         for d, s in zip(c.dims, np.shape(c.values))],
        zarr_format=self._zarr_format))

  def _full_size(self, dim: str, chunk_size: int) -> tuple[int, int]:
    if dim == 'init_time':
      return len(self._init_times), self._out_chunk(dim, self._init_chunk)
    if dim == 'lead_time':
      return len(self._lead_times), self._out_chunk(dim, self._lead_chunk)
    return chunk_size, self._out_chunk(dim, chunk_size)

  def _make_writer(self, key: str, da: DimArray) -> zarr_io.ZarrArrayWriter:
    if da.has_coord('mask'):
      raise ValueError(
          f'{key} carries a mask coord; masks have no cell in an '
          'unaggregated store (reference rejects them too, '
          'beam_pipeline.py:592-599). Use masked aggregation instead.')
    shape, chunks = zip(*(self._full_size(d, s)
                          for d, s in zip(da.dims, da.shape)))
    aux = []
    for cname, c in da.coords.items():
      if cname in ('init_time', 'lead_time'):
        continue  # written whole from TimeChunks at the end
      if set(c.dims) & {'init_time', 'lead_time'} and cname != 'valid_time':
        continue  # chunk-local coord with no stable global layout
      if cname not in da.dims:
        aux.append(str(cname))
      if cname in self._coord_arrays:
        continue
      if cname == 'valid_time':
        full = self._init_times[:, None] + self._lead_times[None, :]
        self._coord_arrays[cname] = Coord(('init_time', 'lead_time'), full)
      else:
        self._coord_arrays[cname] = Coord(c.dims, np.asarray(c.values))
      self._write_coord(cname, self._coord_arrays[cname])
    shards = None
    if self._zarr_shards and any(d in self._zarr_shards for d in da.dims):
      shards = [self._zarr_shards.get(d, c)
                for d, c in zip(da.dims, chunks)]
    return zarr_io.ZarrArrayWriter(
        self._path, key, shape, chunks, np.asarray(da.values).dtype,
        da.dims, extra_attrs={'coordinates': ' '.join(aux)} if aux else None,
        compressor=self._compressor, zarr_format=self._zarr_format,
        shards=shards)

  def write_chunk(self, i: int,
                  offsets: time_chunks_lib.TimeChunkOffsets,
                  flat_stats: Mapping[str, DimArray]) -> None:
    """Scatters one compute chunk's '<stat>.<var>' arrays into the store.

    Output cells this chunk completes are written before it returns,
    encoded together (``zarr_io.write_cells``: the native codec in
    parallel across the arrays); cells straddling compute-chunk boundaries
    (zarr_chunks larger than / not aligned to the compute grid) accumulate
    in host buffers until complete (the in-process analog of the
    reference's xbeam.Rechunk shuffle, beam_pipeline.py:671-677).
    """
    complete: list = []  # (writer, cell, block), encoded together below
    for key, da in canonical_order(flat_stats).items():
      if key not in self._writers:
        self._writers[key] = self._make_writer(key, da)
      w = self._writers[key]
      starts = []
      for ax, (d, n) in enumerate(zip(da.dims, da.shape)):
        if d == 'init_time':
          starts.append(offsets.init_time)
        elif d == 'lead_time':
          starts.append(offsets.lead_time)
        else:
          starts.append(0)
          if n != w.shape[ax]:
            raise ValueError(
                f'{key}: dim {d!r} is {n} in chunk {i} but {w.shape} in '
                'the template; only init_time/lead_time may vary across '
                'chunks in zarr mode (use the shard-directory mode for '
                'ragged statistics)')
      self._scatter(key, w, starts, da.values, complete)
    zarr_io.write_cells(complete)

  def _scatter(self, key: str, w: zarr_io.ZarrArrayWriter,
               starts: list, vals: np.ndarray, complete: list) -> None:
    """Appends the output cells this block completes to ``complete`` and
    buffers the partial ones."""
    grid_ranges = []
    for ax, (st, n) in enumerate(zip(starts, vals.shape)):
      c = w.chunks[ax]
      grid_ranges.append(range(st // c, (st + max(n, 1) - 1) // c + 1))
    for cell in itertools.product(*grid_ranges):
      in_vals, in_buf, cell_shape = [], [], []
      full_cover = True
      for ax, ci in enumerate(cell):
        c = w.chunks[ax]
        cs, ce = ci * c, min((ci + 1) * c, w.shape[ax])
        s0 = max(cs, starts[ax])
        s1 = min(ce, starts[ax] + vals.shape[ax])
        in_vals.append(slice(s0 - starts[ax], s1 - starts[ax]))
        in_buf.append(slice(s0 - cs, s1 - cs))
        cell_shape.append(ce - cs)
        if s0 != cs or s1 != ce:
          full_cover = False
      sub = vals[tuple(in_vals)]
      if full_cover:
        complete.append((w, cell, sub))
        continue
      bkey = (key, cell)
      if bkey not in self._buffers:
        buf = np.full(cell_shape,
                      np.nan if w.dtype.kind == 'f' else 0, dtype=w.dtype)
        self._buffers[bkey] = [buf, 0]
      entry = self._buffers[bkey]
      entry[0][tuple(in_buf)] = sub
      entry[1] += sub.size  # TimeChunks tiles disjointly: no double count
      if entry[1] >= int(np.prod(cell_shape)):
        complete.append((w, cell, entry[0]))
        del self._buffers[bkey]

  def finalize(self) -> str:
    """Writes coordinates + consolidated metadata; returns the path."""
    # Incomplete output cells (chunks dropped by skip_failed, or a ragged
    # coverage pattern) are flushed as-is: the uncovered region keeps the
    # store's fill value, matching the skip-failed contract.
    for (key, cell), (buf, _) in list(self._buffers.items()):
      self._writers[key].write_block(cell, buf)
    self._buffers.clear()
    # Sharded (v3) writers: flush partial shard objects — absent cells
    # keep the missing-chunk sentinel (readers see the fill value), the
    # same contract as the uncovered-cell fill above.
    for w in self._writers.values():
      w.close()
    if self._distributed:
      # Ranks own disjoint cells; the coordinates and metadata are the same
      # everywhere, so rank 0 writes them once every cell is on disk.
      distributed_lib.barrier()
      if distributed_lib.rank() != 0:
        return self._path
    path = self._path
    if self._zarr_format == 3:
      # No consolidated metadata in v3: the eager root zarr.json plus the
      # per-array nodes written as cells streamed make the store complete.
      return path
    if not self._writers and fileio.exists(os.path.join(path, '.zmetadata')):
      # A rerun that wrote no chunks (e.g. checkpoint-resume of a finished
      # run): the store on disk is complete — rewriting .zmetadata from
      # this process's empty template would destroy it.
      return path
    metadata: dict = {'.zgroup': {'zarr_format': 2}, '.zattrs': {}}
    fileio.write_bytes(os.path.join(path, '.zgroup'),
                       json.dumps(metadata['.zgroup']).encode())
    metadata.update(self._coord_meta)  # coord arrays were written eagerly
    for key, w in self._writers.items():
      metadata.update(w.metadata)
    # Arrays written by a previous (crashed or resumed) run exist on disk
    # but not in self._writers; fold their per-array metadata in so the
    # consolidated index covers the whole store, not just this run's
    # writes.
    for akey, ameta in zarr_io._read_store_metadata(path).items():
      metadata.setdefault(akey, ameta)
    fileio.write_bytes_atomic(
        os.path.join(path, '.zmetadata'),
        json.dumps({'metadata': metadata, 'zarr_consolidated_format': 1},
                   default=zarr_io._json_default).encode())
    return path


@dataclasses.dataclass
class UnaggregatedPipeline:
  """Computes per-chunk statistics on a device and streams them to a store.

  Attributes:
    metrics: metric name → Metric (statistics are deduplicated across them).
    predictions_loader / targets_loader / times: as in EvaluationPipeline.
    out_path: ``*.zarr`` → streaming Zarr store (standard format, open with
      xarray or ``zarr_io.open_dataset_zarr``); anything else → a
      directory of per-chunk ``.wbx`` shards + manifest.
    device: the device the statistics are computed on, e.g. 'cuda'.
    mesh / dim_to_axis: optional ``DeviceMesh`` each chunk is sharded over
      (see ChunkEvaluator); the statistics are gathered whole and the
      mesh's first rank writes them.
    distributed: chunk-parallel ranks of the default process group, each
      writing its own chunks' cells of one ``*.zarr`` store.
  """

  metrics: Mapping[str, metrics_base.Metric]
  predictions_loader: data_base.DataLoader
  targets_loader: data_base.DataLoader
  times: time_chunks_lib.TimeChunks
  out_path: str
  device: torch.device | str
  prefetch: int = 2
  mesh: Optional[object] = None
  dim_to_axis: Optional[Mapping[str, str]] = None
  distributed: bool = False
  compressor: Optional[str] = None  # zarr cells: None/'zlib'/'zstd'/'blosc'
  zarr_format: int = 2  # 3: zarr v3 store layout (zarr.json nodes)
  # Output store chunk sizes per dim (e.g. {'init_time': 64}); defaults to
  # the compute chunking. The reference's xbeam.Rechunk zarr_chunks analog.
  zarr_chunks: Optional[Mapping[str, int]] = None
  # v3 only: shard object sizes per dim (elements, rounded up to a chunk
  # multiple): the sharding_indexed codec layout zarr-python 3 consumers
  # default to for many-small-chunk stores.
  zarr_shards: Optional[Mapping[str, int]] = None
  # Transient-failure policy for chunk loads (see pipeline.RetryPolicy).
  # With ``skip_failed`` a dropped chunk's cells keep the store's fill
  # value (NaN) and are listed in ``failed_chunks`` after the run.
  retry: Optional[pipeline_lib.RetryPolicy] = None
  failed_chunks: list = dataclasses.field(default_factory=list, init=False)

  def __post_init__(self):
    self.device = pipeline_lib.loader_device(self.device)
    if self.distributed:
      distributed_lib.require_process_group()
    # The evaluator's host preparation and device placement; only the step
    # differs (raw statistics, no aggregation).
    self._evaluator = evaluator_lib.ChunkEvaluator(
        metrics=self.metrics,
        aggregator=aggregation_lib.Aggregator(reduce_dims=()),
        device=self.device, mesh=self.mesh, dim_to_axis=self.dim_to_axis)

  def _chunk_stats(self, predictions, targets) -> dict[str, DimArray]:
    """The chunk's statistics on the host; whole, gathered on a mesh."""
    stats = self._evaluator.statistics(predictions, targets)
    return canonical_order({
        f'{stat_name}.{var_name}': da
        for stat_name, stat_vars in stats.items()
        for var_name, da in stat_vars.items()})

  def _load(self, chunk):
    # As EvaluationPipeline's: off a mesh each side goes to the device in
    # the loader thread, on a mesh the pair stays on the host.
    return pipeline_lib.load_chunk_pair(
        self.predictions_loader, self.targets_loader, chunk,
        prepare=self._evaluator.prepare_host,
        place=self._evaluator.place if self.mesh is None else None)

  def _stream(self):
    return pipeline_lib.stream_chunk_pairs(
        self._load, self.times, prefetch=self.prefetch, retry=self.retry,
        obs=observability.default_metrics,
        on_failure=lambda i, offsets, e: self.failed_chunks.append(
            (i, offsets, f'{type(e).__name__}: {e}')),
        distributed=self.distributed, mesh=self.mesh)

  def run(self) -> str:
    self.failed_chunks = []
    if self.out_path.rstrip('/').endswith('.zarr'):
      return self._run_zarr()
    if self.distributed:
      raise ValueError(
          'distributed unaggregated output needs a *.zarr out_path: each '
          'process writes its own disjoint cells of one store (the '
          'shard-directory manifest has a single writer)')
    return self._run_shards()

  # -- Zarr mode ---------------------------------------------------------------

  def _run_zarr(self) -> str:
    """One zarr chunk per (TimeChunk, variable): no rechunk shuffle."""
    writes = pipeline_lib.first_of_mesh(self.mesh)
    store = None
    if writes or self.distributed:
      store = ZarrStatsStore(self.times, self.out_path,
                             compressor=self.compressor,
                             distributed=self.distributed,
                             zarr_chunks=self.zarr_chunks,
                             zarr_format=self.zarr_format,
                             zarr_shards=self.zarr_shards)
    for i, offsets, (predictions, targets) in self._stream():
      stats = self._chunk_stats(predictions, targets)
      if writes:
        store.write_chunk(i, offsets, stats)
    path = self.out_path if store is None else store.finalize()
    if self.mesh is not None and not self.distributed:
      distributed_lib.barrier()  # the mesh's first rank has written it all
    return path

  # -- shard-directory mode ------------------------------------------------------

  def _run_shards(self) -> str:
    """One .wbx shard per chunk + manifest (ragged/sparse-safe)."""
    writes = pipeline_lib.first_of_mesh(self.mesh)
    if writes:
      os.makedirs(self.out_path, exist_ok=True)
    manifest = {'version': 1, 'shards': []}
    for i, offsets, (predictions, targets) in self._stream():
      flat = self._chunk_stats(predictions, targets)
      if not writes:
        continue
      shard = f'chunk_{i:06d}.wbx'
      io_lib.save_dataset(os.path.join(self.out_path, shard), flat)
      manifest['shards'].append({
          'path': shard,
          'init_time_offset': offsets.init_time,
          'lead_time_offset': offsets.lead_time,
      })
    if writes:
      tmp = os.path.join(self.out_path, 'manifest.json.tmp')
      with open(tmp, 'w') as f:
        json.dump(manifest, f)
      os.replace(tmp, os.path.join(self.out_path, 'manifest.json'))
    if self.mesh is not None:
      distributed_lib.barrier()  # the mesh's first rank has written it all
    return self.out_path


def load_unaggregated(path: str) -> dict[str, DimArray]:
  """Assembles unaggregated statistics into full host arrays (either
  mode)."""
  if path.rstrip('/').endswith('.zarr'):
    ds = zarr_io.open_dataset_zarr(path.rstrip('/'))
    return {k: v.copy(data=v.data) for k, v in ds.items()}

  with open(os.path.join(path, 'manifest.json')) as f:
    manifest = json.load(f)
  shards = sorted(manifest['shards'],
                  key=lambda s: (s['init_time_offset'],
                                 s['lead_time_offset']))
  # Group shards into rows by init offset, concat leads, then concat inits.
  by_init: dict[int, list] = {}
  for s in shards:
    by_init.setdefault(s['init_time_offset'], []).append(
        io_lib.load_dataset(os.path.join(path, s['path'])))

  out: dict[str, DimArray] = {}
  first_row = next(iter(by_init.values()))
  for key in first_row[0].keys():
    rows = []
    for init_offset in sorted(by_init):
      row = [ds[key] for ds in by_init[init_offset]]
      if len(row) > 1 and 'lead_time' in row[0].dims:
        rows.append(darray.concat(row, 'lead_time'))
      else:
        rows.append(row[0])
    if len(rows) > 1 and 'init_time' in rows[0].dims:
      out[key] = darray.concat(rows, 'init_time')
    else:
      out[key] = rows[0]
  return out


def define_unaggregated_pipeline(
    metrics: Mapping[str, metrics_base.Metric],
    predictions_loader: data_base.DataLoader,
    targets_loader: data_base.DataLoader,
    times: time_chunks_lib.TimeChunks,
    out_path: str,
    **kwargs,
) -> str:
  """One-call unaggregated run (the reference API's entry-point shape);
  ``kwargs`` go to :class:`UnaggregatedPipeline`, ``device`` required."""
  return UnaggregatedPipeline(
      metrics=metrics, predictions_loader=predictions_loader,
      targets_loader=targets_loader, times=times, out_path=out_path,
      **kwargs).run()
