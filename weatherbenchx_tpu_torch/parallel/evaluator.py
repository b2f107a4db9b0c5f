"""The per-chunk evaluation step: statistics → aggregation on a device.

The port of ``weatherbenchx_tpu/parallel/evaluator.py``: one process per
device, a chunk on one device or sharded over a device mesh (below).
PyTorch runs eagerly, so nothing is traced: time coords stay host numpy,
and there is no jit cache to protect.

* ``_plan_resources`` splits the statistics' long-lived arrays
  (climatologies) into device-resident ones, uploaded once by
  ``resources()``, and host-gathered ones, aligned per chunk on the host
  when the resident set would overflow the device budget.
* ``prepare_host`` runs each unique statistic's host hook
  (``Statistic.prepare_chunk``: climatology alignment indices and
  host-gathered slices) and touches no device, so the pipeline runs it in
  its loader threads; ``to_device`` then moves the chunk's data, masks and
  those coords to the evaluator's device in one pass, as a ``PlacedPair``
  that carries the rank's slice on a mesh.
* ``operands_for`` builds the weights and bin masks once per statistic
  layout, uploads one copy of each, and keeps them for later chunks.
* ``eval_chunk`` computes the unique statistics in one compute pass (so
  the CRPS family shares one fused kernel launch), aggregating each one as
  it comes, so that one statistic at a time is held on the device;
  ``eval_with_statistics`` also hands each statistic back as a host copy
  (the pipeline's ``chunk_stats_sink``).
* ``eval_prepared`` evaluates several host-prepared chunks of one
  ``batchable_signature`` at once: each is copied to the device into its
  slice of arrays stacked along a leading ``CHUNK_DIM`` that no aggregator
  reduces, the stack is evaluated once (one fused kernel launch for all
  of its chunks, the weights and bin masks shared), and the state is split
  back into one state per chunk. Coords that differ from chunk to chunk
  (time coords, validity masks, climatology index and value coords) gain
  ``CHUNK_DIM`` in the stack, so each chunk's state carries its own. This
  replaces the JAX package's ``jax.vmap`` of the step: the kernels are
  launched through ctypes and have no batching rule.

With a ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``, one
process per device) and ``dim_to_axis``, a chunk is sharded over the mesh,
in place of the JAX package's GSPMD placement:

* each rank copies to its device only its slice of every mapped dim whose
  size the axis divides (data, masks and the coords along that dim; a dim
  the axis does not divide stays whole, as ``_axis_for`` replicates it);
* a sharded dim that a statistic reads across (``Statistic.reads_across``:
  the ensemble dim of the ensemble statistics, the window dims of FSS;
  every dim for a statistic that does not declare) is made whole first
  (``distributed.gather_dim``), so the fused kernel runs on each rank over
  all the members of the rank's gridpoints;
* weights and bin masks are built from the whole chunk's coords and then
  sliced (``aggregation.ChunkShard``), and resident climatologies resolve
  to the rank's slice; host-gathered climatology slices and the gather
  indices follow their dims;
* after the local contraction the partial state is summed over the axes
  of sharded reduce dims and gathered along sharded preserved dims, so
  every rank of the mesh holds the whole chunk state (and a sink gets the
  whole statistics).

A station chunk brings new coord objects over its ``index`` every chunk
(positions, names, interpolated grid elevations): binnings read theirs by
content, and other host coords past 4,096 values enter the layout key by
identity (``aggregation._layout_key``), so such a chunk's weights and bin
masks are rebuilt, and the operand cache turns over; ``operand_builds``
counts the layouts built.
"""

import dataclasses
import logging
import os
from typing import Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch.darray import Coord, DimArray, as_tensor
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from weatherbenchx_tpu_torch.parallel import distributed

# The leading dim along which a batched dispatch stacks its chunks.
CHUNK_DIM = '_chunk'

_OPERAND_CACHE_SIZE = 32  # layouts kept; ragged runs would grow it per chunk

# Share of the device memory free at planning time that resident
# statistic resources may take. The rest is the per-chunk working set:
# the chunk's predictions and targets, one statistic and its masked copy
# at a time, and the cached weights and bin masks. At the full-width
# deterministic benchmark (25 field-levels x 12 leads at 0.25 degrees) a
# chunk side is 1.25 GB and the working set peaks at several times that;
# 0.45 is the JAX package's share of the TPU's memory for the same
# purpose, kept so that both packages demote at the same relative size.
_RESOURCE_SHARE = 0.45
_CPU_RESOURCE_BYTES = 8 << 30

_DEVICE_COORD_PREFIXES = (metrics_base.CLIM_INDEX_PREFIX,
                          metrics_base.CLIM_VALUE_PREFIX)


def _resource_budget_bytes(device: torch.device) -> int:
  """Bytes that device-resident statistic resources may take.

  ``WBX_RESOURCE_BYTES`` overrides, read as the JAX package reads it; on a
  CUDA device otherwise ``_RESOURCE_SHARE`` of the free memory that
  ``torch.cuda.mem_get_info`` reports; on the CPU the JAX package's 8 GB.
  """
  env = os.environ.get('WBX_RESOURCE_BYTES')
  if env:
    return int(float(env))
  if device.type == 'cuda':
    free, _ = torch.cuda.mem_get_info(device)
    return int(_RESOURCE_SHARE * free)
  return _CPU_RESOURCE_BYTES


def _per_chunk(name, c: Coord, host_coords=()) -> bool:
  """Whether a coord may differ between the chunks of one batched dispatch:
  the device-bound coords (validity mask, climatology index and value
  coords) and the time coords that no binning reads."""
  if _device_bound(name):
    return True
  return (name not in host_coords and isinstance(c.values, np.ndarray)
          and c.values.dtype.kind in 'Mm')


def _device_bound(name) -> bool:
  """Whether a coord goes to the device with the data: the validity mask
  and the climatology index and value coords."""
  return name == 'mask' or str(name).startswith(_DEVICE_COORD_PREFIXES)


def batchable_signature(predictions: Mapping[Hashable, DimArray],
                        targets: Mapping[Hashable, DimArray],
                        host_coords=()) -> tuple:
  """Hashable key: host-prepared pairs with equal keys can share one
  batched dispatch.

  Variables in order, with their dims, shapes and dtypes, and every coord's
  name and dims. Coords that may differ per chunk (``_per_chunk``) enter by
  shape and dtype. The others enter as the aggregation's layout key takes
  them (``aggregation._coord_fingerprint``): by content when a binning
  reads them (``host_coords``) or when small, else by identity, so chunks
  whose bin masks would differ never share a dispatch. Reads no data.
  """
  def side(data):
    out = []
    for var, da in data.items():
      coords = []
      for name, c in da.coords.items():
        if _per_chunk(name, c, host_coords):
          fp = ('per_chunk', tuple(np.shape(c.values)), str(c.values.dtype))
        else:
          fp = aggregation_lib._coord_fingerprint(c, name in host_coords)
        coords.append((str(name), c.dims, fp))
      out.append((var, da.dims, da.shape, str(da.dtype), tuple(sorted(coords))))
    return tuple(out)
  return side(predictions), side(targets)


def _stack_to(values, device: torch.device) -> torch.Tensor:
  """Host arrays (or tensors) of one shape, stacked along a new leading
  axis on ``device``; each copied straight into its slice."""
  first = as_tensor(values[0])
  out = torch.empty((len(values),) + tuple(first.shape), dtype=first.dtype,
                    device=device)
  for k, v in enumerate(values):
    out[k].copy_(as_tensor(v))
  return out


def _split_states(state: aggregation_lib.AggregationState, n: int
                  ) -> list[aggregation_lib.AggregationState]:
  """One state per chunk of a state evaluated over ``CHUNK_DIM``."""
  def take(k):
    def one(x: DimArray) -> DimArray:
      if CHUNK_DIM not in x.dims:
        raise ValueError(
            f'a statistic reduced over {CHUNK_DIM!r}: its chunks cannot be '
            'told apart; evaluate with chunks_per_dispatch=1')
      return x.isel({CHUNK_DIM: k})
    return state.map(one)
  return [take(k) for k in range(n)]


class PlacedPair(tuple):
  """A chunk's (predictions, targets) on the device; it unpacks as the
  pair. ``shard`` is the ``ChunkShard`` they were cut by on a mesh (None
  off a mesh, or when no dim was sliced): the slice travels with the data,
  so pairs placed before the first is evaluated each keep their own."""

  def __new__(cls, predictions, targets, shard=None):
    pair = super().__new__(cls, (predictions, targets))
    pair.shard = shard
    return pair


def host_copy(da: DimArray) -> DimArray:
  """``da`` on the host: its data a CPU tensor, its coords numpy."""
  coords = {name: Coord(c.dims, c.values.detach().cpu().numpy()
                        if isinstance(c.values, torch.Tensor) else c.values)
            for name, c in da.coords.items()}
  return DimArray(da.data.detach().cpu(), da.dims, coords)


@dataclasses.dataclass
class ChunkEvaluator:
  """Runs the fused statistics → aggregation step for chunks on a device.

  Attributes:
    metrics: Mapping of metric name → Metric.
    aggregator: The Aggregator (weights/bins/mask/reduce_dims).
    device: The device the chunks are evaluated on, e.g. 'cuda' or 'cpu'
      (on a mesh, this rank's device).
    mesh: Optional ``DeviceMesh`` of the ranks a chunk is sharded over;
      its ``mesh_dim_names`` are the axes.
    dim_to_axis: Map from data dim name to mesh axis name, e.g.
      {'init_time': 'batch', 'longitude': 'space', 'number': 'ensemble'}.
      Dims not listed are whole on every rank.
  """

  metrics: Mapping[str, metrics_base.Metric]
  aggregator: aggregation_lib.Aggregator
  device: torch.device | str
  mesh: Optional[object] = None
  dim_to_axis: Optional[Mapping[str, str]] = None

  def __post_init__(self):
    self.device = torch.device(self.device)
    unique = metrics_base.unique_statistics_for_metrics(self.metrics)
    self._stat_names = list(unique)
    self._stats = list(unique.values())
    self._host_coords = tuple(sorted({
        name for b in self.aggregator.bin_by or [] for name in b.host_coords}))
    self._operand_cache: dict = {}
    self.operand_builds = 0  # layouts whose operands were built
    self.dispatches = 0  # evaluations: one per chunk, or per stack
    self.signature_splits = 0  # eval_prepared calls evaluated one by one
    self._resource_cache = None
    self._plan_resources()
    self._init_mesh()

  # -- mesh ------------------------------------------------------------------------

  def _init_mesh(self) -> None:
    self._dim_to_axis = dict(self.dim_to_axis or {})
    if self.mesh is None:
      if self._dim_to_axis:
        raise ValueError('dim_to_axis needs a mesh')
      return
    names = tuple(getattr(self.mesh, 'mesh_dim_names', None) or ())
    if not names:
      raise TypeError('mesh must be a torch.distributed.device_mesh.'
                      'DeviceMesh with mesh_dim_names')
    unknown = set(self._dim_to_axis.values()) - set(names)
    if unknown:
      raise ValueError(f'dim_to_axis names axes {sorted(unknown)} that the '
                       f'mesh {names} lacks')
    if CHUNK_DIM in self._dim_to_axis:
      raise ValueError(f'{CHUNK_DIM!r}, the stacked chunks, is never sharded')
    self._axis_size = {a: self.mesh.size(i) for i, a in enumerate(names)}
    declared = [stat.reads_across() for stat in self._stats]
    self._whole_first = (
        set(self._dim_to_axis) if any(r is None for r in declared)
        else {d for r in declared for d in r} & set(self._dim_to_axis))

  def _shard_for(self, predictions: Mapping[Hashable, DimArray],
                 targets: Mapping[Hashable, DimArray]
                 ) -> aggregation_lib.ChunkShard | None:
    """This rank's slice of a host chunk (or of a stack of chunks,
    ``_stack_host``): each mapped dim whose size its axis divides is cut
    into equal parts in the axis's rank order; a dim it does not divide
    stays whole on every rank. The chunk's host coords over the cut dims
    are kept whole in the shard."""
    if self.mesh is None:
      return None
    sizes: dict[str, int] = {}
    for data in (predictions, targets):
      for da in data.values():
        for d, n in da.sizes.items():
          if d in self._dim_to_axis and sizes.setdefault(d, n) != n:
            raise ValueError(f'dim {d!r} is {sizes[d]} and {n} long in one '
                             'chunk: it cannot be sharded')
    slices, owner = {}, {}
    for d, n in sizes.items():
      axis = self._dim_to_axis[d]
      k = self._axis_size[axis]
      if n % k:
        continue
      if axis in owner:
        raise ValueError(f'dims {owner[axis]!r} and {d!r} are both sharded '
                         f'over the mesh axis {axis!r}')
      owner[axis] = d
      r = self.mesh.get_local_rank(axis)
      slices[d] = slice(r * (n // k), (r + 1) * (n // k))
    if not slices:
      return None
    whole = {}
    for data in (predictions, targets):
      for da in data.values():
        for name, c in da.coords.items():
          if c.is_host and set(c.dims) & set(slices):
            whole.setdefault(name, c)
    return aggregation_lib.ChunkShard(
        slices, {d: sizes[d] for d in slices}, whole)

  def _whole_coord(self, name, c: Coord, shard, whole_dims) -> Coord:
    """The whole chunk's host coord ``name``, sliced along the sharded dims
    that are not (yet) whole in the array it goes to."""
    w = shard.whole_coords.get(name)
    if w is None or w.dims != c.dims:
      raise ValueError(f'host coord {name!r} {c.dims} over a sharded dim has '
                       'no whole-chunk counterpart')
    cut = tuple(shard.slices[d] if d in shard.slices and d not in whole_dims
                else slice(None) for d in c.dims)
    return Coord(c.dims, np.asarray(w.values)[cut])

  def _gather_along(self, da: DimArray, d: str, shard,
                    whole_dims) -> DimArray:
    """``da`` made whole along its sharded dim ``d`` on every rank of its
    axis: data and device coords gathered, host coords the whole chunk's.
    ``whole_dims`` are the sharded dims already whole in ``da``."""
    axis = self._dim_to_axis[d]
    whole_dims = set(whole_dims) | {d}
    coords = {}
    for name, c in da.coords.items():
      if d not in c.dims:
        coords[name] = c
      elif c.is_host:
        coords[name] = self._whole_coord(name, c, shard, whole_dims)
      else:
        coords[name] = Coord(c.dims, distributed.gather_dim(
            c.values, c.dims.index(d), self.mesh, axis))
    return DimArray(
        distributed.gather_dim(da.data, da.dims.index(d), self.mesh, axis),
        da.dims, coords)

  def _gathered(self, da: DimArray, dims, shard, whole_dims=()) -> DimArray:
    """``da`` made whole along each of ``dims`` it has."""
    whole_dims = set(whole_dims)
    for d in sorted(dims):
      if d in da.dims:
        da = self._gather_along(da, d, shard, whole_dims)
        whole_dims.add(d)
    return da

  def _still_sharded(self, shard) -> set:
    return set(shard.slices) - self._whole_first

  def _live(self, shard):
    """The part of ``shard`` still sliced while statistics are computed."""
    return None if shard is None else shard.only(self._still_sharded(shard))

  def _whole(self, da: DimArray, shard) -> DimArray:
    """A statistic of this rank's slice made whole along every dim."""
    if self._live(shard) is None:
      return da
    return self._gathered(da, self._still_sharded(shard), shard,
                          self._whole_first)

  def _whole_state(self, state: aggregation_lib.AggregationState,
                   values: Mapping[Hashable, DimArray], shard
                   ) -> aggregation_lib.AggregationState:
    """One statistic's partial state of this rank made the whole chunk's:
    summed over the axes of the sharded dims it reduced, gathered along the
    sharded dims it kept."""
    sharded = self._still_sharded(shard)
    reduce_dims = set(self.aggregator.reduce_dims)

    def whole(var, leaf: DimArray) -> DimArray:
      dims = sharded & set(values[var].dims)
      axes = [self._dim_to_axis[d] for d in sorted(dims & reduce_dims)]
      if axes:
        leaf = leaf.copy(data=distributed.all_reduce_sum(
            leaf.data, self.mesh, axes))
      return self._gathered(leaf, dims - reduce_dims, shard, self._whole_first)

    out = []
    for part in (state.sum_weighted_statistics, state.sum_weights):
      out.append({name: {var: whole(var, leaf) for var, leaf in per_var.items()}
                  for name, per_var in part.items()})
    return aggregation_lib.AggregationState(*out)

  def _check_declared(self, name: str, values, predictions, shard) -> None:
    """Raises when a statistic dropped a sharded dim of its inputs that it
    does not declare in ``reads_across``: its value on a slice would not
    be its value on the whole chunk."""
    sharded = self._still_sharded(shard)
    for var, da in values.items():
      src = predictions.get(var)
      lost = sorted(d for d in sharded
                    if src is not None and d in src.dims and d not in da.dims)
      if lost:
        raise ValueError(
            f'statistic {name!r} reduced the sharded dim(s) {lost} of '
            f'{var!r} without declaring them in reads_across(); on a mesh '
            'it would see only a slice of them')

  # -- resources ------------------------------------------------------------------

  def _plan_resources(self) -> None:
    """Partitions statistic resources: device-resident vs host-gathered.

    Resident resources upload once and are gathered on the device per
    chunk. When their total exceeds the budget, the largest eligible
    arrays are demoted to host-gather: the statistics' prepare_chunk
    aligns them on the host and the chunk carries the aligned slice
    (metrics_base.CLIM_VALUE_PREFIX). An array is eligible only if EVERY
    statistic that registers it lists it as host-gatherable: one that
    reads the array directly in compute keeps it resident, whatever the
    others say.
    """
    sizes: dict[str, int] = {}
    registered_by: dict[str, int] = {}
    gatherable_by: dict[str, int] = {}
    for stat in self._stats:
      arrays = stat.device_resource_arrays()
      for rid, arr in arrays.items():
        sizes[rid] = arr.numel() * arr.element_size()
        registered_by[rid] = registered_by.get(rid, 0) + 1
      for rid in stat.host_gatherable_resource_arrays():
        if rid in arrays:
          gatherable_by[rid] = gatherable_by.get(rid, 0) + 1
    eligible = {rid: sizes[rid] for rid, n in gatherable_by.items()
                if n == registered_by[rid]}
    total = sum(sizes.values())
    budget = _resource_budget_bytes(self.device)
    demoted: set = set()
    if total > budget:
      for rid, nbytes in sorted(eligible.items(), key=lambda kv: -kv[1]):
        demoted.add(rid)
        total -= nbytes
        if total <= budget:
          break
      logging.info(
          'resource plan: %d/%d climatology arrays host-gathered '
          '(resident %.0f MB, budget %.0f MB)',
          len(demoted), len(sizes), total / 2**20, budget / 2**20)
      if total > budget:
        logging.warning(
            'resident statistic resources (%.0f MB) still exceed the budget '
            '(%.0f MB) after host-gathering every eligible array',
            total / 2**20, budget / 2**20)
    self.resource_bytes = total
    self.host_gather_ids = frozenset(demoted)
    for stat in self._stats:
      stat.set_host_gather_resources(self.host_gather_ids)

  def resources(self) -> dict[str, torch.Tensor]:
    """{resource_id: device tensor} of the resident resources, uploaded once.

    Arrays demoted to host-gather are left out; inside the step
    ``metrics_base.resolve_resource`` raises for them rather than copying
    them whole.
    """
    if self._resource_cache is None:
      host = {}
      for stat in self._stats:
        host.update(stat.device_resource_arrays())
      self._resource_cache = {
          rid: arr.to(self.device) for rid, arr in host.items()
          if rid not in self.host_gather_ids}
    return self._resource_cache

  # -- chunk preparation ------------------------------------------------------------

  def prepare_host(self, predictions: Mapping[Hashable, DimArray],
                   targets: Mapping[Hashable, DimArray]) -> tuple:
    """Each unique statistic's host hook, in order; no device work. The
    hooks share one ``alignment_memo``."""
    with (observability.span('wbx.prepare_host'),
          metrics_base.alignment_memo()):
      predictions = dict(predictions)
      for stat in self._stats:
        predictions, _ = stat.prepare_chunk(predictions, targets)
      return predictions, targets

  def _place(self, da: DimArray, shard, parts=None,
             placed: dict | None = None) -> DimArray:
    """Host ``da`` on the device: its data, validity mask and climatology
    index and value coords; on a mesh, this rank's slice of them, made
    whole along the dims the statistics read across. With ``parts``,
    ``da`` is their stack (``_stack_host``), and the data and the
    device-bound coords are copied from the parts, each straight into its
    slice of the stack on the device. ``placed`` (kept by the caller for
    one chunk) holds the device copy of each device-bound coord object
    already copied, so that variables sharing a coord share one copy."""
    if shard is not None:  # a lazy array then reads only this rank's slice
      da = shard.take(da)
      if parts is not None:
        parts = [shard.take(p) for p in parts]
    if parts is None:
      data = da.data.to(self.device)
      # The device-bound coords are small; copied without blocking, a host
      # array is staged and the host goes on, where a blocking copy would
      # wait for the device's queue to drain.
      placed = {} if placed is None else placed
      coords = {}
      for name, c in da.coords.items():
        if _device_bound(name):
          if id(c) not in placed:
            placed[id(c)] = (c, Coord(c.dims, as_tensor(c.values).to(
                self.device, non_blocking=True)))
          c = placed[id(c)][1]
        coords[name] = c
    else:
      data = _stack_to([p.data for p in parts], self.device)
      coords = dict(da.coords)
      for name, c in parts[0].coords.items():
        if _device_bound(name):
          coords[name] = Coord((CHUNK_DIM,) + c.dims, _stack_to(
              [p.coords[name].values for p in parts], self.device))
    out = DimArray(data, da.dims, coords)
    if shard is not None:
      out = self._gathered(out, self._whole_first, shard)
    return out

  def to_device(self, predictions: Mapping[Hashable, DimArray],
                targets: Mapping[Hashable, DimArray]) -> PlacedPair:
    """The host-prepared chunk on the evaluator's device: data, validity
    masks and the climatology index and value coords; on a mesh, this
    rank's slice of them, with the shard it was cut by."""
    with observability.span('wbx.to_device'):
      shard = self._shard_for(predictions, targets)
      placed: dict = {}
      return PlacedPair(
          {var: self._place(da, shard, placed=placed)
           for var, da in predictions.items()},
          {var: self._place(da, shard, placed=placed)
           for var, da in targets.items()},
          shard)

  def place(self, side: Mapping[Hashable, DimArray]) -> dict:
    """One side of a chunk on the evaluator's device, as ``to_device``
    places it off a mesh (its data, validity mask and climatology index
    and value coords), so that the host copy can go before the other side
    is read. ``to_device`` of a placed pair copies nothing. On a mesh the
    two sides are cut by one shard: use ``to_device``."""
    if self.mesh is not None:
      raise ValueError('on a mesh, place both sides with to_device: they '
                       'are cut by one shard')
    with observability.span('wbx.to_device'):
      placed: dict = {}
      return {var: self._place(da, None, placed=placed)
              for var, da in side.items()}

  def prepare_pair(self, predictions: Mapping[Hashable, DimArray],
                   targets: Mapping[Hashable, DimArray]) -> PlacedPair:
    """Host preparation, then the chunk on the device."""
    return self.to_device(*self.prepare_host(predictions, targets))

  def signature(self, predictions: Mapping[Hashable, DimArray],
                targets: Mapping[Hashable, DimArray]) -> tuple:
    """``batchable_signature`` with the coords this aggregator's binnings
    read."""
    return batchable_signature(predictions, targets, self._host_coords)

  def _stack_host(self, parts: list[DimArray]) -> DimArray:
    """Several chunks' host parts of one variable stacked along
    ``CHUNK_DIM``, coords only: its data is one element broadcast to the
    stack's shape, and its device-bound coords (validity mask, climatology
    index and value coords) are left for ``_place`` to stack on the
    device. Coords that may differ per chunk gain ``CHUNK_DIM`` (time
    coords stay numpy, and one that is the same in every chunk is kept
    once); the rest are equal in every chunk of a signature and kept
    once."""
    coords = {}
    for name, c in parts[0].coords.items():
      vals = [p.coords[name].values for p in parts]
      if _device_bound(name):
        continue
      if (not _per_chunk(name, c, self._host_coords)
          or darray._coord_parts_identical(vals)):
        coords[name] = c
      else:
        coords[name] = Coord((CHUNK_DIM,) + c.dims, np.stack(vals))
    first = parts[0]
    return DimArray(
        torch.zeros((), dtype=first.dtype).expand(
            (len(parts),) + tuple(first.shape)),
        (CHUNK_DIM,) + first.dims, coords)

  def to_device_stacked(self, pairs: Sequence[tuple]) -> PlacedPair:
    """Host-prepared pairs of one signature as one pair on the device,
    stacked along ``CHUNK_DIM``; on a mesh, this rank's slice of it, cut
    by the shard of the whole stack (its per-chunk host coords, e.g.
    ``lead_time`` when leads are chunked, gain ``CHUNK_DIM``)."""
    with observability.span('wbx.to_device'):
      parts = [{var: [pair[side][var] for pair in pairs]
                for var in pairs[0][side]} for side in (0, 1)]
      stacked = [{var: self._stack_host(p) for var, p in side.items()}
                 for side in parts]
      shard = self._shard_for(*stacked)
      return PlacedPair(*({var: self._place(da, shard, parts[side][var])
                           for var, da in stacked[side].items()}
                          for side in (0, 1)), shard)

  # -- evaluation ----------------------------------------------------------------------

  def operands_for(
      self, statistics: Mapping[str, Mapping[Hashable, DimArray]],
      shard=None) -> dict:
    """Device-resident weights and bin masks for these statistics.

    ``Aggregator.prepare_operands`` over this evaluator's layout cache:
    built on the host once per statistic layout (and rank slice, on a
    mesh), uploaded once, and kept across chunks (the oldest layouts
    dropped past ``_OPERAND_CACHE_SIZE``). Returns ``{stat_name: {var:
    [DimArray] | None}}`` for ``Aggregator.aggregate_statistics``.
    """
    before = len(self._operand_cache)
    out = self.aggregator.prepare_operands(
        statistics, self._operand_cache, self.device, shard)
    self.operand_builds += len(self._operand_cache) - before
    while len(self._operand_cache) > _OPERAND_CACHE_SIZE:
      self._operand_cache.pop(next(iter(self._operand_cache)))
    return out

  def _shard_of(self, pair: tuple):
    """The shard a pair on the device was cut by. On a mesh, only a
    ``PlacedPair`` knows its slice."""
    if isinstance(pair, PlacedPair):
      return pair.shard
    if self.mesh is not None:
      raise TypeError('on a mesh, evaluate the PlacedPair that to_device or '
                      'prepare_pair returned: it carries the rank\'s slice')
    return None

  def _eval(self, pair: tuple, statistics_out=None
            ) -> aggregation_lib.AggregationState:
    """The aggregated state of a chunk on the device; with
    ``statistics_out`` (a dict), each statistic is also copied there to the
    host as it is aggregated: computed once, consumed twice."""
    with observability.span('wbx.eval'):
      self.dispatches += 1
      # The same pass in the process's registry, where a reader that holds
      # no evaluator (wbxbench's per-pass gathered GB) counts it.
      observability.default_metrics.counter('eval_passes')
      predictions, targets = pair
      shard = self._shard_of(pair)
      live = self._live(shard)
      sums, weights = {}, {}
      with metrics_base.device_resources(self.resources(), live):
        stats = metrics_base.generate_unique_statistics_for_all_metrics(
            self.metrics, predictions, targets)
        for expected in self._stat_names:
          # A span per statistic: its compute is the time outside the two
          # spans inside it.
          with observability.span(f'wbx.statistic.{expected}'):
            name, values = next(stats)
            one = {name: values}
            with observability.span('wbx.operands'):
              operands = self.operands_for(one, live)
            with observability.span('wbx.aggregate'):
              state = self.aggregator.aggregate_statistics(one, operands)
            if live is not None:
              self._check_declared(name, values, predictions, shard)
              state = self._whole_state(state, values, shard)
            sums.update(state.sum_weighted_statistics)
            weights.update(state.sum_weights)
            if statistics_out is not None:
              statistics_out[name] = {var: host_copy(self._whole(da, shard))
                                      for var, da in values.items()}
        stats.close()
      return aggregation_lib.AggregationState(sums, weights)

  def eval_chunk(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> aggregation_lib.AggregationState:
    """Prepares one host chunk, moves it to the device and evaluates it."""
    return self._eval(self.prepare_pair(predictions, targets))

  def eval_host_prepared(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> aggregation_lib.AggregationState:
    """Evaluates a chunk that ``prepare_host`` already prepared."""
    return self._eval(self.to_device(predictions, targets))

  def eval_with_statistics(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> tuple[aggregation_lib.AggregationState, dict]:
    """Evaluates a host-prepared chunk; returns (state, statistics): the
    state as ``eval_host_prepared`` gives it, and host copies (CPU tensors,
    numpy coords) of the ``{stat_name: {var: DimArray}}`` it aggregated."""
    statistics: dict = {}
    state = self._eval(self.to_device(predictions, targets), statistics)
    return state, statistics

  def statistics(self, predictions: Mapping[Hashable, DimArray],
                 targets: Mapping[Hashable, DimArray]) -> dict:
    """The statistics of a host-prepared chunk, not aggregated, as host
    copies ``{stat_name: {var: DimArray}}``; on a mesh, gathered whole."""
    p, t = pair = self.to_device(predictions, targets)
    shard = pair.shard
    with metrics_base.device_resources(self.resources(), self._live(shard)):
      stats = metrics_base.compute_unique_statistics_for_all_metrics(
          self.metrics, p, t)
    return {name: {var: host_copy(self._whole(da, shard))
                   for var, da in per_var.items()}
            for name, per_var in stats.items()}

  def eval_accum(self, pair: tuple, prev_state: aggregation_lib.AggregationState
                 ) -> aggregation_lib.AggregationState:
    """Evaluates a pair on the device (on a mesh, the ``PlacedPair``
    that ``prepare_pair`` or ``to_device`` returned) and adds it to
    ``prev_state``."""
    state = self._eval(pair)
    with observability.span('wbx.state_add'):
      return prev_state + state

  def eval_prepared(self, pairs: Sequence[tuple]
                    ) -> list[aggregation_lib.AggregationState]:
    """One state per host-prepared (predictions, targets) pair.

    A single pair takes the one-chunk path. Pairs of one signature are
    stacked on the device and evaluated once, their aggregation operands
    shared; pairs whose signatures differ (e.g. a ragged tail chunk) are
    evaluated one by one, counted in ``signature_splits``.
    """
    if len(pairs) == 1:
      return [self.eval_host_prepared(*pairs[0])]
    if len({self.signature(*pair) for pair in pairs}) > 1:
      self.signature_splits += 1
      return [self.eval_host_prepared(*pair) for pair in pairs]
    return _split_states(self._eval(self.to_device_stacked(pairs)),
                         len(pairs))

  def eval_chunks(self, pairs: Sequence[tuple]
                  ) -> list[aggregation_lib.AggregationState]:
    """Host chunks prepared, then evaluated as ``eval_prepared`` does."""
    return self.eval_prepared([self.prepare_host(*pair) for pair in pairs])
