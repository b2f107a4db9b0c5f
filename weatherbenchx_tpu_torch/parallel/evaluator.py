"""The per-chunk evaluation step: statistics → aggregation on one device.

The port of ``weatherbenchx_tpu/parallel/evaluator.py``, reduced to one
device. PyTorch runs eagerly, so nothing is traced: time coords stay host
numpy, and there is no jit cache to protect.

* ``_plan_resources`` splits the statistics' long-lived arrays
  (climatologies) into device-resident ones, uploaded once by
  ``resources()``, and host-gathered ones, aligned per chunk on the host
  when the resident set would overflow the device budget.
* ``prepare_host`` runs each unique statistic's host hook
  (``Statistic.prepare_chunk``: climatology alignment indices and
  host-gathered slices) and touches no device, so the pipeline runs it in
  its loader threads; ``to_device`` then moves the chunk's data, masks and
  those coords to the evaluator's device in one pass.
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
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import Coord, DimArray, as_tensor
from weatherbenchx_tpu_torch.metrics import base as metrics_base

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
  if name == 'mask' or str(name).startswith(_DEVICE_COORD_PREFIXES):
    return True
  return (name not in host_coords and isinstance(c.values, np.ndarray)
          and c.values.dtype.kind in 'Mm')


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
    device: The device the chunks are evaluated on, e.g. 'cuda' or 'cpu'.
  """

  metrics: Mapping[str, metrics_base.Metric]
  aggregator: aggregation_lib.Aggregator
  device: torch.device | str

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
    """Each unique statistic's host hook, in order; no device work."""
    predictions = dict(predictions)
    for stat in self._stats:
      predictions, _ = stat.prepare_chunk(predictions, targets)
    return predictions, targets

  def _to_device_one(self, data: Mapping[Hashable, DimArray]
                     ) -> dict[Hashable, DimArray]:
    out = {}
    for var, da in data.items():
      coords = {
          name: (Coord(c.dims, as_tensor(c.values, self.device))
                 if name == 'mask'
                 or str(name).startswith(_DEVICE_COORD_PREFIXES) else c)
          for name, c in da.coords.items()}
      out[var] = DimArray(da.data.to(self.device), da.dims, coords)
    return out

  def to_device(self, predictions: Mapping[Hashable, DimArray],
                targets: Mapping[Hashable, DimArray]) -> tuple:
    """The host-prepared chunk on the evaluator's device: data, validity
    masks and the climatology index and value coords."""
    return self._to_device_one(predictions), self._to_device_one(targets)

  def prepare_pair(self, predictions: Mapping[Hashable, DimArray],
                   targets: Mapping[Hashable, DimArray]) -> tuple:
    """Host preparation, then the chunk on the device."""
    return self.to_device(*self.prepare_host(predictions, targets))

  def signature(self, predictions: Mapping[Hashable, DimArray],
                targets: Mapping[Hashable, DimArray]) -> tuple:
    """``batchable_signature`` with the coords this aggregator's binnings
    read."""
    return batchable_signature(predictions, targets, self._host_coords)

  def _stack_one(self, parts: list[DimArray]) -> DimArray:
    """One variable of several host-prepared chunks, stacked on the device
    along ``CHUNK_DIM``. Coords that may differ per chunk gain
    ``CHUNK_DIM`` (time coords stay numpy, and one that is the same in
    every chunk is kept once); the rest are equal in every chunk of a
    signature and kept once."""
    first = parts[0]
    coords = {}
    for name, c in first.coords.items():
      vals = [p.coords[name].values for p in parts]
      if not _per_chunk(name, c, self._host_coords):
        coords[name] = c
      elif name == 'mask' or str(name).startswith(_DEVICE_COORD_PREFIXES):
        coords[name] = Coord((CHUNK_DIM,) + c.dims,
                             _stack_to(vals, self.device))
      elif darray._coord_parts_identical(vals):
        coords[name] = c
      else:
        coords[name] = Coord((CHUNK_DIM,) + c.dims, np.stack(vals))
    return DimArray(_stack_to([p.data for p in parts], self.device),
                    (CHUNK_DIM,) + first.dims, coords)

  def to_device_stacked(self, pairs: Sequence[tuple]) -> tuple:
    """Host-prepared pairs of one signature as one pair on the device,
    stacked along ``CHUNK_DIM``."""
    return tuple({var: self._stack_one([pair[side][var] for pair in pairs])
                  for var in pairs[0][side]} for side in (0, 1))

  # -- evaluation ----------------------------------------------------------------------

  def operands_for(
      self, statistics: Mapping[str, Mapping[Hashable, DimArray]]) -> dict:
    """Device-resident weights and bin masks for these statistics.

    ``Aggregator.prepare_operands`` over this evaluator's layout cache:
    built on the host once per statistic layout, uploaded once, and kept
    across chunks (the oldest layouts dropped past ``_OPERAND_CACHE_SIZE``).
    Returns ``{stat_name: {var: [DimArray] | None}}`` for
    ``Aggregator.aggregate_statistics``.
    """
    before = len(self._operand_cache)
    out = self.aggregator.prepare_operands(
        statistics, self._operand_cache, self.device)
    self.operand_builds += len(self._operand_cache) - before
    while len(self._operand_cache) > _OPERAND_CACHE_SIZE:
      self._operand_cache.pop(next(iter(self._operand_cache)))
    return out

  def _eval(self, predictions, targets, statistics_out=None
            ) -> aggregation_lib.AggregationState:
    """The aggregated state of a chunk on the device; with
    ``statistics_out`` (a dict), each statistic is also copied there to the
    host as it is aggregated: computed once, consumed twice."""
    self.dispatches += 1
    sums, weights = {}, {}
    with metrics_base.device_resources(self.resources()):
      stats = metrics_base.generate_unique_statistics_for_all_metrics(
          self.metrics, predictions, targets)
      for expected in self._stat_names:
        # A named range per statistic, its compute and its aggregation, for
        # a profiler trace (observability.maybe_profile).
        with torch.profiler.record_function(f'wbx.statistic.{expected}'):
          name, values = next(stats)
          one = {name: values}
          state = self.aggregator.aggregate_statistics(
              one, self.operands_for(one))
          sums.update(state.sum_weighted_statistics)
          weights.update(state.sum_weights)
          if statistics_out is not None:
            statistics_out[name] = {var: host_copy(da)
                                    for var, da in values.items()}
      stats.close()
    return aggregation_lib.AggregationState(sums, weights)

  def eval_chunk(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> aggregation_lib.AggregationState:
    """Prepares one host chunk, moves it to the device and evaluates it."""
    return self._eval(*self.prepare_pair(predictions, targets))

  def eval_host_prepared(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> aggregation_lib.AggregationState:
    """Evaluates a chunk that ``prepare_host`` already prepared."""
    return self._eval(*self.to_device(predictions, targets))

  def eval_with_statistics(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> tuple[aggregation_lib.AggregationState, dict]:
    """Evaluates a host-prepared chunk; returns (state, statistics): the
    state as ``eval_host_prepared`` gives it, and host copies (CPU tensors,
    numpy coords) of the ``{stat_name: {var: DimArray}}`` it aggregated."""
    statistics: dict = {}
    state = self._eval(*self.to_device(predictions, targets), statistics)
    return state, statistics

  def eval_accum(self, pair: tuple, prev_state: aggregation_lib.AggregationState
                 ) -> aggregation_lib.AggregationState:
    """Evaluates a prepared pair on the device and adds it to
    ``prev_state``."""
    return prev_state + self._eval(*pair)

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
    return _split_states(self._eval(*self.to_device_stacked(pairs)),
                         len(pairs))

  def eval_chunks(self, pairs: Sequence[tuple]
                  ) -> list[aggregation_lib.AggregationState]:
    """Host chunks prepared, then evaluated as ``eval_prepared`` does."""
    return self.eval_prepared([self.prepare_host(*pair) for pair in pairs])
