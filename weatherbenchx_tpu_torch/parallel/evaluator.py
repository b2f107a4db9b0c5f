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
  it comes, so that one statistic at a time is held on the device.
"""

import dataclasses
import logging
import os
from typing import Hashable, Mapping

import torch

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch.darray import Coord, DimArray, as_tensor
from weatherbenchx_tpu_torch.metrics import base as metrics_base

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
    self._stats = list(metrics_base.unique_statistics_for_metrics(
        self.metrics).values())
    self._operand_cache: dict = {}
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
    out = self.aggregator.prepare_operands(
        statistics, self._operand_cache, self.device)
    while len(self._operand_cache) > _OPERAND_CACHE_SIZE:
      self._operand_cache.pop(next(iter(self._operand_cache)))
    return out

  def _eval(self, predictions, targets) -> aggregation_lib.AggregationState:
    sums, weights = {}, {}
    with metrics_base.device_resources(self.resources()):
      for name, values in metrics_base.generate_unique_statistics_for_all_metrics(
          self.metrics, predictions, targets):
        one = {name: values}
        state = self.aggregator.aggregate_statistics(
            one, self.operands_for(one))
        sums.update(state.sum_weighted_statistics)
        weights.update(state.sum_weights)
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

  def eval_accum(self, pair: tuple, prev_state: aggregation_lib.AggregationState
                 ) -> aggregation_lib.AggregationState:
    """Evaluates a prepared pair on the device and adds it to
    ``prev_state``."""
    return prev_state + self._eval(*pair)
