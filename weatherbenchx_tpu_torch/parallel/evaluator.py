"""The per-chunk evaluation step: statistics → aggregation on one device.

The port of ``weatherbenchx_tpu/parallel/evaluator.py:170-543``, reduced
to one device. PyTorch runs eagerly, so nothing is traced: time coords
stay host numpy, and there is no jit cache to protect.

* ``prepare_pair`` moves a chunk's data (and its validity-mask coords) to
  the evaluator's device in one pass.
* ``operands_for`` builds the weights and bin masks once per statistic
  layout, uploads one copy of each, and keeps them for later chunks.
* ``eval_chunk`` computes the unique statistics in one compute pass (so
  the CRPS family shares one fused kernel launch) and contracts them
  into an ``AggregationState``.
"""

import dataclasses
from typing import Hashable, Mapping

import torch

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base as metrics_base

_OPERAND_CACHE_SIZE = 32  # layouts kept; ragged runs would grow it per chunk


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
    self._operand_cache: dict = {}

  def _to_device(self, data: Mapping[Hashable, DimArray]
                 ) -> dict[Hashable, DimArray]:
    out = {}
    for var, da in data.items():
      coords = dict(da.coords)
      mask = coords.get('mask')
      if mask is not None:
        coords['mask'] = Coord(mask.dims, torch.as_tensor(
            mask.values, device=self.device))
      out[var] = DimArray(da.data.to(self.device), da.dims, coords)
    return out

  def prepare_pair(self, predictions: Mapping[Hashable, DimArray],
                   targets: Mapping[Hashable, DimArray]) -> tuple:
    """The chunk on the evaluator's device (data and mask coords)."""
    return self._to_device(predictions), self._to_device(targets)

  def operands_for(
      self, statistics: Mapping[str, Mapping[Hashable, DimArray]]) -> dict:
    """Device-resident weights and bin masks for these statistics.

    Built on the host once per statistic layout (``_layout_key``), uploaded
    once, and cached across chunks. Returns ``{stat_name: {var: [DimArray]
    | None}}`` for ``Aggregator.aggregate_statistics``.
    """
    out: dict = {}
    for name, per_var in statistics.items():
      out[name] = {}
      for var, stat in per_var.items():
        if stat is None:
          continue
        if stat.dtype == torch.bool:
          stat = stat.astype(torch.float32)  # as aggregate_statistics does
        key = aggregation_lib._layout_key(stat)
        if key not in self._operand_cache:
          ops = self.aggregator.aggregation_operands(stat)
          if ops is not None:
            ops = [op.copy(data=op.data.to(self.device)) for op in ops]
          if len(self._operand_cache) >= _OPERAND_CACHE_SIZE:
            self._operand_cache.pop(next(iter(self._operand_cache)))
          self._operand_cache[key] = ops
        out[name][var] = self._operand_cache[key]
    return out

  def _eval(self, predictions, targets) -> aggregation_lib.AggregationState:
    statistics = metrics_base.compute_unique_statistics_for_all_metrics(
        self.metrics, predictions, targets)
    return self.aggregator.aggregate_statistics(
        statistics, self.operands_for(statistics))

  def eval_chunk(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> aggregation_lib.AggregationState:
    """Moves one chunk to the device and evaluates it."""
    return self._eval(*self.prepare_pair(predictions, targets))

  def eval_accum(self, pair: tuple, prev_state: aggregation_lib.AggregationState
                 ) -> aggregation_lib.AggregationState:
    """Evaluates a prepared pair and adds it to ``prev_state``."""
    return prev_state + self._eval(*pair)
