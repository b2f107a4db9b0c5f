"""Aggregation: the monoid (Σ weighted statistics, Σ weights) and Aggregator.

The port of ``weatherbenchx_tpu/aggregation.py:67-240, 369-614, 651-666``.
Every metric is a function of weighted means of per-chunk statistics, so
evaluation over many chunks reduces to summing ``(Σ w·s, Σ w)`` pairs — a
commutative monoid — then applying each metric's finalizer to the means.

Per chunk, each (statistic, variable) is contracted with its weights and
bin masks in one ``darray.dot`` (``torch.einsum`` in full float32). The
state serializes with the JAX package's ``#``-separated key schema.
"""

import dataclasses
from typing import Any, Collection, Hashable, Iterable, Mapping, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import binning as binning_lib
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch import weighting as weighting_lib
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base as metrics_base


def _host_dim_coords_equal(a: DimArray, b: DimArray) -> bool:
  for d in a.dims:
    ca, cb = a.coords.get(d), b.coords.get(d)
    if (ca is None) != (cb is None):
      return False
    if ca is None:
      continue
    if ca.is_host != cb.is_host:
      return False
    if ca.is_host and not np.array_equal(np.asarray(ca.values),
                                         np.asarray(cb.values)):
      return False
  return True


def combining_sum(data_arrays: Sequence[DimArray]) -> DimArray:
  """Sum of arrays of one layout (same dims, shape and dim coords).

  The zero-filled outer join over differing coords that the JAX package
  also offers (for sparse, ragged chunk results) is not ported yet.
  """
  data_arrays = list(data_arrays)
  first = data_arrays[0]
  if len(data_arrays) == 1:
    return first
  if not all(a.dims == first.dims and a.shape == first.shape
             and _host_dim_coords_equal(a, first) for a in data_arrays[1:]):
    raise NotImplementedError(
        'combining_sum of arrays with different dims or coords (the outer '
        'join) is not ported yet')
  leaves = darray._on_one_device(*[a.data for a in data_arrays])
  acc = leaves[0]
  for leaf in leaves[1:]:
    acc = acc + leaf
  return first.copy(data=acc)


@dataclasses.dataclass
class AggregationState:
  """Sum of weighted statistics and sum of weights (a commutative monoid).

  Both attributes are nested ``{statistic_name: {var_name: DimArray}}``
  mappings, or None for the zero state.
  """

  sum_weighted_statistics: Any
  sum_weights: Any

  @classmethod
  def zero(cls) -> 'AggregationState':
    return cls(sum_weighted_statistics=None, sum_weights=None)

  def __add__(self, other: 'AggregationState') -> 'AggregationState':
    return self.sum([self, other])

  @classmethod
  def sum(cls, aggregation_states: Iterable['AggregationState']
          ) -> 'AggregationState':
    tuples = [(a.sum_weighted_statistics, a.sum_weights)
              for a in aggregation_states
              if a.sum_weighted_statistics is not None]
    if not tuples:
      return cls.zero()
    sum_ws, sum_w = tree.map_structure(lambda *a: combining_sum(a), *tuples)
    return cls(sum_ws, sum_w)

  def mean_statistics(self) -> Any:
    """Statistics normalized by their weights ({} for the zero state)."""
    if self.sum_weighted_statistics is None:
      return {}
    return tree.map_structure(
        lambda ws, w: ws / w, self.sum_weighted_statistics, self.sum_weights)

  def metric_values(
      self, metrics: Mapping[str, metrics_base.Metric]
  ) -> dict[str, DimArray]:
    """Final metric values as a flat '<metric>.<variable>' dataset."""
    if self.sum_weighted_statistics is None:
      return {}
    metric_values = metrics_base.compute_metrics_from_statistics(
        metrics, self.mean_statistics())
    return {f'{metric_name}.{var_name}': da
            for metric_name, per_var in metric_values.items()
            for var_name, da in per_var.items()}

  def map(self, func) -> 'AggregationState':
    """Applies ``func`` to every DimArray of the state."""
    if self.sum_weighted_statistics is None:
      return self
    return AggregationState(
        tree.map_structure(func, self.sum_weighted_statistics),
        tree.map_structure(func, self.sum_weights))

  def to_host(self) -> 'AggregationState':
    """The state on the host: float64 CPU tensors, numpy coords."""
    def conv(x: DimArray) -> DimArray:
      d = x.data.detach().cpu()
      if d.is_floating_point():
        d = d.double()
      coords = {name: Coord(c.dims, c.values.detach().cpu().numpy()
                            if isinstance(c.values, torch.Tensor)
                            else np.asarray(c.values))
                for name, c in x.coords.items()}
      return DimArray(d, x.dims, coords)
    return self.map(conv)

  def to_dataset(self, separator: str = '#') -> dict[str, DimArray]:
    """Flat view: '<stat>#<var>#sum_weighted_statistics' / '...#sum_weights'."""
    out: dict[str, DimArray] = {}
    for leaf_name, tree_ in (
        ('sum_weighted_statistics', self.sum_weighted_statistics),
        ('sum_weights', self.sum_weights)):
      for path, da in tree.flatten_with_paths(tree_ or {}).items():
        out[separator.join([str(p) for p in path] + [leaf_name])] = da
    return out

  @classmethod
  def from_dataset(cls, dataset: Mapping[str, DimArray],
                   separator: str = '#') -> 'AggregationState':
    sum_ws: dict = {}
    sum_w: dict = {}
    for key, da in dataset.items():
      *path, leaf_name = str(key).split(separator)
      node = sum_ws if leaf_name == 'sum_weighted_statistics' else sum_w
      for p in path[:-1]:
        node = node.setdefault(p, {})
      node[path[-1]] = da
    return cls(sum_ws, sum_w)


def _coord_fingerprint(c: Coord) -> tuple:
  v = c.values
  if isinstance(v, torch.Tensor):
    return ('tensor', tuple(v.shape), str(v.dtype))
  v = np.asarray(v)
  if v.size <= 4096:
    return (str(v.dtype), v.shape, hash(np.ascontiguousarray(v).tobytes()))
  return ('id', id(v))


def _layout_key(stat: DimArray) -> tuple:
  """Hashable key of the operands a statistic needs: dims, shape, dtype and
  the host coords that weightings and binnings read.

  Time coords (datetime/timedelta) are left out: no weighting or binning
  of this package reads them, and init times differ from chunk to chunk.
  Device coords (e.g. validity masks) enter by shape and dtype only.
  """
  coords_key = tuple(sorted(
      (str(n), tuple(c.dims), _coord_fingerprint(c))
      for n, c in stat.coords.items()
      if not (isinstance(c.values, np.ndarray)
              and c.values.dtype.kind in 'Mm')))
  return (tuple(stat.dims), tuple(stat.shape), str(stat.dtype), coords_key)


@dataclasses.dataclass
class Aggregator:
  """Weighted/binned/masked aggregation over a set of dimensions.

  Variables lacking any reduce dim (or any bin-mask input dim) are
  silently dropped; masked values are zeroed in both statistic and
  weights; skipna turns NaNs into masked points; otherwise NaNs propagate.
  """

  reduce_dims: Collection[str]
  bin_by: Sequence[binning_lib.Binning] | None = None
  weigh_by: Sequence[weighting_lib.Weighting] | None = None
  masked: bool = False
  skipna: bool = False

  def aggregation_operands(self, stat: DimArray) -> list[DimArray] | None:
    """Weights and bin masks for a statistic's layout, built on the host.

    Weights come out in the statistic's dtype, bin masks as bool CPU
    tensors. None when the variable must be dropped (missing reduce dims
    or bin-input dims).
    """
    if not set(self.reduce_dims).issubset(stat.dims):
      return None
    bin_dim_names = {b.bin_dim_name for b in self.bin_by or []}
    if len(bin_dim_names) != len(self.bin_by or []):
      raise ValueError('Bin dimension names must be unique.')
    operands = [w.weights(stat).astype(stat.dtype)
                for w in self.weigh_by or []]
    for b in self.bin_by or []:
      bin_mask = b.create_bin_mask(stat)
      if not (set(bin_mask.dims) - {b.bin_dim_name}).issubset(stat.dims):
        return None
      operands.append(bin_mask)
    return operands

  def _promote(self, stat: DimArray) -> DimArray:
    # A bool statistic would sum to a count in the contraction but must
    # aggregate to a weighted mean: promote it first (xr.dot promotes too).
    return stat.astype(torch.float32) if stat.dtype == torch.bool else stat

  def _prepare_masked(self, stat: DimArray) -> tuple[DimArray, DimArray]:
    """masked/skipna prep: (zeroed statistic, weights-indicator mask)."""
    if self.masked and stat.has_coord('mask'):
      mask = DimArray(stat.coords['mask'].values, stat.coords['mask'].dims)
      if self.skipna:
        mask = mask & ~stat.isnull()
      # Zero the masked values in the stat (avoids NaN*0 -> NaN), and use
      # the broadcast mask as the weights indicator.
      stat = stat.where(mask, 0)
      mask = mask.broadcast_like(stat)
    elif self.skipna:
      mask = ~stat.isnull()
      stat = stat.where(mask, 0)
    else:
      mask = darray.ones_like(stat, dtype=torch.bool)
    if mask.sizes != stat.sizes:
      raise ValueError(f'mask sizes {mask.sizes} != statistic sizes '
                       f'{stat.sizes}')
    return stat, mask.astype(stat.dtype)

  def aggregate_statistics(
      self,
      statistics: Mapping[str, Mapping[Hashable, DimArray]],
      operands: Mapping[str, Mapping[Hashable, list | None]] | None = None,
  ) -> AggregationState:
    """Aggregates all (statistic, variable) arrays of a chunk.

    ``operands``: optional pre-built ``{stat_name: {var: [DimArray...] |
    None}}`` (the evaluator's device-resident weights and bin masks);
    missing entries are built here, once per layout of this call.
    """
    reduce_set = set(self.reduce_dims)
    op_memo: dict = {}
    sums: dict = {name: {} for name in statistics}
    weights: dict = {name: {} for name in statistics}
    for name, stats in statistics.items():
      for var, stat in stats.items():
        if stat is None:
          continue
        stat = self._promote(stat)
        given = (operands or {}).get(name) or {}
        if var in given:
          ops = given[var]
        else:
          key = _layout_key(stat)
          if key not in op_memo:
            op_memo[key] = self.aggregation_operands(stat)
          ops = op_memo[key]
        if ops is None or not reduce_set.issubset(stat.dims):
          continue
        stat0, maskf = self._prepare_masked(stat)
        dims = tuple(d for d in stat0.dims if d in reduce_set)
        sums[name][var] = darray.dot(stat0, *ops, dim=dims)
        weights[name][var] = darray.dot(maskf, *ops, dim=dims)
    return AggregationState(sum_weighted_statistics=sums,
                            sum_weights=weights)


def compute_metric_values_for_single_chunk(
    metrics: Mapping[str, metrics_base.Metric],
    aggregator: Aggregator,
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> dict[str, DimArray]:
  """statistics → aggregate → finalize for one in-memory chunk."""
  statistics = metrics_base.compute_unique_statistics_for_all_metrics(
      metrics, predictions, targets)
  return aggregator.aggregate_statistics(statistics).metric_values(metrics)
