"""Aggregation: the monoid (Σ weighted statistics, Σ weights) and Aggregator.

The port of ``weatherbenchx_tpu/aggregation.py``, without its TPU routing
(the ``WBX_AGG_BATCH`` switch and the regime gate of
``aggregate_statistics``): one contraction per statistic.
Every metric is a function of weighted means of per-chunk statistics, so
evaluation over many chunks reduces to summing ``(Σ w·s, Σ w)`` pairs — a
commutative monoid — then applying each metric's finalizer to the means.

Per chunk, each (statistic, variable) is contracted with its weights and
bin masks in one ``darray.dot`` (``torch.einsum`` in full float32). The
state serializes with the JAX package's ``#``-separated key schema.
"""

import dataclasses
import functools
import weakref
from typing import (Any, Callable, Collection, Hashable, Iterable, Mapping,
                    MutableMapping, Sequence)

import numpy as np
import torch

from weatherbenchx_tpu_torch import binning as binning_lib
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import io as io_lib
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
  """Sum with a zero-filled outer join over non-aligned dim coordinates.

  Fast path (same dims, shape and dim coords): a tensor add on the
  operands' device, in order. All-CPU inputs (e.g. float64 states from
  ``to_host`` or a file) stay on the host in their promoted dtype: unlike
  the JAX package, torch does not downcast float64 here, so one loop
  serves both. General path: a host-side sorted-union outer join with zero
  fill, matching ``xr.align(join='outer', fill_value=0)``.
  """
  data_arrays = list(data_arrays)
  first = data_arrays[0]
  if len(data_arrays) == 1:
    return first
  if not all(a.dims == first.dims and a.shape == first.shape
             and _host_dim_coords_equal(a, first) for a in data_arrays[1:]):
    return _outer_join_sum(data_arrays)
  leaves = darray._on_one_device(*[a.data for a in data_arrays])
  acc = leaves[0]
  for leaf in leaves[1:]:
    acc = acc + leaf
  return first.copy(data=acc)


def _outer_join_sum(arrays: Sequence[DimArray]) -> DimArray:
  """Host-side zero-filled outer-join sum (sorted coordinate union).

  Accumulates in float64 for floating inputs and returns a CPU tensor of
  the inputs' promoted dtype, as the JAX package's host path does.
  """
  first = arrays[0]
  dims = first.dims
  for a in arrays[1:]:
    if set(a.dims) != set(dims):
      raise ValueError(
          f'Cannot sum arrays with different dims: {a.dims} vs {dims}')
  arrays = [a.transpose(*dims) for a in arrays]

  union_coords: dict[str, np.ndarray] = {}
  for d in dims:
    has_coord = [a.coords.get(d) is not None for a in arrays]
    sizes = {a.sizes[d] for a in arrays}
    same_coords = all(has_coord) and all(
        np.array_equal(a.coord_values(d), arrays[0].coord_values(d))
        for a in arrays[1:])
    if len(sizes) == 1 and (not any(has_coord) or same_coords):
      continue  # aligned already
    if not all(has_coord):
      raise ValueError(
          f'Cannot outer-join dim {d!r} without coordinates on all arrays')
    union_coords[d] = np.unique(np.concatenate(
        [a.coord_values(d) for a in arrays]))

  dtype = functools.reduce(torch.promote_types, [a.dtype for a in arrays])
  result = np.zeros(
      [len(union_coords[d]) if d in union_coords else first.sizes[d]
       for d in dims],
      np.float64 if dtype.is_floating_point
      else torch.empty(0, dtype=dtype).numpy().dtype)
  for a in arrays:
    indexers = [np.searchsorted(union_coords[d], a.coord_values(d))
                if d in union_coords else np.arange(a.sizes[d])
                for d in dims]
    np.add.at(result, np.ix_(*indexers) if indexers else (), a.values)

  coords: dict[str, Coord] = {}
  for d in dims:
    if d in union_coords:
      coords[d] = Coord((d,), union_coords[d])
    elif first.coords.get(d) is not None:
      coords[d] = first.coords[d]
  # Non-dim coords of the first input on unchanged dims.
  for name, c in first.coords.items():
    if (name not in coords and set(c.dims).issubset(dims)
        and not any(d in union_coords for d in c.dims)):
      coords[name] = c
  return DimArray(torch.from_numpy(result).to(dtype), dims, coords)


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

  def sum_along_dims(self, dims: Collection[str]) -> 'AggregationState':
    """Second-stage reduction over preserved dims (e.g. init_time); a
    variable that lacks a dim is left as it is over that dim."""
    return self.map(lambda x: x.sum(tuple(d for d in dims if d in x.dims)))

  def dot(self, *arrays: DimArray,
          dim: str | Sequence[str]) -> 'AggregationState':
    """Contracts every array of the state with resampling or count
    matrices (the core of the bootstrap)."""
    return self.map(lambda x: darray.dot(x, *arrays, dim=dim))

  @classmethod
  def map_multi(cls, func: Callable[..., DimArray],
                *agg_states: 'AggregationState') -> 'AggregationState':
    """Applies ``func`` across the parallel DimArrays of several states."""
    if any(a.sum_weighted_statistics is None for a in agg_states):
      raise ValueError('Cannot map a zero AggregationState.')
    return cls(
        tree.map_structure(
            func, *[a.sum_weighted_statistics for a in agg_states]),
        tree.map_structure(func, *[a.sum_weights for a in agg_states]))

  def map(self, func: Callable[[DimArray], DimArray]) -> 'AggregationState':
    """Applies ``func`` to every DimArray of the state; the zero state
    maps to itself."""
    if self.sum_weighted_statistics is None:
      return self
    return self.map_multi(func, self)

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

  def save(self, path: str) -> None:
    """Writes the state with ``io.save_dataset`` (the container by suffix)."""
    io_lib.save_dataset(path, self.to_dataset())

  @classmethod
  def load(cls, path: str) -> 'AggregationState':
    """A state written by ``save`` (here or by the JAX package), on the CPU."""
    return cls.from_dataset(io_lib.load_dataset(path))


# Content fingerprints of the coords that binnings read, by the identity of
# the values object: {id: (weak reference, fingerprint)}. The statistics of
# one chunk carry the same coord objects, so a coord is copied from the
# device and hashed once per chunk, not once per statistic.
_CONTENT_FINGERPRINTS: dict = {}
_CONTENT_FINGERPRINTS_KEPT = 256


def _content_fingerprint(v) -> tuple:
  hit = _CONTENT_FINGERPRINTS.get(id(v))
  if hit is not None and hit[0]() is v:
    return hit[1]
  host = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
  fingerprint = (str(host.dtype), host.shape,
                 hash(np.ascontiguousarray(host).tobytes()))
  if len(_CONTENT_FINGERPRINTS) >= _CONTENT_FINGERPRINTS_KEPT:
    for key in [k for k, (ref, _) in list(_CONTENT_FINGERPRINTS.items())
                if ref() is None]:
      del _CONTENT_FINGERPRINTS[key]
    while len(_CONTENT_FINGERPRINTS) >= _CONTENT_FINGERPRINTS_KEPT:
      _CONTENT_FINGERPRINTS.pop(next(iter(_CONTENT_FINGERPRINTS)))
  _CONTENT_FINGERPRINTS[id(v)] = (weakref.ref(v), fingerprint)
  return fingerprint


def _coord_fingerprint(c: Coord, by_content: bool) -> tuple:
  v = c.values
  if by_content:
    return _content_fingerprint(
        v if isinstance(v, (torch.Tensor, np.ndarray)) else np.asarray(v))
  if isinstance(v, torch.Tensor):
    return ('tensor', tuple(v.shape), str(v.dtype))
  v = np.asarray(v)
  if v.size <= 4096:
    return (str(v.dtype), v.shape, hash(np.ascontiguousarray(v).tobytes()))
  return ('id', id(v))


def _layout_key(stat: DimArray, read_coords: Collection[str] = ()) -> tuple:
  """Hashable key of the operands a statistic needs: dims, shape, dtype and
  the coords that weightings and binnings read.

  ``read_coords`` names the coords a binning reads by value
  (``Binning.host_coords``): they enter by content whatever their type and
  size. Of the others, time coords (datetime/timedelta) are left out (init
  times differ from chunk to chunk), device coords (e.g. validity masks)
  enter by shape and dtype only, and large host coords by identity.
  """
  coords_key = tuple(sorted(
      (str(n), tuple(c.dims), _coord_fingerprint(c, n in read_coords))
      for n, c in stat.coords.items()
      if n in read_coords or not (isinstance(c.values, np.ndarray)
                                  and c.values.dtype.kind in 'Mm')))
  return (tuple(stat.dims), tuple(stat.shape), str(stat.dtype), coords_key)


_UNSET = object()  # "build the operands here", as distinct from None (drop)


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

  def layout_key(self, stat: DimArray) -> tuple:
    """The key under which ``stat``'s operands may be shared and cached:
    ``_layout_key`` with the coords this aggregator's binnings read."""
    read = {name for b in self.bin_by or [] for name in b.host_coords}
    return _layout_key(stat, read)

  def aggregation_fn(self, stat: DimArray, operands=_UNSET) -> DimArray | None:
    """The contraction: einsum(stat, *weights, *bin_masks) over the reduce
    dims; None for a variable that must be dropped."""
    if operands is _UNSET:
      operands = self.aggregation_operands(stat)
    if operands is None or not set(self.reduce_dims).issubset(stat.dims):
      return None
    return darray.dot(stat, *operands, dim=tuple(
        d for d in stat.dims if d in set(self.reduce_dims)))

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

  def aggregate_stat_var(self, stat: DimArray,
                         operands=_UNSET) -> AggregationState | None:
    """Aggregates one statistic DimArray of one variable; None for a
    variable that must be dropped."""
    stat = self._promote(stat)
    if operands is _UNSET:
      operands = self.aggregation_operands(stat)
    if operands is None or not set(self.reduce_dims).issubset(stat.dims):
      return None
    stat, maskf = self._prepare_masked(stat)
    return AggregationState(self.aggregation_fn(stat, operands),
                            self.aggregation_fn(maskf, operands))

  def aggregate_stat_vars(
      self, stats: Mapping[Hashable, DimArray],
      operands: Mapping[Hashable, list | None] | None = None,
  ) -> AggregationState:
    """Aggregates one statistic's variables; ``operands`` may give some
    variables' pre-built operands (None drops the variable)."""
    per_var = {
        var: self.aggregate_stat_var(stat, (operands or {}).get(var, _UNSET))
        for var, stat in stats.items() if stat is not None}
    per_var = {v: s for v, s in per_var.items() if s is not None}
    return AggregationState(
        {v: s.sum_weighted_statistics for v, s in per_var.items()},
        {v: s.sum_weights for v, s in per_var.items()})

  def prepare_operands(
      self,
      statistics: Mapping[str, Mapping[Hashable, DimArray]],
      layout_cache: MutableMapping | None = None,
      device: torch.device | str | None = None,
  ) -> dict:
    """``{stat_name: {var: [DimArray...] | None}}``: each statistic's
    weights and bin masks, built on the host from its layout alone (values
    are not read) after the bool → float32 promotion that aggregation
    applies, and moved to ``device`` if one is given.

    Statistics of one layout (``layout_key``) get the SAME operand
    objects, so a caller holds one copy of e.g. the 0.25 degree x 34-bin
    region masks, not one per statistic. ``layout_cache`` is that sharing
    made to last: a mapping the caller keeps (the evaluator's, across
    chunks); entries are added to it and never evicted here.
    """
    cache = {} if layout_cache is None else layout_cache
    out: dict = {}
    for name, per_var in statistics.items():
      out[name] = {}
      for var, stat in per_var.items():
        if stat is None:
          continue
        stat = self._promote(stat)
        key = self.layout_key(stat)
        if key not in cache:
          ops = self.aggregation_operands(stat)
          if ops is not None and device is not None:
            ops = [op.copy(data=op.data.to(device)) for op in ops]
          cache[key] = ops
        out[name][var] = cache[key]
    return out

  def aggregate_statistics(
      self,
      statistics: Mapping[str, Mapping[Hashable, DimArray]],
      operands: Mapping[str, Mapping[Hashable, list | None]] | None = None,
  ) -> AggregationState:
    """Aggregates all (statistic, variable) arrays of a chunk, one
    contraction per statistic and one per weights indicator.

    ``operands``: optional pre-built ``{stat_name: {var: [DimArray...] |
    None}}`` from ``prepare_operands`` (the evaluator's device-resident
    weights and bin masks); missing entries are built here, once per
    layout of this call.
    """
    given = operands or {}
    missing = {
        name: {var: stat for var, stat in stats.items()
               if stat is not None and var not in (given.get(name) or {})}
        for name, stats in statistics.items()}
    built = self.prepare_operands(missing)
    sums: dict = {}
    weights: dict = {}
    for name, stats in statistics.items():
      state = self.aggregate_stat_vars(
          stats, {**built[name], **(given.get(name) or {})})
      sums[name] = state.sum_weighted_statistics
      weights[name] = state.sum_weights
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
