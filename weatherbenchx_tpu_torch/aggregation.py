"""Aggregation: the monoid (Σ weighted statistics, Σ weights) and Aggregator.

The port of ``weatherbenchx_tpu/aggregation.py``, without its TPU routing
(the ``WBX_AGG_BATCH`` switch and the regime gate of
``aggregate_statistics``): one contraction per statistic.
Every metric is a function of weighted means of per-chunk statistics, so
evaluation over many chunks reduces to summing ``(Σ w·s, Σ w)`` pairs — a
commutative monoid — then applying each metric's finalizer to the means.

Per chunk, each (statistic, variable) is zeroed where masked in one
``where`` and contracted in one ``darray.dot`` (``torch.einsum`` in full
float32) with its weights and bin masks, as a layout keeps them in the
contraction dtype (``_contraction_form``). The weights' indicator is
contracted at the mask's own dims, and broadcast to the statistic's only
where skipna makes it read the values (``INDICATOR_FORMS`` counts each);
where nothing is masked it depends on the layout alone and is contracted
once a layout (``Aggregator._indicator``).
The state serializes with the JAX package's ``#``-separated key schema.
"""

import dataclasses
import functools
import math
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
    if ca is None or ca is cb or ca.values is cb.values:
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

# How often the weights' indicator was contracted in each form: at the
# mask's own dims ('mask_dims': the statistic's values are not read), or
# broadcast to the statistic's dims ('broadcast': skipna makes the mask
# depend on the values).
INDICATOR_FORMS = {'mask_dims': 0, 'broadcast': 0}


def reset_indicator_forms() -> None:
  """Zeroes ``INDICATOR_FORMS``."""
  for k in INDICATOR_FORMS:
    INDICATOR_FORMS[k] = 0


class LayoutOperands(list):
  """A layout's weights and bin masks, with their contraction form.

  The list ``Aggregator.aggregation_operands`` builds, as
  ``Aggregator.prepare_operands`` shares and caches it; the forms
  ``_contraction_form`` builds are kept on it, once a layout.
  """

  def __init__(self, operands: Iterable[DimArray]):
    super().__init__(operands)
    self.forms: dict = {}
    self.indicators: dict = {}


def _contraction_form(operands: Sequence[DimArray], dtype: torch.dtype,
                      device: torch.device) -> list[DimArray]:
  """The operands as the contraction takes them: in ``dtype`` on
  ``device``, largest first, each one whose dims lie within a larger one's
  multiplied into it (area weights into the region masks over their grid).
  Kept on a ``LayoutOperands``, so built once per layout, not per call."""
  forms = getattr(operands, 'forms', {})
  key = (dtype, device)
  if key not in forms:
    groups: list[DimArray] = []
    for op in sorted(operands, key=lambda op: -op.data.numel()):
      op = op.copy(data=op.data.to(device=device, dtype=dtype))
      into = next((i for i, g in enumerate(groups)
                   if set(op.dims) <= set(g.dims)), None)
      if into is None:
        groups.append(op)
      else:
        groups[into] = groups[into] * op
    forms[key] = groups
  return forms[key]


def _summed_after(x: DimArray, groups: Sequence[DimArray],
                  reduce: Sequence[str]) -> tuple[str, ...]:
  """The reduce dims of ``x`` that its contraction with ``groups`` keeps
  and sums afterwards.

  Against one operand over x's grid, ``torch.einsum`` would first sum x's
  reduce dims that the operand lacks (init_time), a pass over x, and then
  contract the whole grid as one long K against a few rows, which the BLAS
  splits. Kept, the dims before the grid become rows of the GEMM, and the
  grid's first reduce dim a batch of GEMMs over the rest of the grid; the
  sum over both then reads a result no larger than x, in a fixed order.
  """
  if len(groups) != 1:
    return ()
  (g,) = groups
  shared = [d for d in x.dims if d in g.dims]
  if not shared:
    return ()
  late = [d for d in x.dims[:x.dims.index(shared[0])] if d in reduce]
  grid = [d for d in shared if d in reduce]
  own = math.prod(n for d, n in g.sizes.items() if d not in x.dims)
  if len(grid) > 1 and math.prod(x.sizes[d] for d in grid[1:]) >= own:
    late.append(grid[0])
  return tuple(late)


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkShard:
  """One rank's slice of a chunk sharded over a device mesh.

  Attributes:
    slices: {dim: slice} of the dims this rank holds a part of.
    sizes: {dim: size} of those dims in the whole chunk.
    whole_coords: the whole chunk's host coords over those dims, by name.

  Weights, bin masks and sets are built from the WHOLE chunk's coords and
  then sliced: ``GridAreaWeighting`` normalises to the mean over the
  latitudes it is given, and a region or land mask aligns by label, so
  operands built from a rank's slice of the coords would differ from the
  matching slice of the whole chunk's.
  """

  slices: Mapping[str, slice]
  sizes: Mapping[str, int]
  whole_coords: Mapping[str, Coord]

  @property
  def key(self) -> tuple:
    return tuple(sorted((d, s.start, s.stop) for d, s in self.slices.items()))

  def only(self, dims: Collection[str]) -> 'ChunkShard | None':
    """This shard restricted to ``dims`` (None if it slices none of them)."""
    keep = [d for d in self.slices if d in dims]
    if not keep:
      return None
    return ChunkShard({d: self.slices[d] for d in keep},
                      {d: self.sizes[d] for d in keep}, self.whole_coords)

  def take(self, da: DimArray) -> DimArray:
    """``da``'s part of this rank along the sharded dims it has."""
    sl = {d: s for d, s in self.slices.items() if d in da.dims}
    return da.isel(sl) if sl else da

  def whole(self, stat: DimArray) -> DimArray:
    """A stand-in for ``stat`` at the whole chunk's sizes and host coords
    along the sharded dims. Its data is one element broadcast, so it is
    good for building operands only, which read dims, sizes, dtype and
    coords."""
    if not any(d in self.slices for d in stat.dims):
      return stat
    sizes = {**stat.sizes, **{d: n for d, n in self.sizes.items()
                              if d in stat.dims}}
    shape = tuple(sizes[d] for d in stat.dims)
    coords = {}
    for name, c in stat.coords.items():
      if not set(c.dims) & set(self.slices):
        coords[name] = c
      elif not c.is_host:
        coords[name] = Coord(c.dims, c.values.new_zeros(()).expand(
            tuple(sizes[d] for d in c.dims)))
      elif name in self.whole_coords and self.whole_coords[name].dims == c.dims:
        coords[name] = self.whole_coords[name]
      else:
        raise ValueError(
            f'coord {name!r} over the sharded dims of a statistic has no '
            'whole-chunk counterpart to build its aggregation operands from')
    return DimArray(stat.data.new_zeros(()).expand(shape), stat.dims, coords)


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
    return self._contract(stat, stat, operands)

  def _contract(self, x: DimArray, stat: DimArray,
                operands: Sequence[DimArray]) -> DimArray:
    """``darray.dot(x.broadcast_like(stat), *operands)`` over the reduce
    dims, for an ``x`` whose dims lie within ``stat``'s, without the
    broadcast: ``x`` contracted at its own dims with the operands'
    contraction form, times the sizes of the reduce dims that neither
    spans, spread over the kept dims that x lacks. Dims, coords and dtype
    are those of the contraction of ``stat`` itself."""
    reduce_dims = set(self.reduce_dims)
    reduce = tuple(d for d in stat.dims if d in reduce_dims)
    dtype = functools.reduce(torch.promote_types, [stat.dtype] + [
        op.dtype for op in operands if op.dtype != torch.bool])
    if dtype == torch.bool:  # bool sums would be logical, as in darray.dot
      dtype = torch.float32
    device = next((t.device for t in [stat.data, x.data]
                   + [op.data for op in operands]
                   if t.device.type != 'cpu'), torch.device('cpu'))
    groups = _contraction_form(operands, dtype, device)
    if x.dtype != dtype:
      x = x.astype(dtype)
    spanned = set(x.dims).union(*[g.dims for g in groups])
    late = _summed_after(x, groups, reduce)
    out = darray.dot(x, *groups, dim=tuple(
        d for d in reduce if d in spanned and d not in late))
    if late:
      out = out.sum(late)
    out_dims = tuple(d for d in darray.broadcast_dims(
        stat.dims, *[op.dims for op in operands]) if d not in reduce)
    sizes = {d: n for op in operands for d, n in op.sizes.items()}
    sizes.update(stat.sizes)
    shape = tuple(sizes[d] for d in out_dims)
    count = math.prod(stat.sizes[d] for d in reduce if d not in spanned)
    data = darray._expand_to(out.data, out.dims, out_dims)
    if count != 1 or data.shape != shape:
      data = data.expand(shape) * count
    return DimArray(data, out_dims, darray._merge_coords(
        out_dims, stat.coords, *[op.coords for op in operands]))

  def _promote(self, stat: DimArray) -> DimArray:
    # A bool statistic would sum to a count in the contraction but must
    # aggregate to a weighted mean: promote it first (xr.dot promotes too).
    return stat.astype(torch.float32) if stat.dtype == torch.bool else stat

  def _prepare_masked(self, stat: DimArray
                      ) -> tuple[DimArray, DimArray | None]:
    """masked/skipna prep: (zeroed statistic, weights-indicator mask).

    The mask keeps its own dims (the validity mask's) unless skipna makes
    it read the statistic's values; None where nothing is masked.
    """
    if self.masked and stat.has_coord('mask'):
      c = stat.coords['mask']
      if not set(c.dims).issubset(stat.dims):
        raise ValueError(f'mask dims {c.dims} are not all dims of the '
                         f'statistic {stat.dims}')
      mask = DimArray(c.values, c.dims)
      if self.skipna:
        mask = stat.notnull() & mask
      # Zero the masked values in the stat (avoids NaN*0 -> NaN).
      stat = stat.where(mask, 0)
      mask = mask.copy(data=mask.data.expand(
          tuple(stat.sizes[d] for d in mask.dims)))
    elif self.skipna:
      mask = stat.notnull()
      stat = stat.where(mask, 0)
    else:
      mask = None
    return stat, mask

  def _indicator(self, mask: DimArray | None, stat: DimArray,
                 operands: Sequence[DimArray]) -> DimArray:
    """The weights' indicator: ``mask`` contracted as ``stat`` is.

    Where nothing is masked (``mask`` None) it is the operands' own sum
    over the reduce dims, spread over ``stat``'s kept dims: it reads
    ``stat``'s dims, shape, dtype and device alone, so a
    ``LayoutOperands`` keeps it once for each of them, and the
    statistics of a layout share one contraction, in every chunk. The
    coords are the statistic's, as ``_contract`` merges them.
    """
    if mask is not None:
      return self._contract(mask, stat, operands)
    ones = DimArray(torch.ones((), dtype=stat.dtype, device=stat.device))
    kept = getattr(operands, 'indicators', None)
    if kept is None:
      return self._contract(ones, stat, operands)
    key = (stat.dims, stat.shape, stat.dtype, stat.device)
    if key not in kept:
      kept[key] = self._contract(ones, stat, operands)
    out = kept[key]
    return DimArray(out.data, out.dims, darray._merge_coords(
        out.dims, stat.coords, *[op.coords for op in operands]))

  def aggregate_stat_var(self, stat: DimArray,
                         operands=_UNSET) -> AggregationState | None:
    """Aggregates one statistic DimArray of one variable; None for a
    variable that must be dropped."""
    stat = self._promote(stat)
    if operands is _UNSET:
      operands = self.aggregation_operands(stat)
    if operands is None or not set(self.reduce_dims).issubset(stat.dims):
      return None
    stat, mask = self._prepare_masked(stat)
    INDICATOR_FORMS['broadcast' if self.skipna else 'mask_dims'] += 1
    return AggregationState(self._contract(stat, stat, operands),
                            self._indicator(mask, stat, operands))

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
      shard: ChunkShard | None = None,
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

    With a ``shard`` (statistics of one rank's slice of a chunk sharded
    over a mesh), each layout's operands are built from the whole chunk's
    coords (``ChunkShard.whole``) and then sliced to the rank's part; the
    slice is part of the cache key.
    """
    cache = {} if layout_cache is None else layout_cache
    out: dict = {}
    for name, per_var in statistics.items():
      out[name] = {}
      for var, stat in per_var.items():
        if stat is None:
          continue
        stat = self._promote(stat)
        if shard is not None:
          stat = shard.whole(stat)
        key = self.layout_key(stat)
        if shard is not None:
          key = (key, shard.key)
        if key not in cache:
          ops = self.aggregation_operands(stat)
          if ops is not None and shard is not None:
            ops = [shard.take(op) for op in ops]
          if ops is not None and device is not None:
            ops = [op.copy(data=op.data.to(device)) for op in ops]
          cache[key] = None if ops is None else LayoutOperands(ops)
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
