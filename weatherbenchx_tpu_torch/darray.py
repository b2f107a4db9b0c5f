"""DimArray: a named-axis array over ``torch.Tensor`` data.

The PyTorch counterpart of ``weatherbenchx_tpu.darray``. Data is a
``torch.Tensor`` (numpy input becomes a CPU tensor) or, for a store opened
lazily, a ``lazy.LazyArray`` view on the host, as in the JAX package:
``isel``, ``sel`` and ``take`` compose on the view and read no more than
they select (``take`` reads the gathered rows), ``shape``, ``ndim`` and
``dtype`` come from the view, and everything else materialises it, once,
into a CPU tensor through ``data``. Coordinates are either
host numpy arrays (latitudes, datetimes, labels) or tensors (validity
masks that live beside the data on the device). Binary operations align
their operands by dimension NAME, xarray style, and put every operand on
the one non-CPU device any of them lives on.

The host-side coordinate machinery (``Coord``, ``broadcast_dims``,
``_merge_coords``, ``_check_shared_sizes``, ``_label_indices``) is copied
from the JAX package rather than imported: every module of that package
imports jax, which the port must not.

Every ``DimArray`` method and module function of the JAX package's
``darray`` has its counterpart here under the same name, apart from its
TPU routing (``dot_regime``) and its xarray and pytree glue. Where torch
differs from ``jnp`` the method says so: ``quantile`` sorts (``torch.quantile``
has refused large inputs), ``%`` is ``torch.remainder`` (the divisor's sign),
the NaN-skipping ``std``/``var``/``min``/``max`` are built here.

A "dataset" is a ``dict[str, DimArray]``.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import lazy

# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _is_host_value(v: Any) -> bool:
  """True for host-side values: numpy arrays and Python/numpy scalars."""
  return isinstance(v, (np.ndarray, bool, int, float, str, bytes, np.generic))


def torch_dtype(dtype) -> torch.dtype:
  """The torch dtype for a torch or numpy dtype (or a numpy type)."""
  if isinstance(dtype, torch.dtype):
    return dtype
  return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def as_tensor(value: Any, device: torch.device | str | None = None
              ) -> torch.Tensor:
  """``value`` as a tensor; numpy input is copied only where it must be."""
  if isinstance(value, torch.Tensor):
    return value if device is None else value.to(device)
  arr = np.asarray(value)
  if arr.dtype.kind in 'OUSMm':
    raise TypeError(f'DimArray data cannot hold dtype {arr.dtype}')
  if not arr.dtype.isnative:  # e.g. a big-endian zarr v3 store
    arr = arr.astype(arr.dtype.newbyteorder('='))
  if not (arr.flags.c_contiguous and arr.flags.writeable):
    # Reversed views (torch takes no negative strides) and read-only
    # buffers (e.g. bytes a reader decoded in place), which a tensor
    # must not share.
    arr = arr.copy()
  return torch.as_tensor(arr, device=device)


def _on_one_device(*tensors: torch.Tensor) -> list[torch.Tensor]:
  """Moves CPU tensors to the device of the first non-CPU tensor, if any."""
  dev = next((t.device for t in tensors if t.device.type != 'cpu'), None)
  if dev is None:
    return list(tensors)
  return [t if t.device == dev else t.to(dev) for t in tensors]


@dataclasses.dataclass(frozen=True)
class Coord:
  """A coordinate: values laid out along a (possibly empty) dims tuple.

  ``values`` is a numpy array (host coordinate) or a tensor (device
  coordinate). A dimension coordinate is a 1-D Coord named like its dim.
  """

  dims: tuple[str, ...]
  values: Any

  def __post_init__(self):
    if not isinstance(self.dims, tuple):
      object.__setattr__(self, 'dims', tuple(self.dims))

  @property
  def is_host(self) -> bool:
    return _is_host_value(self.values)

  def __repr__(self):
    v = self.values
    kind = 'host' if self.is_host else 'device'
    return (f'Coord(dims={self.dims}, shape={tuple(np.shape(v))}, '
            f'dtype={getattr(v, "dtype", type(v).__name__)}, {kind})')


def broadcast_dims(*dim_tuples: Sequence[str]) -> tuple[str, ...]:
  """Union of dims in order of first appearance (xarray broadcast order)."""
  out: list[str] = []
  for dims in dim_tuples:
    for d in dims:
      if d not in out:
        out.append(d)
  return tuple(out)


def _check_shared_sizes(*operands) -> None:
  """Raise a named-dim error when shared dims have incompatible extents.

  Each operand is a ``(dims, shape)`` pair. Size-1 extents broadcast
  against any size; two extents both >1 can never be reconciled.
  """
  sizes: dict[str, int] = {}
  for dims, shape in operands:
    for d, n in zip(dims, shape):
      prev = sizes.get(d)
      if prev is None or prev == 1:
        sizes[d] = n
      elif n != 1 and n != prev:
        raise ValueError(
            f'dimension {d!r} has mismatched sizes {prev} and {n}: '
            'named-axis broadcasting requires equal (or size-1) extents '
            'on shared dims')


def _expand_to(data: torch.Tensor, dims: tuple[str, ...],
               out_dims: tuple[str, ...]) -> torch.Tensor:
  """Permutes ``data`` into out_dims order, with size-1 axes for the rest."""
  if dims == out_dims:
    return data
  order = [dims.index(d) for d in out_dims if d in dims]
  if order != list(range(len(dims))):
    data = data.permute(order)
  return data[tuple(slice(None) if d in dims else None for d in out_dims)]


def _merge_coords(
    result_dims: tuple[str, ...],
    *coord_dicts: Mapping[str, Coord],
) -> dict[str, Coord]:
  """Merges coords of operands whose dims fit result_dims; first one wins."""
  out: dict[str, Coord] = {}
  for cd in coord_dicts:
    for name, coord in cd.items():
      if name not in out and set(coord.dims).issubset(result_dims):
        out[name] = coord
  return out


# ---------------------------------------------------------------------------
# DimArray
# ---------------------------------------------------------------------------


class DimArray:
  """Named-axis array over tensor (or lazy host) data with host or device
  coords."""

  __slots__ = ('_data', 'dims', 'coords')

  def __init__(
      self,
      data: Any,
      dims: Sequence[str] | str = (),
      coords: Mapping[str, Coord | tuple | Any] | None = None,
  ):
    if isinstance(dims, str):
      dims = (dims,)
    dims = tuple(dims)
    if not lazy.is_lazy(data):
      data = as_tensor(data)
    if len(data.shape) != len(dims):
      raise ValueError(
          f'data has {len(data.shape)} axes but dims={dims} has {len(dims)}')
    self._data = data
    self.dims = dims
    cdict: dict[str, Coord] = {}
    for name, c in (coords or {}).items():
      coord = _as_coord(name, c, dims)
      if coord.dims == (name,) and name in dims:
        n = data.shape[dims.index(name)]
        cn = np.shape(coord.values)[0] if np.ndim(coord.values) else 1
        if cn != n:
          raise ValueError(
              f'coordinate {name!r} has {cn} labels but dim {name!r} has '
              f'length {n}')
      cdict[name] = coord
    self.coords = cdict

  # -- basic properties -----------------------------------------------------

  @property
  def data(self) -> torch.Tensor:
    """The data as a tensor; a lazy view is read here, once, into a CPU
    tensor that the array keeps."""
    if lazy.is_lazy(self._data):
      self._data = as_tensor(self._data.read())
    return self._data

  @property
  def is_lazy(self) -> bool:
    return lazy.is_lazy(self._data)

  @property
  def shape(self) -> tuple[int, ...]:
    return tuple(self._data.shape)

  @property
  def ndim(self) -> int:
    return len(self.dims)

  @property
  def dtype(self) -> torch.dtype:
    return (torch_dtype(self._data.dtype) if self.is_lazy
            else self._data.dtype)

  @property
  def device(self) -> torch.device:
    return torch.device('cpu') if self.is_lazy else self._data.device

  @property
  def sizes(self) -> dict[str, int]:
    return dict(zip(self.dims, self.shape))

  @property
  def size(self) -> int:
    return int(np.prod(self.shape)) if self.shape else 1

  @property
  def values(self) -> np.ndarray:
    """Host numpy copy of the data (bfloat16 widens to float32)."""
    d = self.data.detach().cpu()
    if d.dtype == torch.bfloat16:
      d = d.float()
    return d.numpy()

  def item(self):
    return self.data.item()

  def __repr__(self):
    lines = [f'DimArray {self.sizes} {self.dtype} on {self.device}']
    lines += [f'  {k}: {v}' for k, v in self.coords.items()]
    lines.append(repr(self._data))
    return '\n'.join(lines)

  def coord_values(self, name: str) -> np.ndarray:
    """Host numpy values of a coordinate."""
    v = self.coords[name].values
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else (
        np.asarray(v))

  def has_coord(self, name: str) -> bool:
    return name in self.coords

  # -- construction helpers ---------------------------------------------------

  def copy(self, data=None, coords=None) -> DimArray:
    return DimArray(self._data if data is None else data, self.dims,
                    self.coords if coords is None else coords)

  def assign_coords(self, **coords) -> DimArray:
    new = dict(self.coords)
    for name, c in coords.items():
      if c is None:
        new.pop(name, None)
      else:
        new[name] = _as_coord(name, c, self.dims)
    return DimArray(self._data, self.dims, new)

  def drop_coords(self, names) -> DimArray:
    if isinstance(names, str):
      names = [names]
    return DimArray(self._data, self.dims,
                    {k: v for k, v in self.coords.items() if k not in names})

  def rename(self, mapping: Mapping[str, str] | None = None, **kw
             ) -> DimArray:
    mapping = dict(mapping or {}, **kw)
    dims = tuple(mapping.get(d, d) for d in self.dims)
    coords = {
        mapping.get(name, name): Coord(
            tuple(mapping.get(d, d) for d in c.dims), c.values)
        for name, c in self.coords.items()}
    return DimArray(self._data, dims, coords)

  # -- dtype / NaN ------------------------------------------------------------

  def astype(self, dtype) -> DimArray:
    return self.copy(data=self.data.to(torch_dtype(dtype)))

  def isnull(self) -> DimArray:
    d = self.data
    if d.is_floating_point() or d.is_complex():
      return self.copy(data=torch.isnan(d))
    return self.copy(data=torch.zeros(d.shape, dtype=torch.bool,
                                      device=d.device))

  def notnull(self) -> DimArray:
    return self.copy(data=~self.isnull().data)

  def fillna(self, value) -> DimArray:
    d = self.data
    if not (d.is_floating_point() or d.is_complex()):
      return self
    return self.copy(data=torch.where(torch.isnan(d), value, d))

  def where(self, cond, other=float('nan')) -> DimArray:
    """Keep values where cond is True, else ``other`` (xarray semantics)."""
    cond_da = cond if isinstance(cond, DimArray) else DimArray(cond)
    if isinstance(other, DimArray):
      other_da = other
    else:
      other_t = as_tensor(other)
      if other_t.dim() == 0:
        # A scalar fill keeps floating data's dtype (a Python float is
        # float64); a float fill of bool or integer data (NaN into an
        # indicator) gives the default float dtype, as jnp's weak scalar
        # does without x64.
        if self.data.is_floating_point():
          other_t = other_t.to(self.dtype)
        elif other_t.is_floating_point():
          other_t = other_t.to(torch.get_default_dtype())
      other_da = DimArray(other_t)
    _check_shared_sizes((self.dims, self.shape),
                        (cond_da.dims, cond_da.shape),
                        (other_da.dims, other_da.shape))
    out_dims = broadcast_dims(self.dims, cond_da.dims, other_da.dims)
    x, c, o = _on_one_device(self.data, cond_da.data, other_da.data)
    data = torch.where(_expand_to(c, cond_da.dims, out_dims),
                       _expand_to(x, self.dims, out_dims),
                       _expand_to(o, other_da.dims, out_dims))
    return DimArray(data, out_dims,
                    _merge_coords(out_dims, self.coords, cond_da.coords))

  def clip(self, min=None, max=None) -> DimArray:
    if min is None and max is None:
      return self
    return self.copy(data=torch.clamp(self.data, min=min, max=max))

  # -- arithmetic -------------------------------------------------------------

  def _binary_op(self, other, op, reflexive=False) -> DimArray:
    if isinstance(other, DimArray):
      _check_shared_sizes((self.dims, self.shape), (other.dims, other.shape))
      out_dims = broadcast_dims(self.dims, other.dims)
      a, b = _on_one_device(self.data, other.data)
      a = _expand_to(a, self.dims, out_dims)
      b = _expand_to(b, other.dims, out_dims)
      data = op(b, a) if reflexive else op(a, b)
      return DimArray(data, out_dims,
                      _merge_coords(out_dims, self.coords, other.coords))
    if isinstance(other, (np.ndarray, np.generic, torch.Tensor)):
      other = as_tensor(other, self.data.device)
    a = self.data
    return DimArray(op(other, a) if reflexive else op(a, other), self.dims,
                    self.coords)

  def __add__(self, o): return self._binary_op(o, operator.add)
  def __radd__(self, o): return self._binary_op(o, operator.add, True)
  def __sub__(self, o): return self._binary_op(o, operator.sub)
  def __rsub__(self, o): return self._binary_op(o, operator.sub, True)
  def __mul__(self, o): return self._binary_op(o, operator.mul)
  def __rmul__(self, o): return self._binary_op(o, operator.mul, True)
  def __truediv__(self, o): return self._binary_op(o, operator.truediv)
  def __rtruediv__(self, o):
    if isinstance(o, (int, float, np.number)) and not isinstance(o, bool):
      # torch computes scalar / tensor as reciprocal(tensor) * scalar, two
      # roundings; numpy and XLA divide once. A 0-d tensor of the result
      # dtype divides correctly rounded and promotes like the scalar.
      dt = torch.result_type(self.data, o)
      o = torch.tensor(o, dtype=dt, device=self.device)
      return self.copy(data=torch.div(o, self.data))
    return self._binary_op(o, operator.truediv, True)
  def __pow__(self, o): return self._binary_op(o, operator.pow)
  # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod.
  def __mod__(self, o): return self._binary_op(o, _tensor_args(torch.remainder))
  def __gt__(self, o): return self._binary_op(o, operator.gt)
  def __ge__(self, o): return self._binary_op(o, operator.ge)
  def __lt__(self, o): return self._binary_op(o, operator.lt)
  def __le__(self, o): return self._binary_op(o, operator.le)
  def __eq__(self, o): return self._binary_op(o, operator.eq)  # type: ignore
  def __ne__(self, o): return self._binary_op(o, operator.ne)  # type: ignore
  def __and__(self, o): return self._binary_op(o, _tensor_args(torch.logical_and))
  def __rand__(self, o):
    return self._binary_op(o, _tensor_args(torch.logical_and), True)
  def __or__(self, o): return self._binary_op(o, _tensor_args(torch.logical_or))
  def __ror__(self, o):
    return self._binary_op(o, _tensor_args(torch.logical_or), True)
  def __xor__(self, o): return self._binary_op(o, _tensor_args(torch.logical_xor))

  def __neg__(self): return self.copy(data=-self.data)
  def __abs__(self): return self.copy(data=self.data.abs())
  def __invert__(self): return self.copy(data=torch.logical_not(self.data))

  __hash__ = None  # type: ignore

  # -- reductions ---------------------------------------------------------------

  def _reduce(self, fn: Callable, dim=None) -> DimArray:
    """``fn(data, axes)`` over named dims; ``axes`` is None for all dims."""
    dims = _norm_dims(dim, self.dims)
    if dim is not None and dim is not Ellipsis and not dims:
      # Reducing over an explicitly-empty dim list is a no-op (xarray).
      return self
    axes = tuple(self.dims.index(d) for d in dims)
    out_dims = tuple(d for d in self.dims if d not in dims)
    data = fn(self.data, axes if len(axes) < self.ndim else None)
    coords = {k: v for k, v in self.coords.items()
              if set(v.dims).issubset(out_dims)}
    return DimArray(data, out_dims, coords)

  def sum(self, dim=None, skipna=False) -> DimArray:
    f = torch.nansum if skipna else torch.sum
    return self._reduce(lambda x, ax: f(x, dim=ax), dim)

  def mean(self, dim=None, skipna=False) -> DimArray:
    f = torch.nanmean if skipna else torch.mean
    return self._reduce(lambda x, ax: f(x, dim=ax), dim)

  def var(self, dim=None, skipna=False, ddof=0) -> DimArray:
    def fn(x, ax):
      if not skipna:
        return torch.var(x, dim=ax, correction=ddof)
      # torch has no nanvar: the two-pass form over the non-NaN members,
      # NaN where fewer than ddof + 1 of them remain (as jnp.nanvar).
      ok = ~torch.isnan(x)
      n = ok.sum(dim=ax, keepdim=True)
      mean = torch.nansum(x, dim=ax, keepdim=True) / n
      sq = torch.where(ok, (x - mean) ** 2, 0).sum(dim=ax, keepdim=True)
      out = torch.where(n > ddof, sq / (n - ddof), torch.nan)
      return out.reshape(()) if ax is None else out.squeeze(ax)
    return self._reduce(fn, dim)

  def std(self, dim=None, skipna=False, ddof=0) -> DimArray:
    v = self.var(dim, skipna=skipna, ddof=ddof)
    return v if v is self else v.copy(data=torch.sqrt(v.data))

  def _extremum(self, dim, skipna: bool, largest: bool) -> DimArray:
    """min or max over dims. ``amin``/``amax`` take several dims and
    propagate NaN as ``jnp.min`` does; skipna skips NaN members and gives
    NaN only where every member is NaN (``jnp.nanmin``)."""
    reduce = torch.amax if largest else torch.amin

    def fn(x, ax):
      ax = () if ax is None else ax  # () reduces every dim
      if not (skipna and x.is_floating_point()):
        return reduce(x, dim=ax)
      nan = torch.isnan(x)
      fill = -torch.inf if largest else torch.inf
      out = reduce(torch.where(nan, fill, x), dim=ax)
      return torch.where(nan.all(dim=ax) if ax else nan.all(), torch.nan, out)
    return self._reduce(fn, dim)

  def min(self, dim=None, skipna=False) -> DimArray:
    return self._extremum(dim, skipna, largest=False)

  def max(self, dim=None, skipna=False) -> DimArray:
    return self._extremum(dim, skipna, largest=True)

  def any(self, dim=None) -> DimArray:
    return self._reduce(
        lambda x, ax: x.any() if ax is None else torch.any(x, dim=ax), dim)

  def all(self, dim=None) -> DimArray:
    return self._reduce(
        lambda x, ax: x.all() if ax is None else torch.all(x, dim=ax), dim)

  def count(self, dim=None) -> DimArray:
    """Count of non-NaN values over dims."""
    return self.notnull()._reduce(lambda x, ax: x.sum(dim=ax), dim)

  def cumsum(self, dim: str) -> DimArray:
    return self.copy(data=torch.cumsum(self.data, dim=self.dims.index(dim)))

  def quantile(self, q, dim: str, skipna: bool = False,
               quantile_dim: str = 'quantile') -> DimArray:
    """Quantiles along a dim (numpy's 'linear' interpolation, like xarray).

    By one ``torch.sort`` along the dim and an interpolation between the
    two neighbouring order statistics: ``torch.quantile`` has a history of
    refusing inputs past 16,777,216 elements, and a full-width ensemble
    has 207,653,760.
    The quantile axis comes first, as ``jnp.quantile`` puts it. ``q`` is
    taken as float64 and the result keeps the data's dtype. A NaN member
    gives NaN at its point; with skipna the quantile is over the non-NaN
    members of each point (torch sorts NaN last), NaN where there is none.
    """
    q_arr = np.atleast_1d(np.asarray(q, dtype=np.float64))
    ax = self.dims.index(dim)
    x = self.data
    if not x.is_floating_point():
      x = x.to(torch.get_default_dtype())
    s = torch.sort(x.movedim(ax, 0), dim=0).values
    n = s.shape[0]
    if skipna:
      count = (~torch.isnan(s)).sum(0, keepdim=True)  # (1, *rest)
      pos = (torch.as_tensor(q_arr, device=s.device).reshape(
          (-1,) + (1,) * (s.dim() - 1)) * (count - 1).clamp(min=0))
      low = pos.floor()
      high_weight = (pos - low).to(s.dtype)
      low = low.long()
      high = torch.minimum(low + 1, (count - 1).clamp(min=0))
      data = (torch.take_along_dim(s, low, 0) * (1 - high_weight)
              + torch.take_along_dim(s, high, 0) * high_weight)
      data = torch.where(count > 0, data, torch.nan)
    else:
      pos = q_arr * (n - 1)
      low = np.floor(pos)
      high_weight = torch.as_tensor(pos - low, device=s.device).to(
          s.dtype).reshape((-1,) + (1,) * (s.dim() - 1))
      low = torch.as_tensor(low.astype(np.int64), device=s.device)
      high = (low + 1).clamp(max=n - 1)
      data = (s.index_select(0, low) * (1 - high_weight)
              + s.index_select(0, high) * high_weight)
      data = torch.where(torch.isnan(s[-1]), torch.nan, data)
    out_dims = (quantile_dim,) + self.dims[:ax] + self.dims[ax + 1:]
    coords = {k: c for k, c in self.coords.items() if dim not in c.dims}
    coords[quantile_dim] = Coord((quantile_dim,), q_arr)
    return DimArray(data, out_dims, coords)

  def diff(self, dim: str, n: int = 1) -> DimArray:
    """n-th difference along a dim; coords keep the upper labels."""
    ax = self.dims.index(dim)
    coords = {}
    for k, c in self.coords.items():
      if dim in c.dims:
        sl = (slice(None),) * c.dims.index(dim) + (slice(n, None),)
        coords[k] = Coord(c.dims, c.values[sl])
      else:
        coords[k] = c
    return DimArray(torch.diff(self.data, n=n, dim=ax), self.dims, coords)

  def stack_to_new_dim(self, dims_to_stack: Sequence[str],
                       new_dim: str) -> DimArray:
    """Stacks dims into one new trailing range-valued dimension."""
    dims_to_stack = tuple(dims_to_stack)
    rest = [d for d in self.dims if d not in dims_to_stack]
    out = self.transpose(*(rest + list(dims_to_stack)))
    new_size = int(np.prod([self.sizes[d] for d in dims_to_stack]))
    data = out.data.reshape(tuple(self.sizes[d] for d in rest) + (new_size,))
    coords = {k: c for k, c in self.coords.items()
              if not (set(c.dims) & set(dims_to_stack))}
    coords[new_dim] = Coord((new_dim,), np.arange(new_size))
    return DimArray(data, tuple(rest) + (new_dim,), coords)

  # -- shape manipulation -------------------------------------------------------

  def transpose(self, *dims: str) -> DimArray:
    if not dims:
      dims = tuple(reversed(self.dims))
    if '...' in dims:
      named = [d for d in dims if d != '...']
      rest = [d for d in self.dims if d not in named]
      i = dims.index('...')
      dims = tuple(named[:i]) + tuple(rest) + tuple(named[i:])
    missing = [d for d in dims if d not in self.dims]
    if missing or len(dims) != len(self.dims):
      raise ValueError(
          f'transpose dims {dims} do not match array dims {self.dims}'
          + (f' (unknown: {missing})' if missing else ''))
    if tuple(dims) == self.dims:
      return self
    order = [self.dims.index(d) for d in dims]
    return DimArray(self.data.permute(order), dims, self.coords)

  def expand_dims(self, dim: str | Mapping[str, int], axis: int = 0
                  ) -> DimArray:
    """New leading-at-``axis`` dims; a size > 1 broadcasts (a view)."""
    if isinstance(dim, str):
      dim = {dim: 1}
    data = self.data
    dims = list(self.dims)
    for name, size in dim.items():
      data = data.unsqueeze(axis)
      if size != 1:
        data = data.expand(data.shape[:axis] + (size,)
                           + data.shape[axis + 1:])
      dims.insert(axis, name)
      axis += 1
    return DimArray(data, tuple(dims), self.coords)

  def squeeze(self, dim: str | None = None) -> DimArray:
    """Drops ``dim`` (or every size-1 dim) by ``isel`` at 0, so a coord
    laid out over it loses that dim too."""
    drop = ([d for d, s in self.sizes.items() if s == 1] if dim is None
            else [dim])
    out = self
    for d in drop:
      out = out.isel({d: 0})
    return out

  def broadcast_like(self, other: DimArray) -> DimArray:
    out_dims = broadcast_dims(other.dims, self.dims)
    sizes = {**self.sizes, **other.sizes}
    data = _expand_to(self.data, self.dims, out_dims).expand(
        tuple(sizes[d] for d in out_dims))
    return DimArray(data, out_dims,
                    _merge_coords(out_dims, self.coords, other.coords))

  # -- indexing -------------------------------------------------------------------

  def isel(self, indexers: Mapping[str, Any] | None = None, **kw
           ) -> DimArray:
    out = self
    for dim, idx in dict(indexers or {}, **kw).items():
      out = out._isel_one(dim, idx)
    return out

  def _isel_one(self, dim: str, idx) -> DimArray:
    ax = self.dims.index(dim)
    scalar = isinstance(idx, (int, np.integer))
    if scalar:
      idx = int(idx)
    elif isinstance(idx, slice) and (idx.step or 1) < 0:
      # torch slices step forward only
      idx = np.ascontiguousarray(np.arange(self.shape[ax])[idx])
    elif not isinstance(idx, slice):
      idx = np.ascontiguousarray(idx)  # torch takes no negative strides
    if self.is_lazy:  # composes on the view; reads nothing
      new_data = self._data[(slice(None),) * ax + (idx,)]
    else:
      t_idx = (torch.as_tensor(idx, device=self._data.device)
               if isinstance(idx, np.ndarray) else idx)
      new_data = self._data[(slice(None),) * ax + (t_idx,)]
    new_dims = self.dims[:ax] + self.dims[ax + 1:] if scalar else self.dims
    new_coords = {}
    for name, c in self.coords.items():
      if dim not in c.dims:
        new_coords[name] = c
        continue
      cax = c.dims.index(dim)
      ci = (torch.as_tensor(idx, device=c.values.device)
            if isinstance(c.values, torch.Tensor)
            and isinstance(idx, np.ndarray) else idx)
      cdims = (c.dims[:cax] + c.dims[cax + 1:]) if scalar else c.dims
      new_coords[name] = Coord(cdims, c.values[(slice(None),) * cax + (ci,)])
    return DimArray(new_data, new_dims, new_coords)

  def sel(self, indexers: Mapping[str, Any] | None = None,
          method: str | None = None, **kw) -> DimArray:
    """Label-based selection on host (numpy) dimension coordinates."""
    isel_idx = {}
    for dim, labels in dict(indexers or {}, **kw).items():
      coord = self.coord_values(dim)
      if isinstance(labels, slice):
        # Inclusive on both ends, in the coordinate's own order: on a
        # descending coordinate, start is the upper bound.
        descending = coord.size > 1 and coord[0] > coord[-1]
        mask = np.ones(coord.shape, bool)
        if labels.start is not None:
          mask &= (coord <= labels.start) if descending else (
              coord >= labels.start)
        if labels.stop is not None:
          mask &= (coord >= labels.stop) if descending else (
              coord <= labels.stop)
        isel_idx[dim] = np.nonzero(mask)[0]
      else:
        isel_idx[dim] = _label_indices(coord, labels, method)
    return self.isel(isel_idx)

  def take(self, dim: str, indices: np.ndarray, new_dims: Sequence[str]
           ) -> DimArray:
    """Vectorized gather: replace ``dim`` with ``new_dims`` of indices.shape.

    The named-array form of xarray's vectorized ``.sel`` with a
    multi-dimensional indexer (e.g. valid_time at every (init_time,
    lead_time) pair). Coords laid out along ``dim`` are gathered too and
    become coords over ``new_dims``.
    """
    idx = np.asarray(indices)
    new_dims = tuple(new_dims)
    if len(new_dims) != idx.ndim:
      raise ValueError(f'{new_dims=} does not match indices shape {idx.shape}')
    ax = self.dims.index(dim)
    flat = idx.reshape(-1).astype(np.int64)

    def gather(values, axis):
      if lazy.is_lazy(values):
        # The windowed read: only the gathered rows come off disk.
        out = as_tensor(values[(slice(None),) * axis + (flat,)].read())
      elif isinstance(values, torch.Tensor):
        out = values.index_select(axis, torch.as_tensor(flat,
                                                        device=values.device))
      else:
        out = np.take(np.asarray(values), flat, axis=axis)
      return out.reshape(tuple(values.shape[:axis]) + idx.shape
                         + tuple(values.shape[axis + 1:]))

    coords = {}
    for name, c in self.coords.items():
      if dim not in c.dims:
        coords[name] = c
        continue
      cax = c.dims.index(dim)
      coords[name] = Coord(c.dims[:cax] + new_dims + c.dims[cax + 1:],
                           gather(c.values, cax))
    return DimArray(gather(self._data, ax),
                    self.dims[:ax] + new_dims + self.dims[ax + 1:], coords)

  def sortby(self, name: str, ascending: bool = True) -> DimArray:
    """Reorders the dim of the 1-D host coord ``name`` by its values."""
    c = self.coords[name]
    if len(c.dims) != 1:
      raise ValueError('sortby requires a 1-D coordinate')
    order = np.argsort(self.coord_values(name), kind='stable')
    if not ascending:
      order = order[::-1]
    return self.isel({c.dims[0]: order})


def _tensor_args(fn):
  """``fn`` of two tensors as a binary op that also takes a Python scalar
  on either side (a scalar beside floating data takes the data's dtype)."""
  def op(a, b):
    def lift(v, like):
      dtype = (like.dtype if like.is_floating_point()
               and not isinstance(v, bool) else None)
      return torch.as_tensor(v, dtype=dtype, device=like.device)
    if not isinstance(a, torch.Tensor):
      a = lift(a, b)
    if not isinstance(b, torch.Tensor):
      b = lift(b, a)
    return fn(a, b)
  return op


def _as_coord(name: str, c, parent_dims: tuple[str, ...]) -> Coord:
  if isinstance(c, Coord):
    return c
  if isinstance(c, tuple) and len(c) == 2:
    dims, values = c
    if isinstance(dims, str):
      dims = (dims,)
    if (isinstance(dims, (tuple, list))
        and all(isinstance(d, str) for d in dims)
        and set(dims) <= set(parent_dims)):
      return Coord(tuple(dims), _coerce_coord_values(values))
    # Otherwise a 2-tuple of VALUES, e.g. {'animal': ('cat', 'dog')}.
  if isinstance(c, DimArray):
    return Coord(c.dims, c.data)
  values = _coerce_coord_values(c)
  ndim = np.ndim(values) if not isinstance(values, torch.Tensor) else (
      values.dim())
  if ndim == 0:
    return Coord((), values)
  if ndim == 1:
    return Coord((name,), values)
  raise ValueError(
      f'Cannot infer dims for >1-D coord {name!r}; pass (dims, values)')


def _coerce_coord_values(values):
  if isinstance(values, torch.Tensor):
    return values
  return np.asarray(values)


def _norm_dims(dim, all_dims: tuple[str, ...]) -> tuple[str, ...]:
  if dim is None or dim is Ellipsis:
    return all_dims
  if isinstance(dim, str):
    dim = (dim,)
  dims = tuple(dim)
  missing = [d for d in dims if d not in all_dims]
  if missing:
    raise ValueError(f'Dimensions {missing} not found in {all_dims}')
  return dims


def _label_indices(coord: np.ndarray, labels, method: str | None):
  labels_arr = np.asarray(labels)
  scalar = labels_arr.ndim == 0
  labels_arr = np.atleast_1d(labels_arr)
  if labels_arr.dtype.kind == 'M':
    labels_arr = labels_arr.astype(coord.dtype)
  if method is None:
    sorter = np.argsort(coord, kind='stable')
    pos = np.searchsorted(coord, labels_arr, sorter=sorter)
    pos = np.clip(pos, 0, len(coord) - 1)
    idx = sorter[pos]
    if not np.array_equal(coord[idx], labels_arr):
      bad = labels_arr[coord[idx] != labels_arr]
      raise KeyError(f'Labels not found in coordinate: {bad[:5]}')
  elif method == 'nearest':
    if coord.dtype.kind in 'Mm':
      c = coord.astype('int64').astype('float64')
      l = labels_arr.astype(coord.dtype).astype('int64').astype('float64')
    else:
      c, l = coord.astype('float64'), labels_arr.astype('float64')
    idx = np.abs(c[None, :] - l[:, None]).argmin(axis=1)
  elif method == 'ffill':
    sorter = np.argsort(coord, kind='stable')
    pos = np.searchsorted(coord[sorter], labels_arr, side='right') - 1
    if np.any(pos < 0):
      raise KeyError('Label before first coordinate value with method=ffill')
    idx = sorter[pos]
  else:
    raise ValueError(f'Unknown sel method: {method}')
  return int(idx[0]) if scalar else idx


# ---------------------------------------------------------------------------
# Module-level functions
# ---------------------------------------------------------------------------


def _unary(fn) -> Callable:
  def f(x):
    if isinstance(x, DimArray):
      return x.copy(data=fn(x.data))
    return fn(as_tensor(x))
  return f


sqrt = _unary(torch.sqrt)
exp = _unary(torch.exp)
log = _unary(torch.log)
log1p = _unary(torch.log1p)
abs_ = _unary(torch.abs)
# torch.sign(NaN) is 0; jnp.sign keeps the NaN.
sign = _unary(lambda x: torch.where(torch.isnan(x), x, torch.sign(x))
              if x.is_floating_point() else torch.sign(x))
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)


def where(cond: DimArray, x, y) -> DimArray:
  """Elementwise select with dim-name broadcasting (xr.where semantics)."""
  xd = x if isinstance(x, DimArray) else DimArray(as_tensor(x))
  return xd.where(cond, y)


def maximum(a: DimArray, b) -> DimArray:
  """Elementwise maximum; NaN propagates, as in ``jnp.maximum``."""
  return a._binary_op(b, _tensor_args(torch.maximum))


def minimum(a: DimArray, b) -> DimArray:
  """Elementwise minimum; NaN propagates, as in ``jnp.minimum``."""
  return a._binary_op(b, _tensor_args(torch.minimum))


def full_like(x: DimArray, fill, dtype=None) -> DimArray:
  return x.copy(data=torch.full(
      x.shape, fill, dtype=torch_dtype(dtype) if dtype is not None else x.dtype,
      device=x.device))


def ones_like(x: DimArray, dtype=None) -> DimArray:
  return full_like(x, 1, dtype)


def zeros_like(x: DimArray, dtype=None) -> DimArray:
  return full_like(x, 0, dtype)


def _concat_values(parts: Sequence[Any], axis: int):
  """Concatenated coord values: numpy while every part is a host value,
  else a tensor on the parts' device."""
  if all(_is_host_value(p) for p in parts):
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)
  return torch.cat(_on_one_device(*[as_tensor(p) for p in parts]), dim=axis)


def concat(arrays: Sequence[DimArray], dim: str) -> DimArray:
  """Concatenates along a (possibly new) named dimension.

  Parts are matched by dim name (transposed to the first part's order),
  as ``xr.concat`` does. A coord over ``dim`` is concatenated; a coord off
  ``dim`` that differs between the parts gains ``dim`` (xr.concat's
  ``coords='different'``), one that is the same in every part is kept once.
  """
  arrays = list(arrays)
  if dim not in arrays[0].dims:
    arrays = [a.expand_dims(dim) for a in arrays]
  order = arrays[0].dims
  arrays = [a.transpose(*order) for a in arrays]
  ax = order.index(dim)
  data = torch.cat(_on_one_device(*[a.data for a in arrays]), dim=ax)
  coords: dict[str, Coord] = {}
  for name, c in arrays[0].coords.items():
    parts = [a.coords.get(name) for a in arrays]
    if dim in c.dims:
      if all(p is not None for p in parts):
        coords[name] = Coord(c.dims, _concat_values(
            [p.values for p in parts], c.dims.index(dim)))
      continue
    if any(p is None for p in parts):
      coords[name] = c
      continue
    vals = [p.values for p in parts]
    if all(p.dims == c.dims for p in parts) and _coord_parts_identical(vals):
      coords[name] = c
      continue
    # Each part's coord covers all of that part's slices along dim.
    expand = (np.broadcast_to if all(_is_host_value(v) for v in vals)
              else lambda v, shape: as_tensor(v).expand(shape))
    coords[name] = Coord((dim,) + c.dims, _concat_values(
        [expand(v, (a.sizes[dim],) + tuple(np.shape(v)))
         for v, a in zip(vals, arrays)], 0))
  return DimArray(data, order, coords)


def _coord_parts_identical(vals: Sequence[Any]) -> bool:
  """Whether per-part coord values are certainly all the same: one object,
  or equal host values. Tensors are not compared (that would wait for the
  device): distinct tensor objects count as different."""
  first = vals[0]
  if all(v is first for v in vals):
    return True
  if not all(_is_host_value(v) for v in vals):
    return False
  first = np.asarray(first)
  for v in vals[1:]:
    v = np.asarray(v)
    if v.shape != first.shape or v.dtype != first.dtype:
      return False
    if not (np.array_equal(v, first)
            or (v.dtype.kind == 'f'
                and np.array_equal(v, first, equal_nan=True))):
      return False
  return True


def comparison_safe_threshold(thresholds: DimArray, data_dtype,
                              op: str) -> DimArray:
  """Rounds float64 comparison constants directionally to a data dtype.

  The port of ``weatherbenchx_tpu/darray.py:773-822``. Comparing float32
  data with a threshold rounded to nearest in float32 can TIE a data value
  that float64 puts strictly on one side, flipping an indicator statistic
  against the float64 comparison. For data x exact in ``data_dtype`` and a
  float64 threshold t, rounding t directionally keeps the float64 result:

  * ops ``<=`` and ``>``: the largest ``data_dtype`` value <= t;
  * ops ``<`` and ``>=``: the smallest ``data_dtype`` value >= t;

  after which the comparison may run at any precision. A host-side
  adjustment of the constants: a no-op for float64 or non-float data, and
  for thresholds off the CPU (data-dependent thresholds are computed at
  data precision on both sides, so ties there are shared, not skewed).
  """
  if op not in ('<=', '>', '<', '>='):
    raise ValueError(f'unsupported comparison op {op!r}')
  dt = torch_dtype(data_dtype)
  t = thresholds.data
  if not (t.device.type == 'cpu' and t.is_floating_point()
          and dt.is_floating_point and torch.finfo(dt).bits < 64):
    return thresholds
  t64 = t.double()
  t_near = t64.to(dt)
  if op in ('<=', '>'):
    step_to, off = -np.inf, t_near.double() > t64
  else:
    step_to, off = np.inf, t_near.double() < t64
  rounded = torch.where(
      off, torch.nextafter(t_near, torch.full_like(t_near, step_to)), t_near)
  return thresholds.copy(data=rounded)


def dot(*arrays: DimArray, dim: Sequence[str] | str) -> DimArray:
  """Named contraction: multiply all arrays and sum over ``dim``.

  The port of the JAX package's aggregation contraction, which there is
  XLA's einsum outside any Pallas kernel: here ``torch.einsum`` in full
  float32 (the package sets TF32 off at import). Operands move to the
  first non-CPU device among them. All-bool operands become float32 first
  (bool sums would be logical); mixed operands promote to one dtype,
  since ``torch.einsum`` takes a single dtype.
  """
  dims = (dim,) if isinstance(dim, str) else tuple(dim)
  all_dims = broadcast_dims(*[a.dims for a in arrays])
  out_dims = tuple(d for d in all_dims if d not in dims)
  operands = _on_one_device(*[a.data for a in arrays])
  floats = [op.dtype for op in operands if op.dtype != torch.bool]
  dtype = (functools.reduce(torch.promote_types, floats) if floats
           else torch.float32)
  operands = [op.to(dtype) for op in operands]
  letters = {d: chr(ord('a') + i) for i, d in enumerate(all_dims)}
  spec = ','.join(''.join(letters[d] for d in a.dims) for a in arrays)
  spec += '->' + ''.join(letters[d] for d in out_dims)
  data = torch.einsum(spec, *operands)
  return DimArray(data, out_dims,
                  _merge_coords(out_dims, *[a.coords for a in arrays]))


def dot_batched(stats: Sequence[DimArray], *operands: DimArray,
                dim: Sequence[str] | str) -> list[DimArray]:
  """Contracts several same-layout arrays against shared operands at once.

  The results of ``[dot(s, *operands, dim=dim) for s in stats]`` (the rows
  of a contraction are independent) from one contraction over the
  statistics stacked on a new leading axis.
  """
  stats = list(stats)
  if not stats:
    return []
  first = stats[0]
  for s in stats[1:]:
    if s.dims != first.dims or s.shape != first.shape:
      raise ValueError('dot_batched requires identical dims/shape: '
                       f'{s.dims}{s.shape} vs {first.dims}{first.shape}')
  if len(stats) == 1:
    return [dot(first, *operands, dim=dim)]
  batch_dim = '__stack__'
  if batch_dim in first.dims:
    raise ValueError(f'{batch_dim!r} is reserved for the stacking axis')
  stacked = DimArray(
      torch.stack(_on_one_device(*[s.data for s in stats])),
      (batch_dim,) + first.dims,
      {k: c for k, c in first.coords.items()
       if set(c.dims).issubset(first.dims)})
  outb = dot(stacked, *operands, dim=dim)
  ax = outb.dims.index(batch_dim)
  out_dims = tuple(d for d in outb.dims if d != batch_dim)
  # Each entry's own coords are merged as dot() would merge them.
  return [DimArray(outb.data.select(ax, i), out_dims,
                   _merge_coords(out_dims, s.coords,
                                 *[a.coords for a in operands]))
          for i, s in enumerate(stats)]


def apply_ufunc(
    fn: Callable,
    *arrays: DimArray,
    input_core_dims: Sequence[Sequence[str]] | None = None,
    output_core_dims: Sequence[Sequence[str]] = ((),),
) -> DimArray:
  """Applies a raw-tensor function over broadcast dims with core dims last.

  A minimal ``xr.apply_ufunc(..., vectorize=False)``: inputs are transposed
  so that their core dims are the trailing axes, batch dims are broadcast
  by name, and ``fn`` maps core-dim tensors to a core-dim tensor. One
  output only.
  """
  input_core_dims = input_core_dims or [()] * len(arrays)
  batch_dims = broadcast_dims(*[
      tuple(d for d in a.dims if d not in set(icd))
      for a, icd in zip(arrays, input_core_dims)])
  sizes: dict[str, int] = {}
  for a in arrays:
    sizes.update(a.sizes)
  bshape = tuple(sizes[d] for d in batch_dims)
  ops = []
  for a, data, icd in zip(arrays, _on_one_device(*[a.data for a in arrays]),
                          input_core_dims):
    d = _expand_to(data, a.dims, tuple(batch_dims) + tuple(icd))
    ops.append(d.expand(bshape + tuple(d.shape[len(batch_dims):])))
  out_dims = tuple(batch_dims) + tuple(output_core_dims[0])
  return DimArray(fn(*ops), out_dims,
                  _merge_coords(out_dims, *[a.coords for a in arrays]))
