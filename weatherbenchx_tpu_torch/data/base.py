"""Base data loader.

The port of ``weatherbenchx_tpu/data/base.py``. Loaders return chunks as
``dict[var, DimArray]`` with canonical dims
(init_time/lead_time/valid_time/latitude/longitude[/number], or ``index``
for sparse observations) on the HOST: CPU tensors and numpy coords. The
pipeline moves them to its device. The load pipeline per chunk, in the JAX
package's order: source load → process_chunk_fn → interpolation against a
reference chunk → compute → optional NaN mask coord → optional padding of
the sparse ``index`` dim → optional values-as-coord. For a store opened
lazily the compute step is the per-chunk windowed read: only the chunk's
selection comes off disk.
"""

import abc
from typing import Callable, Collection, Hashable, Mapping, Optional, Union

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import Coord, DimArray


def add_nan_mask_to_data(
    data: Mapping[Hashable, DimArray],
    variable_subset: Collection[str] | None = None,
) -> dict[Hashable, DimArray]:
  """Adds a boolean host 'mask' coord to each variable, False at NaNs.

  Preferred over skipna so unexpected NaNs still propagate loudly.
  """
  out = dict(data)
  for var in out:
    if variable_subset is None or var in variable_subset:
      da = out[var]
      out[var] = da.assign_coords(
          mask=Coord(da.dims, ~np.isnan(da.values)))
  return out


def _pad_with_first(v, ax: int, pad: int, target: int):
  """``v`` (numpy or tensor) extended along ``ax`` by ``pad`` copies of its
  first slice there; zeros of ``target`` length when it is empty."""
  if isinstance(v, torch.Tensor):
    if not v.numel():
      return v.new_zeros(v.shape[:ax] + (target,) + v.shape[ax + 1:])
    first = v.narrow(ax, 0, 1)
    return torch.cat([v, first.expand(v.shape[:ax] + (pad,)
                                      + v.shape[ax + 1:])], dim=ax)
  if v.dtype.kind in 'US':
    return np.pad(v, [(0, pad if i == ax else 0) for i in range(v.ndim)],
                  constant_values='')
  if not v.size:
    return np.zeros(v.shape[:ax] + (target,) + v.shape[ax + 1:], v.dtype)
  first = v.take([0], axis=ax)
  return np.concatenate(
      [v, np.broadcast_to(first, v.shape[:ax] + (pad,) + v.shape[ax + 1:])],
      axis=ax)


def _pad_constant(v, ax: int, pad: int, value):
  """``v`` (numpy or tensor) extended along ``ax`` by ``pad`` entries of
  ``value``."""
  if isinstance(v, torch.Tensor):
    fill = torch.full(v.shape[:ax] + (pad,) + v.shape[ax + 1:], value,
                      dtype=v.dtype, device=v.device)
    return torch.cat([v, fill], dim=ax)
  return np.pad(v, [(0, pad if i == ax else 0) for i in range(v.ndim)],
                constant_values=value)


def pad_dim_to_multiple(
    data: Mapping[Hashable, DimArray],
    dim: str,
    multiple: int,
) -> dict[Hashable, DimArray]:
  """Pads a ragged dim up to a bucket size, masking padded entries.

  Sparse chunks have a variable-length ``index`` dim; padding it to the
  next multiple keeps a run's chunks at a few shapes, so the statistics'
  operands (weights, bin masks) are built for a few layouts. Padded
  positions get mask=False (use masked=True aggregation) and fill data of
  NaN for floats and 0 (False) for integer and bool data: dtypes are
  preserved, so exact-multiple and padded chunks of the same variable stay
  layout-identical and their states combine. Numeric and datetime coords
  are padded with their first value (weights and bins see valid values;
  the mask excludes them), string coords with ''.
  """
  out = {}
  for var, da in data.items():
    if dim not in da.dims:
      out[var] = da
      continue
    n = da.sizes[dim]
    target = max(-(-n // multiple) * multiple, multiple)
    pad = target - n
    ax = da.dims.index(dim)
    if pad == 0 and da.has_coord('mask'):
      out[var] = da
      continue
    d = da.data
    new_data = _pad_constant(d, ax, pad,
                             float('nan') if d.is_floating_point() else 0)
    coords = {}
    for name, c in da.coords.items():
      if dim in c.dims:
        v = c.values if isinstance(c.values, torch.Tensor) else np.asarray(
            c.values)
        coords[name] = Coord(c.dims,
                             _pad_with_first(v, c.dims.index(dim), pad,
                                             target))
      else:
        coords[name] = c
    # Extend (or create) the validity mask.
    if 'mask' in da.coords:
      m = da.coords['mask']
      mv = m.values if isinstance(m.values, torch.Tensor) else np.asarray(
          m.values)
      coords['mask'] = Coord(m.dims, _pad_constant(mv, m.dims.index(dim),
                                                   pad, False))
    else:
      mask = np.ones(tuple(new_data.shape), bool)
      sl = [slice(None)] * new_data.dim()
      sl[ax] = slice(n, None)
      mask[tuple(sl)] = False
      coords['mask'] = Coord(da.dims, mask)
    out[var] = DimArray(new_data, da.dims, coords)
  return out


class DataLoader(abc.ABC):
  """Base class for data loaders.

  Loaders return prediction/target chunks that broadcast against each
  other; when mapping one dataset onto another (e.g. grid → sparse points),
  the other chunk is passed as ``reference`` for interpolation.
  """

  def __init__(
      self,
      interpolation=None,
      compute: bool = True,
      add_nan_mask: bool = False,
      process_chunk_fn: Optional[Callable[
          [Mapping[Hashable, DimArray]], Mapping[Hashable, DimArray]]] = None,
      add_values_to_coords: bool = False,
      pad_index_multiple: Optional[int] = None,
  ):
    self._interpolation = interpolation
    self._compute = compute
    self._add_nan_mask = add_nan_mask
    self._process_chunk_fn = process_chunk_fn
    self._add_values_to_coords = add_values_to_coords
    self._pad_index_multiple = pad_index_multiple

  @abc.abstractmethod
  def _load_chunk_from_source(
      self,
      init_times: np.ndarray,
      lead_times: Optional[Union[np.ndarray, slice]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Loader-specific source read."""

  def load_chunk(
      self,
      init_times: np.ndarray,
      lead_times: Optional[Union[np.ndarray, slice]] = None,
      reference: Optional[Mapping[Hashable, DimArray]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Shared chunk-loading pipeline (reference ``base.py:111-163``)."""
    chunk = self._load_chunk_from_source(init_times, lead_times)
    if self._process_chunk_fn is not None:
      chunk = self._process_chunk_fn(chunk)
    if self._interpolation is not None:
      chunk = self._interpolation.interpolate(chunk, reference)
    if self._compute:
      # Lazy views are read here, the chunk's window alone (the reference's
      # per-chunk .compute(), data_loaders/base.py:146-153), into CPU
      # tensors; contiguous, so the device copy is one block per variable.
      chunk = {k: da.copy(data=da.data.contiguous())
               for k, da in chunk.items()}
    if self._add_nan_mask:
      chunk = add_nan_mask_to_data(chunk)
    if self._pad_index_multiple:
      # Bucket the ragged 'index' dim: padded rows carry NaN data and
      # mask=False, so this requires masked=True aggregation.
      chunk = pad_dim_to_multiple(chunk, 'index', self._pad_index_multiple)
    if self._add_values_to_coords:
      chunk = {k: da.assign_coords(values_as_coord=Coord(da.dims, da.values))
               for k, da in chunk.items()}
    return chunk
