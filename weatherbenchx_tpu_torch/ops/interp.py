"""Gather-based rectilinear interpolation.

The port of ``weatherbenchx_tpu/ops/interp.py``: fractional indices are
computed on the host (numpy) from monotonic source coords, and the
(multi)linear combination is a handful of ``index_select`` gathers and
lerps on the data's own device. Loader chunks are CPU tensors, so
grid→station interpolation inside a loader runs on the host; a tensor on
the card is interpolated on the card. No kernel of its own: the JAX
package's version is jnp, not Pallas.

Two indexing modes, matching xarray semantics:

* outer: each target axis is an independent 1-D coordinate array → the
  result has one axis per interpolated dim (regridding);
* pointwise: all target arrays share the same dims (e.g. ('index',)) → the
  interpolated dims collapse into those dims (grid → sparse stations).

Weights take the gathered data's dtype (float32 for non-floating data,
whose product then promotes as numpy's would) and the corners are summed
in the JAX package's order, so float32 results agree with its bit for bit.
"""

from typing import Mapping, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import as_tensor, torch_dtype


def fractional_indices(
    source: np.ndarray,
    targets: np.ndarray,
    extrapolate: bool,
) -> tuple[np.ndarray, np.ndarray]:
  """(lower index, fraction) of targets within a monotonic 1-D source grid.

  With extrapolate=True the fraction is unclamped (linear extrapolation,
  matching scipy fill_value='extrapolate'); otherwise out-of-bounds
  fractions are marked NaN.
  """
  source = np.asarray(source)
  targets = np.asarray(targets)
  descending = source.size > 1 and source[0] > source[-1]
  s = source[::-1] if descending else source
  if s.size == 0:
    raise ValueError('Cannot interpolate along an empty dim.')
  if s.size > 1 and not np.all(np.diff(s) > 0):
    # searchsorted on a non-monotonic grid returns meaningless indices (and
    # duplicate values divide by zero): fail loudly instead of silently
    # corrupting every interpolated value. Callers sort first (CropToBox
    # does; wrap-around-unsorted longitudes are the typical culprit).
    raise ValueError(
        'Interpolation source coordinate must be strictly monotonic.')
  if s.size == 1:
    # Degenerate single-point grid (e.g. chunked init/lead dims of size 1
    # interpolated pointwise with method='nearest'): everything maps to it.
    idx = np.zeros(targets.shape, dtype=np.int32)
    frac = np.zeros(targets.shape, dtype=np.float64)
    if not extrapolate:
      frac = np.where(targets == s[0], frac, np.nan)
    return idx, frac
  idx = np.searchsorted(s, targets, side='right') - 1
  idx = np.clip(idx, 0, s.size - 2)
  frac = (targets - s[idx]) / (s[idx + 1] - s[idx])
  if not extrapolate:
    oob = (targets < s[0]) | (targets > s[-1])
    frac = np.where(oob, np.nan, frac)
  if descending:
    idx = source.size - 2 - idx
    frac = 1.0 - frac
  return idx.astype(np.int32), frac.astype(np.float64)


def _index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(device)


def _lerp_operands(gathered: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.dtype]:
  """(data to weight, weight dtype): floating data keeps its dtype and its
  weights take it; other data is weighted in float32 and promotes to
  numpy's result type of (its dtype, float32), as the JAX package's host
  path (numpy) computes it."""
  if gathered.is_floating_point():
    return gathered, gathered.dtype
  np_dtype = torch.empty(0, dtype=gathered.dtype).numpy().dtype
  return (gathered.to(torch_dtype(np.result_type(np_dtype, np.float32))),
          torch.float32)


def _nan_where(out: torch.Tensor, nan_mask: np.ndarray,
               shape: Sequence[int]) -> torch.Tensor:
  """NaN at ``nan_mask`` (reshaped to broadcast against ``out``); non-
  floating data becomes float64 there, as numpy's ``where`` makes it."""
  if not out.is_floating_point():
    out = out.to(torch.float64)
  mask = torch.from_numpy(np.ascontiguousarray(nan_mask).reshape(shape))
  return torch.where(mask.to(out.device), torch.nan, out)


def interp_1d_along_axis(
    data: torch.Tensor,
    axis: int,
    idx: np.ndarray,
    frac: np.ndarray,
    method: str,
) -> torch.Tensor:
  """Linear/nearest interp along one axis at (idx, frac) positions."""
  n = data.shape[axis]
  if method == 'nearest':
    take = np.minimum(np.where(frac > 0.5, idx + 1, idx), n - 1)
    out = data.index_select(axis, _index(take, data.device))
    nan_mask = np.isnan(frac)
    if nan_mask.any():
      shape = [1] * out.dim()
      shape[axis] = nan_mask.size
      out = _nan_where(out, nan_mask, shape)
    return out
  if method != 'linear':
    raise ValueError(f'Unsupported interpolation method: {method}')
  lo = data.index_select(axis, _index(idx, data.device))
  hi = data.index_select(axis, _index(np.minimum(idx + 1, n - 1),
                                      data.device))
  lo, wdtype = _lerp_operands(lo)
  hi, _ = _lerp_operands(hi)
  shape = [1] * lo.dim()
  shape[axis] = frac.size
  f = torch.from_numpy(np.ascontiguousarray(frac)).to(
      lo.device, wdtype).reshape(shape)
  return lo * (1 - f) + hi * f


def interp_outer(
    data: torch.Tensor,
    dims: Sequence[str],
    dim_targets: Mapping[str, np.ndarray],
    source_coords: Mapping[str, np.ndarray],
    method: str,
    extrapolate: bool,
) -> torch.Tensor:
  """Separable interpolation: each dim to its own 1-D target coords."""
  out = as_tensor(data)
  for d, targets in dim_targets.items():
    ax = list(dims).index(d)
    idx, frac = fractional_indices(
        np.asarray(source_coords[d]), np.asarray(targets), extrapolate)
    out = interp_1d_along_axis(out, ax, idx, frac, method)
  return out


def interp_pointwise(
    data: torch.Tensor,
    dims: Sequence[str],
    dim_targets: Mapping[str, np.ndarray],
    source_coords: Mapping[str, np.ndarray],
    method: str,
    extrapolate: bool,
) -> torch.Tensor:
  """Joint pointwise interpolation: all targets share one flat point axis.

  The interpolated dims are moved last and replaced by a single point axis
  of the targets' common shape; the multilinear combination sums the 2^k
  corner gathers (k = number of interpolated dims, typically 2).
  """
  if method not in ('nearest', 'linear'):
    # Nearest and (multi)linear only; anything else (e.g. the reference's
    # scipy 'cubic') must fail loudly rather than silently lerping.
    raise ValueError(f'Unsupported interpolation method: {method}')
  interp_dims = list(dim_targets.keys())
  k = len(interp_dims)
  other_dims = [d for d in dims if d not in interp_dims]
  order = [list(dims).index(d) for d in other_dims + interp_dims]
  arr = as_tensor(data).permute(order)
  grid_shape = tuple(arr.shape[-k:])
  arr_flat = arr.reshape(tuple(arr.shape[:-k]) + (-1,))

  idx_list, frac_list = [], []
  point_shape = None
  for d in interp_dims:
    t = np.asarray(dim_targets[d]).reshape(-1)
    point_shape = np.asarray(dim_targets[d]).shape
    idx, frac = fractional_indices(
        np.asarray(source_coords[d]), t, extrapolate)
    idx_list.append(idx)
    frac_list.append(frac)

  strides = np.cumprod([1] + list(grid_shape[::-1][:-1]))[::-1]

  if method == 'nearest':
    flat_idx = np.zeros_like(idx_list[0], dtype=np.int64)
    nan_mask = np.zeros_like(frac_list[0], dtype=bool)
    for idx, frac, stride, size in zip(idx_list, frac_list, strides,
                                       grid_shape):
      nearest = np.minimum(
          np.where(np.nan_to_num(frac) > 0.5, idx + 1, idx), size - 1)
      flat_idx += nearest * int(stride)
      nan_mask |= np.isnan(frac)
    out = arr_flat.index_select(-1, _index(flat_idx, arr.device))
    if nan_mask.any():
      out = _nan_where(out, nan_mask, nan_mask.shape)
  else:
    out = 0.0
    for corner in range(2 ** k):
      flat_idx = np.zeros_like(idx_list[0], dtype=np.int64)
      weight = np.ones_like(frac_list[0])
      for j, (idx, frac, stride) in enumerate(
          zip(idx_list, frac_list, strides)):
        bit = (corner >> j) & 1
        # Clamp the upper corner on degenerate (size-1) axes: its weight is
        # zero there, and index_select raises out of bounds.
        flat_idx += np.minimum(idx + bit, grid_shape[j] - 1) * int(stride)
        weight = weight * (frac if bit else (1.0 - frac))
      gathered, wdtype = _lerp_operands(
          arr_flat.index_select(-1, _index(flat_idx, arr.device)))
      out = out + gathered * torch.from_numpy(weight).to(arr.device, wdtype)

  return out.reshape(tuple(arr.shape[:-k]) + tuple(point_shape))
