"""Interpolation / regridding, applied inside loaders before compute.

The port of ``weatherbenchx_tpu/interpolations.py``. The interpolation
itself is the gathers and lerps of ``ops/interp.py`` on the data's device
(loader chunks are CPU tensors, so in a loader it runs on the host);
longitude wrap is a one-cell pad on each side.
"""

import abc
import dataclasses
from typing import Hashable, Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import spatial
from weatherbenchx_tpu_torch.metrics import wrappers
from weatherbenchx_tpu_torch.ops import interp as interp_ops


class Interpolation(abc.ABC):
  """Interpolation base class."""

  @abc.abstractmethod
  def interpolate_data_array(
      self,
      da: DimArray,
      reference: Optional[DimArray] = None,
  ) -> DimArray:
    """Interpolation for a single variable."""

  def _interpolate_named(self, da: DimArray,
                         reference: Optional[DimArray],
                         name: Hashable) -> DimArray:
    """Per-variable hook carrying the variable name.

    The default ignores the name; name-sensitive interpolations
    (GridToSparseWithAltitudeAdjustment keys its temperature and wind
    adjustments off it) override THIS rather than ``interpolate``, so the
    name survives every call path, composition through
    MultipleInterpolation included.
    """
    return self.interpolate_data_array(da, reference)

  def interpolate(
      self,
      ds: Mapping[Hashable, DimArray],
      reference: Optional[Mapping[Hashable, DimArray]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Interpolates a dataset, optionally against a reference dataset."""
    return {
        k: self._interpolate_named(
            v, None if reference is None else reference[k], k)
        for k, v in dict(ds).items()
    }


class MultipleInterpolation(Interpolation):
  """Applies several interpolations in sequence."""

  def __init__(self, interpolations: Sequence[Interpolation]):
    self.interpolations = interpolations

  def interpolate_data_array(self, da, reference=None):
    for interpolation in self.interpolations:
      da = interpolation.interpolate_data_array(da, reference)
    return da

  def _interpolate_named(self, da, reference, name):
    for interpolation in self.interpolations:
      da = interpolation._interpolate_named(da, reference, name)
    return da


@dataclasses.dataclass(frozen=True)
class _Targets:
  """Pointwise target coordinates laid out over ``dims``, with the coords
  that ride along: a reference chunk's coordinate as ``interpolate_to_
  coords`` takes it. Not a DimArray, because a reference's init and lead
  times (datetime64, timedelta64) are targets too, and a DimArray's data
  is a tensor."""

  values: np.ndarray
  dims: tuple
  coords: Mapping[str, Coord]


def pad_longitude(da: DimArray) -> DimArray:
  """Pads one wrapped cell on each side of longitude for wrap interp."""
  left = da.isel(longitude=[-1])
  lv = left.coord_values('longitude') - 360
  left = left.assign_coords(longitude=Coord(('longitude',), lv))
  right = da.isel(longitude=[0])
  rv = right.coord_values('longitude') + 360
  right = right.assign_coords(longitude=Coord(('longitude',), rv))
  return darray.concat([left, da, right], 'longitude')


def interpolate_to_coords(
    da: DimArray,
    dim_args: Mapping[str, Union[DimArray, np.ndarray]],
    method: str,
    extrapolate_out_of_bounds: bool = True,
) -> DimArray:
  """Interpolate to target coordinates (outer or pointwise mode).

  Pointwise mode (all targets are DimArrays sharing the same non-trivial
  dims, e.g. ('index',)) collapses the interpolated dims into the targets'
  dims and carries the targets' coords into the result, as xarray's
  vectorized ``interp`` does for grid→sparse matching. Numeric and boolean
  non-dim coords of ``da`` over interpolated dims are interpolated
  alongside the data (e.g. grid_elevation); host coords stay host.
  """
  dim_args = dict(dim_args)
  interp_dims = list(dim_args.keys())
  source_coords = {d: da.coord_values(d) for d in interp_dims}

  pointwise = False
  target_dims: tuple = ()
  if all(isinstance(v, (DimArray, _Targets)) for v in dim_args.values()):
    tdims = {v.dims for v in dim_args.values()}
    if len(tdims) == 1:
      target_dims = next(iter(tdims))
      pointwise = not (len(interp_dims) == len(target_dims)
                       and set(target_dims) == set(interp_dims))

  def target_values(v):
    return (v.values if isinstance(v, (DimArray, _Targets))
            else np.asarray(v))

  def interp_array(values: torch.Tensor, dims: tuple) -> tuple:
    """Returns (data, out_dims)."""
    present = [d for d in interp_dims if d in dims]
    if not present:
      return values, dims
    targets = {d: target_values(dim_args[d]) for d in present}
    if pointwise:
      out = interp_ops.interp_pointwise(
          values, dims, targets, source_coords, method,
          extrapolate_out_of_bounds)
      out_dims = tuple(d for d in dims if d not in present) + target_dims
    else:
      out = interp_ops.interp_outer(
          values, dims, targets, source_coords, method,
          extrapolate_out_of_bounds)
      out_dims = dims
    return out, out_dims

  # ``da.data`` reads a lazy store-backed view once, into a CPU tensor.
  data, out_dims = interp_array(da.data, da.dims)

  coords: dict[str, Coord] = {}
  # Untouched coords (no interpolated dims).
  for name, c in da.coords.items():
    if not set(c.dims) & set(interp_dims):
      if set(c.dims).issubset(out_dims):
        coords[name] = c
    elif name not in interp_dims:
      # Interpolate numeric coords along with the data. Integer aux coords
      # (e.g. an int DEM grid_elevation) are promoted to float32 for the
      # lerp, as xarray's interp promotes them; dropping them would break
      # the altitude adjustment downstream. Boolean coords (validity masks)
      # are lerped in float and kept boolean: a target point stays valid
      # only when every contributing source point is valid.
      host = c.is_host
      v = np.asarray(c.values) if host else c.values
      dtype = (v.dtype if host
               else torch.empty(0, dtype=v.dtype).numpy().dtype)
      is_bool = np.issubdtype(dtype, np.bool_)
      if np.issubdtype(dtype, np.number) or is_bool:
        cv = darray.as_tensor(v)
        if not np.issubdtype(dtype, np.floating):
          cv = cv.to(torch.float32)
        cdata, cdims = interp_array(cv, c.dims)
        if is_bool:
          cdata = cdata >= 1.0 - 1e-6
        coords[name] = Coord(cdims, cdata.numpy() if host else cdata)
  # Target coords.
  if pointwise:
    for d, v in dim_args.items():
      coords[d] = Coord(target_dims, v.values)
      for name, c in v.coords.items():
        if name not in coords and set(c.dims).issubset(out_dims):
          coords[name] = c
  else:
    for d, v in dim_args.items():
      coords[d] = Coord((d,), target_values(v))

  return DimArray(data, out_dims, coords)


class CropToBox(Interpolation):
  """Crops to a lat/lon bounding box (reference ``interpolations.py:116-163``)."""

  def __init__(self, lat_min: float, lat_max: float,
               lon_min: float, lon_max: float):
    if lat_min > lat_max:
      raise ValueError(f'Invalid latitudes: {lat_min} and {lat_max}')
    if lon_min > lon_max:
      raise ValueError(f'Invalid longitudes: {lon_min} and {lon_max}')
    self._lat_min, self._lat_max = lat_min, lat_max
    self._lon_min, self._lon_max = lon_min, lon_max

  def interpolate_data_array(self, da, reference=None):
    da = da.sortby('longitude')
    da = da.sortby('latitude')
    return da.sel(latitude=slice(self._lat_min, self._lat_max),
                  longitude=slice(self._lon_min, self._lon_max))


class InterpolateToFixedCoords(Interpolation):
  """Interpolate to fixed coordinates (regridding)."""

  def __init__(self, method: str,
               coords: Mapping[str, Union[DimArray, np.ndarray]],
               wrap_longitude: bool = False,
               extrapolate_out_of_bounds: bool = True):
    self._method = method
    self._coords = dict(coords)
    self._wrap_longitude = wrap_longitude
    self._extrapolate_out_of_bounds = extrapolate_out_of_bounds

  def interpolate_data_array(self, da, reference=None):
    if self._wrap_longitude:
      da = pad_longitude(da)
    return interpolate_to_coords(
        da, self._coords, self._method, self._extrapolate_out_of_bounds)


class InterpolateToReferenceCoords(Interpolation):
  """Interpolate onto the coordinates of a reference chunk.

  Infers interpolated dims from the intersection of the array's dims and
  the reference's coords (reference ``interpolations.py:214-290``), with an
  empty-reference guard.
  """

  def __init__(self, method: str, dims: Optional[Sequence[str]] = None,
               wrap_longitude: bool = False,
               clip_reference_coords: Optional[Iterable[str]] = None,
               extrapolate_out_of_bounds: bool = True):
    self._method = method
    self._dims = dims
    self._wrap_longitude = wrap_longitude
    self._clip_reference_coords = clip_reference_coords
    self._extrapolate_out_of_bounds = extrapolate_out_of_bounds

  def interpolate_data_array(self, da, reference=None):
    assert reference is not None, (
        'InterpolateToReferenceCoords requires a reference chunk.')
    if self._wrap_longitude:
      da = pad_longitude(da)

    if self._clip_reference_coords is not None:
      for coord in self._clip_reference_coords:
        cv = da.coord_values(coord)
        ref_v = reference.coord_values(coord)
        keep = np.nonzero((ref_v >= cv.min()) & (ref_v <= cv.max()))[0]
        rdim = reference.coords[coord].dims[0]
        reference = reference.isel({rdim: keep})

    if self._dims is None:
      dims = [d for d in da.dims if d in reference.coords]
    else:
      dims = list(self._dims)

    if reference.size == 0:
      da_dims_to_retain = [d for d in da.dims if d not in dims]
      shared = [d for d in da_dims_to_retain if d in reference.dims]
      if shared:
        # The JAX package builds an array with these dims twice and fails
        # in the statistics; upstream's expand_dims raises here.
        raise ValueError(
            f'empty reference chunk with dims {reference.dims}: cannot '
            f'expand it by {shared}, which it already has')
      out = reference
      for d in reversed(da_dims_to_retain):
        out = out.expand_dims({d: da.sizes[d]})
        if d in da.coords:
          out = out.assign_coords(**{d: da.coords[d]})
      return out

    dim_args = {}
    for d in dims:
      c = reference.coords[d]
      dim_args[d] = _Targets(reference.coord_values(d), c.dims, {
          name: cc for name, cc in reference.coords.items()
          if set(cc.dims).issubset(c.dims)})
    return interpolate_to_coords(
        da, dim_args, self._method, self._extrapolate_out_of_bounds)


LAPSE_RATE_K_PER_M = -0.0065  # Standard atmosphere lapse rate.


class GridToSparseWithAltitudeAdjustment(InterpolateToReferenceCoords):
  """Grid→station matching with elevation adjustments.

  Lapse-rate temperature adjustment and >100m wind-speed factor, following
  Ingleby (2014) §3.3; reference ``interpolations.py:296-380``. Variables
  must be named '2m_temperature' and '10m_wind_speed'; others pass through.
  The station-minus-grid height is computed from the host coords (float64
  for float64 elevations) and the adjustment applied in the data's dtype,
  so float32 forecasts stay float32.
  """

  def __init__(self, method: str, grid_elevation: DimArray,
               dims: Optional[Sequence[str]] = None,
               wrap_longitude: bool = False,
               extrapolate_out_of_bounds: bool = True,
               max_alititude_diff_in_m: float = 1500):
    self._grid_elevation = grid_elevation
    self._max_alititude_diff_in_m = max_alititude_diff_in_m
    super().__init__(method=method, dims=dims, wrap_longitude=wrap_longitude,
                     extrapolate_out_of_bounds=extrapolate_out_of_bounds)

  def _interpolate_named(self, da, reference, name):
    return self.interpolate_data_array(da, reference, name=name)

  def interpolate_data_array(self, da, reference=None, name=None):
    if name in ['2m_temperature', '10m_wind_speed']:
      da = da.assign_coords(grid_elevation=Coord(
          self._grid_elevation.dims, self._grid_elevation.values))
    out = super().interpolate_data_array(da, reference)
    # An empty reference chunk short-circuits interpolation (the inherited
    # guard returns the expanded empty reference), so the interpolated
    # elevation coords never exist, and there is nothing to adjust.
    if name in ['2m_temperature', '10m_wind_speed'] and out.size > 0:
      elevation = DimArray(out.coord_values('elevation'),
                           out.coords['elevation'].dims)
      grid_elev = DimArray(out.coord_values('grid_elevation'),
                           out.coords['grid_elevation'].dims)
      sparse_higher_m = elevation - grid_elev
      sparse_higher_m = sparse_higher_m.where(
          abs(sparse_higher_m) < self._max_alititude_diff_in_m, 0)
      if name == '2m_temperature':
        out = out + (sparse_higher_m * LAPSE_RATE_K_PER_M).astype(out.dtype)
      else:  # 10m_wind_speed
        ones = darray.ones_like(sparse_higher_m, dtype=np.float32)
        dz = sparse_higher_m - 100
        factor = ones.where(sparse_higher_m < 100, 1 + 0.002 * dz)
        factor = factor.where(sparse_higher_m < 1100, 3)
        out = out * factor.astype(out.dtype)
    return out


class NeighborhoodThresholdProbabilities(Interpolation):
  """Deterministic → probabilistic via FSS-style neighborhood fractions.

  Reference ``interpolations.py:383-435``.
  """

  def __init__(self, neighborhood_sizes, thresholds,
               threshold_dim: str = 'threshold_value',
               wrap_longitude: bool = False):
    self._neighborhood_sizes = list(neighborhood_sizes)
    self._thresholds = thresholds
    self._threshold_dim = threshold_dim
    self._wrap_longitude = wrap_longitude

  def interpolate_data_array(self, da, reference=None):
    da = wrappers.binarize_thresholds(
        da, thresholds=self._thresholds, threshold_dim=self._threshold_dim)
    out = [spatial.neighborhood_averaging_for_single_size(
        da, n, wrap_longitude=self._wrap_longitude)
        for n in self._neighborhood_sizes]
    result = darray.concat(out, 'smoothing_neighborhood')
    return result.assign_coords(smoothing_neighborhood=Coord(
        ('smoothing_neighborhood',), np.asarray(self._neighborhood_sizes)))


class Subsample(Interpolation):
  """Strided subsampling along given dims (reference ``:438-471``)."""

  def __init__(self, dims: Sequence[str], stride: int):
    if stride < 1:
      raise ValueError(f'stride must be >= 1, got {stride}')
    self._dims = list(dims)
    self._stride = stride

  def interpolate_data_array(self, da, reference=None):
    isel_kwargs = {
        dim: slice(None, None, self._stride)
        for dim in self._dims if dim in da.dims}
    return da.isel(isel_kwargs)
