"""Weighting schemes for aggregation.

A numpy copy of ``weatherbenchx_tpu/weighting.py:20-96``: area weights are
the exact sin-bounds cell-area integral (``sin(upper) - sin(lower)`` per
latitude cell, clamped at the poles), normalized to a mean of 1. Weights
are computed on the host from latitude coords; the evaluator uploads them
once per layout.
"""

import abc
import dataclasses

import numpy as np

from weatherbenchx_tpu_torch.darray import DimArray


class Weighting(abc.ABC):
  """Abstract class for weighting."""

  @abc.abstractmethod
  def weights(self, statistic: DimArray) -> DimArray:
    """Weights broadcastable against the statistic's dims."""


def _is_strictly_monotonic(vector: np.ndarray) -> bool:
  diff = np.diff(vector)
  return bool(np.all(diff > 0) or np.all(diff < 0))


def latitude_cell_bounds(x: np.ndarray) -> np.ndarray:
  """Bounds for latitude cells, given increasing cell centers in radians."""
  if not np.all(np.diff(x) > 0):
    raise ValueError('Points must be increasing.')
  diff = np.diff(x)
  pi_over_2 = np.pi / 2
  left_bound = max(x[0] - diff[0] / 2, -pi_over_2)
  right_bound = min(x[-1] + diff[-1] / 2, pi_over_2)
  return np.concatenate([
      np.array([left_bound], dtype=x.dtype),
      (x[:-1] + x[1:]) / 2,
      np.array([right_bound], dtype=x.dtype),
  ])


def cell_area_from_latitude(points: np.ndarray) -> np.ndarray:
  """Normalized cell area: integral of cos(lat) between cell bounds."""
  bounds = latitude_cell_bounds(points)
  return np.sin(bounds[1:]) - np.sin(bounds[:-1])


@dataclasses.dataclass
class GridAreaWeighting(Weighting):
  """Weights proportional to the area of each rectangular grid box.

  Attributes:
    latitude_name: Name of the latitude dimension. Default 'latitude'.
    return_normalized: Normalize weights to mean 1. Default True.
  """

  latitude_name: str = 'latitude'
  return_normalized: bool = True

  def weights(self, statistic: DimArray) -> DimArray:
    if self.latitude_name not in statistic.dims:
      return DimArray(np.float32(1.0))
    latitude = statistic.coord_values(self.latitude_name).astype(np.float64)
    if not _is_strictly_monotonic(latitude):
      raise ValueError(f'Points must be strictly monotonic: {latitude}')
    needs_reversing = latitude[0] > latitude[1]
    if needs_reversing:
      latitude = latitude[::-1]
    w = cell_area_from_latitude(np.deg2rad(latitude))
    if needs_reversing:
      w = w[::-1]
    if self.return_normalized:
      w = w / np.mean(w)
    return DimArray(
        w, (self.latitude_name,),
        {self.latitude_name: statistic.coords[self.latitude_name]})


@dataclasses.dataclass
class ConstantWeighting(Weighting):
  """A constant weight (useful for tests and for weighting ablations)."""

  value: float = 1.0

  def weights(self, statistic: DimArray) -> DimArray:
    return DimArray(np.float32(self.value))
