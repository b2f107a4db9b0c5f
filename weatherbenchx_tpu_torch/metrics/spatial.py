"""Spatial verification metrics: the Fractions Skill Score (FSS).

The port of ``weatherbenchx_tpu/metrics/spatial.py``. The neighborhood
averaging is a batched cumulative-sum difference (``ops/conv.py``) over all
leading dims at once.
"""

import dataclasses
from typing import Iterable, Mapping, Union

import numpy as np
import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.ops import conv


# The dims the neighborhood windows span: a statistic of them reads across
# both, so a chunk sharded along either is made whole first.
WINDOW_DIMS = ('latitude', 'longitude')


def neighborhood_averaging_for_single_size(
    da: DimArray, neighborhood_size: int, wrap_longitude: bool = False
) -> DimArray:
  """Neighborhood average over (latitude, longitude) for one size.

  A ``mask`` coord is averaged too, and a point stays valid only where
  every point of its neighborhood is (the averaged mask is 1, up to the
  convolution's rounding).
  """
  order = [d for d in da.dims if d not in ('latitude', 'longitude')]
  dat = da.transpose(*order, 'latitude', 'longitude')
  out = DimArray(
      conv.convolve2d_wrap_longitude(dat.data, neighborhood_size,
                                     wrap_longitude),
      dat.dims, dat.coords)
  if da.has_coord('mask'):
    mask_c = da.coords['mask']
    new_mask = neighborhood_averaging(
        DimArray(mask_c.values, mask_c.dims,
                 {d: da.coords[d] for d in mask_c.dims if d in da.coords}),
        neighborhood_size, wrap_longitude)
    one = torch.ones((), dtype=new_mask.dtype, device=new_mask.device)
    out = out.assign_coords(mask=Coord(
        new_mask.dims, torch.isclose(new_mask.data, one)))
  return out


def neighborhood_averaging(
    da: DimArray,
    neighborhood_size: Union[int, Iterable[int]],
    wrap_longitude: bool = False,
) -> DimArray:
  """Neighborhood averaging; several sizes concatenate along a new
  ``neighborhood_size`` dim."""
  if isinstance(neighborhood_size, Iterable):
    sizes = list(neighborhood_size)
    out = darray.concat(
        [neighborhood_averaging_for_single_size(da, n, wrap_longitude)
         for n in sizes], 'neighborhood_size')
    return out.assign_coords(neighborhood_size=Coord(
        ('neighborhood_size',), np.asarray(sizes)))
  return neighborhood_averaging_for_single_size(
      da, neighborhood_size, wrap_longitude)


def get_suffix(neighborhood_size, wrap_longitude: bool = False) -> str:
  if isinstance(neighborhood_size, Iterable):
    suffix = ','.join([str(t) for t in neighborhood_size])
  else:
    suffix = str(neighborhood_size)
  if wrap_longitude:
    suffix += '_wrap_longitude'
  return suffix


@dataclasses.dataclass
class SquaredFractionsError(base.PerVariableStatistic):
  """Numerator of the FSS."""

  def reads_across(self):
    return WINDOW_DIMS

  neighborhood_size_in_pixels: Union[int, Iterable[int]]
  wrap_longitude: bool = False

  @property
  def unique_name(self) -> str:
    suffix = get_suffix(self.neighborhood_size_in_pixels, self.wrap_longitude)
    return f'SquaredFractionsError_{suffix}'

  def _compute_per_variable(self, predictions, targets):
    predictions = neighborhood_averaging(
        predictions, self.neighborhood_size_in_pixels, self.wrap_longitude)
    targets = neighborhood_averaging(
        targets, self.neighborhood_size_in_pixels, self.wrap_longitude)
    return (predictions - targets) ** 2


@dataclasses.dataclass
class SquaredPredictionFraction(base.PerVariableStatistic):
  """One part of the FSS denominator."""

  def reads_across(self):
    return WINDOW_DIMS

  neighborhood_size_in_pixels: Union[int, Iterable[int]]
  wrap_longitude: bool = False

  @property
  def unique_name(self) -> str:
    suffix = get_suffix(self.neighborhood_size_in_pixels, self.wrap_longitude)
    return f'SquaredPredictionFraction_{suffix}'

  def _compute_per_variable(self, predictions, targets):
    predictions = neighborhood_averaging(
        predictions, self.neighborhood_size_in_pixels, self.wrap_longitude)
    return predictions ** 2 + darray.zeros_like(targets)


@dataclasses.dataclass
class SquaredTargetFraction(base.PerVariableStatistic):
  """One part of the FSS denominator."""

  def reads_across(self):
    return WINDOW_DIMS

  neighborhood_size_in_pixels: Union[int, Iterable[int]]
  wrap_longitude: bool = False

  @property
  def unique_name(self) -> str:
    suffix = get_suffix(self.neighborhood_size_in_pixels, self.wrap_longitude)
    return f'SquaredTargetFraction_{suffix}'

  def _compute_per_variable(self, predictions, targets):
    targets = neighborhood_averaging(
        targets, self.neighborhood_size_in_pixels, self.wrap_longitude)
    return targets ** 2 + darray.zeros_like(predictions)


@dataclasses.dataclass
class FSS(base.PerVariableMetric):
  """Fractions Skill Score over one or several square pixel neighborhoods
  (Roberts & Lean 2008). Inputs must already be binary."""

  neighborhood_size_in_pixels: Union[int, Iterable[int]]
  wrap_longitude: bool = False

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        'SquaredFractionsError': SquaredFractionsError(
            self.neighborhood_size_in_pixels, self.wrap_longitude),
        'SquaredPredictionFraction': SquaredPredictionFraction(
            self.neighborhood_size_in_pixels, self.wrap_longitude),
        'SquaredTargetFraction': SquaredTargetFraction(
            self.neighborhood_size_in_pixels, self.wrap_longitude),
    }

  def _values_from_mean_statistics_per_variable(self, s):
    return 1 - (s['SquaredFractionsError']
                / (s['SquaredPredictionFraction']
                   + s['SquaredTargetFraction']))
