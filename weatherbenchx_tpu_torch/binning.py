"""Binning: boolean bin-mask factories multiplied into the aggregation.

A numpy copy of ``weatherbenchx_tpu/binning.py:24-130``. Each Binning adds
one named bin dimension; its mask is multiplied into the aggregation
contraction, so disaggregation costs one extra einsum axis. Masks over
host coords (lat/lon boxes) are built in numpy and uploaded once per
layout by the evaluator.
"""

import abc
from typing import Hashable, Mapping, Optional, Tuple

import numpy as np

from weatherbenchx_tpu_torch.darray import DimArray


class Binning(abc.ABC):
  """Binning base class."""

  def __init__(self, bin_dim_name: str):
    self.bin_dim_name = bin_dim_name

  @property
  def host_coords(self) -> tuple:
    """Coord names whose host values this binning reads."""
    return ()

  @abc.abstractmethod
  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    """Boolean mask broadcastable against the statistic, with the bin dim."""


def _lat_mask(lat: np.ndarray, lat_lims: Tuple[float, float]) -> np.ndarray:
  if lat_lims[0] >= lat_lims[1]:
    raise ValueError(
        f'`lat_lims[0]` must be smaller than `lat_lims[1]`, got {lat_lims}')
  return (lat >= lat_lims[0]) & (lat <= lat_lims[1])


def _lon_mask(lon: np.ndarray, lon_lims: Tuple[float, float]) -> np.ndarray:
  lon = np.mod(lon, 360)
  lo, hi = np.mod(lon_lims[0], 360), np.mod(lon_lims[1], 360)
  if hi > lo:
    return (lon >= lo) & (lon <= hi)
  # Wraps around the dateline.
  return (lon <= hi) | (lon >= lo)


def _region_mask(lat, lon, lat_lims, lon_lims) -> np.ndarray:
  """Outer AND of a latitude band and a (possibly wrapping) longitude band."""
  return _lat_mask(lat, lat_lims)[:, None] & _lon_mask(lon, lon_lims)[None, :]


def _align_axis(values: np.ndarray, axis: int, have: np.ndarray,
                want: np.ndarray, what: str) -> np.ndarray:
  """Reorders ``values`` along ``axis`` from label order ``have`` to ``want``.

  The aggregation einsum contracts bin masks against statistics purely by
  position, so masks built from externally-stored fields must be
  label-aligned here (an ascending-latitude land mask against a
  descending-latitude statistic would otherwise mirror land north/south).
  """
  if np.array_equal(have, want):
    return values
  if not np.array_equal(np.sort(have), np.sort(want)):
    raise ValueError(
        f'{what} coordinates do not match the statistic: '
        f'{have[:4]}... vs {want[:4]}...')
  pos = {v: i for i, v in enumerate(have.tolist())}
  idx = np.array([pos[v] for v in want.tolist()])
  return np.take(values, idx, axis=axis)


class Regions(Binning):
  """Rectangular lat/lon-box regions, optionally with {region}_land bins.

  Coordinates must be named 'latitude' and 'longitude'.
  """

  def __init__(
      self,
      regions: Mapping[Hashable, Tuple[Tuple[float, float],
                                       Tuple[float, float]]],
      bin_dim_name: str = 'region',
      land_sea_mask: Optional[DimArray] = None,
  ):
    super().__init__(bin_dim_name)
    self._regions = dict(regions)
    self._land_sea_mask = land_sea_mask

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    lat = statistic.coord_values('latitude')
    lon = statistic.coord_values('longitude')
    masks = np.stack([
        _region_mask(lat, lon, lat_lims, lon_lims)
        for lat_lims, lon_lims in self._regions.values()
    ])
    labels = np.array([str(k) for k in self._regions.keys()])
    if self._land_sea_mask is not None:
      ls = self._land_sea_mask
      order = [ls.dims.index('latitude'), ls.dims.index('longitude')]
      ls_np = np.transpose(ls.values, order).astype(bool)
      ls_np = _align_axis(ls_np, 0, ls.coord_values('latitude'), lat,
                          'Land/sea mask latitude')
      ls_np = _align_axis(ls_np, 1, ls.coord_values('longitude'), lon,
                          'Land/sea mask longitude')
      masks = np.concatenate([masks, masks & ls_np[None]], axis=0)
      labels = np.concatenate([labels, np.array(
          [f'{k}_land' for k in self._regions.keys()])])
    return DimArray(
        masks, (self.bin_dim_name, 'latitude', 'longitude'),
        {self.bin_dim_name: labels,
         'latitude': statistic.coords['latitude'],
         'longitude': statistic.coords['longitude']})
