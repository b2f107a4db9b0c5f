"""Binning: boolean bin-mask factories multiplied into the aggregation.

The port of ``weatherbenchx_tpu/binning.py``: all ten binnings. Each
Binning adds one named bin dimension; its mask is multiplied into the
aggregation contraction, so disaggregation costs one extra einsum axis.
Masks over host coords (lat/lon boxes, station sets, time units of
datetime coords) are built in numpy, without pandas, and uploaded once per
layout by the evaluator. ``ByTimeUnitFromSeconds`` builds its mask with
torch where its int-seconds coord lives (CPU or CUDA tensor, or numpy).
"""

import abc
from typing import Any, Hashable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import Coord, DimArray, as_tensor
from weatherbenchx_tpu_torch.metrics.base import dayofyear_and_hour


class Binning(abc.ABC):
  """Binning base class."""

  def __init__(self, bin_dim_name: str):
    self.bin_dim_name = bin_dim_name

  @property
  def host_coords(self) -> tuple:
    """Names of the coords whose VALUES this binning reads, beyond the
    statistic's dims, shape and small space coords.

    Eager PyTorch traces nothing, so nothing has to be kept on the host
    for a binning as in the JAX package; here the names tell the
    aggregation's layout key which coords to take by content, so that bin
    masks cached per layout are rebuilt when those values change.
    """
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


class LandSea(Binning):
  """land/sea (optionally + global) bins from a land fraction field."""

  def __init__(
      self,
      land_sea_fraction: DimArray,
      land_sea_threshold: float = 0.5,
      bin_dim_name: str = 'land_sea',
      include_global_mask: bool = False,
  ):
    super().__init__(bin_dim_name)
    self._land_mask = land_sea_fraction.values >= land_sea_threshold
    self._dims = land_sea_fraction.dims
    self._coords = land_sea_fraction.coords
    self._include_global_mask = include_global_mask

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    # Label-align the land fraction to the statistic's coordinate order:
    # the aggregation contraction is positional (see _align_axis).
    land = self._land_mask
    coords = dict(self._coords)
    for ax, d in enumerate(self._dims):
      if d in self._coords and statistic.has_coord(d):
        land = _align_axis(land, ax, np.asarray(self._coords[d].values),
                           statistic.coord_values(d), f'land_sea_fraction {d}')
        coords[d] = statistic.coords[d]
    masks = [land, ~land]
    labels = ['land', 'sea']
    if self._include_global_mask:
      masks.append(np.ones_like(land))
      labels.append('global')
    coords[self.bin_dim_name] = Coord((self.bin_dim_name,), np.array(labels))
    return DimArray(np.stack(masks), (self.bin_dim_name,) + self._dims, coords)


class LatitudeBins(Binning):
  """Binning by latitude bands, labelled by each band's southern edge."""

  def __init__(
      self,
      degrees: float,
      lat_range: Tuple[float, float] = (-90, 90),
      bin_dim_name: str = 'latitude_bins',
  ):
    super().__init__(bin_dim_name)
    self._degrees = degrees
    self._lat_bins = np.arange(lat_range[0], lat_range[1] + degrees, degrees)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    lat = statistic.coord_values('latitude')
    starts = self._lat_bins[:-1]
    masks = np.stack([_lat_mask(lat, (s, s + self._degrees)) for s in starts])
    return DimArray(masks, (self.bin_dim_name, 'latitude'),
                    {self.bin_dim_name: starts,
                     'latitude': statistic.coords['latitude']})


class LongitudeBins(Binning):
  """Binning by longitude bands, labelled by each band's western edge
  modulo 360; a range may wrap the dateline."""

  def __init__(
      self,
      degrees: float,
      lon_range: Tuple[float, float] = (0, 360),
      bin_dim_name: str = 'longitude_bins',
  ):
    super().__init__(bin_dim_name)
    self._degrees = degrees
    lon_end = lon_range[1] + (360 if lon_range[0] >= lon_range[1] else 0)
    self._lon_bins = np.arange(lon_range[0], lon_end + degrees, degrees)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    lon = statistic.coord_values('longitude')
    starts = self._lon_bins[:-1]
    masks = np.stack([_lon_mask(lon, (s, s + self._degrees)) for s in starts])
    return DimArray(masks, (self.bin_dim_name, 'longitude'),
                    {self.bin_dim_name: np.mod(starts, 360),
                     'longitude': statistic.coords['longitude']})


def _coords_within(coords: dict, parent_coords: Mapping[str, Coord] | None,
                   dims: tuple[str, ...]) -> dict:
  """``coords`` plus the parent's coords that lie within ``dims``."""
  for name, c in (parent_coords or {}).items():
    if name not in coords and set(c.dims).issubset(dims):
      coords[name] = c
  return coords


def vectorized_coord_mask(
    coord_values: np.ndarray,
    coord_dims: tuple[str, ...],
    bin_dim_name: str,
    add_global_bin: bool = False,
    parent_coords: Mapping[str, Coord] | None = None,
) -> DimArray:
  """Bin masks for each unique value of a host coordinate; an empty input
  gives zero bins."""
  unique = np.unique(coord_values)
  masks = np.equal(
      coord_values[None], unique.reshape((-1,) + (1,) * coord_values.ndim))
  labels = unique
  if add_global_bin:
    if labels.dtype.kind not in 'US':
      labels = labels.astype(str)
    labels = np.concatenate([np.array(['global']), labels])
    masks = np.concatenate(
        [np.ones((1,) + coord_values.shape, bool), masks], axis=0)
  coords = {bin_dim_name: Coord((bin_dim_name,), labels)}
  return DimArray(masks, (bin_dim_name,) + coord_dims,
                  _coords_within(coords, parent_coords, coord_dims))


class ByExactCoord(Binning):
  """One bin per unique value of a (non-dimension) coordinate, e.g. per
  unique lead_time of sparse observations whose lead_time lies over the
  ``index`` dim."""

  def __init__(self, coord: str, add_global_bin: bool = False):
    super().__init__(coord)
    self.coord = coord
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.coord,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    if self.coord in statistic.dims:
      raise ValueError('For dimensions, specify reduce_dims in aggregation.')
    c = statistic.coords[self.coord]
    return vectorized_coord_mask(
        statistic.coord_values(self.coord), tuple(c.dims), self.coord,
        self.add_global_bin, statistic.coords)


_TIMEDELTA_UNIT_SECONDS = {'second': 1, 'minute': 60, 'hour': 3600,
                           'day': 86400, 'week': 86400 * 7,
                           'year': 86400 * 365}


def _extract_time_unit(values: np.ndarray, unit: str) -> np.ndarray:
  """A time unit of datetime64 or timedelta64 values, as int64, in numpy.

  datetime64: ``pandas.DatetimeIndex``'s attributes of the same names
  (year, month, day, hour, minute, second, dayofyear / day_of_year,
  dayofweek / day_of_week / weekday with Monday 0, quarter, and the ISO
  week as week / weekofyear). timedelta64: whole multiples of second,
  minute, hour, day, week or year (365 days), floored.
  """
  values = np.asarray(values)
  if values.dtype.kind == 'm':
    if unit not in _TIMEDELTA_UNIT_SECONDS:
      raise ValueError(f'Unsupported unit for timedelta: {unit}')
    seconds = values.astype('timedelta64[ns]').astype(np.int64) / 1e9
    if unit != 'second':
      seconds = seconds // _TIMEDELTA_UNIT_SECONDS[unit]
    return seconds.astype(np.int64)
  if values.dtype.kind != 'M':
    raise ValueError(f'Expected datetime64 or timedelta64 values, got '
                     f'{values.dtype}')

  def since(fine: str, coarse: str) -> np.ndarray:
    """Whole ``fine`` units since the start of the ``coarse`` unit."""
    return (values.astype(f'datetime64[{fine}]')
            - values.astype(f'datetime64[{coarse}]')).astype(np.int64)

  def month():
    return values.astype('datetime64[M]').astype(np.int64) % 12 + 1

  def weekday():  # 1970-01-01 was a Thursday (3)
    return (values.astype('datetime64[D]').astype(np.int64) + 3) % 7

  def iso_week():
    # The ISO week of a date is the week of the year of its Thursday.
    thursday = values.astype('datetime64[D]') + (3 - weekday()).astype(
        'timedelta64[D]')
    return (dayofyear_and_hour(thursday)[0] - 1) // 7 + 1

  extract = {
      'year': lambda: values.astype('datetime64[Y]').astype(np.int64) + 1970,
      'month': month,
      'day': lambda: since('D', 'M') + 1,
      'hour': lambda: dayofyear_and_hour(values)[1],
      'minute': lambda: since('m', 'h'),
      'second': lambda: since('s', 'm'),
      'dayofyear': lambda: dayofyear_and_hour(values)[0],
      'dayofweek': weekday,
      'quarter': lambda: (month() - 1) // 3 + 1,
      'week': iso_week,
  }
  aliases = {'day_of_year': 'dayofyear', 'day_of_week': 'dayofweek',
             'weekday': 'dayofweek', 'weekofyear': 'week'}
  unit = aliases.get(unit, unit)
  if unit not in extract:
    raise ValueError(
        f'Unsupported unit for datetime: {unit!r}; one of '
        f'{sorted(extract) + sorted(aliases)}')
  return extract[unit]().astype(np.int64)


class ByTimeUnit(Binning):
  """Bin by a calendar unit of a host datetime or timedelta coordinate
  (see ``_extract_time_unit`` for the units)."""

  def __init__(self, unit: str, time_dim: str, add_global_bin: bool = False):
    super().__init__(f'{time_dim}_{unit}')
    self.unit = unit
    self.time_dim = time_dim
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.time_dim,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.time_dim]
    unit_values = _extract_time_unit(
        statistic.coord_values(self.time_dim), self.unit)
    return vectorized_coord_mask(
        unit_values, tuple(c.dims), self.bin_dim_name,
        self.add_global_bin, statistic.coords)


def _as_members(s: Any) -> list:
  return list(s) if isinstance(s, Sequence) and not isinstance(s, str) else [s]


def _set_masks(values: np.ndarray, sets: Mapping[str, Any],
               add_set_complements: bool, add_global_bin: bool):
  """(masks, labels): membership of ``values`` in each named set."""
  masks, labels = [], []
  for name, s in sets.items():
    members = np.array(_as_members(s))
    if members.dtype.kind == 'O' or values.dtype.kind == 'O':
      # np.isin on object arrays compares element by element in Python;
      # typed arrays take the sorting path.
      members = members.astype(str)
      values = values.astype(str)
    m = np.isin(values, members)
    masks.append(m)
    labels.append(name)
    if add_set_complements:
      masks.append(~m)
      labels.append(f'not_in_{name}')
  if add_global_bin:
    masks.append(np.ones(values.shape, dtype=bool))
    labels.append('global')
  return np.stack(masks), np.array(labels)


class ByTimeUnitSets(Binning):
  """Bin by named sets of time-unit values."""

  def __init__(
      self,
      sets: Mapping[str, Sequence[Any] | Any],
      unit: str,
      dim: str,
      bin_dim_name: Optional[str] = None,
      add_global_bin: bool = False,
  ):
    super().__init__(bin_dim_name or f'{dim}_{unit}_sets')
    self.sets = dict(sets)
    self.unit = unit
    self.dim = dim
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.dim,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.dim]
    unit_values = _extract_time_unit(
        statistic.coord_values(self.dim), self.unit)
    masks, labels = _set_masks(unit_values, self.sets, False,
                               self.add_global_bin)
    coords = {self.bin_dim_name: Coord((self.bin_dim_name,), labels)}
    return DimArray(masks, (self.bin_dim_name,) + tuple(c.dims),
                    _coords_within(coords, statistic.coords, tuple(c.dims)))


class ByTimeUnitFromSeconds(Binning):
  """Bin by a time unit of an int-seconds coordinate.

  The mask is built with torch where the coordinate lives: a CPU or CUDA
  int64 tensor, or numpy. ``//`` on integer tensors floors, as jnp's does.
  """

  def __init__(self, unit: str, time_dim: str,
               bins: Sequence[int] | None = None):
    super().__init__(f'{time_dim}_{unit}')
    self.unit = unit
    self.time_dim = time_dim
    self.bins = bins

  @property
  def host_coords(self) -> tuple:
    # The JAX package traces this coord and names none; here the name puts
    # the coord's values into the layout key (see Binning.host_coords).
    return (self.time_dim,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.time_dim]
    coord = as_tensor(c.values)
    divisor, default_bins = {
        'second': (1, np.arange(0, 60)), 'minute': (60, np.arange(0, 60)),
        'hour': (3600, np.arange(0, 24)), 'day': (86400, None),
    }.get(self.unit, (None, None))
    if divisor is None:
      raise ValueError(f'Unsupported unit: {self.unit}')
    bins = self.bins if self.bins is not None else default_bins
    if bins is None:
      raise ValueError('bins must be given for unit="day"')
    bins = np.asarray(bins)
    if divisor != 1:
      coord = coord // divisor
    masks = coord[None] == torch.as_tensor(bins, device=coord.device).reshape(
        (-1,) + (1,) * coord.dim())
    coords = {self.bin_dim_name: Coord((self.bin_dim_name,), bins)}
    return DimArray(masks, (self.bin_dim_name,) + tuple(c.dims),
                    _coords_within(coords, statistic.coords, tuple(c.dims)))


class ByCoordBins(Binning):
  """Binning a coordinate into [left, right) edge intervals.

  Bin labels are the left edges; with add_global_bin they become strings
  plus a 'global' bin.
  """

  def __init__(
      self,
      dim_name: str,
      bin_edges: np.ndarray,
      add_global_bin: bool = False,
  ):
    super().__init__(dim_name)
    self.dim_name = dim_name
    self.bin_edges = np.asarray(bin_edges)
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.dim_name,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.dim_name]
    values = statistic.coord_values(self.dim_name)
    starts, stops = self.bin_edges[:-1], self.bin_edges[1:]
    column = (-1,) + (1,) * values.ndim
    masks = ((values[None] >= starts.reshape(column))
             & (values[None] < stops.reshape(column)))
    labels = starts
    left, right = starts, stops
    if self.add_global_bin:
      masks = np.concatenate(
          [masks, np.ones((1,) + values.shape, bool)], axis=0)
      labels = np.concatenate([starts.astype(str), np.array(['global'])])
      left = np.concatenate([starts, [np.nan]])
      right = np.concatenate([stops, [np.nan]])
    coords = {
        self.dim_name: Coord((self.dim_name,), labels),
        self.dim_name + '_left_edge': Coord((self.dim_name,), left),
        self.dim_name + '_right_edge': Coord((self.dim_name,), right),
    }
    return DimArray(masks, (self.dim_name,) + tuple(c.dims),
                    _coords_within(coords, statistic.coords, tuple(c.dims)))


class BySets(Binning):
  """Bin by named sets of coordinate values (e.g. station-name sets),
  optionally with each set's complement and a global bin."""

  def __init__(
      self,
      sets: Mapping[str, Sequence[Any] | Any],
      coord_name: str,
      bin_dim_name: Optional[str] = None,
      add_set_complements: bool = False,
      add_global_bin: bool = False,
  ):
    if bin_dim_name is None or bin_dim_name == coord_name:
      raise ValueError(
          'bin_dim_name must be defined and be different from coord_name.')
    super().__init__(bin_dim_name)
    self.sets = dict(sets)
    self.coord_name = coord_name
    self.add_set_complements = add_set_complements
    self.add_global_bin = add_global_bin

  @property
  def host_coords(self) -> tuple:
    return (self.coord_name,)

  def create_bin_mask(self, statistic: DimArray) -> DimArray:
    c = statistic.coords[self.coord_name]
    masks, labels = _set_masks(
        statistic.coord_values(self.coord_name), self.sets,
        self.add_set_complements, self.add_global_bin)
    coords = {self.bin_dim_name: Coord((self.bin_dim_name,), labels)}
    return DimArray(masks, (self.bin_dim_name,) + tuple(c.dims),
                    _coords_within(coords, statistic.coords, tuple(c.dims)))
