"""Gridded dataset loaders.

The port of ``weatherbenchx_tpu/data/loaders.py``, over two sources: an
in-memory ``dict[var, DimArray]`` dataset (``ds=``) or a path opened
lazily by ``io.open_dataset_auto`` (``.npz``, ``.wbx``, zarr v2/v3 local or
through fsspec; netCDF is read whole). The one-time preparation
(preprocessing, renames, ``sel``/``isel``) composes on the lazy views and
reads only coordinates; each chunk's selection is read in the compute
step of ``data/base.py``. Chunks come out on the host: CPU tensors and
numpy coords.

Canonical dim names follow the ECMWF convention after renaming:
``init_time``/``lead_time`` for forecasts, ``valid_time`` for analyses,
``latitude``/``longitude`` for space, ``number`` for ensemble members.

The JAX package's xarray-backed stores wait for xarray on the port's
machines.
"""

import threading
from typing import Any, Callable, Iterable, Mapping, Optional, Union

import numpy as np
import torch

from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.darray import Coord, DimArray, _label_indices
from weatherbenchx_tpu_torch.data import base
from weatherbenchx_tpu_torch.metrics.base import dayofyear_and_hour

Dataset = dict[str, DimArray]


def rename_dataset(
    ds: Dataset,
    rename_dimensions: Optional[Union[Mapping[str, str], str]] = 'ecmwf',
    rename_variables: Optional[Mapping[str, str]] = None,
    convert_lat_lon_to_latitude_longitude: bool = True,
) -> Dataset:
  """Renames dims/vars to canonical names."""
  dims = set()
  for da in ds.values():
    dims.update(da.dims)
    dims.update(da.coords.keys())
  mapping: dict[str, str] = {}
  if convert_lat_lon_to_latitude_longitude and 'lat' in dims and 'lon' in dims:
    mapping.update({'lat': 'latitude', 'lon': 'longitude'})
  if rename_dimensions == 'ecmwf':
    if 'prediction_timedelta' in dims:  # forecast dataset
      mapping.update({'time': 'init_time', 'prediction_timedelta': 'lead_time'})
    else:  # (re-)analysis dataset
      mapping.update({'time': 'valid_time'})
  elif isinstance(rename_dimensions, Mapping):
    mapping.update(rename_dimensions)
  elif rename_dimensions is not None:
    raise ValueError('rename_dimensions must be either "ecmwf", a dict or None.')

  out = {k: (da.rename(mapping) if mapping else da) for k, da in ds.items()}
  if rename_variables:
    out = {rename_variables.get(k, k): v for k, v in out.items()}
  return out


class DatasetBackedLoader(base.DataLoader):
  """Shared source handling: an in-memory dataset or a store path."""

  def __init__(
      self,
      path: Optional[str] = None,
      ds: Optional[Dataset] = None,
      variables: Optional[Iterable[str]] = None,
      sel_kwargs: Optional[Mapping[str, Any]] = None,
      isel_kwargs: Optional[Mapping[str, Any]] = None,
      rename_dimensions: Optional[Union[Mapping[str, str], str]] = 'ecmwf',
      automatically_convert_lat_lon_to_latitude_longitude: bool = True,
      rename_variables: Optional[Mapping[str, str]] = None,
      preprocessing_fn: Optional[Callable[[Dataset], Dataset]] = None,
      **kwargs,
  ):
    if (path is None) == (ds is None):
      raise ValueError('Exactly one of path or ds must be specified.')
    self._ds = ds
    self._path = path
    self._variables = variables
    self._sel_kwargs = sel_kwargs
    self._isel_kwargs = isel_kwargs
    self._rename_dimensions = rename_dimensions
    self._auto_latlon = automatically_convert_lat_lon_to_latitude_longitude
    self._rename_variables = rename_variables
    self._preprocessing_fn = preprocessing_fn
    self._preprocessed = False
    self._prepare_lock = threading.Lock()
    super().__init__(**kwargs)

  def maybe_prepare_dataset(self) -> None:
    """Opens and preprocesses the dataset once.

    Thread-safe: the pipeline's prefetch threads call load_chunk
    concurrently from the first chunks on, and an unguarded lazy init would
    apply preprocessing_fn (a user function, e.g. a unit shift, that need
    not be idempotent) twice to the same dataset.
    """
    if self._preprocessed:
      return
    with self._prepare_lock:
      if self._preprocessed:
        return
      ds = self._ds if self._ds is not None else io_lib.open_dataset_auto(
          self._path)
      if self._preprocessing_fn is not None:
        ds = self._preprocessing_fn(ds)
      ds = rename_dataset(ds, self._rename_dimensions, self._rename_variables,
                          self._auto_latlon)
      if self._variables is not None:
        ds = {k: ds[k] for k in self._variables}
      # Per-variable selection on the dims each variable has (xarray
      # Dataset.sel semantics: variables lacking a dim pass through).
      if self._sel_kwargs is not None:
        ds = {k: v.sel({d: s for d, s in self._sel_kwargs.items()
                        if d in v.dims})
              for k, v in ds.items()}
      if self._isel_kwargs is not None:
        ds = {k: v.isel({d: s for d, s in self._isel_kwargs.items()
                         if d in v.dims})
              for k, v in ds.items()}
      self._ds = ds
      self._preprocessed = True

  def load_chunk(self, init_times, lead_times=None, reference=None):
    self.maybe_prepare_dataset()
    return super().load_chunk(init_times, lead_times, reference)


class PredictionsFromDataset(DatasetBackedLoader):
  """Forecast loader: selects (init_time, lead_time) directly."""

  def _load_chunk_from_source(self, init_times, lead_times=None):
    out = {}
    for k, da in self._ds.items():
      sel = da.sel(init_time=init_times)
      if isinstance(lead_times, slice):
        lt = sel.coord_values('lead_time')
        keep = np.nonzero((lt >= np.timedelta64(lead_times.start))
                          & (lt <= np.timedelta64(lead_times.stop)))[0]
        sel = sel.isel(lead_time=keep)  # inclusive end
      elif lead_times is not None:
        sel = sel.sel(lead_time=lead_times)
      out[k] = sel
    return out


class TargetsFromDataset(DatasetBackedLoader):
  """Analysis/target loader: a valid_time = init_time + lead_time gather.

  A vectorized select over the valid_time dim, producing (init_time,
  lead_time, ...) arrays with a valid_time non-dim coord.
  """

  def _load_chunk_from_source(self, init_times, lead_times=None):
    out = {}
    if lead_times is None:
      for k, da in self._ds.items():
        sel = da.sel(valid_time=init_times).rename({'valid_time': 'init_time'})
        out[k] = sel.assign_coords(
            valid_time=Coord(('init_time',), init_times))
      return out
    if isinstance(lead_times, slice):
      raise ValueError('Lead time slice not supported for target data loaders.')
    valid_time = (init_times[:, None].astype('datetime64[ns]')
                  + lead_times[None, :].astype('timedelta64[ns]'))
    for k, da in self._ds.items():
      # Normalize to ns before keying: datetime64 scalars of different
      # units compare equal but HASH differently, so a [s]/[h]-unit store
      # coord would miss every (ns) lookup key.
      coord = da.coord_values('valid_time').astype('datetime64[ns]')
      lookup = {v: i for i, v in enumerate(coord)}
      try:
        idx = np.array([[lookup[v] for v in row] for row in valid_time])
      except KeyError as e:
        raise KeyError(f'valid_time {e} not found in target dataset') from e
      sel = da.take('valid_time', idx, ('init_time', 'lead_time'))
      out[k] = sel.assign_coords(
          init_time=Coord(('init_time',), init_times),
          lead_time=Coord(('lead_time',), lead_times),
          valid_time=Coord(('init_time', 'lead_time'), valid_time))
    return out


def _valid_times(init_times: np.ndarray, lead_times) -> np.ndarray:
  """(init, lead) valid times in ns; exact lead times only."""
  if lead_times is None or isinstance(lead_times, slice):
    raise ValueError(
        'Exact lead times must be specified for this data loader.')
  return (init_times[:, None].astype('datetime64[ns]')
          + lead_times[None, :].astype('timedelta64[ns]'))


class ClimatologyFromDataset(DatasetBackedLoader):
  """Reads a (dayofyear[, hour]) climatology as a predictions dataset."""

  def __init__(
      self,
      climatology_time_coords: Iterable[str] = ('dayofyear', 'hour'),
      rename_dimensions=None,
      **kwargs,
  ):
    super().__init__(rename_dimensions=rename_dimensions, **kwargs)
    self._climatology_time_coords = tuple(climatology_time_coords)

  def _load_chunk_from_source(self, init_times, lead_times=None):
    if isinstance(lead_times, slice):
      raise ValueError(
          'Lead time slice not yet supported for climatology data loaders.')
    if lead_times is not None:
      valid_time = _valid_times(init_times, lead_times)
      out_dims = ('init_time', 'lead_time')
    else:
      valid_time = init_times.astype('datetime64[ns]')
      out_dims = ('init_time',)
    doy, hour = dayofyear_and_hour(valid_time)
    units = {'dayofyear': doy, 'hour': hour}
    out = {}
    for k, da in self._ds.items():
      sel = da
      for i, name in enumerate(self._climatology_time_coords):
        idx = _label_indices(sel.coord_values(name).astype(np.int64),
                             units[name], None)
        # The first select expands to the output dims; later ones index
        # the same output dims, so they select diagonally.
        sel = (sel.take(name, idx, out_dims) if i == 0
               else _diagonal_take(sel, name, idx, out_dims))
      coords = {'init_time': Coord(('init_time',), init_times)}
      if lead_times is not None:
        coords['lead_time'] = Coord(('lead_time',), lead_times)
        coords['valid_time'] = Coord(out_dims, valid_time)
      out[k] = sel.assign_coords(**coords)
    return out


def _diagonal_take(da: DimArray, dim: str, idx: np.ndarray,
                   out_dims: tuple) -> DimArray:
  """da[dim=idx] where idx is laid out along ``out_dims``, already dims of
  ``da``: xarray's pointwise sel when the indexer shares the array's dims
  (the second time select of a dayofyear x hour climatology)."""
  rest = tuple(d for d in da.dims if d not in out_dims and d != dim)
  da_t = da.transpose(*out_dims, dim, *rest)
  n_out = len(out_dims)
  data = da_t.data.reshape((-1,) + tuple(da_t.shape[n_out:]))
  rows = torch.arange(data.shape[0])
  gathered = data[rows, torch.as_tensor(idx.reshape(-1))]
  gathered = gathered.reshape(idx.shape + tuple(da_t.shape[n_out + 1:]))
  dims = tuple(out_dims) + rest
  coords = {k: c for k, c in da.coords.items() if set(c.dims).issubset(dims)}
  return DimArray(gathered, dims, coords)


class PersistenceFromDataset(DatasetBackedLoader):
  """The target dataset at init time as a forecast, repeated along
  lead_time."""

  def _load_chunk_from_source(self, init_times, lead_times=None):
    if lead_times is None or isinstance(lead_times, slice):
      raise ValueError(
          'Exact lead times must be specified for persistence data loader.')
    out = {}
    for k, da in self._ds.items():
      sel = da.sel(valid_time=init_times).rename({'valid_time': 'init_time'})
      sel = sel.expand_dims({'lead_time': len(lead_times)}, axis=1)
      out[k] = sel.assign_coords(
          lead_time=Coord(('lead_time',), lead_times),
          init_time=Coord(('init_time',), init_times))
    return out


class ProbabilisticClimatologyFromDataset(DatasetBackedLoader):
  """Each year of a target dataset as one ensemble member: for each valid
  time, the same (dayofyear, hour) of every year in [start_year,
  end_year]."""

  def __init__(self, start_year: int, end_year: int,
               ensemble_dim: str = 'number', **kwargs):
    super().__init__(**kwargs)
    self._start_year = start_year
    self._end_year = end_year
    self._ensemble_dim = ensemble_dim

  def _load_chunk_from_source(self, init_times, lead_times=None):
    valid_time = _valid_times(init_times, lead_times)
    doy, hour = dayofyear_and_hour(valid_time)
    years = list(range(self._start_year, self._end_year + 1))
    member_times = np.stack([
        np.datetime64(str(year), 'ns')
        + ((doy - 1) * 24 + hour) * np.timedelta64(1, 'h')
        for year in years])  # (member, init, lead)
    out = {}
    for k, da in self._ds.items():
      # ns-normalized keys: cross-unit datetime64 scalars hash differently.
      coord = da.coord_values('valid_time').astype('datetime64[ns]')
      idx = _label_indices(coord, member_times, None)
      sel = da.take('valid_time', idx,
                    (self._ensemble_dim, 'init_time', 'lead_time'))
      out[k] = sel.assign_coords(**{
          self._ensemble_dim: Coord((self._ensemble_dim,),
                                    np.arange(len(years))),
          'init_time': Coord(('init_time',), init_times),
          'lead_time': Coord(('lead_time',), lead_times),
          'valid_time': Coord(('init_time', 'lead_time'), valid_time),
      })
    return out
