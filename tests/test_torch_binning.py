"""The port's ten binnings against the JAX package, on the CPU.

The same numpy coords go through each ``Binning`` of both packages: masks,
dims, bin labels and carried coords are equal exactly. ``_extract_time_unit``
(numpy here, ``pandas.DatetimeIndex`` there) is held to pandas over leap
years, year ends and ISO week 53. String labels survive a state's
``to_dataset`` / ``save`` / ``load`` and the conversion of a JAX state.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as jb
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning as tb
from weatherbenchx_tpu_torch import convert
from weatherbenchx_tpu_torch import darray as td

torch.set_num_threads(1)

LAT = np.linspace(90, -90, 13)  # descending, poles included
LON = np.linspace(0, 360, 24, endpoint=False)
INITS = np.array(['2019-12-30T00', '2019-12-31T18', '2020-01-01T06',
                  '2020-02-29T12', '2020-06-15T00', '2021-01-03T23'],
                 dtype='datetime64[ns]')
LEADS = (np.array([0, 6, 24, 30, 120]) * np.timedelta64(1, 'h')).astype(
    'timedelta64[ns]')
STATIONS = np.array(['a', 'b', 'c', 'a', 'zz', 'b', 'c'])


def _grid_stat(mod):
  return mod.DimArray(
      np.zeros((len(INITS), len(LEADS), len(LAT), len(LON)), np.float32),
      ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': INITS, 'lead_time': LEADS, 'latitude': LAT,
       'longitude': LON,
       'valid_time': mod.Coord(('init_time', 'lead_time'),
                               INITS[:, None] + LEADS[None, :])})


def _sparse_stat(mod):
  n = len(STATIONS)
  return mod.DimArray(
      np.zeros(n, np.float32), ('index',),
      {'station': mod.Coord(('index',), STATIONS),
       'lead': mod.Coord(('index',), np.array([6, 12, 6, 24, 12, 6, 6])),
       'elevation': mod.Coord(('index',), np.array(
           [10.0, 100.0, 1000.0, 50.0, 0.0, 2000.0, 99.999])),
       'valid_time': mod.Coord(('index',), INITS[np.arange(n) % len(INITS)]),
       'index': np.arange(n)})


def _land_fraction(mod, ascending):
  frac = np.random.default_rng(0).random((len(LAT), len(LON))).astype(
      np.float32)
  lat = LAT
  if ascending:  # stored in the opposite latitude order to the statistic
    frac, lat = frac[::-1], LAT[::-1]
  return mod.DimArray(np.ascontiguousarray(frac), ('latitude', 'longitude'),
                      {'latitude': lat, 'longitude': LON})


REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-20, 20), (0, 360)),
           'dateline': ((-90, 90), (170, -170)),
           'europe': ((35, 75), (-12.5, 42.5))}

# name -> (statistic factory, binning factory given the module pair)
CASES = {
    'regions': (_grid_stat, lambda b, m: b.Regions(REGIONS)),
    'regions_land_sea': (_grid_stat, lambda b, m: b.Regions(
        REGIONS, land_sea_mask=_land_fraction(m, True))),
    'land_sea': (_grid_stat, lambda b, m: b.LandSea(_land_fraction(m, False))),
    'land_sea_flipped_global': (_grid_stat, lambda b, m: b.LandSea(
        _land_fraction(m, True), land_sea_threshold=0.3,
        include_global_mask=True)),
    'latitude_bins': (_grid_stat, lambda b, m: b.LatitudeBins(30)),
    'latitude_bins_range': (_grid_stat, lambda b, m: b.LatitudeBins(
        15, lat_range=(-30, 60), bin_dim_name='band')),
    'longitude_bins': (_grid_stat, lambda b, m: b.LongitudeBins(90.0)),
    'longitude_bins_wrap': (_grid_stat, lambda b, m: b.LongitudeBins(
        60.0, lon_range=(300, 60))),
    'by_exact_coord': (_sparse_stat, lambda b, m: b.ByExactCoord('lead')),
    'by_exact_coord_global': (_sparse_stat, lambda b, m: b.ByExactCoord(
        'lead', add_global_bin=True)),
    'by_exact_coord_strings': (_sparse_stat, lambda b, m: b.ByExactCoord(
        'station', add_global_bin=True)),
    'by_exact_coord_2d': (_grid_stat, lambda b, m: b.ByExactCoord(
        'valid_time')),
    'by_time_unit_hour': (_grid_stat, lambda b, m: b.ByTimeUnit(
        'hour', 'init_time')),
    'by_time_unit_month_global': (_grid_stat, lambda b, m: b.ByTimeUnit(
        'month', 'init_time', add_global_bin=True)),
    'by_time_unit_lead_hour': (_grid_stat, lambda b, m: b.ByTimeUnit(
        'hour', 'lead_time')),
    'by_time_unit_lead_day': (_grid_stat, lambda b, m: b.ByTimeUnit(
        'day', 'lead_time')),
    'by_time_unit_2d_valid_time': (_grid_stat, lambda b, m: b.ByTimeUnit(
        'dayofyear', 'valid_time')),
    'by_time_unit_sets_month': (_grid_stat, lambda b, m: b.ByTimeUnitSets(
        {'DJF': [12, 1, 2], 'JJA': [6, 7, 8]}, unit='month',
        dim='init_time', add_global_bin=True)),
    'by_time_unit_sets_scalar_member': (
        _grid_stat, lambda b, m: b.ByTimeUnitSets(
            {'day1': 1, 'later': [2, 5]}, unit='day', dim='lead_time',
            bin_dim_name='lead_sets')),
    'by_coord_bins': (_sparse_stat, lambda b, m: b.ByCoordBins(
        'elevation', np.array([0.0, 100.0, 2000.0]))),
    'by_coord_bins_global': (_sparse_stat, lambda b, m: b.ByCoordBins(
        'elevation', np.array([0.0, 100.0, 2000.0]), add_global_bin=True)),
    'by_sets': (_sparse_stat, lambda b, m: b.BySets(
        {'ab': ['a', 'b'], 'only_c': 'c'}, 'station',
        bin_dim_name='station_set')),
    'by_sets_complements_global': (_sparse_stat, lambda b, m: b.BySets(
        {'ab': ['a', 'b'], 'none': ['q']}, 'station',
        bin_dim_name='station_set', add_set_complements=True,
        add_global_bin=True)),
    'by_sets_ints': (_sparse_stat, lambda b, m: b.BySets(
        {'short': [6, 12]}, 'lead', bin_dim_name='lead_set',
        add_set_complements=True)),
}


def _same_mask(got, want):
  assert got.dims == tuple(want.dims)
  w = np.asarray(want.values)
  assert got.values.dtype == bool and w.dtype == bool
  np.testing.assert_array_equal(got.values, w)
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    g, wv = got.coord_values(name), np.asarray(c.values)
    assert g.dtype.kind == wv.dtype.kind, (name, g.dtype, wv.dtype)
    if wv.dtype.kind == 'f':
      np.testing.assert_array_equal(g, wv, err_msg=name)  # NaN == NaN here
    else:
      np.testing.assert_array_equal(g, wv, err_msg=name)


@pytest.mark.parametrize('name', sorted(CASES))
def test_bin_mask_matches_jax(name):
  stat, make = CASES[name]
  t_bin, j_bin = make(tb, td), make(jb, jd)
  assert t_bin.bin_dim_name == j_bin.bin_dim_name
  got = t_bin.create_bin_mask(stat(td))
  assert isinstance(got.data, torch.Tensor) and got.device.type == 'cpu'
  _same_mask(got, j_bin.create_bin_mask(stat(jd)))


@pytest.mark.parametrize('name', sorted(CASES))
def test_host_coords_cover_the_jax_packages(name):
  """Every coord the JAX binning keeps on the host is named by the port's
  too (the port also names the coords whose values key its mask cache)."""
  _, make = CASES[name]
  assert set(make(jb, jd).host_coords) <= set(make(tb, td).host_coords)


def test_by_exact_coord_refuses_a_dimension():
  with pytest.raises(ValueError, match='reduce_dims'):
    tb.ByExactCoord('index').create_bin_mask(_sparse_stat(td))
  with pytest.raises(ValueError, match='bin_dim_name'):
    tb.BySets({'a': ['a']}, 'station')
  with pytest.raises(ValueError, match='bin_dim_name'):
    tb.BySets({'a': ['a']}, 'station', bin_dim_name='station')


@pytest.mark.parametrize('global_bin', [False, True])
@pytest.mark.parametrize('values', [
    np.zeros((0,), np.int64), np.zeros((0, 3), np.int64),
    np.array([3, 1, 3, 2]), np.array([[1, 2], [2, 1]]),
    np.array(['x', 'y', 'x'])], ids=['empty', 'empty2d', 'ints', '2d', 'str'])
def test_vectorized_coord_mask_matches_jax(values, global_bin):
  dims = ('index',) if values.ndim == 1 else ('a', 'b')
  got = tb.vectorized_coord_mask(values, dims, 'bin', global_bin)
  want = jb.vectorized_coord_mask(values, dims, 'bin', global_bin)
  _same_mask(got, want)
  assert got.shape[0] == len(np.unique(values)) + int(global_bin)


# -- _extract_time_unit against pandas ------------------------------------------

_DATES = np.concatenate([
    np.arange('2015-12-25', '2016-01-10', dtype='datetime64[D]'),
    np.arange('2020-02-26', '2020-03-03', dtype='datetime64[D]'),
    np.arange('2020-12-26', '2021-01-06', dtype='datetime64[D]'),
    np.array(['1969-12-31', '1970-01-01', '2000-02-29', '2100-03-01',
              '1900-01-01'], dtype='datetime64[D]'),
]).astype('datetime64[ns]') + np.timedelta64(13 * 3600 + 47 * 60 + 59, 's')

_PANDAS_UNITS = ['year', 'month', 'day', 'hour', 'minute', 'second',
                 'dayofyear', 'day_of_year', 'dayofweek', 'day_of_week',
                 'weekday', 'quarter']


@pytest.mark.parametrize('unit', _PANDAS_UNITS + ['week', 'weekofyear'])
def test_extract_time_unit_matches_pandas(unit):
  got = tb._extract_time_unit(_DATES, unit)
  index = pd.DatetimeIndex(_DATES)
  want = (index.isocalendar().week if unit in ('week', 'weekofyear')
          else getattr(index, unit))
  assert got.dtype == np.int64
  np.testing.assert_array_equal(got, np.asarray(want, np.int64))


# Every unit the JAX package's function (pandas.DatetimeIndex attributes)
# takes on these dates, written out: the port's list, then the 14 it
# refused before (bool, int and object units).
_JAX_UNITS = _PANDAS_UNITS + [
    'microsecond', 'nanosecond', 'days_in_month', 'daysinmonth',
    'is_leap_year', 'is_month_start', 'is_month_end', 'is_quarter_start',
    'is_quarter_end', 'is_year_start', 'is_year_end', 'date', 'time',
    'timetz']

# Sub-second parts on month, quarter and year ends and starts, leap days
# and the century years 1900 (not leap), 2000 (leap) and 2100 (not leap).
_SUBSECOND_DATES = np.array([
    '1900-01-01T00:00:00.000000001', '1900-02-28T23:59:59.999999999',
    '1900-03-01T12:30:00.5', '2000-02-29T23:59:59.999999', '2000-03-31',
    '2020-06-30T18:00:00.000001', '2020-07-01T00:00:00.123456789',
    '2020-09-30T23:59:59.9', '2020-12-31T23:59:59.999999999',
    '2021-01-01T00:00:00.000000999', '2100-02-28T06:00:00.25',
    '2100-12-31T00:00:00.000999'], dtype='datetime64[ns]')


@pytest.mark.parametrize('unit', _JAX_UNITS)
def test_extract_time_unit_matches_jax_package(unit):
  for dates in (_DATES, _SUBSECOND_DATES):
    got, want = (tb._extract_time_unit(dates, unit),
                 jb._extract_time_unit(dates, unit))
    np.testing.assert_array_equal(got, want)
    assert got.dtype.kind == {'i': 'i', 'b': 'b', 'O': 'O'}[want.dtype.kind]
    if got.dtype.kind == 'O':
      assert [type(g) for g in got] == [type(w) for w in want]
  grid = _DATES[:12].reshape(3, 4)  # a 2-D coord keeps its shape
  assert tb._extract_time_unit(grid, unit).shape == (3, 4)
  np.testing.assert_array_equal(tb._extract_time_unit(grid, unit),
                                jb._extract_time_unit(grid, unit))


def _subsecond_stat(mod):
  return mod.DimArray(
      np.zeros((len(_SUBSECOND_DATES), 2), np.float32), ('init_time', 'x'),
      {'init_time': _SUBSECOND_DATES, 'x': np.arange(2)})


# One unit of each kind, with sets of its own labels (and one that no
# label matches: a date set given as a string).
_UNIT_KIND_SETS = {
    'microsecond': {'zero': [0], 'half': [500000, 250000]},
    'is_month_end': {'end': [True], 'not_end': False},
    'date': {'leap_day': [datetime.date(2000, 2, 29)],
             'as_string': ['2000-02-29']},
    'time': {'midnight': datetime.time(0, 0),
             'late': [datetime.time(23, 59, 59, 999999)]},
}


@pytest.mark.parametrize('global_bin', [False, True])
@pytest.mark.parametrize('unit', sorted(_UNIT_KIND_SETS))
def test_time_unit_binnings_of_each_kind_match_jax(unit, global_bin):
  got = tb.ByTimeUnit(unit, 'init_time', global_bin).create_bin_mask(
      _subsecond_stat(td))
  want = jb.ByTimeUnit(unit, 'init_time', global_bin).create_bin_mask(
      _subsecond_stat(jd))
  _same_mask(got, want)
  assert got.sizes[f'init_time_{unit}'] > 1 + global_bin
  sets = _UNIT_KIND_SETS[unit]
  got = tb.ByTimeUnitSets(sets, unit, 'init_time',
                          add_global_bin=global_bin).create_bin_mask(
                              _subsecond_stat(td))
  want = jb.ByTimeUnitSets(sets, unit, 'init_time',
                           add_global_bin=global_bin).create_bin_mask(
                               _subsecond_stat(jd))
  _same_mask(got, want)
  assert got.values[0].any()


def _unit_state(agg_mod, b, m, unit):
  stat = _subsecond_stat(m)
  stat = stat.copy(data=np.arange(stat.size, dtype=np.float32).reshape(
      stat.shape)) if m is td else m.DimArray(
          np.arange(24, dtype=np.float32).reshape(12, 2), stat.dims,
          stat.coords)
  return agg_mod.Aggregator(
      reduce_dims=['x'], bin_by=[b.ByTimeUnit(unit, 'init_time')]
  ).aggregate_statistics({'S': {'v': stat}})


@pytest.mark.parametrize('suffix', ['.npz', '.wbx', '.zarr', '.nc'])
@pytest.mark.parametrize('unit', ['microsecond', 'is_year_end'])
def test_int_and_bool_unit_labels_survive_a_save_as_in_jax(tmp_path, unit,
                                                          suffix):
  got = _unit_state(aggregation, tb, td, unit)
  want = _unit_state(j_aggregation, jb, jd, unit)
  got.save(str(tmp_path / f'port{suffix}'))
  want.save(str(tmp_path / f'jax{suffix}'))
  name = f'init_time_{unit}'
  for path in (f'port{suffix}', f'jax{suffix}'):
    back = aggregation.AggregationState.load(str(tmp_path / path))
    labels = back.sum_weights['S']['v'].coord_values(name)
    j_back = j_aggregation.AggregationState.load(str(tmp_path / path))
    np.testing.assert_array_equal(
        labels, np.asarray(j_back.sum_weights['S']['v'].coords[name].values))
    np.testing.assert_array_equal(
        labels, np.asarray(want.sum_weights['S']['v'].coords[name].values))
    np.testing.assert_array_equal(
        back.sum_weighted_statistics['S']['v'].values,
        got.sum_weighted_statistics['S']['v'].values)


@pytest.mark.parametrize('unit', ['date', 'time'])
def test_object_unit_labels_save_and_refuse_as_in_jax(tmp_path, unit):
  """Date and time labels are object arrays: .npz and zarr write them and
  refuse to read them back, .nc refuses to write them, in both packages
  with ValueError. The port's .wbx refuses to write them, where the JAX
  package's writes the objects' addresses, which another process reads
  into a crash."""
  got = _unit_state(aggregation, tb, td, unit)
  want = _unit_state(j_aggregation, jb, jd, unit)
  name = f'init_time_{unit}'
  np.testing.assert_array_equal(
      got.sum_weights['S']['v'].coord_values(name),
      np.asarray(want.sum_weights['S']['v'].coords[name].values))
  for suffix in ('.npz', '.zarr'):
    got.save(str(tmp_path / f'port{suffix}'))
    want.save(str(tmp_path / f'jax{suffix}'))
    for path in (f'port{suffix}', f'jax{suffix}'):
      with pytest.raises(ValueError):
        aggregation.AggregationState.load(str(tmp_path / path))
      with pytest.raises(ValueError):
        j_aggregation.AggregationState.load(str(tmp_path / path))
  for state in (got, want):
    with pytest.raises(ValueError, match='NetCDF 3'):
      state.save(str(tmp_path / 'x.nc'))
  with pytest.raises(ValueError, match='object array'):
    got.save(str(tmp_path / 'port.wbx'))
  assert not (tmp_path / 'port.wbx').exists()
  want.save(str(tmp_path / 'jax.wbx'))  # the addresses: read them nowhere
  with pytest.raises(ValueError, match='object array'):
    aggregation.AggregationState.load(str(tmp_path / 'jax.wbx'))


@pytest.mark.parametrize('unit', ['second', 'minute', 'hour', 'day', 'week',
                                  'year'])
def test_extract_timedelta_unit_matches_jax_package(unit):
  deltas = (np.array([0, 59, 3599, 3600, 86399, 86400, 8 * 86400 + 5,
                      400 * 86400]) * np.timedelta64(1, 's')).astype(
                          'timedelta64[ns]')
  np.testing.assert_array_equal(tb._extract_time_unit(deltas, unit),
                                jb._extract_time_unit(deltas, unit))


def test_extract_time_unit_names_an_unknown_unit():
  with pytest.raises(ValueError, match='fortnight'):
    tb._extract_time_unit(_DATES, 'fortnight')
  with pytest.raises(ValueError, match='month'):
    tb._extract_time_unit(LEADS, 'month')
  with pytest.raises(ValueError, match='int64'):
    tb._extract_time_unit(np.arange(3), 'hour')


# -- ByTimeUnitFromSeconds ------------------------------------------------------


@pytest.mark.parametrize('kind', ['numpy', 'tensor'])
@pytest.mark.parametrize('unit,bins', [('hour', None), ('hour', [0, 6, 23]),
                                       ('minute', None), ('second', [0, 59]),
                                       ('day', [0, 1, -1])])
def test_by_time_unit_from_seconds_matches_jax(unit, bins, kind):
  secs = np.array([0, 59, 3600 * 6 + 61, 86399, 86400 + 3600 * 23, -1,
                   -3601], np.int64)
  if unit in ('minute', 'second'):
    secs = secs % 3600
  stat_j = jd.DimArray(np.zeros(len(secs), np.float32), ('valid_time',), {
      'valid_time': jd.Coord(('valid_time',), jnp.asarray(secs))})
  stat_t = td.DimArray(np.zeros(len(secs), np.float32), ('valid_time',), {
      'valid_time': td.Coord(('valid_time',), torch.from_numpy(secs)
                             if kind == 'tensor' else secs)})
  got = tb.ByTimeUnitFromSeconds(unit, 'valid_time', bins).create_bin_mask(
      stat_t)
  want = jb.ByTimeUnitFromSeconds(unit, 'valid_time', bins).create_bin_mask(
      stat_j)
  assert got.dims == tuple(want.dims) == ('valid_time_' + unit, 'valid_time')
  np.testing.assert_array_equal(got.values, np.asarray(want.values))
  np.testing.assert_array_equal(got.coord_values('valid_time_' + unit),
                                want.coord_values('valid_time_' + unit))


def test_by_time_unit_from_seconds_refuses_what_jax_refuses():
  stat = td.DimArray(np.zeros(2, np.float32), ('t',),
                     {'t': td.Coord(('t',), np.array([0, 5]))})
  with pytest.raises(ValueError, match='Unsupported unit'):
    tb.ByTimeUnitFromSeconds('month', 't').create_bin_mask(stat)
  with pytest.raises(ValueError, match='bins'):
    tb.ByTimeUnitFromSeconds('day', 't').create_bin_mask(stat)


# -- BySets: typed arrays only ----------------------------------------------------


def test_by_sets_gives_isin_typed_arrays(monkeypatch):
  """``np.isin`` never sees an object array: on those it compares element
  by element in Python, which dominated a station evaluation's wall time."""
  seen = []
  real = np.isin

  def spy(element, test_elements, **kwargs):
    seen.append((np.asarray(element).dtype, np.asarray(test_elements).dtype))
    return real(element, test_elements, **kwargs)

  monkeypatch.setattr(np, 'isin', spy)
  stations = np.array(['a', 'b', 'c', None], dtype=object)
  stat = td.DimArray(np.zeros(4, np.float32), ('index',),
                     {'station': td.Coord(('index',), stations)})
  mask = tb.BySets({'ab': ['a', 'b'], 'mixed': ['c', 7]}, 'station',
                   bin_dim_name='station_set').create_bin_mask(stat)
  np.testing.assert_array_equal(
      mask.values, [[True, True, False, False], [False, False, True, False]])
  assert seen and all(a.kind != 'O' and b.kind != 'O' for a, b in seen)


# -- through the aggregator, and string labels through a saved state --------------


def _aggregators(mod_agg, b, m):
  return mod_agg.Aggregator(
      reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'],
      bin_by=[b.LandSea(_land_fraction(m, True), include_global_mask=True),
              b.LatitudeBins(30), b.ByTimeUnit('hour', 'lead_time')])


def _field(mod):
  x = np.random.default_rng(7).standard_normal(
      (len(INITS), len(LEADS), len(LAT), len(LON))).astype(np.float32)
  return _grid_stat(mod).copy(data=x) if mod is td else jd.DimArray(
      x, _grid_stat(jd).dims, _grid_stat(jd).coords)


def test_three_binnings_aggregate_like_jax_and_labels_survive_a_save(tmp_path):
  stats_t = {'SquaredError': {'t2m': _field(td)}}
  stats_j = {'SquaredError': {'t2m': _field(jd)}}
  got = _aggregators(aggregation, tb, td).aggregate_statistics(stats_t)
  want = _aggregators(j_aggregation, jb, jd).aggregate_statistics(stats_j)
  g = got.mean_statistics()['SquaredError']['t2m']
  w = want.mean_statistics()['SquaredError']['t2m']
  assert g.dims == tuple(w.dims) == ('land_sea', 'latitude_bins',
                                     'lead_time_hour')
  np.testing.assert_allclose(g.values, np.asarray(w.values), rtol=0,
                             atol=1e-5, equal_nan=True)
  assert list(got.to_dataset()) == list(want.to_dataset())
  path = str(tmp_path / 'state.npz')
  got.save(path)
  back = aggregation.AggregationState.load(path)
  labels = back.sum_weights['SquaredError']['t2m'].coord_values('land_sea')
  assert labels.dtype.kind == 'U'
  np.testing.assert_array_equal(labels, ['land', 'sea', 'global'])
  np.testing.assert_array_equal(
      back.sum_weights['SquaredError']['t2m'].coord_values('lead_time_hour'),
      w.coord_values('lead_time_hour'))
  # A JAX state converts with its string and number labels, and sums with
  # the port's.
  conv = convert.state_from_reference(want)
  both = (got + conv).mean_statistics()['SquaredError']['t2m']
  np.testing.assert_array_equal(both.coord_values('land_sea'),
                                ['land', 'sea', 'global'])
  np.testing.assert_allclose(both.values, g.values, rtol=1e-5, atol=1e-5,
                             equal_nan=True)


def test_convert_keeps_string_and_datetime_coords():
  stat = _sparse_stat(jd)
  got = convert.dimarray_from_reference(stat)
  assert got.coord_values('station').dtype.kind == 'U'
  assert got.coord_values('valid_time').dtype == np.dtype('datetime64[ns]')
  np.testing.assert_array_equal(got.coord_values('station'), STATIONS)
  _same_mask(tb.ByTimeUnit('month', 'valid_time').create_bin_mask(got),
             jb.ByTimeUnit('month', 'valid_time').create_bin_mask(stat))


def test_bin_masks_are_rebuilt_when_a_read_coord_changes():
  """The layout key takes the coords a binning reads by content: two
  chunks of one shape with different lead times get their own masks."""
  agg = aggregation.Aggregator(
      reduce_dims=['lead_time'], bin_by=[tb.ByTimeUnit('hour', 'lead_time')])

  def stat(leads):
    return td.DimArray(np.ones(2, np.float32), ('lead_time',), {
        'lead_time': (np.array(leads) * np.timedelta64(1, 'h')).astype(
            'timedelta64[ns]')})
  cache = {}
  a = agg.prepare_operands({'s': {'v': stat([0, 6])}}, cache)
  b = agg.prepare_operands({'s': {'v': stat([12, 18])}}, cache)
  c = agg.prepare_operands({'s': {'v': stat([0, 6])}}, cache)
  assert len(cache) == 2 and a['s']['v'] is c['s']['v']
  np.testing.assert_array_equal(
      b['s']['v'][0].coord_values('lead_time_hour'), [12, 18])
