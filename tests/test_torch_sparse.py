"""The port's sparse path against the JAX package's, on the CPU.

* Every interpolation class of ``interpolations`` on the same seeded grids
  and station references in both packages: values, dims and coords. Plain
  interpolation is bit-equal for float32 data; the altitude adjustment is
  computed from float64 elevations and added in the data's dtype in the
  port (float32 stays float32), where the JAX package under x64 promotes
  to float64, so adjusted values agree to rtol 1e-6.
* The Parquet loaders on the same pandas-written hive-partitioned files,
  cached and uncached, with tolerances, duplicate removal, METAR QC and
  ``dropna``: every value and coord exactly.
* ``pad_dim_to_multiple`` on every dtype a port DimArray holds, and its
  coords (strings, datetimes, numbers, masks) against the JAX package's.
* ``DataLoader.load_chunk`` in the JAX package's order: interpolation
  against the reference, NaN mask, index padding, values as a coord.
"""

import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import interpolations as j_interpolations
from weatherbenchx_tpu.data import base as j_data_base
from weatherbenchx_tpu.data import loaders as j_loaders
from weatherbenchx_tpu.data import sparse_parquet as j_sparse_parquet
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import interpolations
from weatherbenchx_tpu_torch.data import base as data_base
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.data import sparse_parquet

torch.set_num_threads(1)

PKG = {'torch': (td, interpolations), 'jax': (jd, j_interpolations)}
LAT = np.linspace(-90, 90, 13)
LON = np.linspace(0, 360, 24, endpoint=False)
N_STATIONS = 17


def _grid(mod, seed=0, dtype=np.float32, mask=False):
  rng = np.random.default_rng(seed)
  coords = {'latitude': LAT, 'longitude': LON,
            'time': np.arange(2)}
  if mask:
    m = rng.random((13, 24)) > 0.2
    coords['mask'] = mod.Coord(('latitude', 'longitude'), m)
  return mod.DimArray(
      (270 + rng.standard_normal((2, 13, 24))).astype(dtype),
      ('time', 'latitude', 'longitude'), coords)


def _stations(mod, n=N_STATIONS, seed=1):
  rng = np.random.default_rng(seed)
  return mod.DimArray(
      np.zeros(n, np.float32), ('index',),
      {'index': np.arange(n),
       'latitude': mod.Coord(('index',), rng.uniform(-89, 89, n)),
       'longitude': mod.Coord(('index',), rng.uniform(0, 360, n)),
       'elevation': mod.Coord(('index',), rng.uniform(-50, 2500, n)),
       'stationName': mod.Coord(('index',),
                                np.array([f'ST{i:03d}' for i in range(n)]))})


def _elevation(mod, dtype):
  rng = np.random.default_rng(2)
  return mod.DimArray((rng.random((13, 24)) * 1500).astype(dtype),
                      ('latitude', 'longitude'),
                      {'latitude': LAT, 'longitude': LON})


def _assert_da_match(got, want, rtol=0.0, atol=0.0):
  assert got.dims == tuple(want.dims)
  w = np.asarray(want.values)
  if rtol or atol:
    np.testing.assert_allclose(got.values, w, rtol=rtol, atol=atol)
  else:
    np.testing.assert_array_equal(got.values, w)
  assert sorted(got.coords) == sorted(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    np.testing.assert_array_equal(got.coord_values(name),
                                  np.asarray(c.values), err_msg=name)


def _interpolations(kind, mod, lib):
  if kind == 'fixed':
    return lib.InterpolateToFixedCoords(
        'linear', {'latitude': np.array([-45.5, 0.0, 12.25]),
                   'longitude': np.array([10.0, 200.0, 359.0])},
        wrap_longitude=True)
  if kind == 'fixed_nearest_no_extrapolation':
    return lib.InterpolateToFixedCoords(
        'nearest', {'latitude': np.array([-95.0, 12.25])},
        extrapolate_out_of_bounds=False)
  if kind == 'reference':
    return lib.InterpolateToReferenceCoords('linear', wrap_longitude=True)
  if kind == 'reference_clipped':
    return lib.InterpolateToReferenceCoords(
        'nearest', clip_reference_coords=['latitude'])
  if kind == 'crop':
    return lib.CropToBox(-30, 30, 45, 180)
  if kind == 'subsample':
    return lib.Subsample(['longitude', 'latitude'], 3)
  if kind == 'multiple':
    return lib.MultipleInterpolation([
        lib.Subsample(['longitude'], 2),
        lib.InterpolateToReferenceCoords('linear')])
  raise ValueError(kind)


@pytest.mark.parametrize('kind', [
    'fixed', 'fixed_nearest_no_extrapolation', 'reference',
    'reference_clipped', 'crop', 'subsample', 'multiple'])
@pytest.mark.parametrize('mask', [False, True])
def test_interpolation_matches_jax(kind, mask):
  out = {}
  for name, (mod, lib) in PKG.items():
    ref = _stations(mod)
    out[name] = _interpolations(kind, mod, lib).interpolate(
        {'t': _grid(mod, mask=mask)}, {'t': ref})['t']
  _assert_da_match(out['torch'], out['jax'])
  if mask and kind not in ('crop', 'subsample'):
    assert out['torch'].coords['mask'].values.dtype == np.bool_


@pytest.mark.parametrize('elevation_dtype', [np.float64, np.float32,
                                             np.int32])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_altitude_adjustment_matches_jax(elevation_dtype, method):
  out = {}
  for name, (mod, lib) in PKG.items():
    ref = _stations(mod)
    interp = lib.MultipleInterpolation([
        lib.GridToSparseWithAltitudeAdjustment(
            method, grid_elevation=_elevation(mod, elevation_dtype),
            wrap_longitude=True)])
    grid = _grid(mod)
    out[name] = interp.interpolate(
        {'2m_temperature': grid, '10m_wind_speed': grid - 265, 'z': grid},
        {k: ref for k in ('2m_temperature', '10m_wind_speed', 'z')})
  for var in out['jax']:
    got = out['torch'][var]
    assert got.dtype == torch.float32, var  # the data's dtype is kept
    _assert_da_match(got, out['jax'][var], rtol=1e-6, atol=1e-5)
  # Some stations sit over 100 m and over 1100 m above the grid, some
  # beyond the 1500 m cap: every branch of the adjustment is exercised.
  diff = (out['torch']['2m_temperature'].coord_values('elevation')
          - out['torch']['2m_temperature'].coord_values('grid_elevation'))
  assert (diff > 1100).any() and (np.abs(diff) > 1500).any()
  assert ((diff > 100) & (diff < 1100)).any()


@pytest.mark.parametrize('variable', ['2m_temperature', 'z'])
def test_empty_reference_matches_jax(variable):
  out = {}
  for name, (mod, lib) in PKG.items():
    ref = _stations(mod, n=0)
    interp = lib.GridToSparseWithAltitudeAdjustment(
        'linear', grid_elevation=_elevation(mod, np.float64))
    out[name] = interp.interpolate({variable: _grid(mod)},
                                   {variable: ref})[variable]
  assert out['torch'].sizes == {'time': 2, 'index': 0}
  _assert_da_match(out['torch'], out['jax'])


def test_neighborhood_threshold_probabilities_matches_jax():
  out = {}
  for name, (mod, lib) in PKG.items():
    interp = lib.NeighborhoodThresholdProbabilities(
        neighborhood_sizes=[1, 3, 5], thresholds=[270.0, 270.5],
        wrap_longitude=True)
    out[name] = interp.interpolate_data_array(_grid(mod))
  _assert_da_match(out['torch'], out['jax'], atol=1e-6)
  assert out['torch'].dims[0] == 'smoothing_neighborhood'


def test_pad_longitude_and_interpolate_to_coords_match_jax():
  got = interpolations.pad_longitude(_grid(td))
  want = j_interpolations.pad_longitude(_grid(jd))
  _assert_da_match(got, want)
  assert got.sizes['longitude'] == 26
  stations = {d: td.DimArray(_stations(td).coord_values(d), ('index',))
              for d in ('latitude', 'longitude')}
  j_stations = {d: jd.DimArray(_stations(jd).coord_values(d), ('index',))
                for d in ('latitude', 'longitude')}
  _assert_da_match(
      interpolations.interpolate_to_coords(_grid(td), stations, 'linear'),
      j_interpolations.interpolate_to_coords(_grid(jd), j_stations,
                                             'linear'))
  for lib, mod in ((interpolations, td), (j_interpolations, jd)):
    with pytest.raises(ValueError, match='Unsupported interpolation'):
      lib.interpolate_to_coords(_grid(mod), {'latitude': np.zeros(1)},
                                'cubic')


# -- Parquet loaders ------------------------------------------------------------


def _write_parquet(tmp_path, n_stations=6):
  import pandas as pd

  times = np.arange('2020-01-31T00', '2020-02-02T00', np.timedelta64(3, 'h'),
                    dtype='datetime64[ns]')
  rng = np.random.default_rng(0)
  rows = []
  for t in times:
    for s in range(n_stations):
      rows.append({
          'timeNominal': pd.Timestamp(t),
          'timeObs': pd.Timestamp(t + np.timedelta64(int(rng.integers(
              -20, 20)), 'm')),
          'stationName': f'ST{s}',
          'latitude': -60.0 + 25.0 * s,
          'longitude': -170.0 + 60.0 * s,
          'elevation': 9999.0 if s == 2 else 100.0 * s,
          'temperature': np.nan if s == 4 else 270.0 + rng.standard_normal(),
          'temperatureDD': 'Z' if s == 3 else 'S',
          'windSpeed': 5.0 + rng.standard_normal(),
          'windSpeedDD': 'B' if s == 1 else 'V',
          'cloudCount': np.int64(s),
      })
      if s == 0:  # a duplicate report, 10 minutes late
        dup = dict(rows[-1])
        dup['timeNominal'] = pd.Timestamp(t + np.timedelta64(10, 'm'))
        dup['temperature'] = 300.0
        rows.append(dup)
  df = pd.DataFrame(rows)
  path = str(tmp_path / 'obs')
  for (month, day), g in df.groupby([df.timeNominal.dt.month,
                                     df.timeNominal.dt.day]):
    fn = os.path.join(path, 'year=2020', f'month={month}', f'day={day}',
                      f'2020-{month:02d}-{day:02d}.parquet')
    os.makedirs(os.path.dirname(fn), exist_ok=True)
    g.to_parquet(fn)
  return path


@pytest.fixture(scope='module')
def parquet_path(tmp_path_factory):
  return _write_parquet(tmp_path_factory.mktemp('parquet'))


INIT = np.array(['2020-01-31T12', '2020-02-01T00'], dtype='datetime64[ns]')
LEAD = np.array([0, 3, 12], dtype='timedelta64[h]').astype('timedelta64[ns]')
LOADER_CASES = {
    'exact': dict(variables=['temperature', 'windSpeed']),
    'tolerance_dedup': dict(
        variables=['temperature'], tolerance=np.timedelta64(30, 'm'),
        remove_duplicates=True, observation_dim='stationName',
        pick_closest_duplicate_by='timeNominal'),
    'asymmetric_tolerance': dict(
        variables=['temperature'],
        tolerance=(np.timedelta64(-1, 'h'), np.timedelta64(2, 'h')),
        include_slice_end_time=True),
    'dropna': dict(variables=['temperature', 'windSpeed'], dropna=True),
    'dropna_split': dict(variables=['temperature', 'cloudCount'],
                         dropna=True, split_variables=True),
    'renamed_with_time_coord': dict(
        variables=['t'], rename_variables={'temperature': 't'},
        extra_coords=['timeObs']),
}


def _loader(lib, case, path, cache_files, **kwargs):
  kw = dict(LOADER_CASES[case])
  extra = kw.pop('extra_coords', [])
  return lib.SparseObservationsFromParquet(
      path=path, partitioned_by='day', time_dim='timeNominal',
      coordinate_variables=['latitude', 'longitude', 'elevation',
                            'stationName'] + extra,
      cache_files=cache_files, **kw, **kwargs)


def _assert_chunks_match(got, want):
  assert sorted(got) == sorted(want)
  for var in want:
    _assert_da_match(got[var], want[var])


@pytest.mark.parametrize('cache_files', [0, 3])
@pytest.mark.parametrize('case', list(LOADER_CASES))
def test_parquet_loader_matches_jax(parquet_path, case, cache_files):
  got = _loader(sparse_parquet, case, parquet_path, cache_files).load_chunk(
      INIT, LEAD)
  want = _loader(j_sparse_parquet, case, parquet_path,
                 cache_files).load_chunk(INIT, LEAD)
  _assert_chunks_match(got, want)
  for da in got.values():
    assert isinstance(da.data, torch.Tensor) and da.dims == ('index',)
    assert da.coords['stationName'].values.dtype.kind == 'U'
    assert da.coords['valid_time'].values.dtype == np.dtype('datetime64[ns]')


@pytest.mark.parametrize('lead', ['none', 'interval'])
def test_parquet_loader_lead_forms_match_jax(parquet_path, lead):
  lead_times = None if lead == 'none' else slice(
      np.timedelta64(1, 'h'), np.timedelta64(4, 'h'))
  got = _loader(sparse_parquet, 'exact', parquet_path, 2).load_chunk(
      INIT, lead_times)
  want = _loader(j_sparse_parquet, 'exact', parquet_path, 2).load_chunk(
      INIT, lead_times)
  _assert_chunks_match(got, want)


@pytest.mark.parametrize('cache_files', [0, 4])
def test_metar_loader_matches_jax(parquet_path, cache_files):
  def load(lib):
    return lib.METARFromParquet(
        path=parquet_path, variables=['2m_temperature', '10m_wind_speed'],
        time_dim='timeNominal', partitioned_by='day',
        tolerance=np.timedelta64(30, 'm'), remove_duplicates=True,
        pick_closest_duplicate_by='timeNominal', cache_files=cache_files,
        add_nan_mask=True, pad_index_multiple=8).load_chunk(INIT, LEAD)
  got, want = load(sparse_parquet), load(j_sparse_parquet)
  _assert_chunks_match(got, want)
  t = got['2m_temperature']
  names = t.coord_values('stationName')
  valid = t.coord_values('mask')
  assert t.sizes['index'] % 8 == 0
  assert np.isnan(t.values[(names == 'ST3') & valid]).all()  # QC 'Z'
  assert np.isnan(got['10m_wind_speed'].values[(names == 'ST1')
                                               & valid]).all()  # QC 'B'
  assert (t.coord_values('longitude')[valid] >= 0).all()
  assert np.isnan(t.coord_values('elevation')[valid & (names == 'ST2')]).all()
  # The duplicate (300 K, 10 minutes from the hour) never wins.
  assert not (t.values[valid] == 300.0).any()


def test_non_numeric_variable_is_refused(parquet_path):
  loader = sparse_parquet.SparseObservationsFromParquet(
      path=parquet_path, partitioned_by='day', time_dim='timeNominal',
      variables=['temperatureDD'], coordinate_variables=['stationName'])
  with pytest.raises(TypeError, match="'temperatureDD' has dtype"):
    loader.load_chunk(INIT, LEAD)


def test_window_and_layout_match_jax():
  for lib in (sparse_parquet, j_sparse_parquet):
    with pytest.raises(ValueError, match='partitioned_by'):
      lib.PartitionLayout('week')
    with pytest.raises(ValueError, match='empty tolerance window'):
      lib.SparseObservationsFromParquet(
          path='x', partitioned_by='day', time_dim='t', variables=['v'],
          tolerance=(np.timedelta64(1, 'h'), np.timedelta64(0, 'h')))
  start = np.datetime64('2020-02-01T00', 'ns')
  stop = start + np.timedelta64(2, 'h')
  assert (sparse_parquet.PartitionLayout('hour').files_covering(
      '/r', start, stop) == j_sparse_parquet.PartitionLayout(
          'hour').files_covering('/r', start, stop))
  times = start + np.arange(-5, 200) * np.timedelta64(1, 'm')
  for closed in (False, True):
    w = sparse_parquet.Window(start, stop, closed_end=closed)
    jw = j_sparse_parquet.Window(start, stop, closed_end=closed)
    np.testing.assert_array_equal(w.mask(times), jw.mask(times))
    assert w.sorted_bounds(times) == jw.sorted_bounds(times)
    assert w.predicate('t') == jw.predicate('t')
  t = times[[0, 3, 2, 5]]
  sparse_parquet._check_rowwise_preprocess(t, t[[0, 2]])
  with pytest.raises(ValueError, match='row-wise'):
    sparse_parquet._check_rowwise_preprocess(t, np.sort(t))


# -- pad_dim_to_multiple and load_chunk -------------------------------------


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int64,
                                   np.int32, np.bool_, np.uint8])
@pytest.mark.parametrize('with_mask', [False, True])
def test_pad_dim_to_multiple_matches_jax(dtype, with_mask):
  n = 5
  values = (np.array([2**40 + 7, 1, 0, 3, 1]) if np.dtype(dtype).itemsize == 8
            else np.array([1, 0, 1, 3, 1])).astype(dtype)
  coords = {
      'index': np.arange(n),
      'stationName': ('index', np.array(['a', 'b', 'c', 'd', 'e'])),
      'valid_time': ('index', np.datetime64('2020-01-01', 'ns')
                     + np.arange(n) * np.timedelta64(1, 'h')),
      'latitude': ('index', np.linspace(-10, 10, n)),
      'lead_time': ((), np.timedelta64(6, 'h'))}
  if with_mask:
    coords['mask'] = ('index', np.array([True, False, True, True, True]))
  got = data_base.pad_dim_to_multiple(
      {'v': td.DimArray(values, ('index',), coords),
       'other': td.DimArray(np.zeros(3, dtype), ('x',))}, 'index', 4)
  want = j_data_base.pad_dim_to_multiple(
      {'v': jd.DimArray(values, ('index',), coords),
       'other': jd.DimArray(np.zeros(3, dtype), ('x',))}, 'index', 4)
  _assert_da_match(got['v'], want['v'])
  assert got['v'].dtype == torch.from_numpy(values).dtype
  assert got['v'].sizes['index'] == 8
  assert got['other'].sizes == {'x': 3}
  # An exact multiple that already carries a mask is returned as it is.
  again = data_base.pad_dim_to_multiple(got, 'index', 4)['v']
  assert again is got['v']


def test_pad_dim_extends_a_tensor_mask_on_its_device():
  da = td.DimArray(np.arange(3.0), ('index',),
                   {'mask': td.Coord(('index',), torch.tensor([1, 0, 1],
                                                              dtype=bool)),
                    'w': td.Coord(('index',), torch.tensor([4.0, 5.0, 6.0]))})
  out = data_base.pad_dim_to_multiple({'v': da}, 'index', 4)['v']
  assert out.coords['mask'].values.tolist() == [True, False, True, False]
  assert out.coords['w'].values.tolist() == [4.0, 5.0, 6.0, 4.0]
  assert torch.isnan(out.data[3])


def test_load_chunk_runs_the_jax_order(parquet_path):
  """Grid predictions interpolated to the targets' stations, NaN mask,
  index padding and values-as-coord: the same chunk in both packages."""
  ds = {}
  for name, (mod, lib) in PKG.items():
    inits = np.array(['2020-01-31T12', '2020-02-01T00'], 'datetime64[ns]')
    rng = np.random.default_rng(5)
    grid = mod.DimArray(
        (270 + rng.standard_normal((2, 3, 13, 24))).astype(np.float32),
        ('init_time', 'lead_time', 'latitude', 'longitude'),
        {'init_time': inits, 'lead_time': LEAD, 'latitude': LAT,
         'longitude': LON})
    ds[name] = (mod, lib, {'2m_temperature': grid})
  out = {}
  for name, lib_loaders, lib_sparse in (
      ('torch', loaders, sparse_parquet),
      ('jax', j_loaders, j_sparse_parquet)):
    mod, lib, grid_ds = ds[name]
    targets = lib_sparse.METARFromParquet(
        path=parquet_path, variables=['2m_temperature'],
        time_dim='timeNominal', partitioned_by='day',
        tolerance=np.timedelta64(30, 'm'), remove_duplicates=True,
        pick_closest_duplicate_by='timeNominal', add_nan_mask=True,
        pad_index_multiple=16)
    tchunk = targets.load_chunk(INIT, LEAD)
    predictions = lib_loaders.PredictionsFromDataset(
        ds=grid_ds, rename_dimensions=None, add_nan_mask=True,
        add_values_to_coords=True, pad_index_multiple=16,
        interpolation=lib.InterpolateToReferenceCoords(
            'linear', dims=['latitude', 'longitude'], wrap_longitude=True))
    out[name] = (predictions.load_chunk(INIT, LEAD, reference=tchunk),
                 tchunk)
  for got, want in zip(out['torch'], out['jax']):
    _assert_chunks_match(got, want)
  p = out['torch'][0]['2m_temperature']
  np.testing.assert_array_equal(p.coord_values('values_as_coord'), p.values)
  assert p.sizes['index'] % 16 == 0
