"""The port's spatial metrics (FSS) against the JAX package, on the CPU.

The same seeded binary fields go through ``neighborhood_averaging``, the
three FSS statistics and the ``FSS`` metric of both packages: values to
atol 1e-5, dims, coords (the averaged ``mask`` too) and unique names
exactly. Then the hand cases of the JAX package's own tests.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import weighting as jw
from weatherbenchx_tpu.metrics import spatial as j_spatial
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch import weighting as tw
from weatherbenchx_tpu_torch.metrics import spatial

torch.set_num_threads(1)

ATOL = 1e-5
N_INIT, N_LAT, N_LON = 2, 9, 12
LAT = np.linspace(60, -60, N_LAT)  # descending
LON = np.arange(N_LON) * 30.0
DIMS = ('init_time', 'latitude', 'longitude')


def _field(mod, seed, mask=False, nan=False, order=DIMS):
  rng = np.random.default_rng(seed)
  x = (rng.random((N_INIT, N_LAT, N_LON)) > 0.6).astype(np.float32)
  if nan:
    x[1, 3, 4] = np.nan
  coords = {'init_time': np.arange(N_INIT), 'latitude': LAT,
            'longitude': LON}
  if mask:
    m = np.ones((N_LAT, N_LON), bool)
    m[4, 6] = False
    m[0, :] = False
    coords['mask'] = mod.Coord(('latitude', 'longitude'), m)
  da = mod.DimArray(x, DIMS, coords)
  return da.transpose(*order) if order != DIMS else da


def _same(got, want, atol=ATOL):
  assert got.dims == tuple(want.dims)
  np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=0,
                             atol=atol, equal_nan=True)
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    np.testing.assert_array_equal(got.coord_values(name),
                                  np.asarray(c.values), err_msg=name)


SIZES = {'one': 1, 'three': 3, 'five': 5, 'list': [1, 3, 5], 'tuple': (3,)}


@pytest.mark.parametrize('order', [DIMS, ('latitude', 'init_time',
                                          'longitude')], ids=['lat_lon_last',
                                                              'transposed'])
@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('wrap', [False, True])
@pytest.mark.parametrize('size', sorted(SIZES))
def test_neighborhood_averaging_matches_jax(size, wrap, mask, order):
  got = spatial.neighborhood_averaging(_field(td, 1, mask, order=order),
                                       SIZES[size], wrap)
  want = j_spatial.neighborhood_averaging(_field(jd, 1, mask, order=order),
                                          SIZES[size], wrap)
  _same(got, want)
  if mask:
    assert got.coord_values('mask').dtype == bool


@pytest.mark.parametrize('size', [3, [1, 3], (3, 5)], ids=str)
@pytest.mark.parametrize('wrap', [False, True])
def test_suffix_and_unique_names_match_jax(size, wrap):
  assert spatial.get_suffix(size, wrap) == j_spatial.get_suffix(size, wrap)
  for name in ('SquaredFractionsError', 'SquaredPredictionFraction',
               'SquaredTargetFraction'):
    assert (getattr(spatial, name)(size, wrap).unique_name
            == getattr(j_spatial, name)(size, wrap).unique_name)
  got = spatial.FSS(size, wrap).statistics
  want = j_spatial.FSS(size, wrap).statistics
  assert list(got) == list(want)
  assert ([s.unique_name for s in got.values()]
          == [s.unique_name for s in want.values()])


@pytest.mark.parametrize('nan', [False, True])
@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('name', ['SquaredFractionsError',
                                  'SquaredPredictionFraction',
                                  'SquaredTargetFraction'])
def test_statistic_matches_jax(name, mask, nan):
  got = getattr(spatial, name)([1, 3], True).compute(
      {'v': _field(td, 2, mask, nan)}, {'v': _field(td, 3, mask)})['v']
  want = getattr(j_spatial, name)([1, 3], True).compute(
      {'v': _field(jd, 2, mask, nan)}, {'v': _field(jd, 3, mask)})['v']
  _same(got, want)


def _fss(which, size, wrap, masked, seeds=(4, 5)):
  mod, agg, sp, w = {'torch': (td, aggregation, spatial, tw),
                     'jax': (jd, j_aggregation, j_spatial, jw)}[which]
  aggregator = agg.Aggregator(
      reduce_dims=list(DIMS), weigh_by=[w.GridAreaWeighting()],
      masked=masked)
  return agg.compute_metric_values_for_single_chunk(
      {'fss': sp.FSS(size, wrap)}, aggregator,
      {'v': _field(mod, seeds[0], masked)},
      {'v': _field(mod, seeds[1], masked)})['fss.v']


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('wrap', [False, True])
@pytest.mark.parametrize('size', sorted(SIZES))
def test_fss_metric_matches_jax(size, wrap, masked):
  _same(_fss('torch', SIZES[size], wrap, masked),
        _fss('jax', SIZES[size], wrap, masked))


def test_fss_multi_size_uses_each_sizes_own_mask():
  multi = _fss('torch', [1, 3], True, True)
  assert multi.dims == ('neighborhood_size',)
  np.testing.assert_array_equal(multi.coord_values('neighborhood_size'),
                                [1, 3])
  for i, n in enumerate([1, 3]):
    single = _fss('torch', n, True, True)
    np.testing.assert_allclose(multi.isel(neighborhood_size=i).values,
                               single.values, rtol=1e-6)


def test_per_size_masks_differ_along_the_new_dim():
  out = spatial.neighborhood_averaging(_field(td, 6, mask=True), [1, 3], True)
  mask_c = out.coords['mask']
  assert mask_c.dims == ('neighborhood_size', 'latitude', 'longitude')
  m = out.coord_values('mask')
  assert m[0].sum() > m[1].sum()
  # The invalid cell's whole neighborhood is invalid at size 3.
  assert not m[1][3:6, 5:8].any() and m[0][3:6, 5:8].sum() == 8


def test_hand_cases():
  x = np.zeros((5, 5), np.float32)
  x[2, 2] = 1.0
  out = spatial.neighborhood_averaging(
      td.DimArray(x, ('latitude', 'longitude')), 3)
  want = np.zeros((5, 5), np.float32)
  want[1:4, 1:4] = 1 / 9
  np.testing.assert_allclose(out.values, want, atol=1e-6)
  with pytest.raises(ValueError, match='odd'):
    spatial.neighborhood_averaging(
        td.DimArray(x, ('latitude', 'longitude')), 4)


def test_fss_perfect_and_total_miss():
  p = np.zeros((1, 8, 8), np.float32)
  p[0, 4, 4] = 1
  t = np.zeros((1, 8, 8), np.float32)
  t[0, 1, 1] = 1
  agg = aggregation.Aggregator(reduce_dims=list(DIMS))
  preds = {'v': td.DimArray(p, DIMS)}
  fss = {'fss': spatial.FSS(neighborhood_size_in_pixels=3)}
  assert aggregation.compute_metric_values_for_single_chunk(
      fss, agg, preds, preds)['fss.v'].item() == pytest.approx(1.0)
  assert aggregation.compute_metric_values_for_single_chunk(
      fss, agg, preds, {'v': td.DimArray(t, DIMS)})['fss.v'].item() == (
          pytest.approx(0.0, abs=1e-6))
