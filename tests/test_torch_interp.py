"""The port's ``ops/interp`` against the JAX package's, on the CPU.

Seeded numpy grids (float32 and float64, ascending and descending source
coords, with a size-1 axis) go through every function of both packages:
``fractional_indices``, ``interp_1d_along_axis``, ``interp_outer`` and
``interp_pointwise``, nearest and linear, extrapolating and not. The JAX
functions get numpy arrays, so they run their host (numpy) path, as the
loaders run them. Values agree to atol 1e-5 (float32 results are in fact
bit-equal: the weights take the data's dtype in both), NaNs where the
other side has them, dtypes as numpy promotes them; and the refusals
(unknown methods, non-monotonic or duplicated sources) are the same.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu.ops import interp as j_interp
from weatherbenchx_tpu_torch.ops import interp

torch.set_num_threads(1)

ATOL = 1e-5
LAT = np.linspace(-90, 90, 7)
LON = np.linspace(0, 360, 12, endpoint=False)


def _grid(dtype, seed=0):
  return np.random.default_rng(seed).standard_normal(
      (3, 7, 12)).astype(dtype)


def _targets(seed=1, n=9):
  rng = np.random.default_rng(seed)
  # Inside, on grid points, and outside the source range on both sides.
  lat = np.concatenate([rng.uniform(-95, 95, n), LAT[[0, 3, -1]]])
  lon = np.concatenate([rng.uniform(-10, 345, n), LON[[0, 5, -1]]])
  return lat, lon


def _assert_match(got: torch.Tensor, want):
  want = np.asarray(want)
  assert got.dtype == torch.from_numpy(np.empty(0, want.dtype)).dtype
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('descending', [False, True])
@pytest.mark.parametrize('extrapolate', [False, True])
def test_fractional_indices_match_jax(descending, extrapolate):
  source = LAT[::-1] if descending else LAT
  lat, _ = _targets()
  got = interp.fractional_indices(source, lat, extrapolate)
  want = j_interp.fractional_indices(source, lat, extrapolate)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  for g, w in zip(interp.fractional_indices(np.array([5.0]), lat, False),
                  j_interp.fractional_indices(np.array([5.0]), lat, False)):
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
@pytest.mark.parametrize('extrapolate', [False, True])
def test_interp_1d_along_axis_matches_jax(dtype, method, extrapolate):
  data = (_grid(np.float64) * 10).astype(dtype)
  lat, _ = _targets()
  idx, frac = interp.fractional_indices(LAT, lat, extrapolate)
  got = interp.interp_1d_along_axis(torch.from_numpy(data), 1, idx, frac,
                                    method)
  _assert_match(got, j_interp.interp_1d_along_axis(data, 1, idx, frac,
                                                   method))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
@pytest.mark.parametrize('extrapolate', [False, True])
@pytest.mark.parametrize('descending', [False, True])
def test_interp_outer_matches_jax(dtype, method, extrapolate, descending):
  data = _grid(dtype)
  lats = LAT[::-1] if descending else LAT
  lat, lon = _targets()
  dims = ('time', 'latitude', 'longitude')
  source = {'latitude': lats, 'longitude': LON}
  targets = {'latitude': lat, 'longitude': lon}
  got = interp.interp_outer(torch.from_numpy(data), dims, targets, source,
                            method, extrapolate)
  want = j_interp.interp_outer(data, dims, targets, source, method,
                               extrapolate)
  assert got.shape == (3, len(lat), len(lon))
  _assert_match(got, want)
  if dtype == np.float32:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('dtype', [np.float32, np.float64, np.int32])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
@pytest.mark.parametrize('extrapolate', [False, True])
@pytest.mark.parametrize('descending', [False, True])
def test_interp_pointwise_matches_jax(dtype, method, extrapolate,
                                      descending):
  data = (_grid(np.float64) * 10).astype(dtype)
  lats = LAT[::-1] if descending else LAT
  lat, lon = _targets()
  dims = ('time', 'latitude', 'longitude')
  source = {'latitude': lats, 'longitude': LON}
  targets = {'latitude': lat.reshape(3, 4), 'longitude': lon.reshape(3, 4)}
  got = interp.interp_pointwise(torch.from_numpy(data), dims, targets,
                                source, method, extrapolate)
  want = j_interp.interp_pointwise(data, dims, targets, source, method,
                                   extrapolate)
  assert got.shape == (3, 3, 4)
  _assert_match(got, want)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_pointwise_over_a_size_one_axis(method):
  """A size-1 source axis: the upper corner is clamped (its weight is 0)
  rather than gathered out of bounds."""
  data = _grid(np.float32)[:, :1]
  dims = ('time', 'latitude', 'longitude')
  source = {'latitude': LAT[:1], 'longitude': LON}
  targets = {'latitude': np.full(4, LAT[0]), 'longitude': LON[[1, 3, 4, 7]]}
  got = interp.interp_pointwise(torch.from_numpy(data), dims, targets,
                                source, method, True)
  _assert_match(got, j_interp.interp_pointwise(data, dims, targets, source,
                                               method, True))
  assert not torch.isnan(got).any()


def test_pointwise_keeps_the_data_device_and_dtype():
  data = torch.from_numpy(_grid(np.float32)).to(torch.float64)
  out = interp.interp_pointwise(
      data, ('time', 'latitude', 'longitude'),
      {'latitude': np.array([1.0]), 'longitude': np.array([2.0])},
      {'latitude': LAT, 'longitude': LON}, 'linear', False)
  assert out.dtype == torch.float64 and out.device == data.device


@pytest.mark.parametrize('fn', ['outer', 'pointwise', 'along_axis'])
def test_refusals_match_jax(fn):
  data = _grid(np.float32)
  dims = ('time', 'latitude', 'longitude')
  bad_sources = {
      'unsorted': np.array([0.0, 30.0, 20.0, 40.0, 50.0, 60.0, 70.0]),
      'duplicated': np.array([0.0, 10.0, 10.0, 30.0, 40.0, 50.0, 60.0])}
  for mod, arr in ((interp, torch.from_numpy(data)), (j_interp, data)):
    if fn == 'along_axis':
      idx, frac = mod.fractional_indices(LAT, np.array([3.0]), True)
      with pytest.raises(ValueError, match='Unsupported interpolation'):
        mod.interp_1d_along_axis(arr, 1, idx, frac, 'cubic')
      for source in bad_sources.values():
        with pytest.raises(ValueError, match='strictly monotonic'):
          mod.fractional_indices(source, np.array([5.0]), True)
      with pytest.raises(ValueError, match='empty dim'):
        mod.fractional_indices(np.zeros(0), np.array([5.0]), True)
      continue
    call = mod.interp_outer if fn == 'outer' else mod.interp_pointwise
    targets = {'latitude': np.array([3.0]), 'longitude': np.array([5.0])}
    with pytest.raises(ValueError, match='Unsupported interpolation'):
      call(arr, dims, targets, {'latitude': LAT, 'longitude': LON}, 'cubic',
           True)
    for source in bad_sources.values():
      with pytest.raises(ValueError, match='strictly monotonic'):
        call(arr, dims, targets, {'latitude': source, 'longitude': LON},
             'linear', True)
