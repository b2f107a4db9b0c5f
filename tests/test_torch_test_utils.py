"""The port's ``test_utils`` against the JAX package's: from the same seed,
the same values, dims and coords, as port ``DimArray``s over torch
tensors; and ``compute_all_metrics`` on the same pair agrees within atol
1e-5."""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import test_utils as j_test_utils
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu_torch import test_utils
from weatherbenchx_tpu_torch.metrics import deterministic


def _assert_same(got, want):
  assert list(got) == list(want)
  for k in want:
    g, w = got[k], want[k]
    assert isinstance(g.data, torch.Tensor)
    assert g.dims == tuple(w.dims), k
    np.testing.assert_array_equal(g.values, np.asarray(w.values), err_msg=k)
    assert g.values.dtype == np.asarray(w.values).dtype, k
    assert sorted(g.coords) == sorted(w.coords), k
    for name in w.coords:
      assert g.coords[name].dims == tuple(w.coords[name].dims)
      np.testing.assert_array_equal(g.coord_values(name),
                                    np.asarray(w.coords[name].values))


@pytest.mark.parametrize('kwargs', [
    {},
    {'random': True, 'seed': 3, 'time_stop': '2020-01-05'},
    {'random': True, 'seed': 1, 'ensemble_size': 3, 'time_stop': '2020-01-03',
     'spatial_resolution_in_degrees': 30.0, 'dtype': np.float64},
    {'time_dim': 'valid_time', 'ensemble_dim': 'number', 'ensemble_size': 2,
     'time_stop': '2020-01-02', 'variables_3d': ('a', 'b'), 'levels': (500,)},
])
def test_mock_target_data(kwargs):
  _assert_same(test_utils.mock_target_data(**kwargs),
               j_test_utils.mock_target_data(**kwargs))


@pytest.mark.parametrize('kwargs', [
    {'time_stop': '2020-01-03'},
    {'random': True, 'seed': 5, 'time_stop': '2020-01-03',
     'lead_stop': np.timedelta64(2, 'D'), 'lead_dim': 'lead_time'},
])
def test_mock_prediction_data(kwargs):
  _assert_same(test_utils.mock_prediction_data(**kwargs),
               j_test_utils.mock_prediction_data(**kwargs))


@pytest.mark.parametrize('kwargs', [
    {},
    {'ensemble_size': 4, 'seed': 2, 'variables_3d': ('geopotential',)},
    {'n_init': 2, 'n_lead': 1, 'spatial_resolution_in_degrees': 30.0,
     'dtype': np.float64},
])
def test_canonical_forecast_pair(kwargs):
  got = test_utils.canonical_forecast_pair(**kwargs)
  want = j_test_utils.canonical_forecast_pair(**kwargs)
  for g, w in zip(got, want):
    _assert_same(g, w)


def test_compute_all_metrics():
  kwargs = {'variables_3d': ('geopotential',), 'seed': 4}
  got = test_utils.compute_all_metrics(
      {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()},
      *test_utils.canonical_forecast_pair(**kwargs),
      reduce_dims=['init_time', 'latitude', 'longitude'])
  want = j_test_utils.compute_all_metrics(
      {'rmse': j_deterministic.RMSE(), 'bias': j_deterministic.Bias()},
      *j_test_utils.canonical_forecast_pair(**kwargs),
      reduce_dims=['init_time', 'latitude', 'longitude'])
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == tuple(want[k].dims), k
    np.testing.assert_allclose(got[k].values, np.asarray(want[k].values),
                               atol=1e-5, rtol=0, err_msg=k)
