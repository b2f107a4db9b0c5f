"""The port's copies of three public names of the JAX package, on the CPU.

``metrics.base.NoOpMetric`` (a statistic used as a metric),
``metrics.base.align_climatology`` (the climatology at a forecast's valid
times) and ``tree.unflatten_from_paths``, each against the JAX function on
the same inputs: gathers and trees exactly, metric values to rtol 1e-5 /
atol 1e-6.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import tree as j_tree
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import deterministic

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LAT = np.linspace(-90, 90, 7)
LON = np.linspace(0, 360, 12, endpoint=False)
# Inits across the end of the leap year 2020 (day 366, then day 1).
INITS = np.array(['2020-12-30T12', '2020-12-31T00'], dtype='datetime64[ns]')
LEADS = np.array([0, 6, 18, 30], dtype='timedelta64[h]').astype(
    'timedelta64[ns]')


def _clim(mod, kind: str, rng):
  space = {'latitude': LAT, 'longitude': LON}
  if kind == 'time':
    t = (np.datetime64('2020-12-30', 'ns')
         + np.arange(12) * np.timedelta64(6, 'h'))
    return mod.DimArray(rng.standard_normal((12, 7, 12)).astype(np.float32),
                        ('time', 'latitude', 'longitude'), {'time': t, **space})
  if kind == 'dayofyear':
    return mod.DimArray(rng.standard_normal((366, 7, 12)).astype(np.float32),
                        ('dayofyear', 'latitude', 'longitude'),
                        {'dayofyear': np.arange(1, 367), **space})
  return mod.DimArray(
      rng.standard_normal((366, 4, 7, 12)).astype(np.float32),
      ('dayofyear', 'hour', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
       **space})


def _pair(mod, rng, members=False):
  """(predictions, targets) of 2 inits x 4 leads; with ``members``, 3
  ensemble members in front."""
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  coords = {'init_time': INITS, 'lead_time': LEADS, 'latitude': LAT,
            'longitude': LON}
  shape = (2, 4, 7, 12)
  pred = rng.standard_normal(((3,) if members else ()) + shape).astype(
      np.float32)
  tgt = rng.standard_normal(shape).astype(np.float32)
  pdims = (('number',) if members else ()) + dims
  return ({'t': mod.DimArray(pred, pdims, coords)},
          {'t': mod.DimArray(tgt, dims, coords)})


@pytest.mark.parametrize('kind', ['time', 'dayofyear', 'doy_hour'])
def test_align_climatology_matches_jax(kind):
  clim = _clim(darray, kind, np.random.default_rng(0))
  j_clim = _clim(j_darray, kind, np.random.default_rng(0))
  pred = _pair(darray, np.random.default_rng(1))[0]['t']
  j_pred = _pair(j_darray, np.random.default_rng(1))[0]['t']
  got = base.align_climatology(clim, pred)
  want = j_base.align_climatology(j_clim, j_pred)
  assert got.dims == want.dims == ('init_time', 'lead_time', 'latitude',
                                   'longitude')
  np.testing.assert_array_equal(got.values, np.asarray(want.values))
  assert sorted(got.coords) == sorted(want.coords)


@pytest.mark.parametrize('members', [False, True])
def test_noop_metric_matches_jax(members):
  """A statistic wrapped by NoOpMetric is the statistic, and scores as the
  JAX package's does."""
  stat, j_stat = deterministic.SquaredError(), j_deterministic.SquaredError()
  assert base.NoOpMetric(stat) is stat
  assert j_base.NoOpMetric(j_stat) is j_stat
  reduce_dims = ['init_time', 'latitude', 'longitude']
  got = aggregation.compute_metric_values_for_single_chunk(
      {'se': base.NoOpMetric(stat)},
      aggregation.Aggregator(reduce_dims=reduce_dims),
      *_pair(darray, np.random.default_rng(2), members))
  want = j_aggregation.compute_metric_values_for_single_chunk(
      {'se': j_base.NoOpMetric(j_stat)},
      j_aggregation.Aggregator(reduce_dims=reduce_dims),
      *_pair(j_darray, np.random.default_rng(2), members))
  assert sorted(got) == sorted(want) == ['se.t']
  assert got['se.t'].dims == want['se.t'].dims
  np.testing.assert_allclose(got['se.t'].values,
                             np.asarray(want['se.t'].values),
                             rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('structure', [
    {},
    {'a': 1},
    {'rmse': {'t2m': 1.0, 'z': {'500': 2.0, '850': 3.0}}, 'bias': {'t2m': 0}},
    {'x': {'y': {'z': {'w': 'leaf'}}}, 'v': None},
])
def test_unflatten_from_paths_matches_jax(structure):
  flat = tree.flatten_with_paths(structure)
  assert flat == j_tree.flatten_with_paths(structure)
  got = tree.unflatten_from_paths(flat)
  assert got == j_tree.unflatten_from_paths(flat)
  assert got == structure
