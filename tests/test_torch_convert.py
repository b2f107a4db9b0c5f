"""Conversions between the JAX package, numpy and the port, on the CPU.

A state computed by the JAX package, converted, sums with a state of the
port into the state of both chunks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import convert
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

REGIONS = {'global': ((-90, 90), (0, 360)), 'north': ((0, 90), (0, 360))}


def _chunk(mod, seed):
  rng = np.random.default_rng(seed)
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01', 'ns')
                             + seed * np.timedelta64(1, 'D')]),
      'lead_time': (np.arange(2) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': np.linspace(-90, 90, 7),
      'longitude': np.linspace(0, 360, 8, endpoint=False),
  }
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  x = rng.standard_normal((6, 1, 2, 7, 8)).astype(np.float32)
  y = rng.standard_normal((1, 2, 7, 8)).astype(np.float32)
  return ({'z': mod.DimArray(x, ('number',) + dims,
                             dict(coords, number=np.arange(6)))},
          {'z': mod.DimArray(y, dims, coords)})


def _metrics(mod):
  return {'crps': mod.CRPSEnsemble(use_sort=True),
          'ssr': mod.UnbiasedSpreadSkillRatio()}


def _assert_states_close(got, want, rtol=1e-6):
  g, w = got.to_dataset(), want.to_dataset()
  assert sorted(g) == sorted(w)
  for k in w:
    assert g[k].dims == w[k].dims, k
    np.testing.assert_allclose(g[k].values, w[k].values, rtol=rtol, err_msg=k)


def test_dimarray_from_reference_round_trip():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((3, 4)).astype(np.float32)
  ref = j_darray.DimArray(jnp.asarray(x), ('a', 'b'),
                          {'a': np.arange(3), 'mask': (('b',), x[0] > 0)})
  got = convert.dimarray_from_reference(ref)
  assert got.dims == ('a', 'b') and got.dtype == torch.float32
  np.testing.assert_array_equal(got.values, x)
  np.testing.assert_array_equal(got.coord_values('mask'), x[0] > 0)
  assert got.coords['mask'].dims == ('b',)
  half = convert.dimarray_from_reference(
      j_darray.DimArray(jnp.asarray(x, jnp.bfloat16), ('a', 'b')))
  assert half.dtype == torch.bfloat16
  np.testing.assert_allclose(half.values, x, rtol=1e-2)


def test_numpy_round_trip():
  metrics = _metrics(probabilistic)
  ev = evaluator.ChunkEvaluator(
      metrics, aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=[binning.Regions(REGIONS)]), device='cpu')
  state = ev.eval_chunk(*_chunk(darray, 0))
  arrays = convert.state_to_numpy(state)
  assert sorted(arrays) == sorted(state.to_dataset())
  assert all(k.endswith(('#sum_weighted_statistics', '#sum_weights'))
             for k in arrays)
  assert all(isinstance(v['data'], np.ndarray) for v in arrays.values())
  back = convert.state_from_numpy(arrays)
  _assert_states_close(back, state, rtol=0)
  for k, da in back.to_dataset().items():
    for name, c in da.coords.items():
      np.testing.assert_array_equal(
          c.values, state.to_dataset()[k].coords[name].values)
  assert back.metric_values(metrics).keys() == state.metric_values(
      metrics).keys()
  host = state.to_host()
  for k, da in host.to_dataset().items():
    assert da.dtype == torch.float64 and da.device.type == 'cpu', k
    assert all(isinstance(c.values, np.ndarray) for c in da.coords.values())
  _assert_states_close(host, state, rtol=0)


def test_reference_state_sums_with_port_state(monkeypatch):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  reduce_dims = ['init_time', 'latitude', 'longitude']
  j_agg = j_aggregation.Aggregator(
      reduce_dims=reduce_dims, weigh_by=[j_weighting.GridAreaWeighting()],
      bin_by=[j_binning.Regions(REGIONS)])
  agg = aggregation.Aggregator(
      reduce_dims=reduce_dims, weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(REGIONS)])
  # Chunk 0 evaluated by the JAX package, chunk 1 by the port.
  j_state = j_agg.aggregate_statistics(
      j_base.compute_unique_statistics_for_all_metrics(
          _metrics(j_probabilistic), *_chunk(j_darray, 0)))
  metrics = _metrics(probabilistic)
  ev = evaluator.ChunkEvaluator(metrics, agg, device='cpu')
  mixed = convert.state_from_reference(j_state) + ev.eval_chunk(
      *_chunk(darray, 1))
  both = ev.eval_chunk(*_chunk(darray, 0)) + ev.eval_chunk(
      *_chunk(darray, 1))
  _assert_states_close(mixed, both, rtol=1e-5)
  got, want = mixed.metric_values(metrics), both.metric_values(metrics)
  for k in want:
    np.testing.assert_allclose(got[k].values, want[k].values, rtol=1e-5)
  assert convert.state_from_reference(
      j_aggregation.AggregationState.zero()).sum_weights is None


def test_misaligned_states_raise():
  a = aggregation.AggregationState(
      {'s': {'v': darray.DimArray(np.ones(2), ('x',), {'x': [0, 1]})}},
      {'s': {'v': darray.DimArray(np.ones(2), ('x',), {'x': [0, 1]})}})
  b = aggregation.AggregationState(
      {'s': {'v': darray.DimArray(np.ones(2), ('x',), {'x': [1, 2]})}},
      {'s': {'v': darray.DimArray(np.ones(2), ('x',), {'x': [1, 2]})}})
  with pytest.raises(NotImplementedError, match='outer'):
    _ = a + b
  assert (a + aggregation.AggregationState.zero()) is not None
