"""The PyTorch port's main path against the JAX package, on the CPU.

Identical float32 inputs, made with numpy from a seed, go through the JAX
package (its fused Pallas kernel in interpret mode) and through the port
(the kernel's plain version, since the tensors lie on the CPU). Metric
values must agree to rtol 1e-5 / atol 1e-6: both sides compute in float32,
and the contraction is an einsum on both.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu.parallel import evaluator as j_evaluator
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
M, N_LEAD, N_LAT, N_LON = 21, 2, 10, 12
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-30, 30), (0, 360))}
NAN_POINT = (3, 0, 1, 2, 5)  # member, init, lead, lat, lon: in 'global' only


def _arrays(seed, ensemble=True, nan=False):
  rng = np.random.default_rng(seed)
  shape = (1, N_LEAD, N_LAT, N_LON)
  x = rng.standard_normal(((M,) if ensemble else ()) + shape).astype(
      np.float32)
  y = rng.standard_normal(shape).astype(np.float32)
  if nan:
    x[NAN_POINT if ensemble else NAN_POINT[1:]] = np.nan
  mask = rng.random((N_LAT, N_LON)) > 0.2
  mask[NAN_POINT[3:]] = False
  return x, y, mask


def _pair(mod, x, y, mask, init=0):
  """(predictions, targets) as DimArrays of the module ``mod``."""
  coords = {
      'init_time': np.array([np.datetime64('2020-01-01T00', 'ns')
                             + init * np.timedelta64(12, 'h')]),
      'lead_time': (np.arange(N_LEAD) * np.timedelta64(6, 'h')
                    ).astype('timedelta64[ns]'),
      'latitude': np.linspace(90, -90, N_LAT),
      'longitude': np.linspace(0, 360, N_LON, endpoint=False),
  }
  if mask is not None:
    coords['mask'] = mod.Coord(('latitude', 'longitude'), mask)
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  if x.ndim == len(dims) + 1:
    p = mod.DimArray(x.copy(), ('number',) + dims,
                     dict(coords, number=np.arange(M)))
  else:
    p = mod.DimArray(x.copy(), dims, coords)
  return {'t2m': p}, {'t2m': mod.DimArray(y.copy(), dims, coords)}


def _metrics(prob, family):
  if family == 'prob':
    return {'crps': prob.CRPSEnsemble(use_sort=True),
            'ssr': prob.UnbiasedSpreadSkillRatio(),
            'umr': prob.UnbiasedEnsembleMeanRMSE()}
  return {'rmse': prob.RMSE(), 'mae': prob.MAE(), 'bias': prob.Bias()}


def _aggregator(agg_mod, bin_mod, w_mod, masked, skipna):
  return agg_mod.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[w_mod.GridAreaWeighting()],
      bin_by=[bin_mod.Regions(REGIONS)], masked=masked, skipna=skipna)


def _assert_values_match(got: dict, want: dict):
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims, k
    w = np.asarray(want[k].values, np.float64)
    g = got[k].values.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
  assert any(np.isfinite(np.asarray(v.values)).any() for v in want.values())


CASES = [  # masked, skipna, nan
    (False, False, False),
    (True, False, False),
    (False, False, True),
    (True, False, True),
    (False, True, True),
]


@pytest.mark.parametrize('family', ['prob', 'det'])
@pytest.mark.parametrize('masked,skipna,nan', CASES)
def test_single_chunk_matches_jax(family, masked, skipna, nan, monkeypatch):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  x, y, mask = _arrays(1, ensemble=family == 'prob', nan=nan)
  mask = mask if masked else None
  j_metric_mod = j_probabilistic if family == 'prob' else j_deterministic
  t_metric_mod = probabilistic if family == 'prob' else deterministic
  want = j_aggregation.compute_metric_values_for_single_chunk(
      _metrics(j_metric_mod, family),
      _aggregator(j_aggregation, j_binning, j_weighting, masked, skipna),
      *_pair(j_darray, x, y, mask))
  got = aggregation.compute_metric_values_for_single_chunk(
      _metrics(t_metric_mod, family),
      _aggregator(aggregation, binning, weighting, masked, skipna),
      *_pair(darray, x, y, mask))
  if nan and not (masked or skipna):
    # The NaN member poisons 'global' but not 'tropics'.
    assert np.isnan(got['crps.t2m' if family == 'prob' else 'rmse.t2m']
                    .values).any()
  _assert_values_match(got, want)


@pytest.mark.parametrize('nan', [False, True])
def test_chunk_evaluator_matches_jax(nan, monkeypatch):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  x, y, mask = _arrays(2, nan=nan)
  want = j_evaluator.ChunkEvaluator(
      _metrics(j_probabilistic, 'prob'),
      _aggregator(j_aggregation, j_binning, j_weighting, True, False),
  ).eval_chunk(*_pair(j_darray, x, y, mask)).metric_values(
      _metrics(j_probabilistic, 'prob'))
  metrics = _metrics(probabilistic, 'prob')
  ev = evaluator.ChunkEvaluator(
      metrics, _aggregator(aggregation, binning, weighting, True, False),
      device='cpu')
  got = ev.eval_chunk(*_pair(darray, x, y, mask)).metric_values(metrics)
  _assert_values_match(got, want)


def test_eval_accum_sums_chunks_and_reuses_operands():
  metrics = _metrics(probabilistic, 'prob')
  ev = evaluator.ChunkEvaluator(
      metrics, _aggregator(aggregation, binning, weighting, True, False),
      device='cpu')
  pairs = [_pair(darray, *_arrays(10 + k), init=k) for k in range(3)]
  state = aggregation.AggregationState.zero()
  for p, t in pairs:
    state = ev.eval_accum(ev.prepare_pair(p, t), state)
  want = aggregation.AggregationState.sum(
      [ev.eval_chunk(p, t) for p, t in pairs])
  for k, da in want.to_dataset().items():
    np.testing.assert_allclose(state.to_dataset()[k].values, da.values,
                               rtol=1e-6)
  # Init times differ per chunk, yet one layout serves every chunk: the
  # operands are built once (statistics with and without the targets' coords
  # share a layout here, since both sides carry the same mask coord).
  assert len(ev._operand_cache) == 1


def test_fused_kernel_runs_once_per_compute_pass(monkeypatch):
  calls = []
  orig = crps_pairwise.fused_ensemble_stats

  def counting(x, y):
    calls.append(x.shape)
    return orig(x, y)

  monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', counting)
  metrics = _metrics(probabilistic, 'prob')
  p, t = _pair(darray, *_arrays(3))
  stats = base.compute_unique_statistics_for_all_metrics(metrics, p, t)
  assert len(stats) == 4  # skill, spread, variance, unbiased MSE
  assert len(calls) == 1
  # Outside a compute pass each statistic takes its standalone path.
  spread = probabilistic.CRPSSpread()._compute_per_variable(p['t2m'], t['t2m'])
  assert len(calls) == 1
  np.testing.assert_allclose(
      spread.values, stats['CRPSSpread_number_fair_predictions']['t2m'].values,
      rtol=1e-5)


def test_float64_statistics_take_the_plain_forms():
  """Dtypes the kernel does not take use each statistic's own plain form."""
  x, y, _ = _arrays(4)
  metrics = {'crps': probabilistic.CRPSEnsemble(use_sort=True),
             'crps_pairs': probabilistic.CRPSEnsemble(use_sort=False),
             'ssr': probabilistic.UnbiasedSpreadSkillRatio()}
  agg = _aggregator(aggregation, binning, weighting, False, False)
  got32 = aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, *_pair(darray, x, y, None))
  got64 = aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, *_pair(darray, x.astype(np.float64),
                           y.astype(np.float64), None))
  for k in got32:
    assert got64[k].dtype == torch.float64
    np.testing.assert_allclose(got64[k].values, got32[k].values, rtol=1e-5)


def test_ensemble_targets_raise_until_the_cross_kernel_lands():
  """The cross kernel has landed: ensemble targets no longer raise, and
  CRPSSkill takes the kernel's route (its plain version on the CPU)."""
  x, y, _ = _arrays(5)
  p, _ = _pair(darray, x, y, None)
  crps_pairwise.reset_launch_counts()
  got = probabilistic.CRPSSkill()._compute_per_variable(p['t2m'], p['t2m'])
  assert got.dims == ('init_time', 'lead_time', 'latitude', 'longitude')
  np.testing.assert_allclose(got.values, np.abs(x[:, None] - x[None]).mean(
      (0, 1)), rtol=1e-5, atol=1e-6)
  assert crps_pairwise.LAUNCHES['pairwise_cross_sum'] == 0  # CPU: no launch
