"""The port's ``inference`` package against the JAX package's, on the CPU.

States are computed by the JAX package from seeded numpy inputs (float64:
the tests run JAX under x64) and carried across by
``convert.state_from_reference``; every method of both packages then runs
on the same state and its point estimates, standard errors, confidence
intervals and p-values must agree to rtol 1e-9. Both packages compute in
float64 and draw bootstrap counts and indices from numpy's
``default_rng``, so the same seed resamples the same units. The delta
method (``autodiff``) is held on RMSE, ACC and the relative economic value,
whose finalizers must trace under ``torch.func``.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu.inference import autodiff as j_autodiff
from weatherbenchx_tpu.inference import bootstrap as j_bootstrap
from weatherbenchx_tpu.inference import t_test as j_t_test
from weatherbenchx_tpu.inference import test_utils as j_test_utils
from weatherbenchx_tpu.inference import utils as j_utils
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu_torch import convert
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch.inference import autodiff
from weatherbenchx_tpu_torch.inference import base
from weatherbenchx_tpu_torch.inference import block_length
from weatherbenchx_tpu_torch.inference import bootstrap
from weatherbenchx_tpu_torch.inference import t_test
from weatherbenchx_tpu_torch.inference import test_utils
from weatherbenchx_tpu_torch.inference import utils
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
N_UNITS, N_LEAD, N_X = 40, 2, 6
INITS = (np.datetime64('2020-01-01T00', 'ns')
         + np.arange(N_UNITS) * np.timedelta64(12, 'h'))
DAYS = INITS.astype('datetime64[D]')
CLR = np.geomspace(0.01, 1, 5)[:-1]


def _ar1(rng, shape, phi=0.6):
  """AR(1) noise along the first axis (the units)."""
  x = rng.standard_normal(shape)
  for i in range(1, shape[0]):
    x[i] = phi * x[i - 1] + np.sqrt(1 - phi ** 2) * x[i]
  return x


def _jax_state(kind: str, seed: int = 0, offset: float = 0.0):
  """(JAX metrics, port metrics, JAX state over init_time units)."""
  rng = np.random.default_rng(seed)
  dims = ('init_time', 'lead_time', 'x')
  coords = {'init_time': INITS, 'lead_time': np.arange(N_LEAD),
            'x': np.arange(N_X), 'day': jd.Coord(('init_time',), DAYS)}
  shape = (N_UNITS, N_LEAD, N_X)
  if kind == 'rmse_bias':
    t = rng.standard_normal(shape)
    p = t + offset + _ar1(rng, shape)
    j_metrics = {'rmse': j_deterministic.RMSE(),
                 'bias': j_deterministic.Bias()}
    t_metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
  elif kind == 'rev':
    prob = rng.random(shape)
    t = (rng.random(shape) < prob).astype(np.float64)
    p = (rng.random((5,) + shape) < prob[None]).mean(0)
    opt = {'jax': jd.DimArray(np.full(4, 0.5), ('cost_loss_ratio',),
                              {'cost_loss_ratio': CLR}),
           'torch': td.DimArray(np.full(4, 0.5), ('cost_loss_ratio',),
                                {'cost_loss_ratio': CLR})}
    j_metrics = {'rev': j_probabilistic.RelativeEconomicValue(
        ensemble_size=5, cost_loss_ratios=CLR, optimal_thresholds=opt['jax'])}
    t_metrics = {'rev': probabilistic.RelativeEconomicValue(
        ensemble_size=5, cost_loss_ratios=CLR,
        optimal_thresholds=opt['torch'])}
  elif kind == 'acc':
    # ACC's three anomaly statistics, made directly from anomalies with a
    # known correlation (its climatology alignment is tested elsewhere).
    ta = rng.standard_normal(shape)
    pa = 0.6 * ta + 0.8 * _ar1(rng, shape)
    stats = {'SquaredPredictionAnomaly': pa ** 2,
             'SquaredTargetAnomaly': ta ** 2, 'AnomalyCovariance': pa * ta}
    ws = {k: {'v': jd.DimArray(v.sum(-1), dims[:2], coords)}
          for k, v in stats.items()}
    w = {k: {'v': jd.DimArray(np.full(shape[:2], float(N_X)), dims[:2],
                              coords)} for k in stats}
    clim = np.zeros((2, 4, N_X))
    ccoords = {'dayofyear': np.arange(1, 3), 'hour': np.arange(0, 24, 6),
               'x': np.arange(N_X)}
    j_metrics = {'acc': j_deterministic.ACC(climatology={'v': jd.DimArray(
        clim, ('dayofyear', 'hour', 'x'), ccoords)})}
    t_metrics = {'acc': deterministic.ACC(climatology={'v': td.DimArray(
        clim, ('dayofyear', 'hour', 'x'), ccoords)})}
    return j_metrics, t_metrics, j_aggregation.AggregationState(ws, w)
  else:
    raise ValueError(kind)
  stats = j_base.compute_unique_statistics_for_all_metrics(
      j_metrics, {'v': jd.DimArray(p, dims, coords)},
      {'v': jd.DimArray(t, dims, coords)})
  state = j_aggregation.Aggregator(reduce_dims=['x']).aggregate_statistics(
      stats)
  # Indicator statistics are float32; both packages infer from float64.
  return j_metrics, t_metrics, state.map(
      lambda x: x.copy(data=np.asarray(x.data, np.float64)))


def _assert_tree_close(got, want, what=''):
  assert sorted(got) == sorted(want), what
  for k in want:
    if isinstance(want[k], dict):
      _assert_tree_close(got[k], want[k], f'{what}{k}.')
      continue
    g, w = got[k], want[k]
    assert g.dims == tuple(w.dims), f'{what}{k}'
    np.testing.assert_allclose(
        g.values, np.asarray(w.values, np.float64), rtol=RTOL, atol=ATOL,
        err_msg=f'{what}{k}')


def _assert_methods_agree(got: base.StatisticalInferenceMethod, want):
  _assert_tree_close(got.point_estimates(), want.point_estimates(), 'pt.')
  _assert_tree_close(got.standard_error_estimates(),
                     want.standard_error_estimates(), 'se.')
  for g, w, side in zip(got.confidence_intervals(0.1),
                        want.confidence_intervals(0.1), ('lo.', 'hi.')):
    _assert_tree_close(g, w, side)
  _assert_tree_close(got.p_values(0.0), want.p_values(0.0), 'p.')
  sig = got.significance_tests(0.0, 0.1)
  want_sig = want.significance_tests(0.0, 0.1)
  for m in want_sig:
    for v in want_sig[m]:
      np.testing.assert_array_equal(sig[m][v].values,
                                    np.asarray(want_sig[m][v].values))


METHODS = {
    'iid_t': lambda mod, m, s: mod['t'].IID(m, s, 'init_time'),
    'ar2_t': lambda mod, m, s: mod['t'].GeerAR2Corrected(m, s, 'init_time'),
    'hac_ewc_t': lambda mod, m, s: mod['t'].LazarusHACEWC(m, s, 'init_time'),
    'iid_bootstrap': lambda mod, m, s: mod['b'].IIDBootstrap(
        m, s, 'init_time', n_replicates=200, seed=3),
    'cluster_bootstrap': lambda mod, m, s: mod['b'].ClusterBootstrap(
        m, s, 'day', n_replicates=200, seed=4),
    'stationary_bootstrap': lambda mod, m, s: mod['b'].StationaryBootstrap(
        m, s, 'init_time', n_replicates=100, seed=5),
}
JAX_MODS = {'t': j_t_test, 'b': j_bootstrap}
PORT_MODS = {'t': t_test, 'b': bootstrap}


@pytest.mark.parametrize('kind', ['rmse_bias', 'acc', 'rev'])
@pytest.mark.parametrize('method', list(METHODS))
def test_method_matches_jax(kind, method):
  j_metrics, t_metrics, jstate = _jax_state(kind)
  state = convert.state_from_reference(jstate)
  got = METHODS[method](PORT_MODS, t_metrics, state)
  want = METHODS[method](JAX_MODS, j_metrics, jstate)
  _assert_methods_agree(got, want)


@pytest.mark.parametrize('method', ['iid_t', 'hac_ewc_t', 'iid_bootstrap'])
def test_baseline_comparison_matches_jax(method):
  """The paired comparison: main carries a known offset over baseline."""
  j_metrics, t_metrics, j_main = _jax_state('rmse_bias', 1, offset=0.5)
  _, _, j_baseline = _jax_state('rmse_bias', 1)
  main, baseline = (convert.state_from_reference(s)
                    for s in (j_main, j_baseline))

  def make(mods, metrics, a, b):
    cls = type(METHODS[method](mods, metrics, a))
    kwargs = {'experimental_unit_dim': 'init_time'}
    if 'bootstrap' in method:
      kwargs.update(n_replicates=200, seed=6)
    return cls.for_baseline_comparison(metrics, a, b, **kwargs)

  got = make(PORT_MODS, t_metrics, main, baseline)
  _assert_methods_agree(got, make(JAX_MODS, j_metrics, j_main, j_baseline))
  bias = got.point_estimates()['bias']['v'].values
  np.testing.assert_allclose(bias, 0.5, atol=0.3)


@pytest.mark.parametrize('kind', ['rmse_bias', 'acc', 'rev'])
def test_delta_method_matches_jax(kind):
  """Values at the mean statistics and per-unit tangents: RMSE, ACC and
  REV's finalizers linearized by torch.func against jax.linearize."""
  j_metrics, t_metrics, jstate = _jax_state(kind)
  state = convert.state_from_reference(jstate)
  value, tangents = autodiff.per_unit_values_linearized_around_mean_statistics(
      t_metrics, state, 'init_time')
  j_value, j_tangents = (
      j_autodiff.per_unit_values_linearized_around_mean_statistics(
          j_metrics, jstate, 'init_time'))
  _assert_tree_close(value, j_value)
  _assert_tree_close(tangents, j_tangents)
  for per_var in tangents.values():
    for da in per_var.values():
      assert da.dtype == torch.float64
      assert da.dims[-1] == 'init_time'
      np.testing.assert_array_equal(da.coord_values('init_time'), INITS)
      # Tangents are zero-mean over the units.
      np.testing.assert_allclose(da.values.mean(-1), 0, atol=1e-12)


def test_rmse_delta_method_closed_form():
  """IID standard error of RMSE: std(mse_i) / (2 rmse sqrt(n))."""
  _, t_metrics, jstate = _jax_state('rmse_bias', 2)
  state = convert.state_from_reference(jstate)
  se = t_test.IID(t_metrics, state, 'init_time').standard_error_estimates()
  mse_i = (state.sum_weighted_statistics['SquaredError']['v'].values
           / state.sum_weights['SquaredError']['v'].values)
  rmse = np.sqrt(mse_i.mean(0))
  want = mse_i.std(0, ddof=1) / (2 * rmse * np.sqrt(N_UNITS))
  np.testing.assert_allclose(se['rmse']['v'].values, want, rtol=1e-12)


def test_float32_state_is_inferred_in_float64():
  j_metrics, t_metrics, jstate = _jax_state('rmse_bias')
  state32 = convert.state_from_reference(jstate).map(
      lambda x: x.astype(torch.float32))
  got = t_test.IID(t_metrics, state32, 'init_time')
  assert got.standard_error_estimates()['rmse']['v'].dtype == torch.float64
  want = j_t_test.IID(j_metrics, jstate.map(
      lambda x: x.copy(data=np.asarray(x.data, np.float32).astype(
          np.float64))), 'init_time')
  _assert_tree_close(got.standard_error_estimates(),
                     want.standard_error_estimates())


def test_stationary_bootstrap_indices_and_block_length_match_jax():
  np.testing.assert_array_equal(
      bootstrap.stationary_bootstrap_indices(50, 3.7, 20, seed=9),
      j_bootstrap.stationary_bootstrap_indices(50, 3.7, 20, seed=9))
  x = _ar1(np.random.default_rng(3), (300,))
  assert block_length.optimal_block_length_stationary(x) == (
      j_bootstrap.block_length.optimal_block_length_stationary(x))
  with pytest.raises(ValueError, match='at least 8'):
    block_length.optimal_block_length_stationary(np.zeros(5))


def test_utils_match_jax():
  _, _, jstate = _jax_state('rmse_bias')
  state = convert.state_from_reference(jstate)
  coord = utils.get_and_check_experimental_unit_coord(state, 'init_time')
  np.testing.assert_array_equal(
      coord.values, np.asarray(j_utils.get_and_check_experimental_unit_coord(
          jstate, 'init_time').values))
  day = utils.get_and_check_experimental_unit_coord(
      state, 'day', check_is_dim=False)
  assert day.dims == ('init_time',)
  with pytest.raises(ValueError, match='No experimental unit'):
    utils.get_and_check_experimental_unit_coord(state, 'nope')
  with pytest.raises(ValueError, match='not a dimension coordinate'):
    utils.get_and_check_experimental_unit_coord(state, 'day')
  assert utils.logarithmic_round(9.7, resolution=1) == pytest.approx(10.0)
  assert utils.logarithmic_round(3.3) == j_utils.logarithmic_round(3.3)
  da = td.DimArray(np.arange(6.0).reshape(2, 3), ('a', 'b'))
  out = utils.apply_to_slices(lambda x: x * 2, da, dim=('a', 'b'))
  np.testing.assert_array_equal(out.values, np.arange(6.0).reshape(2, 3) * 2)
  assert out.dims == ('a', 'b')
  with pytest.raises(ValueError, match='not found'):
    utils.apply_to_slices(lambda x: x, da, dim='c')


def test_test_utils_fixtures_match_jax():
  """The port's coverage helpers: the same toy metrics and simulators, and
  an IID t-test that covers its true mean at the stated rate."""
  rng = np.random.default_rng(7)
  sims = test_utils.simulate_ar1(0.5, 1.0, 0.3, steps=30, replicates=400,
                                 rng=rng)
  np.testing.assert_array_equal(sims, j_test_utils.simulate_ar1(
      0.5, 1.0, 0.3, steps=30, replicates=400,
      rng=np.random.default_rng(7)))
  np.testing.assert_array_equal(
      test_utils.simulate_ar2(0, 1, 0.5, 0.2, rng=np.random.default_rng(1)),
      j_test_utils.simulate_ar2(0, 1, 0.5, 0.2,
                                rng=np.random.default_rng(1)))
  assert test_utils.gaussian_ar1_true_stderr_of_sample_mean(1, 0.5, 30) == (
      j_test_utils.gaussian_ar1_true_stderr_of_sample_mean(1, 0.5, 30))
  data = td.DimArray(rng.standard_normal((30, 400)), ('unit', 'replicates'))
  metrics, state = test_utils.metrics_and_agg_state_for_mean(data)
  inference = t_test.IID(metrics, state, 'unit')
  test_utils.assert_coverage_probability_estimate_plausible(
      inference, 0.0, alpha=0.05, rtol=0.05,
      coverage_prob_significance_level=0.01)
  metrics, state = test_utils.metrics_and_agg_state_for_ratio_of_means(
      data + 5, data * 0 + 10)
  value, _ = autodiff.per_unit_values_linearized_around_mean_statistics(
      metrics, state, 'unit')
  np.testing.assert_allclose(value['ratio_of_means']['variable'].values,
                             data.values.mean(0) / 10 + 0.5, rtol=1e-12)
  metrics, state = test_utils.metrics_and_agg_state_for_exp_of_mean(data)
  value, _ = autodiff.per_unit_values_linearized_around_mean_statistics(
      metrics, state, 'unit')
  np.testing.assert_allclose(value['exp_mean']['variable'].values,
                             np.exp(data.values.mean(0)), rtol=1e-12)
  with pytest.raises(AssertionError, match='not close enough'):
    test_utils.assert_probability_estimate_plausible(10, 1000, 0.5)
