"""Fixtures for statistical-inference tests (frequentist simulations).

The port of ``weatherbenchx_tpu/inference/test_utils.py``. Mirrors the reference's test strategy
(``statistical_inference/test_utils.py:26-236``): toy metrics (mean,
ratio-of-means, exp-of-mean), closed-form AR(1)/AR(2) simulators, the exact
stderr of an AR(1) sample mean, and binomial-plausibility assertions for
CI coverage.
"""

import numpy as np
import scipy.stats

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.inference import base
from weatherbenchx_tpu_torch.metrics import base as metrics_base


class MeanPrediction(metrics_base.Statistic):

  def compute(self, predictions, targets):
    return predictions


class MeanTarget(metrics_base.Statistic):

  def compute(self, predictions, targets):
    return targets


def metrics_and_agg_state_for_mean(data: DimArray):
  """Single 'mean' metric over the raw data (no reduction yet)."""
  metrics = {'mean': MeanPrediction()}
  stats = metrics_base.compute_unique_statistics_for_all_metrics(
      metrics=metrics, predictions={'variable': data}, targets={})
  aggregator = aggregation.Aggregator(reduce_dims=())
  return metrics, aggregator.aggregate_statistics(stats)


class RatioOfPredictionAndTargetMeans(metrics_base.PerVariableMetric):
  """Nonlinear function of the means of two statistics."""

  @property
  def statistics(self):
    return {'mean_prediction': MeanPrediction(),
            'mean_target': MeanTarget()}

  def _values_from_mean_statistics_per_variable(self, s):
    return s['mean_prediction'] / s['mean_target']


def metrics_and_agg_state_for_ratio_of_means(
    numerator: DimArray, denominator: DimArray):
  metrics = {'ratio_of_means': RatioOfPredictionAndTargetMeans()}
  stats = metrics_base.compute_unique_statistics_for_all_metrics(
      metrics=metrics, predictions={'variable': numerator},
      targets={'variable': denominator})
  aggregator = aggregation.Aggregator(reduce_dims=())
  return metrics, aggregator.aggregate_statistics(stats)


class ExpMeanPrediction(metrics_base.PerVariableMetric):
  """exp of the mean: skewed/non-Gaussian finalizer."""

  @property
  def statistics(self):
    return {'mean_prediction': MeanPrediction()}

  def _values_from_mean_statistics_per_variable(self, s):
    return darray.exp(s['mean_prediction'])


def metrics_and_agg_state_for_exp_of_mean(data: DimArray):
  metrics = {'exp_mean': ExpMeanPrediction()}
  stats = metrics_base.compute_unique_statistics_for_all_metrics(
      metrics=metrics, predictions={'variable': data}, targets={})
  aggregator = aggregation.Aggregator(reduce_dims=())
  return metrics, aggregator.aggregate_statistics(stats)


def simulate_ar2(mean, sigma, phi1, phi2, steps=10, replicates=1000,
                 rng=None):
  """Stationary Gaussian AR(2) sample paths, shape (steps, replicates)."""
  rng = rng or np.random.default_rng(0)
  denom = (1 + phi2) * (1 - phi1 ** 2 + phi2 ** 2 - 2 * phi2)
  gamma_0 = sigma ** 2 * (1 - phi2) / denom
  gamma_1 = sigma ** 2 * phi1 / denom
  rho_1 = gamma_1 / gamma_0
  x_0 = rng.standard_normal(replicates)
  y_0 = np.sqrt(gamma_0) * x_0
  x_1 = rng.standard_normal(replicates)
  y_1 = np.sqrt(gamma_0) * (rho_1 * x_0 + np.sqrt(1 - rho_1 ** 2) * x_1)
  results = [y_0, y_1]
  for _ in range(steps - 2):
    y_nm2, y_nm1 = results[-2], results[-1]
    x_n = rng.standard_normal(replicates)
    results.append(phi1 * y_nm1 + phi2 * y_nm2 + x_n * sigma)
  return np.stack(results, axis=0) + mean


def simulate_ar1(mean, sigma_marginal, phi, steps=10, replicates=1000,
                 rng=None):
  """Stationary Gaussian AR(1) sample paths, shape (steps, replicates)."""
  rng = rng or np.random.default_rng(0)
  sigma = sigma_marginal * np.sqrt(1 - phi ** 2)
  y_0 = sigma_marginal * rng.standard_normal(replicates)
  results = [y_0]
  for _ in range(steps - 1):
    results.append(phi * results[-1]
                   + rng.standard_normal(replicates) * sigma)
  return np.stack(results, axis=0) + mean


def gaussian_ar1_true_stderr_of_sample_mean(
    sigma_marginal: float, phi: float, n: int):
  """Exact stderr of the sample mean of a stationary Gaussian AR(1)."""
  correction = 1 + 2 * phi / (1 - phi) * (1 - (1 - phi ** n) / (1 - phi) / n)
  effective_n = n / correction
  return sigma_marginal / np.sqrt(effective_n)


def assert_probability_estimate_plausible(
    n_successes: int,
    n_trials: int,
    hypothesized_p: float,
    rtol: float = 1e-2,
    significance_level: float = 0.1,
):
  """Binomial-CI plausibility check for an estimated probability."""
  lower_est, upper_est = scipy.stats.binomtest(
      k=int(n_successes), n=int(n_trials)).proportion_ci(
          1 - significance_level)
  atol = rtol * min(hypothesized_p, 1 - hypothesized_p)
  upper_true = min(1, hypothesized_p + atol)
  lower_true = max(0, hypothesized_p - atol)
  estimate = float(n_successes / n_trials)
  if lower_true > upper_est or upper_true < lower_est:
    raise AssertionError(
        f'{n_successes}/{n_trials} = {estimate:g} is not close enough to '
        f'{hypothesized_p:g}: CI [{lower_est:g}, {upper_est:g}] does not '
        f'overlap tolerated range [{lower_true:g}, {upper_true:g}].')


def assert_coverage_probability_estimate_plausible(
    inference: base.StatisticalInferenceMethod,
    true_value: float,
    metric_name: str = 'mean',
    variable_name: str = 'variable',
    replicates_dim: str = 'replicates',
    alpha: float = 0.05,
    rtol: float = 0.,
    coverage_prob_significance_level: float = 0.05,
):
  """Asserts CI coverage over simulation replicates is plausibly 1-alpha."""
  lower, upper = inference.confidence_intervals(alpha)
  lower = lower[metric_name][variable_name]
  upper = upper[metric_name][variable_name]
  covered = (lower.values <= true_value) & (true_value <= upper.values)
  assert_probability_estimate_plausible(
      n_successes=int(covered.sum()),
      n_trials=int(covered.size),
      hypothesized_p=1 - alpha,
      significance_level=coverage_prob_significance_level,
      rtol=rtol)
