"""Deterministic statistics and metrics.

The port of ``weatherbenchx_tpu/metrics/deterministic.py:56-204``: plain
elementwise tensor code, no kernel.
"""

from typing import Mapping

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.metrics import base


class Error(base.PerVariableStatistic):
  """prediction - target."""

  def _compute_per_variable(self, predictions, targets):
    return predictions - targets


class AbsoluteError(base.PerVariableStatistic):
  """|prediction - target|."""

  def _compute_per_variable(self, predictions, targets):
    return abs(predictions - targets)


class SquaredError(base.PerVariableStatistic):
  """(prediction - target)^2."""

  def _compute_per_variable(self, predictions, targets):
    return (predictions - targets) ** 2


# Metrics that are just the mean of a Statistic: use the Statistic directly.
Bias = Error
MAE = AbsoluteError
MSE = SquaredError


class RMSE(base.PerVariableMetric):
  """Root mean squared error."""

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {'SquaredError': SquaredError()}

  def _values_from_mean_statistics_per_variable(self, statistic_values):
    return darray.sqrt(statistic_values['SquaredError'])
