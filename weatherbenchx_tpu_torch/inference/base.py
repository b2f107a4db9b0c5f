"""Base class for statistical inference methods.

The port of ``weatherbenchx_tpu/inference/base.py`` (reference
``weatherbenchX/statistical_inference/base.py:31-198``).
"""

import abc
from typing import Hashable, Mapping, final

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from weatherbenchx_tpu_torch.inference import baseline_comparison

MetricValues = Mapping[str, Mapping[Hashable, DimArray]]


class StatisticalInferenceMethod(abc.ABC):
  """Confidence intervals, p-values etc for underlying metric values."""

  @abc.abstractmethod
  def __init__(
      self,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
  ):
    """See reference ``statistical_inference/base.py:42-76`` for semantics."""

  @classmethod
  def for_baseline_comparison(
      cls,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
      baseline_aggregated_statistics: aggregation.AggregationState,
      baseline_metrics: Mapping[str, metrics_base.Metric] | None = None,
      comparison=baseline_comparison.difference,
      **init_kwargs,
  ):
    """Inference on a paired comparison against a baseline model."""
    return cls(
        metrics=baseline_comparison.for_metrics(
            metrics, baseline_metrics, comparison),
        aggregated_statistics=baseline_comparison.combine_aggregation_states(
            aggregated_statistics, baseline_aggregated_statistics),
        **init_kwargs,
    )

  @abc.abstractmethod
  def point_estimates(self) -> MetricValues:
    """Point estimates for the metric values (or their differences)."""

  @abc.abstractmethod
  def confidence_intervals(
      self, alpha: float = 0.05) -> tuple[MetricValues, MetricValues]:
    """(lower, upper) confidence interval bounds at significance alpha."""

  @abc.abstractmethod
  def standard_error_estimates(self) -> MetricValues:
    """Estimated standard deviation of the point estimator."""

  @abc.abstractmethod
  def p_values(self, null_value: float = 0.) -> MetricValues:
    """Two-sided p-values for H0: true metric == null_value."""

  @final
  def significance_tests(self, null_value: float = 0,
                         alpha: float = 0.05) -> MetricValues:
    """True where H0 is rejected at significance level alpha."""
    p_values = self.p_values(null_value)
    return tree.map_structure(lambda p: p <= alpha, p_values)
