"""Paired baseline comparisons ("is model A significantly better than B?").

The port of ``weatherbenchx_tpu/inference/baseline_comparison.py``
(reference ``weatherbenchX/statistical_inference/baseline_comparison.py``).
"""

from typing import Callable, Hashable, Mapping

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from weatherbenchx_tpu_torch.metrics import wrappers

MetricResult = Mapping[Hashable, DimArray]
Comparison = Callable[[MetricResult, MetricResult], MetricResult]


def difference(main_result: MetricResult,
               baseline_result: MetricResult) -> MetricResult:
  return {
      k: main_result[k] - baseline_result[k]
      for k in main_result.keys() & baseline_result.keys()
  }


class BaselineComparison(metrics_base.Metric):
  """Metric comparing an underlying metric's values against a baseline.

  Statistics are the union of the main/baseline statistics under
  'main_'/'baseline_' unique-name prefixes; the finalizer applies the
  comparison (default: difference). Constructed post-hoc over a combined
  AggregationState (reference ``baseline_comparison.py:41-131``).
  """

  def __init__(self, metric: metrics_base.Metric,
               baseline_metric: metrics_base.Metric | None = None,
               comparison: Comparison = difference):
    self.metric = metric
    self.baseline_metric = baseline_metric or metric
    self._comparison = comparison

  @property
  def statistics(self) -> Mapping[str, metrics_base.Statistic]:
    main_stats = {
        f'main_{name}': wrappers.RenamedStatistic(
            stat, f'main_{stat.unique_name}')
        for name, stat in self.metric.statistics.items()
    }
    baseline_stats = {
        f'baseline_{name}': wrappers.RenamedStatistic(
            stat, f'baseline_{stat.unique_name}')
        for name, stat in self.baseline_metric.statistics.items()
    }
    return {**main_stats, **baseline_stats}

  def values_from_mean_statistics(self, statistic_values):
    main_values = {
        name[len('main_'):]: v for name, v in statistic_values.items()
        if name.startswith('main_')}
    baseline_values = {
        name[len('baseline_'):]: v for name, v in statistic_values.items()
        if name.startswith('baseline_')}
    main_result = self.metric.values_from_mean_statistics(main_values)
    baseline_result = self.baseline_metric.values_from_mean_statistics(
        baseline_values)
    return self._comparison(main_result, baseline_result)


def combine_aggregation_states(
    aggregation_state: aggregation.AggregationState,
    baseline_aggregation_state: aggregation.AggregationState,
) -> aggregation.AggregationState:
  """Merges main and baseline states under prefixed statistic names."""
  return aggregation.AggregationState(
      sum_weighted_statistics={
          **{f'main_{k}': v for k, v in
             aggregation_state.sum_weighted_statistics.items()},
          **{f'baseline_{k}': v for k, v in
             baseline_aggregation_state.sum_weighted_statistics.items()},
      },
      sum_weights={
          **{f'main_{k}': v for k, v in
             aggregation_state.sum_weights.items()},
          **{f'baseline_{k}': v for k, v in
             baseline_aggregation_state.sum_weights.items()},
      },
  )


def for_metrics(
    metrics: Mapping[str, metrics_base.Metric],
    baseline_metrics: Mapping[str, metrics_base.Metric] | None = None,
    comparison: Comparison = difference,
) -> Mapping[str, BaselineComparison]:
  """BaselineComparisons for all metrics present in both mappings."""
  if baseline_metrics is None:
    baseline_metrics = metrics
  return {
      name: BaselineComparison(metrics[name], baseline_metrics[name],
                               comparison)
      for name in metrics.keys() & baseline_metrics.keys()
  }
