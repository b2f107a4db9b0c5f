"""The Metric/Statistic contract.

The port of ``weatherbenchx_tpu/metrics/base.py:66-360``:

* A ``Statistic`` maps a (predictions, targets) chunk — each a
  ``dict[var, DimArray]`` — to per-variable statistic arrays.
* A ``Metric`` names the statistics it needs and finalizes their
  (weighted) means via ``values_from_mean_statistics``.
* Statistics are deduplicated across metrics by ``unique_name``, loudly:
  two statistics that share a name but provably differ raise.
* ``computation_cache`` is the per-pass memo through which sibling
  statistics share one fused kernel launch.
"""

import abc
import contextlib
import threading
from typing import Any, Hashable, Mapping, final

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import Coord, DimArray


class Metric(abc.ABC):
  """A set of named Statistics plus a finalizer over their means."""

  @property
  @abc.abstractmethod
  def statistics(self) -> Mapping[str, 'Statistic']:
    """Statistics whose mean values are required to compute the metric."""

  @abc.abstractmethod
  def values_from_mean_statistics(
      self,
      statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
  ) -> Mapping[Hashable, DimArray]:
    """Computes metric values from mean statistics, keyed by internal name."""


class Statistic(Metric):
  """A per-chunk function of (predictions, targets), aggregated by mean.

  ``unique_name`` must capture every parameter that affects the value:
  deduplication and AggregationState keys rely on it. A Statistic is a
  Metric whose finalizer is the identity on the statistic's mean.
  """

  @property
  def unique_name(self) -> str:
    return type(self).__name__

  @abc.abstractmethod
  def compute(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> Mapping[Hashable, DimArray]:
    """Computes statistic values for a predictions/targets chunk."""

  def _dedup_identity(self) -> Mapping[str, Any]:
    """State compared when another statistic claims the same unique_name.

    Override to exclude parameters that select only the algorithm, not the
    value (e.g. ``CRPSSpread.use_sort``).
    """
    return vars(self)

  @final
  @property
  def statistics(self) -> Mapping[str, 'Statistic']:
    return {'self': self}

  @final
  def values_from_mean_statistics(self, statistic_values):
    return statistic_values['self']


class PerVariableStatistic(Statistic):
  """Statistic computed independently for each common variable."""

  @final
  def compute(self, predictions, targets):
    result = {}
    for var_name in predictions.keys():
      if var_name in targets.keys():
        per_var = self._compute_per_variable(
            predictions[var_name], targets[var_name])
        if per_var is not None:
          result[var_name] = per_var
    return result

  @abc.abstractmethod
  def _compute_per_variable(self, predictions: DimArray, targets: DimArray
                            ) -> DimArray | None:
    """Computes statistic for one variable, or None if undefined for it."""


class PerVariableMetric(Metric):
  """Metric computed independently for each variable common to all stats."""

  @final
  def values_from_mean_statistics(self, statistic_values):
    common_variables = set.intersection(
        *[set(statistic_values[s]) for s in self.statistics])
    values = {}
    for v in sorted(common_variables, key=str):
      values[v] = self._values_from_mean_statistics_per_variable(
          {s: statistic_values[s][v] for s in self.statistics})
    return values

  @abc.abstractmethod
  def _values_from_mean_statistics_per_variable(
      self, statistic_values: Mapping[str, DimArray]) -> DimArray:
    """Compute metric value for a single variable."""


def _host_array(v: Any) -> np.ndarray | None:
  """Numpy view of a host value or CPU tensor; None for device tensors."""
  if isinstance(v, torch.Tensor):
    if v.device.type != 'cpu':
      return None  # comparing would need a device sync
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
  return v if isinstance(v, np.ndarray) else None


def _provably_different(a: Any, b: Any, _depth: int = 0) -> bool:
  """True when two parameter values are demonstrably unequal.

  Conservative: opaque values (callables, tensors on a device) compare as
  equal, so the collision guard below never raises spuriously.
  """
  if a is b or _depth > 8:
    return False
  if type(a) is not type(b):
    return True
  if isinstance(a, (bool, int, float, complex, str, bytes)) or a is None:
    return a != b
  if isinstance(a, (np.ndarray, torch.Tensor)):
    ha, hb = _host_array(a), _host_array(b)
    if ha is None or hb is None:
      return False
    if ha.shape != hb.shape or ha.dtype != hb.dtype:
      return True
    return not (np.array_equal(ha, hb) or (
        ha.dtype.kind == 'f' and np.array_equal(ha, hb, equal_nan=True)))
  if isinstance(a, (list, tuple)):
    return (len(a) != len(b)
            or any(_provably_different(x, y, _depth + 1)
                   for x, y in zip(a, b)))
  if isinstance(a, dict):
    return (set(a) != set(b)
            or any(_provably_different(a[k], b[k], _depth + 1) for k in a))
  if isinstance(a, Coord):
    return (a.dims != b.dims
            or _provably_different(a.values, b.values, _depth + 1))
  if isinstance(a, DimArray):
    return a.dims != b.dims or _provably_different(a.data, b.data, _depth + 1)
  if isinstance(a, Statistic):
    return _provably_different(a._dedup_identity(), b._dedup_identity(),
                               _depth + 1)
  if hasattr(a, '__dict__'):
    return _provably_different(vars(a), vars(b), _depth + 1)
  return False


def unique_statistics_for_metrics(
    metrics: Mapping[str, Metric]) -> Mapping[str, Statistic]:
  """Deduplicates statistics across metrics by unique_name, loudly.

  Two statistics that share a unique_name but differ in value-affecting
  parameters would silently compute only one of them; that is an error.
  """
  out: dict[str, Statistic] = {}
  for m in metrics.values():
    for stat in m.statistics.values():
      prev = out.get(stat.unique_name)
      if prev is not None and _provably_different(prev, stat):
        raise ValueError(
            f'Two statistics with different parameters share the unique_name '
            f'{stat.unique_name!r} ({type(prev).__name__} vs '
            f'{type(stat).__name__}). Statistics are deduplicated across '
            f'metrics by unique_name, so only one of them would be computed.')
      out[stat.unique_name] = stat
  return out


_ACTIVE_COMPUTE_CACHE = threading.local()


@contextlib.contextmanager
def computation_cache():
  """A per-evaluation memo shared by the statistics of one compute pass.

  Statistics whose values derive from one fused computation (the CRPS
  skill/spread + ensemble moments kernel,
  ``ops/crps_pairwise.fused_ensemble_stats``) store it here keyed by their
  input tensors' identities, so sibling statistics of the same pass reuse
  one kernel launch instead of re-reading the ensemble. Scoped to one
  ``compute_unique_statistics_for_all_metrics`` call.
  """
  prev = getattr(_ACTIVE_COMPUTE_CACHE, 'cache', None)
  _ACTIVE_COMPUTE_CACHE.cache = {}
  try:
    yield
  finally:
    _ACTIVE_COMPUTE_CACHE.cache = prev


def get_computation_cache() -> dict | None:
  """The active per-evaluation memo, or None outside a compute pass."""
  return getattr(_ACTIVE_COMPUTE_CACHE, 'cache', None)


def compute_unique_statistics_for_all_metrics(
    metrics: Mapping[str, Metric],
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> dict[str, Mapping[Hashable, DimArray]]:
  """Computes deduplicated statistics for all metrics in one compute pass."""
  out = {}
  with computation_cache():
    for k, stat in unique_statistics_for_metrics(metrics).items():
      try:
        out[k] = stat.compute(predictions, targets)
      except Exception as e:
        raise ValueError(f'Failed to compute statistic {k}={stat}') from e
  return out


def compute_metric_from_statistics(
    metric: Metric,
    statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
) -> Mapping[Hashable, DimArray]:
  """Computes a metric from mean statistics keyed by unique_name."""
  return metric.values_from_mean_statistics({
      k: statistic_values[v.unique_name]
      for k, v in metric.statistics.items()})


def compute_metrics_from_statistics(
    metrics: Mapping[str, Metric],
    statistic_values: Mapping[str, Mapping[Hashable, DimArray]],
) -> Mapping[str, Mapping[Hashable, DimArray]]:
  """Computes multiple metrics from mean statistics keyed by unique_name."""
  return {name: compute_metric_from_statistics(metric, statistic_values)
          for name, metric in metrics.items()}
