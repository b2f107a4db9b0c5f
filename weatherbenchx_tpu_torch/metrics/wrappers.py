"""Input-transform wrappers for statistics and metrics.

The port of the part of ``weatherbenchx_tpu/metrics/wrappers.py`` the
benchmark CLI uses (:58-100, 484-557): ``InputTransform``,
``EnsembleMean``, ``WrappedStatistic``, ``RenamedStatistic`` and
``WrappedMetric``. Unique-name suffixes are the JAX package's text
exactly: saved AggregationState keys depend on them. The wrapping
statistics forward ``prepare_chunk`` and the evaluator's resource
contract to the statistic they wrap. The other transforms (thresholds,
quantiles, selections, ...) are not ported yet.
"""

import abc
from typing import Hashable, Mapping, Sequence

from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.metrics import base


class InputTransform(abc.ABC):
  """Base class for input transformations."""

  def __init__(self, which: str):
    if which not in ['predictions', 'targets', 'both']:
      raise ValueError(f'Invalid value for `which`: {which}')
    self.which = which

  @property
  @abc.abstractmethod
  def unique_name_suffix(self) -> str:
    """Suffix identifying this transform and its parameters."""

  @abc.abstractmethod
  def transform_fn(self, da: DimArray,
                   name: Hashable | None = None) -> DimArray:
    """Function applied to predictions and/or targets arrays."""


class EnsembleMean(InputTransform):
  """Mean over the ensemble dimension."""

  def __init__(self, which: str, ensemble_dim: str = 'number',
               skipna: bool = False,
               skip_if_ensemble_dim_missing: bool = False):
    super().__init__(which)
    self._ensemble_dim = ensemble_dim
    self._skipna = skipna
    self._skip_if_ensemble_dim_missing = skip_if_ensemble_dim_missing

  @property
  def unique_name_suffix(self) -> str:
    # The 'self._'-prefixed key text is the JAX package's (an f-string '='
    # specifier upstream); saved AggregationState keys must match it.
    return (f'ensemble_mean_self._ensemble_dim={self._ensemble_dim!r}_'
            f'self._skipna={self._skipna}')

  def transform_fn(self, da, name=None):
    if self._ensemble_dim not in da.dims and self._skip_if_ensemble_dim_missing:
      return da
    return da.mean(self._ensemble_dim, skipna=self._skipna)


class _ForwardingStatistic(base.Statistic):
  """A statistic around ``self.statistic``: forwards the host hook and the
  evaluator's resource contract to it."""

  statistic: base.Statistic

  def prepare_chunk(self, predictions, targets):
    return self.statistic.prepare_chunk(predictions, targets)

  def device_resource_arrays(self):
    return self.statistic.device_resource_arrays()

  def host_gatherable_resource_arrays(self):
    return self.statistic.host_gatherable_resource_arrays()

  def set_host_gather_resources(self, ids) -> None:
    self.statistic.set_host_gather_resources(ids)


class WrappedStatistic(_ForwardingStatistic):
  """Wraps a statistic with one input transform (name-suffixing)."""

  def __init__(self, statistic: base.Statistic, transform: InputTransform):
    self.statistic = statistic
    self.transform = transform

  @property
  def unique_name(self) -> str:
    return (f'{self.statistic.unique_name}_{self.transform.which}_'
            f'{self.transform.unique_name_suffix}')

  def compute(self, predictions, targets):
    if self.transform.which in ('predictions', 'both'):
      predictions = {k: self.transform.transform_fn(v, k)
                     for k, v in predictions.items()}
    if self.transform.which in ('targets', 'both'):
      targets = {k: self.transform.transform_fn(v, k)
                 for k, v in targets.items()}
    return self.statistic.compute(predictions, targets)


class RenamedStatistic(_ForwardingStatistic):
  """Wraps a statistic with a new unique name."""

  def __init__(self, statistic: base.Statistic, unique_name: str):
    self.statistic = statistic
    self._unique_name = unique_name

  @property
  def unique_name(self) -> str:
    return self._unique_name

  def compute(self, predictions, targets):
    return self.statistic.compute(predictions, targets)


class WrappedMetric(base.Metric):
  """Wraps all statistics of a metric with a list of input transforms.

  Transforms [f, g, h] apply as h(g(f(x))).
  """

  def __init__(self, metric: base.Metric,
               transforms: Sequence[InputTransform],
               unique_name_suffix: str | None = None):
    self.metric = metric
    self.transforms = list(transforms)
    self.unique_name_suffix = unique_name_suffix

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    stats = {}
    for stat_name, stat in self.metric.statistics.items():
      original_name = stat.unique_name
      for wrapper in self.transforms[::-1]:
        stat = WrappedStatistic(stat, wrapper)
      if self.unique_name_suffix is not None:
        stat = RenamedStatistic(
            stat, f'{original_name}_{self.unique_name_suffix}')
      stats[stat_name] = stat
    return stats

  def values_from_mean_statistics(self, statistic_values):
    return self.metric.values_from_mean_statistics(statistic_values)
