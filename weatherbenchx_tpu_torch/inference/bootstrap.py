"""Bootstrap-based statistical inference.

The port of ``weatherbenchx_tpu/inference/bootstrap.py`` (reference
``weatherbenchX/statistical_inference/bootstrap.py``). Resampling is
expressed as count-matrix contractions (``AggregationState.dot``, one
``torch.einsum``) and index-matrix gathers (``DimArray.take``), in float64
on the state's device. The counts and indices come from numpy's
``default_rng`` on the host, as in the JAX package, so both packages
resample the same units for one seed. The p-values' CDF inversion is a
host loop over the points, as there.
"""

import functools
from typing import Mapping, final

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.inference import autodiff
from weatherbenchx_tpu_torch.inference import base
from weatherbenchx_tpu_torch.inference import block_length
from weatherbenchx_tpu_torch.inference import utils
from weatherbenchx_tpu_torch.metrics import base as metrics_base

_REPLICATE_DIM = 'bootstrap_replicate'


class Bootstrap(base.StatisticalInferenceMethod):
  """Superclass for bootstrap methods (percentile CIs, CDF-inversion p).

  NaN replicates are skipped throughout (reference rationale:
  ``bootstrap.py:74-84``).
  """

  _resampled_values: base.MetricValues
  _point_estimates: base.MetricValues

  @property
  def resampled_values(self) -> base.MetricValues:
    return self._resampled_values

  def point_estimates(self) -> base.MetricValues:
    return self._point_estimates

  @final
  def standard_error_estimates(self) -> base.MetricValues:
    return tree.map_structure(
        lambda x: x.std(_REPLICATE_DIM, ddof=1, skipna=True),
        self.resampled_values)

  @final
  def confidence_intervals(self, alpha: float = 0.05):
    def q(x, p):
      return x.quantile(p, _REPLICATE_DIM, skipna=True).isel(quantile=0)
    return (
        tree.map_structure(lambda x: q(x, alpha / 2), self.resampled_values),
        tree.map_structure(lambda x: q(x, 1 - alpha / 2),
                           self.resampled_values),
    )

  @final
  def p_values(self, null_value: float = 0.) -> base.MetricValues:
    """Two-sided p-value by inverting the percentile interval."""

    def p_value_1d(resampled: np.ndarray) -> float:
      resampled = resampled[~np.isnan(resampled)]
      if resampled.size == 0:
        return np.nan
      data = np.sort(resampled)
      q = np.linspace(0, 1, data.shape[0])
      cdf_at_null = np.interp(null_value, data, q)
      return 2 * min(cdf_at_null, 1 - cdf_at_null)

    def p_value(resampled: DimArray) -> DimArray:
      order = [d for d in resampled.dims if d != _REPLICATE_DIM]
      r = resampled.transpose(*(order + [_REPLICATE_DIM]))
      v = r.values
      flat = v.reshape((-1, v.shape[-1]))
      out = np.array([p_value_1d(row) for row in flat]).reshape(v.shape[:-1])
      coords = {k: c for k, c in r.coords.items()
                if _REPLICATE_DIM not in c.dims}
      return DimArray(torch.as_tensor(out, device=r.device), tuple(order),
                      coords)

    return tree.map_structure(p_value, self.resampled_values)


class IIDBootstrap(Bootstrap):
  """IID bootstrap via a multinomial count-matrix contraction.

  Reference ``bootstrap.py:131-160``: instead of gathering resampled units,
  sample counts of how often each unit appears per replicate and contract —
  one einsum over (unit × replicate) on device.
  """

  def __init__(
      self,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
      experimental_unit_dim: str,
      n_replicates: int,
      seed: int | None = None,
  ):
    aggregated_statistics = utils.as_float64(aggregated_statistics)
    num_units = np.asarray(utils.get_and_check_experimental_unit_coord(
        aggregated_statistics, experimental_unit_dim).values).size
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(
        num_units, np.full(num_units, 1 / num_units), size=n_replicates)
    counts_da = DimArray(
        counts.astype(np.float64), (_REPLICATE_DIM, experimental_unit_dim))
    resampled_stats = aggregated_statistics.dot(
        counts_da, dim=experimental_unit_dim)
    self._point_estimates = metrics_base.compute_metrics_from_statistics(
        metrics, aggregated_statistics.sum_along_dims(
            [experimental_unit_dim]).mean_statistics())
    self._resampled_values = metrics_base.compute_metrics_from_statistics(
        metrics, resampled_stats.mean_statistics())


class ClusterBootstrap(Bootstrap):
  """Resamples clusters given by distinct values of a (1-D) coordinate.

  Assumes independence between clusters, arbitrary dependence within
  (reference ``bootstrap.py:163-235``).
  """

  def __init__(
      self,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
      experimental_unit_coord: str,
      n_replicates: int,
      seed: int | None = None,
  ):
    aggregated_statistics = utils.as_float64(aggregated_statistics)
    coord = utils.get_and_check_experimental_unit_coord(
        aggregated_statistics, experimental_unit_coord, check_is_dim=False)
    experimental_unit_dim = coord.dims[0]
    unique_ids, cluster_ids = np.unique(
        np.asarray(coord.values), return_inverse=True)
    num_units = unique_ids.shape[0]
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(
        num_units, np.full(num_units, 1 / num_units), size=n_replicates)
    # Per-unit counts: look up each unit's cluster count.
    counts_per_unit = counts[:, cluster_ids]
    counts_da = DimArray(
        counts_per_unit.astype(np.float64),
        (_REPLICATE_DIM, experimental_unit_dim))
    resampled_stats = aggregated_statistics.dot(
        counts_da, dim=experimental_unit_dim)
    self._point_estimates = metrics_base.compute_metrics_from_statistics(
        metrics, aggregated_statistics.sum_along_dims(
            [experimental_unit_dim]).mean_statistics())
    self._resampled_values = metrics_base.compute_metrics_from_statistics(
        metrics, resampled_stats.mean_statistics())


def stationary_bootstrap_indices(
    n_data: int,
    mean_block_length: float,
    n_replicates: int,
    seed: int | None = None,
    dtype=np.int64,
) -> np.ndarray:
  """Politis-Romano circular-block indices, shape (n_data, n_replicates)."""
  rng = np.random.default_rng(seed)
  end_block_prob = 1 / mean_block_length
  current = rng.integers(n_data, size=(n_replicates,), dtype=dtype)
  all_indices = [current]
  for _ in range(1, n_data):
    end_flags = rng.random(n_replicates) < end_block_prob
    new_random = rng.integers(n_data, size=(n_replicates,), dtype=dtype)
    nxt = (current + 1) % n_data  # circular wrap avoids endpoint bias
    current = np.where(end_flags, new_random, nxt)
    all_indices.append(current)
  return np.stack(all_indices, axis=0)


class StationaryBootstrap(Bootstrap):
  """Stationary (Politis-Romano) block bootstrap with automatic block length.

  Block length selected per metric/variable/extra-dim-slice on the
  linearized per-unit values (reference ``bootstrap.py:262-555``); the
  Politis-White selection runs in-repo (``block_length.py``).
  """

  def __init__(
      self,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
      experimental_unit_dim: str,
      n_replicates: int,
      mean_block_length: float | None = None,
      block_length_rounding_resolution: float | None = 30.0,
      stationary_bootstrap_indices_cache_size: int = 50,
      seed: int | None = None,
  ):
    aggregated_statistics = utils.as_float64(aggregated_statistics)
    self._experimental_unit_dim = experimental_unit_dim
    self._mean_block_length = mean_block_length
    self._n_replicates = n_replicates
    self._aggregated_statistics = aggregated_statistics
    self._block_length_rounding_resolution = block_length_rounding_resolution
    self._seed = seed
    self._stationary_bootstrap_indices = functools.lru_cache(
        maxsize=stationary_bootstrap_indices_cache_size)(
            stationary_bootstrap_indices)

    (self._point_estimates, self._per_unit_tangents
     ) = autodiff.per_unit_values_linearized_around_mean_statistics(
         metrics, aggregated_statistics, experimental_unit_dim)

    self._resampled_values = {}
    for metric_name, metric in metrics.items():
      self._resampled_values[metric_name] = (
          self._bootstrap_results_for_metric(
              metric,
              self._point_estimates[metric_name],
              self._per_unit_tangents[metric_name]))

  def _optimal_block_length(self, data_array: DimArray) -> float:
    if self._mean_block_length is not None:
      return self._mean_block_length
    assert self._experimental_unit_dim in data_array.dims
    if data_array.sizes[self._experimental_unit_dim] < 8:
      raise ValueError(
          'Need at least 8 data points along experimental_unit_dim '
          f'{self._experimental_unit_dim} to set mean_block_length '
          'automatically -- and many more than 8 recommended.')
    values = data_array.values.squeeze()
    assert values.ndim == 1
    result = block_length.optimal_block_length_stationary(values)
    result = max(1.0, result)
    if self._block_length_rounding_resolution is not None:
      result = utils.logarithmic_round(
          result, self._block_length_rounding_resolution)
    return result

  def _bootstrap_results_for_metric(
      self, metric, point_estimates, per_unit_tangents):
    sum_weighted_stats = {
        stat_name: self._aggregated_statistics.sum_weighted_statistics[
            stat.unique_name]
        for stat_name, stat in metric.statistics.items()}
    sum_weights = {
        stat_name: self._aggregated_statistics.sum_weights[stat.unique_name]
        for stat_name, stat in metric.statistics.items()}
    resampled_values = {}
    for var_name in point_estimates.keys():
      if (len(point_estimates) > 1
          and all(var_name in vars_ for vars_ in sum_weighted_stats.values())):
        ws_for_var = {sn: {var_name: v[var_name]}
                      for sn, v in sum_weighted_stats.items()}
        w_for_var = {sn: {var_name: v[var_name]}
                     for sn, v in sum_weights.items()}
      else:
        ws_for_var = sum_weighted_stats
        w_for_var = sum_weights
      resampled_values[var_name] = utils.apply_to_slices(
          functools.partial(self._bootstrap_results_for_metric_scalar,
                            metric, var_name),
          per_unit_tangents[var_name],
          ws_for_var,
          w_for_var,
          dim=point_estimates[var_name].dims,
      )
    return resampled_values

  def _bootstrap_results_for_metric_scalar(
      self, metric, var_name, per_unit_tangents, sum_weighted_stats,
      sum_weights) -> DimArray:
    n_data = per_unit_tangents.sizes[self._experimental_unit_dim]
    mean_block_length = self._optimal_block_length(per_unit_tangents)
    indices = self._stationary_bootstrap_indices(
        n_data=n_data,
        mean_block_length=mean_block_length,
        n_replicates=self._n_replicates,
        seed=self._seed,
    )

    unit = self._experimental_unit_dim

    def sum_of_resampled(data: DimArray) -> DimArray:
      resampled = data.take(unit, indices, (unit, _REPLICATE_DIM))
      return resampled.sum(unit)

    sum_weighted_stats, sum_weights = tree.map_structure(
        sum_of_resampled, (sum_weighted_stats, sum_weights))
    mean_stats = tree.map_structure(
        lambda x, y: x / y, sum_weighted_stats, sum_weights)
    return metric.values_from_mean_statistics(mean_stats)[var_name]
