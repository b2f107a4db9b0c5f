"""Deterministic statistics and metrics.

The port of ``weatherbenchx_tpu/metrics/deterministic.py``: plain
elementwise tensor code, no kernel. The climatology statistics (ACC and
prediction activity) align their climatology through ``metrics/base``.
"""

from typing import Hashable, Mapping, Sequence, Union

import numpy as np
import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base


### Statistics


class RelativeIntensity(base.PerVariableStatistic):
  """|ratio of spatial-mean prediction to spatial-mean target - 1|.

  Mask-aware spatial means with epsilon regularization (1e-6). Intended
  for non-negative fields such as precipitation.
  """

  def reads_across(self):
    return self._spatial_dims

  def __init__(self, spatial_dims: Sequence[str] = ('latitude', 'longitude')):
    self._spatial_dims = tuple(spatial_dims)

  def _compute_per_variable(self, predictions, targets):
    spatial_dims = self._spatial_dims
    epsilon = 1e-6
    if targets.has_coord('mask'):
      mask = DimArray(targets.coords['mask'].values,
                      targets.coords['mask'].dims) == 1
      count = mask.astype(predictions.dtype).broadcast_like(
          targets).sum(spatial_dims)
      prediction_sum = predictions.where(mask, 0).sum(spatial_dims)
      target_sum = targets.where(mask, 0).sum(spatial_dims)
      prediction_mean = (prediction_sum / count).where(count > 0, 0.0)
      target_mean = (target_sum / count).where(count > 0, 0.0)
      result = abs((prediction_mean + epsilon) / (target_mean + epsilon) - 1)
      return result.assign_coords(
          mask=Coord(count.dims, (count > 0).astype(torch.int64).data))
    prediction_mean = predictions.mean(spatial_dims)
    target_mean = targets.mean(spatial_dims)
    return abs((prediction_mean + epsilon) / (target_mean + epsilon) - 1)


class Error(base.PerVariableStatistic):
  """prediction - target."""

  def reads_across(self):
    return ()

  def _compute_per_variable(self, predictions, targets):
    return predictions - targets


class AbsoluteError(base.PerVariableStatistic):
  """|prediction - target|."""

  def reads_across(self):
    return ()

  def _compute_per_variable(self, predictions, targets):
    return abs(predictions - targets)


class SquaredError(base.PerVariableStatistic):
  """(prediction - target)^2."""

  def reads_across(self):
    return ()

  def _compute_per_variable(self, predictions, targets):
    return (predictions - targets) ** 2


class PredictionPassthrough(base.PerVariableStatistic):
  """Returns predictions (broadcast against the targets' dims and coords)."""

  def reads_across(self):
    return ()

  def __init__(self, copy_nans_from_targets: bool = False):
    self._copy_nans_from_targets = copy_nans_from_targets

  def _compute_per_variable(self, predictions, targets):
    result = predictions + darray.zeros_like(targets)
    if self._copy_nans_from_targets:
      result = result.where(~targets.isnull())
    return result


class TargetPassthrough(base.PerVariableStatistic):
  """Returns targets (broadcast against the predictions' dims and coords)."""

  def reads_across(self):
    return ()

  def __init__(self, copy_nans_from_predictions: bool = False):
    self._copy_nans_from_predictions = copy_nans_from_predictions

  def _compute_per_variable(self, predictions, targets):
    result = targets + darray.zeros_like(predictions)
    if self._copy_nans_from_predictions:
      result = result.where(~predictions.isnull())
    return result


class WindVectorSquaredError(base.Statistic):
  """(u error)^2 + (v error)^2, as a new variable named ``vector_name``."""

  def reads_across(self):
    return ()

  def __init__(self, u_name: Sequence[str], v_name: Sequence[str],
               vector_name: Sequence[str]):
    self._u_name = list(u_name)
    self._v_name = list(v_name)
    self._vector_name = list(vector_name)
    if not len(self._u_name) == len(self._v_name) == len(self._vector_name):
      raise ValueError(
          'u_name, v_name, and vector_name must have the same length')

  @property
  def unique_name(self) -> str:
    return 'WindVectorSquaredError_' + '_'.join(self._vector_name)

  def compute(self, predictions, targets):
    return {vector: (predictions[u] - targets[u]) ** 2
                    + (predictions[v] - targets[v]) ** 2
            for u, v, vector in zip(self._u_name, self._v_name,
                                    self._vector_name)}


class SquaredPredictionAnomaly(base.PerVariableStatisticWithClimatology):
  """(prediction - climatology)^2."""

  def reads_across(self):
    return ()

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    return (predictions - aligned_climatology) ** 2


class SquaredTargetAnomaly(base.PerVariableStatisticWithClimatology):
  """(target - climatology)^2."""

  def reads_across(self):
    return ()

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    return (targets - aligned_climatology) ** 2


class AnomalyCovariance(base.PerVariableStatisticWithClimatology):
  """(prediction - climatology) * (target - climatology)."""

  def reads_across(self):
    return ()

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    return (predictions - aligned_climatology) * (
        targets - aligned_climatology)


class ErrorExceedance(base.PerVariableStatistic):
  """Indicator of |error| > each threshold, NaN where the error or the
  threshold is NaN; the thresholds become an
  ``error_exceedance_thresholds`` dim."""

  def reads_across(self):
    return tuple(d for d in self._thresholds.dims
                 if d != 'error_exceedance_thresholds')

  def __init__(self, thresholds: Sequence[float] | DimArray):
    if not isinstance(thresholds, DimArray):
      # Kept at float64 so the comparison constants can be rounded
      # directionally to the data dtype at compute time
      # (darray.comparison_safe_threshold).
      t = np.asarray(thresholds, dtype=np.float64)
      thresholds = DimArray(t, ('error_exceedance_thresholds',),
                            {'error_exceedance_thresholds': t})
    self._thresholds = thresholds

  def _compute_per_variable(self, predictions, targets):
    abs_error = abs(predictions - targets)
    thresholds_cmp = darray.comparison_safe_threshold(
        self._thresholds, abs_error.dtype, '>')
    out = (abs_error > thresholds_cmp).astype(predictions.dtype)
    out = out.where(~abs_error.isnull())
    return out.where(~self._thresholds.isnull())


### Metrics

# Metrics that are just the mean of a Statistic: use the Statistic directly.
Bias = Error
MAE = AbsoluteError
MSE = SquaredError
PredictionAverage = PredictionPassthrough
TargetAverage = TargetPassthrough


class RMSE(base.PerVariableMetric):
  """Root mean squared error."""

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {'SquaredError': SquaredError()}

  def _values_from_mean_statistics_per_variable(self, statistic_values):
    return darray.sqrt(statistic_values['SquaredError'])


class WindVectorRMSE(base.Metric):
  """sqrt of the mean wind-vector squared error."""

  def __init__(self, u_name: Union[str, list], v_name: Union[str, list],
               vector_name: Union[str, list]):
    self._u_name = [u_name] if isinstance(u_name, str) else list(u_name)
    self._v_name = [v_name] if isinstance(v_name, str) else list(v_name)
    self._vector_name = ([vector_name] if isinstance(vector_name, str)
                         else list(vector_name))
    if not len(self._u_name) == len(self._v_name) == len(self._vector_name):
      raise ValueError(
          'u_name, v_name, and vector_name must have the same length')

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {'WindVectorSquaredError': WindVectorSquaredError(
        self._u_name, self._v_name, self._vector_name)}

  def values_from_mean_statistics(self, statistic_values):
    return tree.map_structure(
        darray.sqrt, dict(statistic_values['WindVectorSquaredError']))


class ACC(base.PerVariableMetric):
  """Anomaly correlation coefficient."""

  def __init__(self, climatology: Mapping[Hashable, DimArray]):
    self._climatology = climatology

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        'SquaredPredictionAnomaly': SquaredPredictionAnomaly(
            climatology=self._climatology),
        'SquaredTargetAnomaly': SquaredTargetAnomaly(
            climatology=self._climatology),
        'AnomalyCovariance': AnomalyCovariance(climatology=self._climatology),
    }

  def _values_from_mean_statistics_per_variable(self, statistic_values):
    return statistic_values['AnomalyCovariance'] / (
        darray.sqrt(statistic_values['SquaredPredictionAnomaly'])
        * darray.sqrt(statistic_values['SquaredTargetAnomaly']))


class PredictionActivity(base.PerVariableMetric):
  """Standard deviation of the prediction anomalies."""

  def __init__(self, climatology: Mapping[Hashable, DimArray]):
    self._climatology = climatology

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {'SquaredPredictionAnomaly': SquaredPredictionAnomaly(
        climatology=self._climatology)}

  def _values_from_mean_statistics_per_variable(self, statistic_values):
    return darray.sqrt(statistic_values['SquaredPredictionAnomaly'])
