"""t-test family on linearized per-unit metric values.

The port of ``weatherbenchx_tpu/inference/t_test.py`` (reference
``weatherbenchX/statistical_inference/t_test.py``). Variants: IID,
AR(2)-corrected (Geer 2016), and the Lazarus et al. 2018 EWC HAC estimator
(Diebold-Mariano-like when used with a paired baseline comparison). The
per-unit deviations and standard errors are float64 tensors on the
state's device; the t distribution (scipy) and the EWC's DCT
(``scipy.fft``) run on the host, and their results go back to the device.
"""

import abc
import dataclasses
import functools
from typing import Mapping, final

import numpy as np
import scipy.fft
import scipy.stats
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.inference import autodiff
from weatherbenchx_tpu_torch.inference import base
from weatherbenchx_tpu_torch.inference import utils
from weatherbenchx_tpu_torch.metrics import base as metrics_base


def _check_uniform_step(da: DimArray, dim: str) -> None:
  coord = da.coords.get(dim)
  if coord is None:
    return
  values = da.coord_values(dim)
  if values.dtype.kind in 'Mm':
    values = values.astype('int64')
  if np.issubdtype(values.dtype, np.number):
    diffs = np.diff(values)
    if diffs.size and not np.allclose(diffs, diffs[0]):
      raise ValueError(
          f'Found non-constant values along dimension {dim}. '
          'Non-uniform timestep not supported.')


def _variance_estimate_from_deviations(
    deviations: DimArray, dim: str, ddof: int = 1) -> DimArray:
  sample_size = deviations.sizes[dim]
  return (deviations ** 2).sum(dim) / (sample_size - ddof)


def _autocorrelation_estimate_from_deviations(
    deviations: DimArray, dim: str, lag: int = 1) -> DimArray:
  variance = _variance_estimate_from_deviations(deviations, dim)
  deviations = deviations.drop_coords([
      name for name, c in deviations.coords.items() if dim in c.dims])
  original = deviations.isel({dim: slice(0, -lag)})
  lagged = deviations.isel({dim: slice(lag, None)})
  result = (original * lagged).mean(dim) / variance
  # Constant series: autocorrelation undefined; safely treat as zero
  # (reference ``t_test.py:83-87``).
  return result.where(variance != 0, 0)


def _inflation_factor_from_ar2_autocorrelation(
    rho1: DimArray, rho2: DimArray) -> DimArray:
  """The inflation factor k from Geer (2016), assuming an AR(2) process."""
  denominator = (1 - rho1 ** 2)
  phi1 = (rho1 * (1 - rho2)) / denominator
  phi2 = (rho2 - rho1 ** 2) / denominator
  k_squared = (1 - rho1 * phi1 - rho2 * phi2) / (1 - phi1 - phi2) ** 2
  return darray.sqrt(k_squared)


@dataclasses.dataclass(frozen=True)
class _TTestResults:
  """t-test results for a single metric variable."""

  mean: DimArray
  standard_error: DimArray
  degrees_of_freedom: int

  def ci_lower(self, alpha: float = 0.05) -> DimArray:
    z = -scipy.stats.t(df=self.degrees_of_freedom).ppf(alpha / 2)
    return self.mean - self.standard_error * z

  def ci_upper(self, alpha: float = 0.05) -> DimArray:
    z = -scipy.stats.t(df=self.degrees_of_freedom).ppf(alpha / 2)
    return self.mean + self.standard_error * z

  def p_value(self, null_value: float = 0.) -> DimArray:
    difference = self.mean - null_value
    # Zero difference + zero stderr -> z=0 -> p=1; nonzero difference with
    # zero stderr -> inf -> p=0 (reference ``t_test.py:127-140``).
    z_score = darray.where(
        (difference == 0) & (self.standard_error == 0),
        0.0, difference / self.standard_error)
    t_dist = scipy.stats.t(df=self.degrees_of_freedom)
    cdf = t_dist.cdf(np.abs(z_score.values))
    return z_score.copy(data=torch.as_tensor(2 * (1 - cdf),
                                             device=z_score.device))


class _Base(base.StatisticalInferenceMethod):
  """Shared t-test machinery over linearized per-unit values."""

  def __init__(
      self,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
      experimental_unit_dim: str,
  ):
    (values, per_unit_tangents
     ) = autodiff.per_unit_values_linearized_around_mean_statistics(
         metrics, utils.as_float64(aggregated_statistics),
         experimental_unit_dim)
    self._results = tree.map_structure(
        functools.partial(self._compute_results, experimental_unit_dim),
        values, per_unit_tangents)

  @abc.abstractmethod
  def _compute_results(
      self, experimental_unit_dim: str, mean: DimArray,
      per_unit_deviations: DimArray) -> _TTestResults:
    """t-test results for one variable of one metric."""

  @final
  def point_estimates(self):
    return tree.map_structure(lambda x: x.mean, self._results)

  @final
  def standard_error_estimates(self) -> base.MetricValues:
    return tree.map_structure(lambda x: x.standard_error, self._results)

  @final
  def confidence_intervals(self, alpha: float = 0.05):
    return (
        tree.map_structure(lambda x: x.ci_lower(alpha), self._results),
        tree.map_structure(lambda x: x.ci_upper(alpha), self._results),
    )

  @final
  def p_values(self, null_value: float = 0.) -> base.MetricValues:
    return tree.map_structure(
        lambda x: x.p_value(null_value), self._results)


class IID(_Base):
  """The classic t-test assuming i.i.d. evaluation units."""

  def _compute_results(self, experimental_unit_dim, mean,
                       per_unit_deviations) -> _TTestResults:
    sample_size = per_unit_deviations.sizes[experimental_unit_dim]
    variance = _variance_estimate_from_deviations(
        per_unit_deviations, experimental_unit_dim, ddof=1)
    stderr = darray.sqrt(variance / sample_size)
    return _TTestResults(mean, stderr, sample_size - 1)


class GeerAR2Corrected(_Base):
  """t-test with AR(2) stderr inflation (Geer 2016).

  Reference ``t_test.py:278-330``: inflates the standard error by the
  long-run factor k derived from lag-1/lag-2 autocorrelations under a
  stationary AR(2) assumption; dof unchanged.
  """

  def _compute_results(self, experimental_unit_dim, mean,
                       per_unit_deviations) -> _TTestResults:
    _check_uniform_step(per_unit_deviations, experimental_unit_dim)
    sample_size = per_unit_deviations.sizes[experimental_unit_dim]
    variance = _variance_estimate_from_deviations(
        per_unit_deviations, experimental_unit_dim, ddof=1)
    r1 = _autocorrelation_estimate_from_deviations(
        per_unit_deviations, experimental_unit_dim, lag=1)
    r2 = _autocorrelation_estimate_from_deviations(
        per_unit_deviations, experimental_unit_dim, lag=2)
    k = _inflation_factor_from_ar2_autocorrelation(r1, r2)
    stderr = darray.sqrt(variance / sample_size) * k
    return _TTestResults(mean, stderr, sample_size - 1)


class LazarusHACEWC(_Base):
  """EWC (equal-weighted cosine) HAC t-test, Lazarus et al. 2018.

  Long-run variance from the first v = v₀·T^(2/3) DCT coefficients
  (excluding DC); dof = v. Diebold-Mariano-like when used via
  ``for_baseline_comparison``. Reference ``t_test.py:333-485``.
  """

  def __init__(
      self,
      metrics: Mapping[str, metrics_base.Metric],
      aggregated_statistics: aggregation.AggregationState,
      experimental_unit_dim: str,
      v_0: float = 0.4,
  ):
    self._v_0 = v_0
    super().__init__(metrics, aggregated_statistics, experimental_unit_dim)

  def _compute_results(self, experimental_unit_dim, mean,
                       per_unit_deviations) -> _TTestResults:
    sample_size = per_unit_deviations.sizes[experimental_unit_dim]
    _check_uniform_step(per_unit_deviations, experimental_unit_dim)
    v = int(self._v_0 * (sample_size ** (2 / 3)))
    v = max(1, min(v, sample_size - 1))

    # Move the unit dim last and project onto the DCT-II basis on the host
    # (scipy.fft, as the JAX package does).
    order = [d for d in per_unit_deviations.dims
             if d != experimental_unit_dim] + [experimental_unit_dim]
    devs = per_unit_deviations.transpose(*order)
    projections = scipy.fft.dct(devs.values, type=2, axis=-1, norm='ortho')
    projections = projections[..., 1:v + 1]
    long_run_variance = np.mean(projections ** 2, axis=-1)
    stderr = DimArray(
        torch.as_tensor(np.sqrt(long_run_variance / sample_size),
                        device=devs.device), tuple(order[:-1]),
        {k: c for k, c in devs.coords.items()
         if experimental_unit_dim not in c.dims})
    return _TTestResults(mean=mean, standard_error=stderr,
                         degrees_of_freedom=v)
