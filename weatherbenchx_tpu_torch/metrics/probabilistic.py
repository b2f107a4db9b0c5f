"""Probabilistic (ensemble) statistics and metrics.

The port of ``weatherbenchx_tpu/metrics/probabilistic.py``. Inside a
compute pass, CRPSSkill, CRPSSpread, EnsembleVariance and
UnbiasedEnsembleMeanSquaredError share ONE launch of the fused
ensemble-statistics kernel (``ops/crps_pairwise.fused_ensemble_stats``)
through ``base.computation_cache``, so the ensemble is read once. Outside
a pass, and for ensemble targets, CRPSSpread takes the spread-only kernel;
CRPSSkill against ensemble targets takes the cross kernel. All route by
device: a CPU tensor takes the kernel's plain version, a CUDA tensor the
kernel, at any ensemble size. Dtypes the kernels do not take (e.g. float64)
use the plain tensor forms.

The rank histogram, the relative economic value, the ensemble ranked
probability score, the Wasserstein distance and the ensemble-averaged
wrappers are jnp in the JAX package, with no kernel of their own, and
torch ops here. None scatters or adds atomically: the one-hot counts are
compare-and-sum, so a chunk evaluated twice gives the same bits.
"""

from typing import Mapping, Tuple

import numpy as np
import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import categorical
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import wrappers
from weatherbenchx_tpu_torch.ops import crps_pairwise

ENSEMBLE_DIM = 'number'


### Statistics


class EnsembleAveragedStatistic(wrappers._ForwardingStatistic):
  """Averages a wrapped statistic over the ensemble dimension."""

  def reads_across(self):
    return wrappers.union_reads_across(
        self.statistic.reads_across(), (self._ensemble_dim,))

  def __init__(self, wrapped_statistic: base.Statistic, *,
               ensemble_dim: str, skipna_ensemble: bool):
    self.statistic = wrapped_statistic
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def unique_name(self) -> str:
    # skipna_ensemble is appended only when on, so that states written
    # with the default keep the name upstream WeatherBench-X gives them.
    name = self.statistic.unique_name + '_each_' + self._ensemble_dim
    if self._skipna_ensemble:
      name += '_skipna_ensemble'
    return name

  def compute(self, predictions, targets):
    def reduce_over_ensemble(da: DimArray) -> DimArray:
      if self._ensemble_dim not in da.dims:
        raise ValueError(
            f'Dimension {self._ensemble_dim} not found in {da.dims}')
      return da.mean(self._ensemble_dim, skipna=self._skipna_ensemble)

    return tree.map_structure(
        reduce_over_ensemble, dict(self.statistic.compute(predictions,
                                                          targets)))


class EnsembleAveragedMetric(base.Metric):
  """Wraps a metric to average its statistics over the ensemble dim."""

  def __init__(self, wrapped_metric: base.Metric, *,
               ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._wrapped_metric = wrapped_metric
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        name: EnsembleAveragedStatistic(
            wrapped_statistic=stat, ensemble_dim=self._ensemble_dim,
            skipna_ensemble=self._skipna_ensemble)
        for name, stat in self._wrapped_metric.statistics.items()}

  def values_from_mean_statistics(self, statistic_values):
    return self._wrapped_metric.values_from_mean_statistics(statistic_values)


class CRPSSkill(base.PerVariableStatistic):
  """The skill term of CRPS, E|X - Y|.

  Ensemble targets (the ensemble dim on both sides) take the two-ensemble
  cross kernel where it applies, else a pseudo ensemble dim on the targets
  and an O(Mx·My) broadcast.
  """

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def unique_name(self) -> str:
    name = f'CRPSSkill_{self._ensemble_dim}'
    if self._skipna_ensemble:
      name += '_skipna_ensemble'
    return name

  def _compute_per_variable(self, predictions, targets):
    ens = self._ensemble_dim
    if ens in targets.dims:
      cross = self._maybe_cross_kernel(predictions, targets)
      if cross is not None:
        return cross
      pseudo = f'{ens}_PSEUDO_FOR_TARGETS'
      return abs(predictions - targets.rename({ens: pseudo})).mean(
          (ens, pseudo), skipna=self._skipna_ensemble)
    if not self._skipna_ensemble:
      fused = _fused_ensemble_pass(predictions, targets, ens)
      if fused is not None:
        return fused['skill_sum'] / fused['m']
    return abs(predictions - targets).mean(ens, skipna=self._skipna_ensemble)

  def _maybe_cross_kernel(self, predictions, targets):
    """Two-ensemble E|X−Y| by the cross kernel, or None where it does not
    apply: skipna on, differing non-ensemble dims or sizes, or a dtype the
    kernel does not take (NaN propagation matches skipna=False)."""
    ens = self._ensemble_dim
    if self._skipna_ensemble:
      return None
    rest = [d for d in predictions.dims if d != ens]
    if (sorted(d for d in targets.dims if d != ens) != sorted(rest)
        or any(targets.sizes[d] != predictions.sizes[d] for d in rest)
        or predictions.dtype != targets.dtype
        or predictions.dtype not in crps_pairwise.KERNEL_DTYPES):
      return None
    mx, my = predictions.sizes[ens], targets.sizes[ens]
    total = crps_pairwise.pairwise_cross_sum(
        predictions.transpose(ens, *rest).data,
        targets.transpose(ens, *rest).data)
    # Coords from BOTH operands, as the broadcast form's arithmetic would
    # give: a targets-side ``mask`` coord must survive masked aggregation.
    coords = darray._merge_coords(tuple(rest), predictions.coords,
                                  targets.coords)
    return DimArray(total / (mx * my), tuple(rest), coords)


def _fused_ensemble_pass(predictions, targets, ensemble_dim):
  """The fused kernel's results for this compute pass, or None.

  One launch gives CRPS spread, CRPS skill, the ensemble mean and
  Σ(x−mean)²; sibling statistics of the same pass find it in
  ``base.computation_cache`` instead of launching again. Deterministic
  targets with the predictions' data dims and dtype only; None outside a
  compute pass, so each statistic then takes its standalone path.
  """
  cache = base.get_computation_cache()
  if cache is None:
    return None
  if ensemble_dim not in predictions.dims or ensemble_dim in targets.dims:
    return None
  m = int(predictions.sizes[ensemble_dim])
  rest = [d for d in predictions.dims if d != ensemble_dim]
  if (sorted(targets.dims) != sorted(rest)
      or any(targets.sizes[d] != predictions.sizes[d] for d in rest)
      or predictions.dtype != targets.dtype
      or predictions.dtype not in crps_pairwise.KERNEL_DTYPES or m < 2):
    return None
  key = ('fused_ens_stats', ensemble_dim, id(predictions.data),
         id(targets.data))
  hit = cache.get(key)
  if hit is not None:
    return hit
  x = predictions.transpose(ensemble_dim, *rest).data
  y = targets.transpose(*rest).data
  spread, skill, mean, sq_dev = crps_pairwise.fused_ensemble_stats(x, y)
  out_dims = tuple(rest)
  p_coords = {k: c for k, c in predictions.coords.items()
              if set(c.dims).issubset(out_dims)}
  both_coords = darray._merge_coords(out_dims, predictions.coords,
                                     targets.coords)
  out = {
      'm': m,
      'spread_sum': DimArray(spread, out_dims, p_coords),
      'skill_sum': DimArray(skill, out_dims, both_coords),
      'mean': DimArray(mean, out_dims, p_coords),
      'sq_dev_sum': DimArray(sq_dev, out_dims, p_coords),
      # The key is id()-based: holding the inputs keeps those ids from
      # being reused by other tensors while the entry lives.
      '_pin': (predictions.data, targets.data),
  }
  cache[key] = out
  return out


class CRPSSpread(base.PerVariableStatistic):
  """Sample estimate of the CRPS spread term E|X - X'|.

  use_sort selects the plain form for dtypes the kernels do not take: the
  O(M log M) sorted-members (PWM) form, or the O(M²) pairwise broadcast.
  """

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               use_sort: bool = False, fair: bool = True,
               which: str = 'predictions', skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._use_sort = use_sort
    self._which = which
    self._fair = fair
    self._skipna_ensemble = skipna_ensemble

  @property
  def unique_name(self) -> str:
    fair_str = 'fair' if self._fair else 'unfair'
    name = f'CRPSSpread_{self._ensemble_dim}_{fair_str}_{self._which}'
    if self._skipna_ensemble:
      name += '_skipna_ensemble'
    return name

  def _dedup_identity(self):
    # use_sort selects the algorithm, not the value.
    return {k: v for k, v in vars(self).items() if k != '_use_sort'}

  def _compute_per_variable(self, predictions, targets):
    if self._which == 'predictions':
      da = predictions
    elif self._which == 'targets':
      da = targets
    else:
      raise ValueError(f'Unhandled which={self._which!r}')
    ens = self._ensemble_dim
    fair = int(self._fair)

    if self._skipna_ensemble:
      if self._use_sort:
        raise ValueError(
            'skipna_ensemble is not supported with use_sort=True.')
      n = da.count(ens)
      second = 'ensemble_dim_2'
      return abs(da - da.rename({ens: second})).sum(
          (ens, second), skipna=True) / (n * (n - fair))

    m = da.sizes[ens]
    if m < 2:
      raise ValueError('Cannot estimate CRPS spread with n_ensemble < 2.')
    if self._which == 'predictions':
      fused = _fused_ensemble_pass(predictions, targets, ens)
      if fused is not None:
        return fused['spread_sum'] / (m * (m - fair))

    out_dims = tuple(d for d in da.dims if d != ens)
    coords = {k: c for k, c in da.coords.items()
              if set(c.dims).issubset(out_dims)}
    x = da.transpose(ens, *out_dims).data
    if da.dtype in crps_pairwise.KERNEL_DTYPES:
      pair_sum = crps_pairwise.spread_sum_along_axis(x, 0)
    elif self._use_sort:
      pair_sum = crps_pairwise.pairwise_spread_sum_plain(x)
    else:
      pair_sum = (x[:, None] - x[None, :]).abs().sum((0, 1))
    return DimArray(pair_sum / (m * (m - fair)), out_dims, coords)


class EnsembleVariance(base.PerVariableStatistic):
  """Unbiased (ddof=1) ensemble variance."""

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def unique_name(self) -> str:
    return (f'EnsembleVariance_{self._ensemble_dim}_skipna_ensemble_'
            f'{self._skipna_ensemble}')

  def _compute_per_variable(self, predictions, targets):
    if not self._skipna_ensemble:
      fused = _fused_ensemble_pass(predictions, targets, self._ensemble_dim)
      if fused is not None:
        return fused['sq_dev_sum'] / (fused['m'] - 1)
    return predictions.var(self._ensemble_dim, ddof=1,
                           skipna=self._skipna_ensemble)


class UnbiasedEnsembleMeanSquaredError(base.PerVariableStatistic):
  """E(X̄ - Y)² debiased by var/M."""

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def unique_name(self) -> str:
    return (f'UnbiasedEnsembleMeanSquaredError_{self._ensemble_dim}_'
            f'skipna_ensemble_{self._skipna_ensemble}')

  def _compute_per_variable(self, predictions, targets):
    ens, skipna = self._ensemble_dim, self._skipna_ensemble
    if ens not in predictions.dims:
      raise ValueError(f'Dimension {ens} not found in {predictions.dims}')
    fused = None if skipna else _fused_ensemble_pass(predictions, targets,
                                                     ens)
    if fused is not None:
      mean, m = fused['mean'], fused['m']
      return (mean - targets) ** 2 - fused['sq_dev_sum'] / (m - 1) / m

    def mean_and_bias(da):
      n = da.count(ens) if skipna else da.sizes[ens]
      return (da.mean(ens, skipna=skipna),
              da.var(ens, ddof=1, skipna=skipna) / n)

    predictions_mean, predictions_bias = mean_and_bias(predictions)
    if ens in targets.dims:
      targets_mean, targets_bias = mean_and_bias(targets)
    else:
      targets_mean, targets_bias = targets, 0.0
    return ((predictions_mean - targets_mean) ** 2 - predictions_bias
            - targets_bias)


class EnsembleRankedProbabilityScore(wrappers._ForwardingStatistic):
  """Fair (or biased) RPS from ensemble samples via CDF binning.

  ContinuousToCDF wrappers around the (un)biased squared error of the
  ensemble mean, summed over the bins. Each variable is computed under its
  own name, so that per-variable threshold mappings resolve. With
  ``fair`` the inner statistic is UnbiasedEnsembleMeanSquaredError, which
  on a CUDA tensor inside a compute pass takes the fused kernel.
  """

  def reads_across(self):
    return wrappers.union_reads_across(
        self.statistic.reads_across(), (self._ensemble_dim,))

  def __init__(self, prediction_bin_thresholds, target_bin_thresholds,
               bin_dim: str, unique_name_suffix: str,
               ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False, fair: bool = True,
               enforce_monotonicity: bool = True,
               right_inclusive: bool = True):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble
    self._fair = fair
    self._bin_dim = bin_dim
    self._unique_name_suffix = unique_name_suffix

    def to_cdf(which, thresholds):
      return wrappers.ContinuousToCDF(
          which=which, threshold_values=thresholds, threshold_dim=bin_dim,
          unique_name_suffix=unique_name_suffix,
          enforce_monotonicity=enforce_monotonicity,
          right_inclusive=right_inclusive)

    if self._fair:
      se_stat = UnbiasedEnsembleMeanSquaredError(
          ensemble_dim=ensemble_dim, skipna_ensemble=skipna_ensemble)
    else:
      se_stat = wrappers.WrappedStatistic(
          deterministic.SquaredError(),
          wrappers.EnsembleMean(
              which='both', ensemble_dim=ensemble_dim,
              skipna=skipna_ensemble, skip_if_ensemble_dim_missing=True))
    self.statistic = wrappers.WrappedStatistic(
        wrappers.WrappedStatistic(se_stat,
                                  to_cdf('targets', target_bin_thresholds)),
        to_cdf('predictions', prediction_bin_thresholds))

  @property
  def unique_name(self) -> str:
    return (f'RankedProbabilityScore_{self._ensemble_dim}_'
            f'skipna_ensemble_{self._skipna_ensemble}_'
            f'fair_{self._fair}_'
            f'{self._unique_name_suffix}')

  def compute(self, predictions, targets):
    out = {}
    for var in predictions:
      if var not in targets:
        continue
      cdf_mse = self.statistic.compute(
          {var: predictions[var]}, {var: targets[var]})[var]
      out[var] = cdf_mse.sum(self._bin_dim, skipna=self._skipna_ensemble)
    return out


def _wasserstein_1d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """1-Wasserstein distance between empirical distributions along the
  last axis, batched over the leading ones.

  ``scipy.stats.wasserstein_distance`` with uniform weights: the integral
  of |CDF_u − CDF_v| between consecutive pooled sample values. Batched
  sort, cat, diff and searchsorted: no loop over the batch.
  """
  # searchsorted copies a boundary tensor that is not contiguous.
  u_sorted = torch.sort(u, dim=-1).values.contiguous()
  v_sorted = torch.sort(v, dim=-1).values.contiguous()
  all_values = torch.sort(torch.cat([u_sorted, v_sorted], dim=-1),
                          dim=-1).values
  deltas = torch.diff(all_values, dim=-1)
  at = all_values[..., :-1].contiguous()
  u_cdf = torch.searchsorted(u_sorted, at, right=True) / u.shape[-1]
  v_cdf = torch.searchsorted(v_sorted, at, right=True) / v.shape[-1]
  return ((u_cdf - v_cdf).abs().to(deltas.dtype) * deltas).sum(-1)


class WassersteinDistance(base.PerVariableStatistic):
  """1-Wasserstein (Earth Mover's) distance between the two ensembles, at
  every point at once. No "fair" debiasing exists for this distance."""

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM):
    self._ensemble_dim = ensemble_dim

  @property
  def unique_name(self) -> str:
    return f'WassersteinDistance_{self._ensemble_dim}'

  def _compute_per_variable(self, predictions, targets):
    for name, da in [('predictions', predictions), ('targets', targets)]:
      if self._ensemble_dim not in da.dims:
        raise ValueError(
            f'Ensemble dimension {self._ensemble_dim!r} not found in '
            f'{name}: {da.dims}')
    return darray.apply_ufunc(
        _wasserstein_1d, predictions, targets,
        input_core_dims=[(self._ensemble_dim,), (self._ensemble_dim,)],
        output_core_dims=[()])


class EnsembleErrorExceedance(deterministic.ErrorExceedance):
  """Error exceedance averaged over ensemble members."""

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, thresholds, ensemble_dim: str = ENSEMBLE_DIM):
    super().__init__(thresholds=thresholds)
    self._ensemble_dim = ensemble_dim

  @property
  def unique_name(self) -> str:
    # The ensemble dim is appended only when it is not the default, so
    # that default states keep upstream WeatherBench-X's bare class name;
    # differing thresholds under one name raise in
    # base.unique_statistics_for_metrics.
    name = 'EnsembleErrorExceedance'
    if self._ensemble_dim != ENSEMBLE_DIM:
      name += f'_{self._ensemble_dim}'
    return name

  def _compute_per_variable(self, predictions, targets):
    out = super()._compute_per_variable(predictions, targets)
    return out.mean(self._ensemble_dim)


### Metrics


class CRPSEnsemble(base.PerVariableMetric):
  """Fair CRPS: E|X - Y| - 0.5 E|X - X'| (Zamo & Naveau 2018)."""

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               use_sort: bool = False, fair: bool = True,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._use_sort = use_sort
    self._fair = fair
    self._skipna_ensemble = skipna_ensemble

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        'CRPSSkill': CRPSSkill(
            ensemble_dim=self._ensemble_dim,
            skipna_ensemble=self._skipna_ensemble),
        'CRPSSpread': CRPSSpread(
            ensemble_dim=self._ensemble_dim, use_sort=self._use_sort,
            fair=self._fair, skipna_ensemble=self._skipna_ensemble),
    }

  def _values_from_mean_statistics_per_variable(self, s):
    return s['CRPSSkill'] - 0.5 * s['CRPSSpread']


class CRPSEnsembleDistance(base.PerVariableMetric):
  """Energy-distance CRPS: skill - ½ pred spread - ½ target spread."""

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               use_sort: bool = False, fair: bool = True,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._use_sort = use_sort
    self._fair = fair
    self._skipna_ensemble = skipna_ensemble

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    # skipna_ensemble goes to ALL three terms, as in the JAX package, which
    # diverges here on purpose from upstream WeatherBench-X: that forwards
    # it to the prediction-spread term only, so E|X-Y| and E|Y-Y'| still go
    # NaN despite its docstring. Values differ only with skipna_ensemble
    # on and NaN members present.
    return {
        'CRPSSkill': CRPSSkill(
            ensemble_dim=self._ensemble_dim,
            skipna_ensemble=self._skipna_ensemble),
        'CRPSSpread': CRPSSpread(
            ensemble_dim=self._ensemble_dim, use_sort=self._use_sort,
            fair=self._fair, skipna_ensemble=self._skipna_ensemble),
        'CRPSTargetSpread': CRPSSpread(
            ensemble_dim=self._ensemble_dim, use_sort=self._use_sort,
            fair=self._fair, which='targets',
            skipna_ensemble=self._skipna_ensemble),
    }

  def _values_from_mean_statistics_per_variable(self, s):
    return (s['CRPSSkill'] - 0.5 * s['CRPSSpread']
            - 0.5 * s['CRPSTargetSpread'])


class UnbiasedEnsembleMeanRMSE(base.PerVariableMetric):
  """sqrt of the unbiased ensemble-mean MSE."""

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {'UnbiasedEnsembleMeanSquaredError':
            UnbiasedEnsembleMeanSquaredError(
                ensemble_dim=self._ensemble_dim,
                skipna_ensemble=self._skipna_ensemble)}

  def _values_from_mean_statistics_per_variable(self, s):
    return darray.sqrt(s['UnbiasedEnsembleMeanSquaredError'])


def SpreadSkillRatio(**unused_kwargs):  # pylint: disable=invalid-name
  raise ValueError(
      'SpreadSkillRatio is no longer supported as it was not correctly '
      'implemented. Please use UnbiasedSpreadSkillRatio instead and see '
      'the docstring of that class for more details.')


class UnbiasedSpreadSkillRatio(base.PerVariableMetric):
  """sqrt(mean ensemble variance / unbiased ensemble-mean MSE)."""

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        'EnsembleVariance': EnsembleVariance(
            ensemble_dim=self._ensemble_dim,
            skipna_ensemble=self._skipna_ensemble),
        'UnbiasedEnsembleMeanSquaredError':
            UnbiasedEnsembleMeanSquaredError(
                ensemble_dim=self._ensemble_dim,
                skipna_ensemble=self._skipna_ensemble),
    }

  def _values_from_mean_statistics_per_variable(self, s):
    return darray.sqrt(
        s['EnsembleVariance'] / s['UnbiasedEnsembleMeanSquaredError'])


class EnsembleRootMeanVariance(base.PerVariableMetric):
  """sqrt of the mean ensemble variance."""

  def __init__(self, ensemble_dim: str = ENSEMBLE_DIM,
               skipna_ensemble: bool = False):
    self._ensemble_dim = ensemble_dim
    self._skipna_ensemble = skipna_ensemble

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {'EnsembleVariance': EnsembleVariance(
        ensemble_dim=self._ensemble_dim,
        skipna_ensemble=self._skipna_ensemble)}

  def _values_from_mean_statistics_per_variable(self, s):
    return darray.sqrt(s['EnsembleVariance'])


def _select_optimal_thresholds(
    values: DimArray,
    optimal_thresholds: DimArray,
    method: str | None = None,
) -> DimArray:
  """Selects, per cost/loss ratio, the value at its optimal threshold.

  The indices come from a label lookup on the host; the gather along the
  threshold axis is one ``torch.take_along_dim`` where the values live.
  """
  flat_idx = darray._label_indices(
      values.coord_values('threshold'),
      optimal_thresholds.values.reshape(-1), method)
  batch_dims = tuple(d for d in values.dims if d != 'threshold')
  extra = tuple(d for d in optimal_thresholds.dims
                if d not in ('cost_loss_ratio',) + batch_dims)
  if extra:
    raise ValueError(f'unaligned optimal_thresholds dims {extra}')
  idx_dims = batch_dims + ('cost_loss_ratio',)
  vt = values.transpose(*batch_dims, 'threshold')
  sizes = {**vt.sizes, **optimal_thresholds.sizes}
  index = darray._expand_to(
      torch.as_tensor(np.asarray(flat_idx).reshape(optimal_thresholds.shape),
                      device=vt.device),
      optimal_thresholds.dims, idx_dims).expand(
          tuple(sizes[d] for d in idx_dims))
  data = vt.data.expand(tuple(sizes[d] for d in batch_dims)
                        + (vt.sizes['threshold'],))
  coords = {k: c for k, c in values.coords.items()
            if set(c.dims).issubset(batch_dims)}
  if 'cost_loss_ratio' in optimal_thresholds.coords:
    coords['cost_loss_ratio'] = optimal_thresholds.coords['cost_loss_ratio']
  return DimArray(torch.take_along_dim(data, index, dim=-1), idx_dims, coords)


class RelativeEconomicValue(base.Metric):
  """Relative economic value over cost/loss ratios and decision thresholds.

  Targets must be binary; predictions are probabilities in [0, 1].
  """

  def __init__(self, *, ensemble_size: int | None = None,
               probability_thresholds: np.ndarray | None = None,
               cost_loss_ratios: np.ndarray | None = None,
               optimal_thresholds=None,
               optimal_thresholds_select_nearest: bool = False,
               statistic_suffix: str | None = None):
    if ensemble_size is None and probability_thresholds is None:
      raise ValueError(
          'Either ensemble_size or probability_thresholds must be specified.')
    if probability_thresholds is not None and ensemble_size is not None:
      raise ValueError(
          'Only one of ensemble_size or probability_thresholds must be'
          ' specified.')
    if probability_thresholds is not None and statistic_suffix is None:
      raise ValueError(
          'If probability_thresholds is specified, statistic_suffix must be'
          ' specified.')

    if cost_loss_ratios is None:
      cost_loss_ratios = np.geomspace(0.005, 1, 51)[:-1]
    cost_loss_ratios = np.asarray(cost_loss_ratios)
    self._cost_loss_ratio = DimArray(
        cost_loss_ratios, ('cost_loss_ratio',),
        {'cost_loss_ratio': cost_loss_ratios})

    self._thresholds = probability_thresholds
    if self._thresholds is None:
      self._thresholds = (np.arange(ensemble_size) + 0.5) / ensemble_size
      if statistic_suffix is None:
        statistic_suffix = 'all_thresholds_for_ensemble_size'
    self._thresholds = np.asarray(self._thresholds)
    if not (np.all(self._thresholds >= 0.0)
            and np.all(self._thresholds <= 1.0)):
      raise ValueError(
          f'Probability thresholds must be in [0, 1], got {self._thresholds=}.')
    self._unique_name_suffix = statistic_suffix or ''

    if optimal_thresholds is not None:
      data_vars = (optimal_thresholds.values()
                   if isinstance(optimal_thresholds, Mapping)
                   else [optimal_thresholds])
      for var in data_vars:
        if 'cost_loss_ratio' not in var.dims:
          raise ValueError(
              'optimal_thresholds must have "cost_loss_ratio" dimensions.')
        if not np.array_equal(var.coord_values('cost_loss_ratio'),
                              cost_loss_ratios):
          raise ValueError(
              'optimal_thresholds must have cost_loss_ratio coordinates with '
              'the same values as the cost_loss_ratios argument.')
    self._optimal_thresholds = optimal_thresholds
    self._optimal_thresholds_select_nearest = optimal_thresholds_select_nearest

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    binarize = wrappers.ContinuousToBinary(
        which='predictions', threshold_value=list(self._thresholds),
        threshold_dim='threshold',
        unique_name_suffix=self._unique_name_suffix)
    # No TrueNegatives, on purpose: the finalizer never reads it (the mean
    # contingency table sums to 1), so it would cost a threshold-sized
    # statistic's compute, memory and state for nothing.
    return {
        'TruePositives': wrappers.WrappedStatistic(
            categorical.TruePositives(), binarize),
        'FalsePositives': wrappers.WrappedStatistic(
            categorical.FalsePositives(), binarize),
        'FalseNegatives': wrappers.WrappedStatistic(
            categorical.FalseNegatives(), binarize),
    }

  def _add_constant_threshold_results(
      self, tp: DimArray, fp: DimArray, fn: DimArray
  ) -> Tuple[DimArray, DimArray, DimArray]:
    """Adds the degenerate thresholds 0 (always positive) and 1 (always
    negative)."""
    base_rate = (tp.isel(threshold=0) + fn.isel(threshold=0)).drop_coords(
        'threshold')
    zero = darray.zeros_like(base_rate)

    def at(x, threshold):
      return x.expand_dims('threshold').assign_coords(threshold=Coord(
          ('threshold',), np.array([threshold])))

    def cat(parts):
      return darray.concat(parts, 'threshold')

    return (cat([at(base_rate, 0.0), tp, at(zero, 1.0)]),
            cat([at(1.0 - base_rate, 0.0), fp, at(zero, 1.0)]),
            cat([at(zero, 0.0), fn, at(base_rate, 1.0)]))

  def values_from_mean_statistics(self, statistic_values):
    common_variables = set.intersection(
        *[set(statistic_values[s]) for s in self.statistics])
    return {
        var_name: self._values_from_mean_statistics_per_variable(
            {s: statistic_values[s][var_name] for s in self.statistics},
            var_name)
        for var_name in sorted(common_variables, key=str)}

  def _values_from_mean_statistics_per_variable(self, s, var_name):
    tp, fp, fn = self._add_constant_threshold_results(
        s['TruePositives'], s['FalsePositives'], s['FalseNegatives'])

    if self._optimal_thresholds is not None:
      if isinstance(self._optimal_thresholds, Mapping):
        optimal_thresholds = self._optimal_thresholds[var_name]
      else:
        optimal_thresholds = self._optimal_thresholds
      method = 'nearest' if self._optimal_thresholds_select_nearest else None
      tp, fp, fn = (_select_optimal_thresholds(x, optimal_thresholds, method)
                    for x in (tp, fp, fn))

    # The cost/loss ratios are float64, so this small finalizer, which
    # cancels, runs in float64 whatever the statistics' dtype.
    ratio = self._cost_loss_ratio
    pred_cost = ratio * (tp + fp) + fn
    perf_cost = ratio * (tp + fn)
    clim_cost = darray.minimum((tp + fn) * 0 + ratio, tp + fn)
    return (clim_cost - pred_cost) / (clim_cost - perf_cost)


class RankHistogram(base.PerVariableStatistic):
  """Counts of the target's rank within the sorted ensemble.

  Adds a 'rank' dim of size M+1 with one-hot float32 counts: a
  compare-and-sum over the members, then a comparison with the M+1 ranks.
  No scatter or bincount, whose atomic adds would vary from run to run. A
  NaN target or member gives NaN over every rank of its point, so that
  masked or skipna aggregation can leave the point out.
  """

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, *, ensemble_dim: str = ENSEMBLE_DIM):
    self._ensemble_dim = ensemble_dim

  @property
  def unique_name(self) -> str:
    return f'RankHistogram_{self._ensemble_dim}'

  def _compute_per_variable(self, predictions, targets):
    num_bins = predictions.sizes[self._ensemble_dim] + 1
    # A bool sum counts in int64 without a widened copy of the comparison.
    ranks = (predictions < targets).sum(self._ensemble_dim)
    categories = DimArray(np.arange(num_bins), ('rank',),
                          {'rank': np.arange(num_bins)})
    counts = (ranks == categories).astype(torch.float32)
    missing = targets.isnull() | predictions.isnull().any(self._ensemble_dim)
    return counts.where(~missing)
