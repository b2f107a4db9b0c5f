"""Probabilistic (ensemble) statistics and metrics: the CRPS family.

The port of ``weatherbenchx_tpu/metrics/probabilistic.py:99-407, 476-499,
611-675``. Inside a compute pass, CRPSSkill, CRPSSpread, EnsembleVariance
and UnbiasedEnsembleMeanSquaredError share ONE launch of the fused
ensemble-statistics kernel (``ops/crps_pairwise.fused_ensemble_stats``)
through ``base.computation_cache``, so the ensemble is read once. Outside
a pass, CRPSSpread takes the spread-only kernel. Both route by device: a
CPU tensor takes the kernel's plain version, a CUDA tensor the kernel.
Dtypes the kernel does not take (e.g. float64) use the plain tensor forms
of each statistic.
"""

from typing import Mapping

import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.ops import crps_pairwise

ENSEMBLE_DIM = 'number'


### Statistics


class CRPSSkill(base.PerVariableStatistic):
  """The skill term of CRPS, E|X - Y|, for deterministic targets.

  Ensemble targets need the two-ensemble cross kernel, which is not ported
  yet: they raise NotImplementedError.
  """

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
    if self._ensemble_dim in targets.dims:
      raise NotImplementedError(
          'CRPSSkill with ensemble targets needs the pairwise cross kernel, '
          'which weatherbenchx_tpu_torch does not have yet')
    if not self._skipna_ensemble:
      fused = _fused_ensemble_pass(predictions, targets, self._ensemble_dim)
      if fused is not None:
        return fused['skill_sum'] / fused['m']
    return abs(predictions - targets).mean(
        self._ensemble_dim, skipna=self._skipna_ensemble)


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
