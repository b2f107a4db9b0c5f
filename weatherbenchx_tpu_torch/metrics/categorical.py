"""Categorical metrics: the confusion-matrix family, SEEPS, the CDF-based
ranked probability score, reliability and the decision-support statistics.

The port of ``weatherbenchx_tpu/metrics/categorical.py``.
"""

from typing import Hashable, Mapping, Sequence, Union, final

import numpy as np
import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import wrappers

_CLIMATOLOGY_TIME_DIMS = ('hour', 'dayofyear', 'time')


def _nan_mask_product(predictions: DimArray, targets: DimArray) -> DimArray:
  return ~(predictions * targets).isnull()


class _ConfusionCell(base.PerVariableStatistic):
  """One cell of the 2x2 contingency table of binary inputs: 1 where the
  prediction is ``_PREDICTED`` and the target ``_OBSERVED``, NaN where
  either input is NaN, float32."""

  _PREDICTED: bool
  _OBSERVED: bool

  def _compute_per_variable(self, predictions, targets):
    p, t = predictions.astype(torch.bool), targets.astype(torch.bool)
    cell = (p if self._PREDICTED else ~p) & (t if self._OBSERVED else ~t)
    return cell.where(_nan_mask_product(predictions, targets)).astype(
        torch.float32)


class TruePositives(_ConfusionCell):
  """pred AND target."""
  _PREDICTED, _OBSERVED = True, True


class TrueNegatives(_ConfusionCell):
  """NOT pred AND NOT target."""
  _PREDICTED, _OBSERVED = False, False


class FalsePositives(_ConfusionCell):
  """pred AND NOT target."""
  _PREDICTED, _OBSERVED = True, False


class FalseNegatives(_ConfusionCell):
  """NOT pred AND target."""
  _PREDICTED, _OBSERVED = False, True


class SEEPS(base.StatisticWithClimatology):
  """Stable Equitable Error in Probability Space (Rodwell et al. 2010).

  Precipitation is classified dry / light / heavy against a dry threshold
  and a climatological wet threshold aligned at each valid time; a 3x3
  scoring matrix built from the climatological dry fraction p1 scores the
  (forecast, truth) category pair; points whose p1 lies outside [min_p1,
  max_p1] are masked (so aggregate with ``masked=True``).

  As in the JAX package, the score is one elementwise pass: six boolean
  category-pair selects, each times its scoring-matrix entry written with
  the entry's own float32 arithmetic, so the values are bit-identical to a
  matrix-then-contraction form. A NaN wet threshold leaves a non-dry point
  in no category (contribution 0, not NaN); NaN precipitation poisons its
  own gridpoint; masks on both predictions and targets raise.

  p1, the dry fraction averaged over its time dims, is constant over a
  run: it is computed once here, with numpy on the host (construction
  touches no device), and the evaluator keeps it resident. Only the wet
  thresholds may be gathered per chunk on the host.
  """

  def __init__(
      self,
      variables: Sequence[str],
      climatology: Mapping[Hashable, DimArray],
      dry_threshold_mm: Union[float, Sequence[float]] = 0.25,
      min_p1: Union[float, Sequence[float]] = 0.1,
      max_p1: Union[float, Sequence[float]] = 0.85,
  ):
    super().__init__(climatology)
    self._variables = list(variables)
    n = len(self._variables)

    def per_variable(x):
      return list(x) if isinstance(x, Sequence) else [x] * n

    self._dry_threshold_mm = per_variable(dry_threshold_mm)
    self._min_p1 = per_variable(min_p1)
    self._max_p1 = per_variable(max_p1)
    if not (n == len(self._dry_threshold_mm) == len(self._min_p1)
            == len(self._max_p1)):
      raise ValueError('All arguments must have the same length.')
    self._p1 = {}
    for variable in self._variables:
      df = self._climatology[f'{variable}_seeps_dry_fraction']
      axes = tuple(i for i, d in enumerate(df.dims)
                   if d in _CLIMATOLOGY_TIME_DIMS)
      values = df.values
      # The mean in float64, stored at the dry fraction's dtype.
      p1 = values.mean(axis=axes, dtype=np.float64).astype(values.dtype)
      keep = [i for i in range(df.ndim) if i not in axes]
      dims = tuple(df.dims[i] for i in keep)
      self._p1[variable] = DimArray(
          p1, dims, {k: c for k, c in df.coords.items()
                     if set(c.dims).issubset(dims)})

  @property
  def unique_name(self) -> str:
    suffix = ('_'.join(self._variables)
              + '_dry_threshold_mm_'
              + '_'.join(str(s) for s in self._dry_threshold_mm)
              + '_min_p1_' + '_'.join(str(s) for s in self._min_p1)
              + '_max_p1_' + '_'.join(str(s) for s in self._max_p1))
    return f'SEEPS_{suffix}'

  def _thresholds(self) -> dict[str, DimArray]:
    return {v: self._climatology[f'{v}_seeps_threshold']
            for v in self._variables}

  def device_resource_arrays(self):
    """The wet thresholds and p1: not the raw dry fraction, which p1
    replaces."""
    out = {base.resource_id(t): t.data for t in self._thresholds().values()}
    out.update({base.resource_id(p1): p1.data for p1 in self._p1.values()})
    return out

  def host_gatherable_resource_arrays(self):
    """Only the wet thresholds are read through alignment; p1 is read
    directly in compute and stays resident."""
    return {base.resource_id(t): t for t in self._thresholds().values()}

  def _aligned_clim_keys(self, var):
    return (f'{var}_seeps_threshold',) if var in self._variables else ()

  def compute(self, predictions, targets):
    return {variable: self._scored_variable(
        predictions[variable], targets[variable], variable, dry_mm, lo, hi)
            for variable, dry_mm, lo, hi in zip(
                self._variables, self._dry_threshold_mm, self._min_p1,
                self._max_p1)}

  @staticmethod
  def _rain_bands(da: DimArray, wet: DimArray, dry_mm: float):
    """(dry, light, heavy) boolean bands of one side; a NaN wet threshold
    puts a non-dry point in no band (comparisons with NaN are False)."""
    lo = dry_mm / 1000.0  # mm → SI meters
    return da <= lo, (da > lo) & (da < wet), da >= wet

  def _scored_variable(self, predictions: DimArray, targets: DimArray,
                       variable: str, dry_mm: float, min_p1: float,
                       max_p1: float) -> DimArray:
    if predictions.has_coord('mask') and targets.has_coord('mask'):
      raise ValueError(
          'SEEPS expects at most one side to carry a nan-mask coord; got '
          'masks on both predictions and targets')
    wet = base.aligned_climatology_for(
        self._climatology[f'{variable}_seeps_threshold'], predictions)
    f_dry, f_light, f_heavy = self._rain_bands(predictions, wet, dry_mm)
    t_dry, t_light, t_heavy = self._rain_bands(targets, wet, dry_mm)
    p1 = base.resolve_resource(self._p1[variable])

    # The six nonzero cells of the scoring matrix, each entry's expression
    # as the JAX package writes it; at most one select fires per point,
    # and halving afterwards is exact, so the order change is lossless.
    score = 0.5 * (
        (f_dry & t_light) * (1 / (1 - p1))
        + (f_dry & t_heavy) * (4 / (1 - p1))
        + (f_light & t_dry) * (1 / p1)
        + (f_light & t_heavy) * (3 / (1 - p1))
        + (f_heavy & t_dry) * (1 / p1 + 3 / (2 + p1))
        + (f_heavy & t_light) * (3 / (2 + p1)))
    result = score.where(~(predictions.isnull() | targets.isnull()))

    mask = (p1 >= min_p1) & (p1 <= max_p1)
    result = result.where(mask, np.nan)
    for side in (predictions, targets):
      if side.has_coord('mask'):
        mask = mask & DimArray(side.coords['mask'].values,
                               side.coords['mask'].dims)
    mask = mask.broadcast_like(result)
    return result.assign_coords(mask=Coord(mask.dims, mask.data))


class RankedProbabilityScore(base.PerVariableStatistic):
  """RPS over inputs that already represent CDFs along ``bin_dim``."""

  def __init__(self, bin_dim: str):
    self._bin_dim = bin_dim

  @property
  def unique_name(self) -> str:
    return 'RankedProbabilityScore'

  def _compute_per_variable(self, predictions, targets):
    return ((predictions - targets) ** 2).sum(self._bin_dim)


### Metrics over the confusion matrix

_CELLS = {'TruePositives': TruePositives, 'TrueNegatives': TrueNegatives,
          'FalsePositives': FalsePositives, 'FalseNegatives': FalseNegatives}
_ALL_CELLS = ('TruePositives', 'FalsePositives', 'FalseNegatives',
              'TrueNegatives')


class _ConfusionMetric(base.PerVariableMetric):
  _STATS: tuple = ()

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {name: _CELLS[name]() for name in self._STATS}


class CSI(_ConfusionMetric):
  """Critical Success Index (Threat Score): TP / (TP + FP + FN)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (
        s['TruePositives'] + s['FalsePositives'] + s['FalseNegatives'])


class Accuracy(_ConfusionMetric):
  """(TP + TN) / total."""

  _STATS = _ALL_CELLS

  def _values_from_mean_statistics_per_variable(self, s):
    return (s['TruePositives'] + s['TrueNegatives']) / (
        s['TruePositives'] + s['FalsePositives'] + s['FalseNegatives']
        + s['TrueNegatives'])


class Recall(_ConfusionMetric):
  """TP / (TP + FN)."""

  _STATS = ('TruePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (s['TruePositives'] + s['FalseNegatives'])


class FalseAlarmRate(_ConfusionMetric):
  """FP / (TP + FP)."""

  _STATS = ('TruePositives', 'FalsePositives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['FalsePositives'] / (s['TruePositives'] + s['FalsePositives'])


class Precision(_ConfusionMetric):
  """TP / (TP + FP)."""

  _STATS = ('TruePositives', 'FalsePositives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (s['TruePositives'] + s['FalsePositives'])


class F1Score(_ConfusionMetric):
  """2TP / (2TP + FP + FN)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return 2 * s['TruePositives'] / (
        2 * s['TruePositives'] + s['FalsePositives'] + s['FalseNegatives'])


class FrequencyBias(_ConfusionMetric):
  """(TP + FP) / (TP + FN)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return (s['TruePositives'] + s['FalsePositives']) / (
        s['TruePositives'] + s['FalseNegatives'])


class HSS(_ConfusionMetric):
  """Heidke Skill Score."""

  _STATS = _ALL_CELLS

  def _values_from_mean_statistics_per_variable(self, s):
    tp, tn = s['TruePositives'], s['TrueNegatives']
    fp, fn = s['FalsePositives'], s['FalseNegatives']
    return 2 * (tp * tn - fp * fn) / (
        (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


class ETS(_ConfusionMetric):
  """Equitable Threat Score (Gilbert Skill Score)."""

  _STATS = _ALL_CELLS

  def _values_from_mean_statistics_per_variable(self, s):
    tp, tn = s['TruePositives'], s['TrueNegatives']
    fp, fn = s['FalsePositives'], s['FalseNegatives']
    tp_random = ((tp + fp) * (tp + fn)) / (tp + fp + fn + tn)
    return (tp - tp_random) / (tp + fp + fn - tp_random)


class SEDI(_ConfusionMetric):
  """Symmetric extremal dependency index (Ferro & Stephenson 2011), with
  the hit and false-alarm rates clipped to [1e-6, 1 - 1e-6]."""

  _STATS = _ALL_CELLS

  def _values_from_mean_statistics_per_variable(self, s):
    tp, tn = s['TruePositives'], s['TrueNegatives']
    fp, fn = s['FalsePositives'], s['FalseNegatives']
    h = (tp / (tp + fn)).clip(1e-6, 1 - 1e-6)
    f = (fp / (fp + tn)).clip(1e-6, 1 - 1e-6)
    log_h, log_f = darray.log(h), darray.log(f)
    log_1mh, log_1mf = darray.log(1 - h), darray.log(1 - f)
    return (log_f - log_h + log_1mh - log_1mf) / (
        log_h + log_f + log_1mh + log_1mf)


class Reliability(base.PerVariableMetric):
  """Calibration curve over binned predicted probabilities."""

  def __init__(
      self,
      bin_values: Sequence[float] = (
          -np.inf, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
      bin_dim: str = 'reliability_bin',
      statistic_suffix: str | None = None,
  ):
    self._bin_values = bin_values
    self._bin_dim = bin_dim
    self._unique_name_suffix = statistic_suffix

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    binned = wrappers.ContinuousToBins(
        which='predictions', bin_values=self._bin_values,
        bin_dim=self._bin_dim, unique_name_suffix=self._unique_name_suffix)
    return {
        'TruePositives': wrappers.WrappedStatistic(TruePositives(), binned),
        'FalsePositives': wrappers.WrappedStatistic(FalsePositives(), binned),
    }

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (s['TruePositives'] + s['FalsePositives'])


### Decision-support statistics (Confident/Covered/JaccardDistant/Opportunism)


def _ensemble_interval(predictions: DimArray, ensemble_dim: str,
                       low: float, high: float) -> tuple[DimArray, DimArray]:
  """The (low, high) ensemble quantiles, from one sort."""
  q = predictions.quantile([low, high], ensemble_dim)
  return q.isel(quantile=0), q.isel(quantile=1)


class Confident(base.PerVariableStatisticWithClimatology):
  """prediction spread < threshold × climatological spread.

  The climatology's variables hold quantiles along a 'quantile' dim.
  """

  def __init__(self, ensemble_dim: str,
               climatology: Mapping[Hashable, DimArray],
               spread_quantile_boundaries: tuple = (0.1, 0.9),
               confidence_threshold: float = 0.7):
    super().__init__(climatology)
    self._ensemble_dim = ensemble_dim
    self._spread_low, self._spread_high = spread_quantile_boundaries
    self._confidence_threshold = confidence_threshold

  @property
  def unique_name(self) -> str:
    return ('Confident'
            + f'_conf_thres={self._confidence_threshold}'
            + f'_spread_low={self._spread_low}'
            + f'_spread_high={self._spread_high}')

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    del targets
    lo, hi = _ensemble_interval(predictions, self._ensemble_dim,
                                self._spread_low, self._spread_high)
    clim_spread = (aligned_climatology.sel(quantile=self._spread_high)
                   - aligned_climatology.sel(quantile=self._spread_low))
    return (hi - lo) < self._confidence_threshold * clim_spread


class Covered(base.PerVariableStatistic):
  """Target inside the [low, high] ensemble quantile interval."""

  def __init__(self, ensemble_dim: str,
               interval_quantile_boundaries: tuple = (0.1, 0.9)):
    self._ensemble_dim = ensemble_dim
    self._interval_low, self._interval_high = interval_quantile_boundaries

  @property
  def unique_name(self) -> str:
    return ('Covered'
            + f'_interval_low={self._interval_low}'
            + f'_interval_high={self._interval_high}')

  def _compute_per_variable(self, predictions, targets):
    lo, hi = _ensemble_interval(predictions, self._ensemble_dim,
                                self._interval_low, self._interval_high)
    return (lo <= targets) & (targets <= hi)


class JaccardDistant(base.PerVariableStatisticWithClimatology):
  """Jaccard distance of the prediction's quantile interval from the
  climatology's > threshold."""

  def __init__(self, ensemble_dim: str,
               climatology: Mapping[Hashable, DimArray],
               threshold: float = 0.75,
               interval_quantile_boundaries: tuple = (0.1, 0.9)):
    super().__init__(climatology)
    self._ensemble_dim = ensemble_dim
    self._threshold = threshold
    self._interval_low, self._interval_high = interval_quantile_boundaries

  @property
  def unique_name(self) -> str:
    return ('JaccardDistant'
            + f'_threshold={self._threshold}'
            + f'_interval_low={self._interval_low}'
            + f'_interval_high={self._interval_high}')

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    del targets
    pred_lo, pred_hi = _ensemble_interval(
        predictions, self._ensemble_dim, self._interval_low,
        self._interval_high)
    clim_lo = aligned_climatology.sel(quantile=self._interval_low)
    clim_hi = aligned_climatology.sel(quantile=self._interval_high)
    max_of_lows = darray.maximum(pred_lo, clim_lo)
    min_of_highs = darray.minimum(pred_hi, clim_hi)
    intersection = darray.maximum(min_of_highs - max_of_lows, 0.0)
    union = (pred_hi - pred_lo) + (clim_hi - clim_lo) - intersection
    jaccard_index = darray.where(union > 0, intersection / union, 1.0)
    return (1 - jaccard_index) > self._threshold


class Opportunism(base.PerVariableMetric):
  """Fraction of forecasts (un)confident × (un)covered × (un)distant."""

  def __init__(self, ensemble_dim: str,
               climatology: Mapping[Hashable, DimArray],
               is_confident: bool,
               is_covered: bool | None = None,
               is_jaccard_distant: bool | None = None,
               confidence_quantile_boundaries: tuple = (0.1, 0.9),
               coverage_quantile_boundaries: tuple = (0.1, 0.9),
               jaccard_distance_quantile_boundaries: tuple = (0.1, 0.9),
               confidence_threshold: float = 0.7,
               jaccard_distance_threshold: float = 0.75):
    self._is_confident = is_confident
    self._is_covered = is_covered
    self._is_jaccard_distant = is_jaccard_distant
    self._ensemble_dim = ensemble_dim
    self._climatology = climatology
    self._confidence_quantile_boundaries = confidence_quantile_boundaries
    self._coverage_quantile_boundaries = coverage_quantile_boundaries
    self._jaccard_distance_quantile_boundaries = (
        jaccard_distance_quantile_boundaries)
    self._confidence_threshold = confidence_threshold
    self._jaccard_distance_threshold = jaccard_distance_threshold

  @final
  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    statistics: dict[str, base.Statistic] = {
        'Confident': Confident(
            ensemble_dim=self._ensemble_dim,
            climatology=self._climatology,
            spread_quantile_boundaries=self._confidence_quantile_boundaries,
            confidence_threshold=self._confidence_threshold),
    }
    if self._is_covered is not None:
      statistics['Covered'] = Covered(
          ensemble_dim=self._ensemble_dim,
          interval_quantile_boundaries=self._coverage_quantile_boundaries)
    if self._is_jaccard_distant is not None:
      statistics['JaccardDistant'] = JaccardDistant(
          ensemble_dim=self._ensemble_dim,
          climatology=self._climatology,
          threshold=self._jaccard_distance_threshold,
          interval_quantile_boundaries=(
              self._jaccard_distance_quantile_boundaries))
    return statistics

  def _values_from_mean_statistics_per_variable(self, s):
    confident = s['Confident']
    values = confident if self._is_confident else 1 - confident
    if self._is_covered is not None:
      covered = s['Covered']
      values = values * (covered if self._is_covered else 1 - covered)
    if self._is_jaccard_distant is not None:
      jd = s['JaccardDistant']
      values = values * (jd if self._is_jaccard_distant else 1 - jd)
    return values
