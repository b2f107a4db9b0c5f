"""Categorical metrics: SEEPS.

The port of ``weatherbenchx_tpu/metrics/categorical.py:52-202``. The
confusion-matrix statistics and the ranked probability score are not
ported yet.
"""

from typing import Hashable, Mapping, Sequence, Union

import numpy as np

from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import base

_CLIMATOLOGY_TIME_DIMS = ('hour', 'dayofyear', 'time')


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
