"""Input-transform wrappers for statistics and metrics.

The port of ``weatherbenchx_tpu/metrics/wrappers.py``. Each
``InputTransform`` is a function over DimArrays applied to predictions
and/or targets before a wrapped statistic. Unique-name suffixes are the
JAX package's text exactly, oddities included: saved AggregationState
keys depend on them. Every comparison with a constant threshold goes
through ``darray.comparison_safe_threshold``. The wrapping statistics
forward ``prepare_chunk`` and the evaluator's resource contract to the
statistic they wrap.
"""

import abc
from typing import Any, Callable, Hashable, Iterable, Mapping, Sequence, Union

import numpy as np
import torch

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch.darray import Coord, DimArray, _label_indices
from weatherbenchx_tpu_torch.metrics import base

Thresholds = Union[float, Iterable[float], DimArray, Mapping[str, DimArray]]


def _thresholds_for(thresholds: Thresholds, threshold_dim: str,
                    name: Hashable | None) -> DimArray:
  """Resolves thresholds to a DimArray (a per-variable mapping is looked
  up by ``name``); constants stay float64 on the host."""
  if isinstance(thresholds, Mapping):
    if name not in thresholds:
      raise KeyError(f'Input variable name ({name}) not found in thresholds')
    thresholds = thresholds[name]
  if isinstance(thresholds, DimArray):
    if threshold_dim not in thresholds.dims:
      raise ValueError(f'threshold_dim ({threshold_dim}) not found in '
                       f'thresholds {thresholds.dims}')
    return thresholds
  t = np.asarray(list(thresholds) if isinstance(thresholds, Iterable)
                 else [thresholds], dtype=np.float64)
  return DimArray(t, (threshold_dim,), {threshold_dim: t})


def _threshold_data_dims(thresholds: Thresholds, threshold_dim: str
                         ) -> tuple[str, ...]:
  """The data dims that thresholds given as arrays vary along (e.g. a
  per-gridpoint climatological quantile): a transform reads them whole."""
  arrays = (thresholds.values() if isinstance(thresholds, Mapping)
            else [thresholds])
  return tuple(dict.fromkeys(d for t in arrays if isinstance(t, DimArray)
                             for d in t.dims if d != threshold_dim))


def binarize_thresholds(
    x: DimArray,
    thresholds: Thresholds,
    threshold_dim: str,
    name: Hashable | None = None,
) -> DimArray:
  """(x > threshold) with NaNs retained, as float32."""
  threshold = _thresholds_for(thresholds, threshold_dim, name)
  threshold_cmp = darray.comparison_safe_threshold(threshold, x.dtype, '>')
  return (x > threshold_cmp).where(~x.isnull()).astype(torch.float32)


def union_reads_across(*parts) -> tuple[str, ...] | None:
  """The dims read across by all of ``parts`` (each a ``reads_across``
  answer); None if any part is undeclared."""
  if any(p is None for p in parts):
    return None
  return tuple(dict.fromkeys(d for p in parts for d in p))


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

  def reads_across(self) -> tuple[str, ...] | None:
    """As ``Statistic.reads_across``; None (undeclared) by default."""
    return None


class EnsembleMean(InputTransform):
  """Mean over the ensemble dimension."""

  def reads_across(self):
    return (self._ensemble_dim,)

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


class EnsembleQuantiles(InputTransform):
  """Ensemble quantiles (numpy 'linear' interpolation, like xarray)."""

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, which: str, quantiles: Union[float, Iterable[float]],
               quantile_dim: str = 'quantile', ensemble_dim: str = 'number',
               skipna: bool = False,
               skip_if_ensemble_dim_missing: bool = False):
    super().__init__(which)
    self._quantiles = (list(quantiles) if isinstance(quantiles, Iterable)
                       else [quantiles])
    self._quantile_dim = quantile_dim
    self._ensemble_dim = ensemble_dim
    self._skipna = skipna
    self._skip_if_ensemble_dim_missing = skip_if_ensemble_dim_missing

  @property
  def unique_name_suffix(self) -> str:
    quantiles_str = ','.join([str(q) for q in self._quantiles])
    return (f'ensemble_quantiles_{self._ensemble_dim}_{self._quantile_dim}_'
            f'{self._skipna}_{quantiles_str}')

  def transform_fn(self, da, name=None):
    if self._ensemble_dim not in da.dims and self._skip_if_ensemble_dim_missing:
      return da
    if self._quantile_dim in da.dims:
      raise ValueError(
          f'Input DimArray already has a {self._quantile_dim!r} dimension. '
          'Please rename it before applying the EnsembleQuantiles wrapper.')
    return da.quantile(self._quantiles, dim=self._ensemble_dim,
                       skipna=self._skipna, quantile_dim=self._quantile_dim)


def _require_suffix(values: Any, unique_name_suffix: str | None,
                    what: str) -> None:
  if isinstance(values, (DimArray, Mapping)) and unique_name_suffix is None:
    raise ValueError(f'unique_name_suffix must be provided if {what} is a '
                     'DimArray or Mapping.')


class ContinuousToBinary(InputTransform):
  """x > threshold for each threshold, along a new threshold dim."""

  def reads_across(self):
    return _threshold_data_dims(self._threshold_value, self._threshold_dim)

  def __init__(self, which: str, threshold_value: Thresholds,
               threshold_dim: str, unique_name_suffix: str | None = None):
    super().__init__(which)
    self._threshold_value = (
        threshold_value
        if isinstance(threshold_value, (Iterable, DimArray, Mapping))
        else [threshold_value])
    self._threshold_dim = threshold_dim
    _require_suffix(self._threshold_value, unique_name_suffix,
                    'threshold_value')
    self._unique_name_suffix = unique_name_suffix

  @property
  def unique_name_suffix(self) -> str:
    if self._unique_name_suffix is None:
      s = ','.join([str(t) for t in self._threshold_value])
    else:
      s = self._unique_name_suffix
    return f'{self._threshold_dim}={s}'

  def transform_fn(self, da, name=None):
    return binarize_thresholds(
        da, self._threshold_value, self._threshold_dim, name)


def select_bin_thresholds_by_time_from_chunk(
    bin_thresholds: DimArray,
    chunk: DimArray,
) -> DimArray:
  """Selects time-dependent bin thresholds at the chunk's times.

  By ``valid_time``, by (``init_time``, ``lead_time``), or by the day of
  year of the init or valid time, whichever dims the thresholds have; the
  chunk's time coords must be host datetime64 / timedelta64 arrays, as the
  port's loaders keep them.
  """
  def host_coord(name):
    v = chunk.coord_values(name)
    if v.dtype.kind not in 'Mm':
      raise ValueError(
          'select_bin_thresholds_by_time_from_chunk requires host '
          f'datetime coords, got {v.dtype} for {name}.')
    if chunk.coords[name].dims != (name,):
      # A batched dispatch stacks the chunks' time coords along a new dim.
      raise ValueError(
          'select_bin_thresholds_by_time_from_chunk requires one chunk\'s '
          f'1-D {name} coord, got dims {chunk.coords[name].dims}; evaluate '
          'with chunks_per_dispatch=1.')
    return v

  def dayofyear(t):
    return base.dayofyear_and_hour(t)[0]

  if {'init_time', 'lead_time'}.issubset(chunk.dims):
    if 'valid_time' in bin_thresholds.dims:
      vt = (host_coord('init_time')[:, None]
            + host_coord('lead_time')[None, :]).astype('datetime64[ns]')
      coord = bin_thresholds.coord_values('valid_time').astype(
          'datetime64[ns]')
      idx = _label_indices(coord, vt.reshape(-1), None).reshape(vt.shape)
      return bin_thresholds.take('valid_time', idx,
                                 ('init_time', 'lead_time'))
    if {'init_time', 'lead_time'}.issubset(bin_thresholds.dims):
      return bin_thresholds.sel(init_time=host_coord('init_time'),
                                lead_time=host_coord('lead_time'))
    if {'dayofyear', 'lead_time'}.issubset(bin_thresholds.dims):
      return bin_thresholds.sel(
          dayofyear=dayofyear(host_coord('init_time')),
          lead_time=host_coord('lead_time')).rename(
              {'dayofyear': 'init_time'})
    return bin_thresholds
  if 'valid_time' in chunk.dims:
    if 'valid_time' in bin_thresholds.dims:
      return bin_thresholds.sel(valid_time=host_coord('valid_time'))
    if 'dayofyear' in bin_thresholds.dims:
      return bin_thresholds.sel(
          dayofyear=dayofyear(host_coord('valid_time'))).rename(
              {'dayofyear': 'valid_time'})
  return bin_thresholds


def compute_cdf(
    threshold_values: Thresholds,
    da: DimArray,
    threshold_dim: str,
    enforce_monotonicity: bool,
    right_inclusive: bool = True,
    name: Hashable | None = None,
) -> DimArray:
  """Empirical CDF indicator of ``da`` at each threshold, float32; NaNs in
  the data or the thresholds propagate."""
  if isinstance(threshold_values, (DimArray, Mapping)):
    thresholds = _thresholds_for(threshold_values, threshold_dim, name)
    thresholds = select_bin_thresholds_by_time_from_chunk(thresholds, da)
  elif isinstance(threshold_values, Iterable):
    thresholds = _thresholds_for(threshold_values, threshold_dim, name)
  else:
    raise ValueError('Bin values must be an Iterable, DimArray, or Mapping.')
  if enforce_monotonicity:
    ax = thresholds.dims.index(threshold_dim)
    if not np.all(np.diff(thresholds.values, axis=ax) > 0):
      raise ValueError(
          'Bin values must be monotonically increasing. To turn off this'
          ' check, set `enforce_monotonicity=False`.')
  op = '<=' if right_inclusive else '<'
  thresholds_cmp = darray.comparison_safe_threshold(thresholds, da.dtype, op)
  cdf = (da <= thresholds_cmp) if right_inclusive else (da < thresholds_cmp)
  return cdf.astype(torch.float32).where(~da.isnull()).where(
      ~thresholds.isnull())


class ContinuousToBins(InputTransform):
  """Bins a continuous input: CDF differences over right-inclusive bins,
  with ``{bin_dim}_left``/``_right`` edge coords and readable bin labels."""

  def reads_across(self):
    return _threshold_data_dims(self._bin_values, self._bin_dim)

  def __init__(self, which: str, bin_values: Thresholds, bin_dim: str,
               unique_name_suffix: str | None = None,
               enforce_monotonicity: bool = True):
    super().__init__(which)
    self._bin_values = bin_values
    self._bin_dim = bin_dim
    _require_suffix(bin_values, unique_name_suffix, 'bin_values')
    self._unique_name_suffix = unique_name_suffix
    self._enforce_monotonicity = enforce_monotonicity

  @property
  def unique_name_suffix(self) -> str:
    if self._unique_name_suffix is None:
      s = ','.join([str(t) for t in self._bin_values])
    else:
      s = self._unique_name_suffix
    return f'ContinuousToBins_{self._bin_dim}_{s}'

  def transform_fn(self, da, name=None):
    cdf = compute_cdf(
        threshold_values=self._bin_values, da=da,
        threshold_dim=self._bin_dim,
        enforce_monotonicity=self._enforce_monotonicity, name=name)
    edges = cdf.coord_values(self._bin_dim)
    left_edges, right_edges = edges[:-1], edges[1:]
    bin_names = np.array([
        f'{left:.2f} < p <= {right:.2f}'
        for left, right in zip(left_edges, right_edges)])
    return cdf.diff(self._bin_dim).assign_coords(**{
        self._bin_dim: Coord((self._bin_dim,), bin_names),
        f'{self._bin_dim}_left': Coord((self._bin_dim,), left_edges),
        f'{self._bin_dim}_right': Coord((self._bin_dim,), right_edges),
    })


class ContinuousToCDF(InputTransform):
  """CDF indicators of the input at each threshold."""

  def reads_across(self):
    return _threshold_data_dims(self._threshold_values,
                                self._threshold_dim)

  def __init__(self, which: str, threshold_values: Thresholds,
               threshold_dim: str, unique_name_suffix: str | None = None,
               enforce_monotonicity: bool = True,
               right_inclusive: bool = True):
    super().__init__(which)
    self._threshold_values = threshold_values
    self._threshold_dim = threshold_dim
    _require_suffix(threshold_values, unique_name_suffix, 'threshold_values')
    self._unique_name_suffix = unique_name_suffix
    self._enforce_monotonicity = enforce_monotonicity
    self._right_inclusive = right_inclusive

  @property
  def unique_name_suffix(self) -> str:
    if self._unique_name_suffix is None:
      s = ','.join([str(t) for t in self._threshold_values])
    else:
      s = self._unique_name_suffix
    return (f'ContinuousToCDF_{self._threshold_dim}_{s}_right_inclusive_'
            f'{self._right_inclusive}')

  def transform_fn(self, da, name=None):
    return compute_cdf(
        threshold_values=self._threshold_values, da=da,
        threshold_dim=self._threshold_dim,
        enforce_monotonicity=self._enforce_monotonicity,
        right_inclusive=self._right_inclusive, name=name)


class WeibullEnsembleToProbabilistic(InputTransform):
  """Binary ensemble → probability by the Weibull plotting position
  Σ/(M+1)."""

  def reads_across(self):
    return (self._ensemble_dim,)

  def __init__(self, which: str, ensemble_dim: str = 'number',
               skipna: bool = False):
    if which != 'predictions':
      raise ValueError('Only predictions can be converted to probabilities')
    super().__init__(which)
    self._ensemble_dim = ensemble_dim
    self._skipna = skipna

  @property
  def unique_name_suffix(self) -> str:
    return 'ensemble_to_probabilistic_by_weibull_plotting_position'

  def transform_fn(self, da, name=None):
    m = da.sizes[self._ensemble_dim]
    return da.sum(self._ensemble_dim, skipna=self._skipna) / (m + 1)


class Inline(InputTransform):
  """Transform with a user-provided function."""

  def __init__(self, which: str, transform_fn: Callable[[DimArray], DimArray],
               unique_name_suffix: str):
    super().__init__(which)
    self._transform_fn = transform_fn
    self._unique_name_suffix = unique_name_suffix

  @property
  def unique_name_suffix(self) -> str:
    return f'{self._unique_name_suffix}'

  def transform_fn(self, da, name=None):
    return self._transform_fn(da)


class ReLU(InputTransform):
  """max(x, 0), preserving NaNs."""

  def reads_across(self):
    return ()

  @property
  def unique_name_suffix(self) -> str:
    return 'relu'

  def transform_fn(self, da, name=None):
    return darray.where(da > 0, da, 0).where(~da.isnull())


class ShiftAlongNewDim(InputTransform):
  """Adds shift values along a new dimension."""

  def __init__(self, which: str,
               shift_value: Union[float, Iterable[float], Mapping[str, DimArray]],
               shift_dim: str, unique_name_suffix: str):
    super().__init__(which)
    self._shift_value = (
        shift_value if isinstance(shift_value, (Iterable, Mapping))
        else [shift_value])
    self._shift_dim = shift_dim
    self._unique_name_suffix = unique_name_suffix

  @property
  def unique_name_suffix(self) -> str:
    return self._unique_name_suffix

  def transform_fn(self, da, name=None):
    if isinstance(self._shift_value, Mapping):
      shifts = self._shift_value[name]
      if self._shift_dim not in shifts.dims:
        raise RuntimeError(
            f'Expected to find shift_dim={self._shift_dim!r} in '
            f'{shifts.dims!r} but did not.')
    else:
      v = np.asarray(list(self._shift_value), dtype=np.float64)
      # The constants take the data's dtype, as jnp's float64 constants
      # do without x64; float64 data keeps them whole.
      shifts = DimArray(torch.as_tensor(v).to(
          da.dtype if da.data.is_floating_point() else torch.float32),
                        (self._shift_dim,), {self._shift_dim: v})
    return da + shifts


class Rename(InputTransform):
  """Renames dims and coords."""

  def __init__(self, which: str, renames: Mapping[str, str]):
    super().__init__(which)
    self._renames = dict(renames)

  @property
  def unique_name_suffix(self) -> str:
    return f'rename_{self._renames}'

  def transform_fn(self, da, name=None):
    return da.rename(self._renames)


class Select(InputTransform):
  """Applies label (sel) and/or positional (isel) selection."""

  def __init__(self, which: str,
               sel: Mapping[str, Any] | None = None,
               isel: Mapping[str, Any] | None = None,
               sel_kwargs: Mapping[str, Any] | None = None,
               isel_kwargs: Mapping[str, Any] | None = None):
    super().__init__(which)
    self._sel = sel
    self._isel = isel
    self._sel_kwargs = dict(sel_kwargs or {})
    self._isel_kwargs = dict(isel_kwargs or {})

  @property
  def unique_name_suffix(self) -> str:
    # The 'self._'-prefixed key text is the JAX package's (see EnsembleMean).
    return (f'select_self._isel={self._isel}_self._isel_kwargs='
            f'{self._isel_kwargs}_self._sel={self._sel}_self._sel_kwargs='
            f'{self._sel_kwargs}')

  def transform_fn(self, da, name=None):
    if self._sel is not None:
      da = da.sel(self._sel, **self._sel_kwargs)
    if self._isel is not None:
      da = da.isel(self._isel, **self._isel_kwargs)
    return da


class StackToNewDimension(InputTransform):
  """Stacks dims into a new range-valued dimension."""

  def __init__(self, which: str, dims_to_stack: Sequence[str],
               new_dim_name: str):
    super().__init__(which)
    self._dims_to_stack = tuple(dims_to_stack)
    self._new_dim_name = new_dim_name

  @property
  def unique_name_suffix(self) -> str:
    return f'stack_{self._dims_to_stack}_to_{self._new_dim_name}'

  def transform_fn(self, da, name=None):
    return da.stack_to_new_dim(self._dims_to_stack, self._new_dim_name)


class _ForwardingStatistic(base.Statistic):
  """A statistic around ``self.statistic``: forwards the host hook, the
  evaluator's resource contract and the dims read across to it."""

  statistic: base.Statistic

  def reads_across(self):
    return self.statistic.reads_across()

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

  def reads_across(self):
    return union_reads_across(self.transform.reads_across(),
                              self.statistic.reads_across())

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


class SubselectVariablesForStatistic(_ForwardingStatistic):
  """Computes a statistic only for a subset of variables."""

  def __init__(self, statistic: base.Statistic, variables: Sequence[str]):
    self.statistic = statistic
    self.variables = list(variables)

  @property
  def unique_name(self) -> str:
    return f"{self.statistic.unique_name}_{'_'.join(self.variables)}"

  def compute(self, predictions, targets):
    predictions = {k: v for k, v in predictions.items()
                   if k in self.variables}
    targets = {k: v for k, v in targets.items() if k in self.variables}
    return self.statistic.compute(predictions, targets)


class SubselectVariables(base.Metric):
  """Computes a metric only for a subset of variables."""

  def __init__(self, metric: base.Metric, variables: Sequence[str]):
    self.metric = metric
    self.variables = list(variables)

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    return {
        name: SubselectVariablesForStatistic(stat, self.variables)
        for name, stat in self.metric.statistics.items()}

  def values_from_mean_statistics(self, statistic_values):
    return self.metric.values_from_mean_statistics(statistic_values)
