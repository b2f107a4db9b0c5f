"""The Metric/Statistic contract.

The port of ``weatherbenchx_tpu/metrics/base.py``:

* A ``Statistic`` maps a (predictions, targets) chunk — each a
  ``dict[var, DimArray]`` — to per-variable statistic arrays.
* A ``Metric`` names the statistics it needs and finalizes their
  (weighted) means via ``values_from_mean_statistics``.
* Statistics are deduplicated across metrics by ``unique_name``, loudly:
  two statistics that share a name but provably differ raise.
* ``computation_cache`` is the per-pass memo through which sibling
  statistics share one fused kernel launch.
* Climatology-aligned statistics (ACC, activity, SEEPS) hold their
  climatology on the host; the evaluator uploads it once and maps it to
  the device copy through ``device_resources``. Alignment indices, and
  for climatologies too large to keep on the device the aligned values,
  are built per chunk on the host by ``Statistic.prepare_chunk``.
"""

import abc
import contextlib
import threading
from typing import Any, Hashable, Iterator, Mapping, final

import numpy as np
import torch

from weatherbenchx_tpu_torch.darray import Coord, DimArray, _label_indices

# -- device resources ---------------------------------------------------------
# Large arrays a statistic holds for its whole lifetime (climatologies) are
# uploaded to the device once by the evaluator, not with every chunk. While
# the evaluator computes a chunk, this registry maps the statistic's host
# array (by object identity) to its device copy.

_ACTIVE_RESOURCES = threading.local()


def resource_id(da: DimArray) -> str:
  return f'r{id(da)}'


@contextlib.contextmanager
def device_resources(mapping: Mapping[str, torch.Tensor] | None):
  """Activates a {resource_id: device tensor} mapping for this thread."""
  prev = getattr(_ACTIVE_RESOURCES, 'mapping', None)
  _ACTIVE_RESOURCES.mapping = mapping
  try:
    yield
  finally:
    _ACTIVE_RESOURCES.mapping = prev


def resolve_resource(da: DimArray) -> DimArray:
  """The device copy of a long-lived host array while a mapping is active.

  Outside the evaluator (no mapping) the host array itself is used. Inside,
  an array the mapping lacks — one the planner demoted to host-gather, or
  one no statistic registered — raises: the step never falls back to
  copying a whole host climatology to the device.
  """
  m = getattr(_ACTIVE_RESOURCES, 'mapping', None)
  if m is None:
    return da
  hit = m.get(resource_id(da))
  if hit is None:
    raise KeyError(
        f'resource {resource_id(da)} {da.dims} is not resident on the device '
        '(demoted to host-gather, or not registered by its statistic); its '
        'aligned values must arrive with the chunk')
  return DimArray(hit, da.dims, da.coords)


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

  def prepare_chunk(
      self,
      predictions: Mapping[Hashable, DimArray],
      targets: Mapping[Hashable, DimArray],
  ) -> tuple[Mapping[Hashable, DimArray], Mapping[Hashable, DimArray]]:
    """Host-side hook run on each chunk before it moves to the device.

    Statistics needing per-chunk host information (e.g. datetime coords
    for climatology alignment) attach it here as coords. Host work only:
    the pipeline runs it in its loader threads. Default: no-op.
    """
    return predictions, targets

  def device_resource_arrays(self) -> dict[str, torch.Tensor]:
    """{resource_id: host tensor} the evaluator uploads once. Default: none."""
    return {}

  def host_gatherable_resource_arrays(self) -> dict[str, DimArray]:
    """{resource_id: DimArray} this statistic reads only through alignment,
    so the planner may gather them per chunk on the host instead."""
    return {}

  def set_host_gather_resources(self, ids) -> None:
    """Told by the evaluator which resource_ids are not resident."""

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


def _strip_gathered(values: Mapping[Hashable, DimArray]) -> dict:
  """Drops host-gathered climatology slices (CLIM_VALUE_PREFIX coords):
  chunk-sized, they ride along through arithmetic and are dead weight once
  a statistic is computed."""
  out = {}
  for var, da in values.items():
    names = [n for n in da.coords if str(n).startswith(CLIM_VALUE_PREFIX)]
    out[var] = da.drop_coords(names) if names else da
  return out


def generate_unique_statistics_for_all_metrics(
    metrics: Mapping[str, Metric],
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> Iterator[tuple[str, Mapping[Hashable, DimArray]]]:
  """Yields (unique_name, values) for each deduplicated statistic, in one
  compute pass; a consumer that aggregates each before asking for the next
  holds one statistic at a time."""
  unique_statistics = unique_statistics_for_metrics(metrics)
  with computation_cache():
    for k, stat in unique_statistics.items():
      try:
        values = stat.compute(predictions, targets)
      except Exception as e:
        raise ValueError(f'Failed to compute statistic {k}={stat}') from e
      yield k, _strip_gathered(values)


def compute_unique_statistics_for_all_metrics(
    metrics: Mapping[str, Metric],
    predictions: Mapping[Hashable, DimArray],
    targets: Mapping[Hashable, DimArray],
) -> dict[str, Mapping[Hashable, DimArray]]:
  """Computes deduplicated statistics for all metrics in one compute pass."""
  return dict(generate_unique_statistics_for_all_metrics(
      metrics, predictions, targets))


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


# ---------------------------------------------------------------------------
# Climatology-aligned statistics
# ---------------------------------------------------------------------------

# Host coords carrying precomputed climatology gather indices, attached by
# ``prepare_chunk`` and moved to the device with the chunk.
CLIM_INDEX_PREFIX = '_clim_idx_'

# Coords carrying HOST-GATHERED climatology values for one chunk, named by
# the climatology array's resource_id (statistics sharing one climatology
# share one slice). Used for climatologies the evaluator's planner did not
# keep resident: a dayofyear x hour climatology of every field-level at
# 0.25 degrees is far larger than the card, so residency is a cache
# policy, not a correctness requirement.
CLIM_VALUE_PREFIX = '_clim_val_'


def valid_time_coord(da: DimArray) -> tuple[tuple[str, ...], np.ndarray]:
  """Host valid_time (dims, datetime64[ns] values) from coords: an explicit
  ``valid_time`` coord, or the broadcast sum of init_time and lead_time."""
  if da.has_coord('valid_time'):
    return da.coords['valid_time'].dims, da.coord_values('valid_time')
  if da.has_coord('init_time') and da.has_coord('lead_time'):
    init, lead = da.coords['init_time'], da.coords['lead_time']
    dims = tuple(init.dims) + tuple(d for d in lead.dims
                                    if d not in init.dims)
    sizes = dict(zip(init.dims, np.shape(init.values)))
    sizes.update(zip(lead.dims, np.shape(lead.values)))
    shape = tuple(sizes[d] for d in dims)

    def expand(values, vdims):
      order = [vdims.index(d) for d in dims if d in vdims]
      v = np.transpose(np.asarray(values), order)
      return np.broadcast_to(
          v[tuple(slice(None) if d in vdims else None for d in dims)], shape)

    return dims, (expand(init.values, init.dims)
                  + expand(lead.values, lead.dims)).astype('datetime64[ns]')
  raise ValueError(
      'Predictions should have either valid_time or init/lead_time coords.')


def dayofyear_and_hour(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
  """1-based day of year and hour of day of datetime64 values (numpy only:
  pandas' ``DatetimeIndex.dayofyear`` semantics, 366 on Dec 31 of a leap
  year)."""
  day = t.astype('datetime64[D]')
  doy = (day - t.astype('datetime64[Y]')).astype(np.int64) + 1
  hour = (t.astype('datetime64[h]') - day).astype(np.int64)
  return doy, hour


def climatology_alignment_indices(
    clim: DimArray, valid_time: np.ndarray) -> dict[str, np.ndarray]:
  """Host indices aligning a climatology to given valid times.

  The climatology has a ``time`` dim (exact match), a ``dayofyear`` dim,
  or ``dayofyear`` and ``hour`` dims. Returns {clim_dim: int64 index array
  of valid_time's shape}.
  """
  vt = np.asarray(valid_time).astype('datetime64[ns]').reshape(-1)
  if 'time' in clim.dims:
    coord = clim.coord_values('time').astype('datetime64[ns]')
    return {'time': _label_indices(coord, vt, None).reshape(valid_time.shape)}
  doy, hour = dayofyear_and_hour(vt)
  out = {'dayofyear': _label_indices(
      clim.coord_values('dayofyear').astype(np.int64), doy, None
  ).reshape(valid_time.shape)}
  if 'hour' in clim.dims:
    out['hour'] = _label_indices(clim.coord_values('hour').astype(np.int64),
                                 hour, None).reshape(valid_time.shape)
  return out


def _gather_layout(clim: DimArray, indices: Mapping[str, Any]):
  """(time dims, other dims, axis order, time shape) of a gather."""
  time_dims = [d for d in clim.dims if d in indices]
  other_dims = [d for d in clim.dims if d not in indices]
  order = [clim.dims.index(d) for d in time_dims + other_dims]
  tshape = tuple(clim.sizes[d] for d in time_dims)
  return time_dims, other_dims, order, tshape


def _spatial_coords(clim: DimArray, other_dims) -> dict[str, Coord]:
  return {k: c for k, c in clim.coords.items()
          if set(c.dims).issubset(other_dims)}


def gather_climatology(
    clim: DimArray, indices: Mapping[str, Any], out_dims: tuple[str, ...]
) -> DimArray:
  """Climatology at precomputed time indices, gathered where its data is.

  ``indices`` are host arrays or tensors of one shape, laid out along
  ``out_dims``. The result has ``out_dims`` in place of the climatology's
  time dims, then its other (spatial) dims, and their coords.
  """
  time_dims, other_dims, order, tshape = _gather_layout(clim, indices)
  data = clim.data.permute(order)
  data = data.reshape((-1,) + tuple(data.shape[len(time_dims):]))
  flat = None
  stride = 1
  for d, s in zip(reversed(time_dims), reversed(tshape)):
    i = torch.as_tensor(indices[d], device=data.device).long() * stride
    flat = i if flat is None else flat + i
    stride *= s
  gathered = data.index_select(0, flat.reshape(-1))
  gathered = gathered.reshape(tuple(flat.shape) + tuple(data.shape[1:]))
  return DimArray(gathered, tuple(out_dims) + tuple(other_dims),
                  _spatial_coords(clim, other_dims))


def gather_climatology_host(
    clim: DimArray, indices: Mapping[str, np.ndarray],
    out_dims: tuple[str, ...]) -> DimArray:
  """Numpy twin of :func:`gather_climatology` for the host-gather path.

  Runs in the pipeline's loader threads on the host climatology (never
  touching the device). The same gather, so the values are bit-identical
  to the device gather, and the same coords as the index path.
  """
  time_dims, other_dims, order, tshape = _gather_layout(clim, indices)
  data = np.transpose(clim.values, order)
  data = data.reshape((-1,) + data.shape[len(time_dims):])
  flat = np.zeros(np.shape(indices[time_dims[0]]), np.int64)
  stride = 1
  for d, s in zip(reversed(time_dims), reversed(tshape)):
    flat = flat + np.asarray(indices[d], np.int64) * stride
    stride *= s
  gathered = np.take(data, flat.reshape(-1), axis=0).reshape(
      flat.shape + data.shape[1:])
  return DimArray(gathered, tuple(out_dims) + tuple(other_dims),
                  _spatial_coords(clim, other_dims))


def attach_climatology_indices(
    predictions: Mapping[Hashable, DimArray],
    climatology: Mapping[Hashable, DimArray],
) -> dict[Hashable, DimArray]:
  """Attaches host int32 alignment-index coords to each prediction.

  Host-side per chunk (O(number of valid times)); the evaluator moves them
  to the device with the chunk.
  """
  out = dict(predictions)
  for var, da in predictions.items():
    if var in climatology:
      clim = climatology[var]
    elif climatology:
      # Derived climatology names (e.g. SEEPS's '{var}_seeps_threshold')
      # share the climatology's time layout.
      clim = next(iter(climatology.values()))
    else:
      continue
    vt_dims, vt = valid_time_coord(da)
    idx = climatology_alignment_indices(clim, vt)
    out[var] = da.assign_coords(**{
        f'{CLIM_INDEX_PREFIX}{d}': Coord(vt_dims, np.asarray(i, np.int32))
        for d, i in idx.items()})
  return out


def aligned_climatology_for(clim: DimArray, pred: DimArray) -> DimArray:
  """The host climatology ``clim`` aligned to ``pred``'s valid times.

  In order: a host-gathered ``_clim_val_<rid>`` slice attached by
  ``prepare_chunk`` (for climatologies not resident on the device); else
  a gather of the resident copy at the ``_clim_idx_*`` coords; else (no
  prepared coords: a notebook call) alignment from the datetime coords.
  """
  val = pred.coords.get(f'{CLIM_VALUE_PREFIX}{resource_id(clim)}')
  if val is not None:
    # The index path's coords too: the climatology's time coords lie on
    # dims the slice no longer has, its spatial coords on dims it keeps.
    return DimArray(val.values, val.dims, _spatial_coords(clim, val.dims))
  resolved = resolve_resource(clim)
  idx = {name[len(CLIM_INDEX_PREFIX):]: c for name, c in pred.coords.items()
         if name.startswith(CLIM_INDEX_PREFIX)}
  idx = {d: c for d, c in idx.items() if d in clim.dims}
  if idx:
    out_dims = next(iter(idx.values())).dims
    return gather_climatology(resolved, {d: c.values for d, c in idx.items()},
                              tuple(out_dims))
  vt_dims, vt = valid_time_coord(pred)
  return gather_climatology(resolved, climatology_alignment_indices(clim, vt),
                            vt_dims)


class StatisticWithClimatology(Statistic):
  """Climatology storage, the evaluator's resource contract and the
  prepare hook that aligns the climatology per chunk on the host."""

  # resource_ids the evaluator did not keep on the device; prepare_chunk
  # gathers these per chunk on the host instead.
  _host_gather_ids: frozenset = frozenset()

  def __init__(self, climatology: Mapping[Hashable, DimArray]):
    self._climatology = dict(climatology)

  @property
  def climatology(self) -> Mapping[Hashable, DimArray]:
    return self._climatology

  def device_resource_arrays(self) -> dict[str, torch.Tensor]:
    return {resource_id(da): da.data for da in self._climatology.values()}

  def host_gatherable_resource_arrays(self) -> dict[str, DimArray]:
    """Entries consumed only through ``aligned_climatology_for``; a
    subclass that reads an entry directly in compute must exclude it."""
    return {resource_id(da): da for da in self._climatology.values()}

  def set_host_gather_resources(self, ids) -> None:
    self._host_gather_ids = frozenset(ids)

  def _aligned_clim_keys(self, var: Hashable) -> tuple:
    """Climatology keys that compute() aligns to variable ``var``."""
    return (var,) if var in self._climatology else ()

  def _attach_host_gathered(self, predictions: dict) -> dict:
    """Attaches host-gathered aligned slices of non-resident climatologies."""
    if not self._host_gather_ids:
      return predictions
    for var, da in list(predictions.items()):
      for key in self._aligned_clim_keys(var):
        clim = self._climatology[key]
        rid = resource_id(clim)
        name = f'{CLIM_VALUE_PREFIX}{rid}'
        if rid not in self._host_gather_ids or name in da.coords:
          continue  # resident, or attached by a statistic sharing it
        vt_dims, vt = valid_time_coord(da)
        g = gather_climatology_host(
            clim, climatology_alignment_indices(clim, vt), vt_dims)
        da = da.assign_coords(**{name: Coord(g.dims, g.values)})
      predictions[var] = da
    return predictions

  def prepare_chunk(self, predictions, targets):
    return self._attach_host_gathered(attach_climatology_indices(
        dict(predictions), self._climatology)), targets


class PerVariableStatisticWithClimatology(StatisticWithClimatology):
  """Per-variable statistic of a time-aligned climatology: aligned to the
  predictions' valid_time (explicit, or init_time + lead_time) by exact
  ``time`` or by dayofyear[, hour]."""

  @final
  def compute(self, predictions, targets):
    result = {}
    for var_name, pred in predictions.items():
      if var_name not in targets:
        continue
      aligned = aligned_climatology_for(self._climatology[var_name], pred)
      result[var_name] = self._compute_per_variable_with_aligned_climatology(
          pred, targets[var_name], aligned)
    return result

  @abc.abstractmethod
  def _compute_per_variable_with_aligned_climatology(
      self, predictions: DimArray, targets: DimArray,
      aligned_climatology: DimArray) -> DimArray:
    """Computes the statistic given the time-aligned climatology."""
