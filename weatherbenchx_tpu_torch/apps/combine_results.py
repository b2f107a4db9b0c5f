"""Combines per-(model, year, resolution) results into one scorecard.

The port of ``weatherbenchx_tpu/apps/combine_results.py``, host code on
the port's ``darray`` and ``io`` (the equivalent of
``public_benchmark/combine_results.py:221-303``): reads each model's metric
file, renames metrics/regions/variables, stacks metrics into a 'metric'
dim and models into a 'model' dim, writes one scorecard dataset (the
container by suffix; an ``.npz`` is byte-identical to the JAX package's).

Example:
  python -m weatherbenchx_tpu_torch.apps.combine_results \
      --results_dir=./results --output_path=scorecard.npz --display_names
"""

import argparse
import os
import re
from typing import Mapping, Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.darray import Coord, DimArray

# Display renames (reference ``combine_results.py:139-193`` rename maps).
METRIC_RENAMES = {
    'rmse': 'RMSE',
    'mae': 'MAE',
    'mse': 'MSE',
    'bias': 'Bias',
    'acc': 'ACC',
    'seeps': 'SEEPS',
    # NOTE: no 'vector_rmse' entry — it is folded into 'rmse' of a synthetic
    # '<name>_vector' variable before renames apply (see combine_model_results),
    # matching the reference rename maps which have no such key either.
    'prediction_activity': 'Forecast Activity',
    'crps': 'CRPS',
    'spread_skill': 'Spread/Skill',
    'unbiased_spread_skill': 'Unbiased Spread/Skill',
    'unbiased_mean_rmse': 'Unbiased Mean RMSE',
    'mean_rmse': 'Mean RMSE',
}

VARIABLE_NAMES = {
    'geopotential': 'Geopotential',
    'temperature': 'Temperature',
    'specific_humidity': 'Specific Humidity',
    'u_component_of_wind': 'U Component of Wind',
    'v_component_of_wind': 'V Component of Wind',
    '10m_u_component_of_wind': '10m U Component of Wind',
    '10m_v_component_of_wind': '10m V Component of Wind',
    'mean_sea_level_pressure': 'Sea Level Pressure',
    '2m_temperature': '2m Temperature',
    'total_precipitation_6hr': '6h Precipitation',
    'total_precipitation_24hr': '24h Precipitation',
    'wind_speed': 'Wind Speed',
    '10m_wind_speed': '10m Wind Speed',
    'wind_vector': 'Wind Vector',
    '10m_wind_vector': '10m Wind Vector',
}

REGION_NAMES = {
    'global': 'Global',
    'tropics': 'Tropics',
    'northern-hemisphere': 'Northern Hemisphere',
    'southern-hemisphere': 'Southern Hemisphere',
    'europe': 'Europe',
    'north-america': 'North America',
    'north-atlantic': 'North Atlantic',
    'north-pacific': 'North Pacific',
    'east-asia': 'East Asia',
    'ausnz': 'Australia/New Zealand',
    'arctic': 'Arctic',
    'antarctic': 'Antarctic',
    'northern-africa': 'Northern Africa',
    'southern-africa': 'Southern Africa',
    'south-america': 'South America',
    'west-asia': 'West Asia',
    'south-east-asia': 'South-East Asia',
}

# (model)_vs_(target) → website display names
# (reference ``combine_results.py:51-117``).
MODEL_NAMES = {
    'hres_vs_hres_t0': 'IFS HRES vs Analysis',
    'hres_vs_era5': 'IFS HRES vs ERA5',
    'ens_mean_vs_hres_t0': 'IFS ENS (mean) vs Analysis',
    'ens_single_member_vs_hres_t0': 'IFS ENS (1st member) vs Analysis',
    'ens_mean_vs_era5': 'IFS ENS (mean) vs ERA5',
    'ens_single_member_vs_era5': 'IFS ENS (1st member) vs ERA5',
    'era5_forecast_vs_era5': 'ERA5-Forecasts vs ERA5',
    'climatology_vs_era5': 'Climatology vs ERA5',
    'persistence_vs_era5': 'Persistence vs ERA5',
    'keisler_vs_era5': 'Keisler (2022) vs ERA5',
    'pangu_vs_era5': 'Pangu-Weather vs ERA5',
    'pangu_hres_init_vs_era5': 'Pangu-Weather (oper.) vs ERA5',
    'pangu_hres_init_vs_hres_t0': 'Pangu-Weather (oper.) vs Analysis',
    'graphcast_vs_era5': 'GraphCast vs ERA5',
    'graphcast_hres_init_vs_era5': 'GraphCast (oper.) vs ERA5',
    'graphcast_hres_init_vs_hres_t0': 'GraphCast (oper.) vs Analysis',
    'neuralgcm_hres_vs_era5': 'NeuralGCM 0.7 vs ERA5',
    'neuralgcm_ens_mean_vs_era5': 'NeuralGCM ENS (mean) vs ERA5',
    'neuralgcm_ens_single_member_vs_era5':
        'NeuralGCM ENS (1st member) vs ERA5',
    'fuxi_vs_era5': 'FuXi vs ERA5',
    'gencast_mean_vs_era5': 'GenCast (mean) vs ERA5',
    'gencast_single_member_vs_era5': 'GenCast (1st member) vs ERA5',
    'gencast_operational_100m_uv_mean_vs_era5':
        'GenCast (oper.) (mean) vs ERA5',
    'gencast_operational_100m_uv_single_member_vs_era5':
        'GenCast (oper.) (1st member) vs ERA5',
    'gencast_operational_100m_uv_mean_vs_hres_t0':
        'GenCast (oper.) (mean) vs Analysis',
    'gencast_operational_100m_uv_single_member_vs_hres_t0':
        'GenCast (oper.) (1st member) vs Analysis',
    'fgn_operational_mean_vs_era5': 'FGN (oper.) (mean) vs ERA5',
    'fgn_operational_single_member_vs_era5':
        'FGN (oper.) (1st member) vs ERA5',
    'fgn_operational_mean_vs_hres_t0': 'FGN (oper.) (mean) vs Analysis',
    'fgn_operational_single_member_vs_hres_t0':
        'FGN (oper.) (1st member) vs Analysis',
    'stormer_ens_mean_vs_era5': 'Stormer ENS (mean) vs ERA5',
    'arches_weather_mx4_vs_era5': 'ArchesWeather-Mx4 vs ERA5',
    'arches_weather_gen_mean_vs_era5': 'ArchesWeatherGen (mean) vs ERA5',
    'swin_vs_era5': 'Swin vs ERA5',
    'excarta_vs_era5': 'Excarta (HEAL-ViT) vs ERA5',
    'aurora_vs_hres_t0': 'Aurora (oper.) vs Analysis',
    'baguan_vs_era5': 'Baguan vs ERA5',
    'weathermesh4_vs_era5': 'WeatherMesh4 vs ERA5',
    'ens_vs_hres_t0': 'IFS ENS vs Analysis',
    'ens_vs_era5': 'IFS ENS vs ERA5',
    'neuralgcm_ens_vs_era5': 'NeuralGCM ENS vs ERA5',
    'probabilistic_climatology_vs_era5': 'Probabilistic Climatology vs ERA5',
    'gencast_vs_era5': 'GenCast vs ERA5',
    'gencast_operational_100m_uv_vs_era5': 'GenCast (oper.) vs ERA5',
    'gencast_operational_100m_uv_vs_hres_t0': 'GenCast (oper.) vs Analysis',
    'fgn_operational_vs_era5': 'FGN (oper.) vs ERA5',
    'fgn_operational_vs_hres_t0': 'FGN (oper.) vs Analysis',
    'arches_weather_gen_vs_era5': 'ArchesWeatherGen vs ERA5',
}


def rename_region(region: str) -> str:
  """'tropics_land' → 'Tropics (Land)' (reference :214-218)."""
  if region.endswith('_land'):
    base = region[:-len('_land')]
    return REGION_NAMES.get(base, base) + ' (Land)'
  return REGION_NAMES.get(region, region)


def combine_model_results(
    model_files: Mapping[str, str],
) -> dict[str, DimArray]:
  """{model_name: metrics_file} → one '<variable>' dataset.

  Output arrays have dims (model, metric, *result_dims); metric values
  computed for different metrics of the same variable are stacked along a
  'metric' dim, models along 'model'.
  """
  per_model: dict[str, dict[str, dict[str, DimArray]]] = {}
  for model, path in model_files.items():
    ds = io_lib.load_dataset(path)
    by_var: dict[str, dict[str, DimArray]] = {}
    for key, da in ds.items():
      metric, var = str(key).split('.', 1)
      if metric == 'vector_rmse':
        # Reference folds vector RMSE into the RMSE metric of a synthetic
        # '<name>_vector' variable (``combine_results.py:235-238``).
        metric, var = 'rmse', f'{var}_vector'
      by_var.setdefault(var, {})[METRIC_RENAMES.get(metric, metric)] = da
    per_model[model] = by_var

  models = sorted(per_model)
  variables = sorted({v for m in per_model.values() for v in m})
  out: dict[str, DimArray] = {}
  for var in variables:
    metric_names = sorted({
        m for model in models for m in per_model[model].get(var, {})})
    # Outer-join labeled dims across models BEFORE stacking: models are
    # evaluated separately and may carry different lead_time extents or
    # level sets (hres 10-day leads vs fuxi 15-day); the reference's
    # xr.merge outer-joins across models the same way — without this the
    # concat crashes (or NaN-templates mis-shape).
    var_arrays = [da for model in models
                  for da in per_model[model].get(var, {}).values()]
    targets = {}
    for d in {d for da in var_arrays for d in da.dims}:
      u = _union_coord(var_arrays, d)
      if u is not None:
        targets[d] = u

    def align(da):
      for d, labels in targets.items():
        da = _reindex_dim(da, d, labels)
      return da

    model_stacks = []
    for model in models:
      stack = []
      for metric in metric_names:
        da = per_model[model].get(var, {}).get(metric)
        if da is not None:
          da = align(da)
        if da is None:
          # NaN fill for a (model, variable, metric) hole. The template
          # must come from the SAME (variable, metric) of another model:
          # a different metric can have extra dims (quantile, threshold)
          # and would mis-shape the stack. One always exists —
          # metric_names only contains metrics present under this
          # variable for at least one model.
          template = align(next(
              per_model[m][var][metric] for m in models
              if metric in per_model[m].get(var, {})))
          da = template.copy(data=np.full(template.shape, np.nan))
        stack.append(da)
      model_stacks.append(darray.concat(stack, 'metric').assign_coords(
          metric=Coord(('metric',), np.array(metric_names))))
    out[var] = darray.concat(model_stacks, 'model').assign_coords(
        model=Coord(('model',), np.array(models)))
  return out


_FILE_RE = re.compile(
    r'^(?P<model>.+?_vs_[^_]+(?:_t0)?)_(?P<res>\d+x\d+)(?:_(?P<year>\d{4}))?'
    r'.*\.npz$')


def _parse_result_filename(fn: str):
  """'<model>_vs_<target>_<res>[_<year>]...npz' → (model_vs_target, res, yr).

  Falls back to (prefix-before-_vs_-target, None, None) for names without
  the resolution segment.
  """
  m = _FILE_RE.match(fn)
  if m:
    return m.group('model'), m.group('res'), m.group('year')
  base = fn[:-len('.npz')]
  return base, None, None


def _union_coord(arrays, dim: str) -> Optional[np.ndarray]:
  """Union of a dim's coord labels across arrays (sorted), or None if
  the dim is unlabeled everywhere."""
  vals = [np.asarray(da.coord_values(dim)) for da in arrays
          if dim in da.dims and da.has_coord(dim)]
  if not vals:
    return None
  cat = np.concatenate(vals)
  try:
    return np.unique(cat)
  except TypeError:
    out: list = []
    for v in cat.tolist():
      if v not in out:
        out.append(v)
    return np.array(out, dtype=object)


def _reindex_dim(da: DimArray, dim: str, labels) -> DimArray:
  """Label-aligns ``da`` along ``dim`` to ``labels``, NaN-filling holes.

  The reference's cross-(year, resolution) stacking goes through xr.merge,
  which outer-joins on coordinate labels (``combine_results.py:268-283``);
  this is the darray equivalent: without it, combos evaluated with e.g.
  different lead_time extents or level sets would either crash the concat
  or stack silently misaligned.
  """
  if dim not in da.dims:
    return da
  labels = np.asarray(labels)
  if not da.has_coord(dim):
    if da.sizes[dim] == len(labels):
      return da
    raise ValueError(
        f'dim {dim!r} has no coord labels to align on but its size '
        f'{da.sizes[dim]} differs across (resolution, year) combos '
        f'(union size {len(labels)})')
  have = np.asarray(da.coord_values(dim))
  if have.shape == labels.shape and (have == labels).all():
    return da
  ax = da.dims.index(dim)
  shape = list(da.shape)
  shape[ax] = len(labels)
  out = np.full(shape, np.nan, dtype=np.float64)
  src = np.asarray(da.values, dtype=np.float64)
  have_list = have.tolist()
  for i, lbl in enumerate(labels.tolist()):
    if lbl in have_list:
      out[(slice(None),) * ax + (i,)] = src[
          (slice(None),) * ax + (have_list.index(lbl),)]
  coords = {}
  for name, c in da.coords.items():
    if name == dim:
      coords[name] = Coord((dim,), labels)
    elif dim in c.dims:
      continue  # stale along the reindexed dim
    else:
      coords[name] = c
  return DimArray(out, da.dims, coords)


def combine_result_files(
    files: Mapping[str, str],
    display_names: bool = False,
) -> dict[str, DimArray]:
  """Combines result files, stacking year/resolution dims when present.

  ``files`` maps file basename → path. When the basenames carry multiple
  (resolution, year) combinations, the output gains 'resolution' and
  'year' dims (reference ``combine_results.py:268-283``); holes are NaN.
  """
  groups: dict = {}
  for fn, path in files.items():
    model, res, year = _parse_result_filename(fn)
    if not display_names:
      model = model.split('_vs_')[0]
    elif model in MODEL_NAMES:
      model = MODEL_NAMES[model]
    group = groups.setdefault((res or '', year or ''), {})
    if model in group:
      print(f'WARNING: multiple result files for model {model!r} at '
            f'resolution={res!r} year={year!r}: '
            f'{os.path.basename(group[model])} overridden by {fn}')
    group[model] = path

  per_combo = {combo: combine_model_results(paths)
               for combo, paths in sorted(groups.items())}
  if display_names:
    renamed = {}
    for combo, ds in per_combo.items():
      out = {}
      for var, da in ds.items():
        if 'region' in da.dims:
          da = da.assign_coords(region=Coord(('region',), np.array(
              [rename_region(str(r)) for r in da.coord_values('region')])))
        out[VARIABLE_NAMES.get(var, var)] = da
      renamed[combo] = out
    per_combo = renamed
  if len(per_combo) == 1:
    return next(iter(per_combo.values()))

  resolutions = sorted({r for r, _ in per_combo})
  years = sorted({y for _, y in per_combo})
  variables = sorted({v for ds in per_combo.values() for v in ds})
  all_models = sorted({str(m) for ds in per_combo.values()
                       for da in ds.values()
                       for m in da.coord_values('model')})
  out: dict[str, DimArray] = {}
  for var in variables:
    arrays = {combo: ds[var] for combo, ds in per_combo.items()
              if var in ds}
    dims0 = next(iter(arrays.values())).dims
    for combo, da in arrays.items():
      if da.dims != dims0:
        raise ValueError(
            f'{var}: dims differ across (resolution, year) combos: '
            f'{da.dims} at {combo} vs {dims0}')
    # Outer-join every labeled dim across combos (model by the precomputed
    # union, the rest by coord labels) so combos evaluated with different
    # extents stack into one NaN-filled hypercube, as xr.merge would.
    targets: dict[str, np.ndarray] = {'model': np.array(all_models)}
    for d in dims0:
      if d == 'model':
        continue
      u = _union_coord(arrays.values(), d)
      if u is not None:
        targets[d] = u
      elif len({da.sizes[d] for da in arrays.values()}) > 1:
        raise ValueError(
            f'{var}: dim {d!r} is unlabeled and its size differs across '
            f'(resolution, year) combos — cannot align')
    aligned = {}
    for combo, da in arrays.items():
      for d, labels in targets.items():
        da = _reindex_dim(da, d, labels)
      aligned[combo] = da
    template = next(iter(aligned.values()))
    nan = template.copy(data=np.full(template.shape, np.nan))
    res_stack = []
    for res in resolutions:
      year_stack = []
      for year in years:
        year_stack.append(aligned.get((res, year), nan))
      res_stack.append(
          darray.concat(year_stack, 'year').assign_coords(
              year=Coord(('year',), np.array(years))))
    out[var] = darray.concat(res_stack, 'resolution').assign_coords(
        resolution=Coord(('resolution',), np.array(resolutions)))
  return out


def main(argv: Optional[Sequence[str]] = None) -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--results_dir', required=True,
                 help='Directory of per-model metric .npz files')
  p.add_argument('--output_path', required=True,
                 help='Combined scorecard output (.npz)')
  p.add_argument('--display_names', action='store_true',
                 help='Apply the website display-name maps to models, '
                      'variables and regions (reference rename maps)')
  args = p.parse_args(argv)

  files = {fn: os.path.join(args.results_dir, fn)
           for fn in sorted(os.listdir(args.results_dir))
           if fn.endswith('.npz')}
  if not files:
    raise SystemExit(f'No .npz result files found in {args.results_dir}')
  combined = combine_result_files(files, display_names=args.display_names)
  io_lib.save_dataset(args.output_path, combined)
  n_models = max(len(da.coord_values('model')) for da in combined.values())
  print(f'Wrote scorecard with {len(combined)} variables, '
        f'{n_models} models to {args.output_path}')


if __name__ == '__main__':
  main()
