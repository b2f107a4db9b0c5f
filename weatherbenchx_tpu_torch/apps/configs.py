"""Benchmark configuration registry.

A copy of ``weatherbenchx_tpu/apps/configs.py`` (host-only code: every
module of the JAX package imports jax, so the port copies it): entries
keyed ``{model}_{resolution}_{year}`` with the public WeatherBench-2 GCS
dataset paths, per-entry default variable lists and per-model loader
quirks, plus the ECMWF-style evaluation regions.

The port reads only local ``.npz`` stores so far: a registry's ``gs://``
path reaches ``fileio``, which raises for remote paths (ROADMAP A8). The
registry structure, not the store format, is the contract the CLI
consumes, so local stores plug in through ``--prediction_path`` and its
siblings.
"""

from typing import Any, Mapping

DEFAULT_LEVELS = [500, 700, 850]

# ECMWF-style evaluation regions: {name: ((lat_min, lat_max),
# (lon_min, lon_max))}; longitude boxes may wrap the dateline.
REGIONS: Mapping[str, tuple] = {
    'global': ((-90, 90), (0, 360)),
    'tropics': ((-20, 20), (0, 360)),
    'northern-hemisphere': ((20, 90), (0, 360)),
    'southern-hemisphere': ((-90, -20), (0, 360)),
    'europe': ((35, 75), (-12.5, 42.5)),
    'north-america': ((25, 60), (360 - 120, 360 - 75)),
    'north-atlantic': ((25, 65), (360 - 70, 360 - 10)),
    'north-pacific': ((25, 60), (145, 360 - 130)),
    'east-asia': ((25, 60), (102.5, 150)),
    'ausnz': ((-45, -12.5), (120, 175)),
    'arctic': ((60, 90), (0, 360)),
    'antarctic': ((-90, -60), (0, 360)),
    'northern-africa': ((5, 32.5), (-12.5, 37.5)),
    'southern-africa': ((-30, 5), (12.5, 37.5)),
    'south-america': ((-40, 5), (-75, -45)),
    'west-asia': ((15, 60), (42.5, 102.5)),
    'south-east-asia': ((-12.5, 25), (95, 125)),
}

SEEPS_DRY_THRESHOLDS_MM = {
    'total_precipitation_6hr': 0.1,
    'total_precipitation_24hr': 0.25,
}

RESOLUTIONS = ('64x32', '240x121', '1440x721')
WB2 = 'gs://weatherbench2/datasets'

# Standard variable sets (reference ``public_configs.py:18-46``).
UPPER_LEVEL_VARIABLES = [
    'geopotential', 'temperature', 'u_component_of_wind',
    'v_component_of_wind', 'wind_speed', 'specific_humidity',
]
SURFACE_VARIABLES = [
    '2m_temperature', 'mean_sea_level_pressure', '10m_u_component_of_wind',
    '10m_v_component_of_wind', '10m_wind_speed',
]
STANDARD_VARIABLES = UPPER_LEVEL_VARIABLES + SURFACE_VARIABLES
PRECIPITATION_VARIABLES = [
    'total_precipitation_6hr', 'total_precipitation_24hr',
]
FUXI_VARIABLES = [v for v in STANDARD_VARIABLES + PRECIPITATION_VARIABLES
                  if v != 'specific_humidity']

# Grid-suffix convention of the WB2 buckets per resolution.
_GRID = {
    '64x32': '64x32_equiangular_conservative',
    '240x121': '240x121_equiangular_with_poles_conservative',
    '1440x721': '1440x721',
}


def _entry(path: str, variables, **extra) -> dict[str, Any]:
  return {'path': path, 'variables': list(variables), **extra}


deterministic_prediction_configs: dict[str, dict[str, Any]] = {}
probabilistic_prediction_configs: dict[str, dict[str, Any]] = {}


def _add(registry, model, resolution, years, entry):
  for year in years:
    registry[f'{model}_{resolution}_{year}'] = dict(entry)


for _r in RESOLUTIONS:
  _g = _GRID[_r]
  # HRES (operational IFS high-res; 00/12z inits).
  _add(deterministic_prediction_configs, 'hres', _r, (2018, 2020, 2022),
       _entry(f'{WB2}/hres/2016-2022-0012-{_g}.zarr',
              STANDARD_VARIABLES + PRECIPITATION_VARIABLES))
  # IFS ENS mean (precomputed ensemble mean).
  _add(deterministic_prediction_configs, 'ens_mean', _r, (2018, 2020, 2022),
       _entry(f'{WB2}/ifs_ens/2018-2022-{_g}_mean.zarr',
              STANDARD_VARIABLES + PRECIPITATION_VARIABLES))
  # ERA5 "forecast" (reanalysis replayed as a forecast baseline).
  for _y in (2018, 2020):
    _add(deterministic_prediction_configs, 'era5_forecast', _r, (_y,),
         _entry(f'{WB2}/era5-forecasts/{_y}-{_g}.zarr', STANDARD_VARIABLES))
  # Pangu-Weather (native ERA5 init and HRES-init variants).
  _add(deterministic_prediction_configs, 'pangu', _r, (2018, 2020, 2022),
       _entry(f'{WB2}/pangu/2018-2022_0012_{_g}.zarr'
              if _r != '1440x721' else f'{WB2}/pangu/2018-2022_0012_0p25.zarr',
              STANDARD_VARIABLES))
  for _y in (2020, 2022):
    _add(deterministic_prediction_configs, 'pangu_hres_init', _r, (_y,),
         _entry(f'{WB2}/pangu_hres_init/{_y}_0012_{_g}.zarr'
                if _r != '1440x721'
                else f'{WB2}/pangu_hres_init/{_y}_0012_0p25.zarr',
                STANDARD_VARIABLES))
  # FuXi (no specific humidity; 500/850 hPa only).
  _add(deterministic_prediction_configs, 'fuxi', _r, (2020,),
       _entry(f'{WB2}/fuxi/2020-{_g}.zarr', FUXI_VARIABLES,
              levels=[500, 850]))
  # IFS ENS (full ensemble, 'number' member dim).
  _add(probabilistic_prediction_configs, 'ens', _r, (2018, 2020, 2022),
       _entry(f'{WB2}/ifs_ens/2018-2022-{_g}.zarr',
              STANDARD_VARIABLES + PRECIPITATION_VARIABLES))

# Models published only at the coarser grids.
for _r in ('64x32', '240x121'):
  _g = _GRID[_r]
  # Keisler GNN: outputs contain NaNs -> mask + skipna aggregation
  # (reference ``run_benchmark_evaluation.py:229-248,378-380``).
  _add(deterministic_prediction_configs, 'keisler', _r, (2020,),
       _entry(f'{WB2}/keisler/2020-{_g}.zarr', UPPER_LEVEL_VARIABLES,
              data_loader_kwargs={'add_nan_mask': True},
              aggregator_kwargs={'skipna': True}))
  # NeuralGCM deterministic (a.k.a. neuralgcm_hres) and ENS mean.
  _add(deterministic_prediction_configs, 'neuralgcm_hres', _r, (2020,),
       _entry(f'{WB2}/neuralgcm_deterministic/2020-{_g}.zarr',
              UPPER_LEVEL_VARIABLES))
  _add(deterministic_prediction_configs, 'neuralgcm_ens_mean', _r, (2020,),
       _entry(f'{WB2}/neuralgcm_ens/2020-{_g}_mean.zarr',
              UPPER_LEVEL_VARIABLES))
  # NeuralGCM ENS ('realization' member dim).
  _add(probabilistic_prediction_configs, 'neuralgcm_ens', _r, (2020,),
       _entry(f'{WB2}/neuralgcm_ens/2020-{_g}.zarr', UPPER_LEVEL_VARIABLES,
              data_loader_kwargs={'rename_dimensions': {
                  'realization': 'number', 'time': 'init_time',
                  'prediction_timedelta': 'lead_time'}}))

def sort_latitude(ds):
  """Sorts every variable's latitude ascending.

  ERA5-derived stores are latitude-descending; SEEPS, the region land
  bins, and the aligned-grid contract assume ascending (the reference
  sorts too, ``run_benchmark_evaluation.py:208-214``). THE shared sort —
  the CLI and the registry entries below all use this one function.
  """
  return {k: (v.sortby('latitude') if 'latitude' in v.dims else v)
          for k, v in ds.items()}


# Ground-truth registry.
_SORT_LAT = {'preprocessing_fn': sort_latitude}
target_configs: dict[str, dict[str, Any]] = {}
for _r in RESOLUTIONS:
  _g = _GRID[_r]
  target_configs[f'era5_{_r}'] = _entry(
      f'{WB2}/era5/1959-2023_01_10-6h-{_g}.zarr'
      if _r != '1440x721'
      else f'{WB2}/era5/1959-2023_01_10-wb13-6h-1440x721_with_derived'
           '_variables.zarr',
      STANDARD_VARIABLES + PRECIPITATION_VARIABLES,
      data_loader_kwargs=dict(_SORT_LAT))
  # HRES T=0 analysis (evaluate HRES against its own analysis).
  target_configs[f'hres_t0_{_r}'] = _entry(
      f'{WB2}/hres_t0/2016-2022-6h-{_g}.zarr', STANDARD_VARIABLES)

# Climatology registry: eval year selects the climatological period
# (1990-2017 for 2016/2018 evals, 1990-2019 for 2020/2022).
climatology_configs: dict[str, dict[str, Any]] = {}
for _r in RESOLUTIONS:
  _g = _GRID[_r]
  for _period, _years in (('1990-2017', (2016, 2018)),
                          ('1990-2019', (2020, 2022))):
    for _y in _years:
      # _SORT_LAT: these entries double as the --prediction=climatology /
      # probabilistic_climatology loader config, where an unsorted
      # (descending-lat) prediction would silently compare flipped rows
      # against the sorted target.
      climatology_configs[f'era5_{_r}_{_y}'] = _entry(
          f'{WB2}/era5-hourly-climatology/{_period}_6h_{_g}.zarr',
          STANDARD_VARIABLES + PRECIPITATION_VARIABLES,
          data_loader_kwargs=dict(_SORT_LAT))
  # Resolution-only key: default to the recent period.
  climatology_configs[f'era5_{_r}'] = climatology_configs[f'era5_{_r}_2020']


def single_member_configs() -> dict[str, dict[str, Any]]:
  """Derives single-member configs from the probabilistic registry.

  Mirrors reference ``public_configs.py:248-285``: evaluate ensemble member
  0 of each full ensemble as a deterministic forecast, keyed
  ``{model}_single_member_{resolution}_{year}``.
  """
  out = {}
  for key, cfg in probabilistic_prediction_configs.items():
    # Keys are '{model}_{resolution}_{year}': split on the known suffix so
    # multi-word model names (neuralgcm_ens, future additions) parse
    # correctly instead of being mangled by prefix matching.
    model, res, year = key.rsplit('_', 2)
    assert res in RESOLUTIONS, key
    out[f'{model}_single_member_{res}_{year}'] = {
        **cfg,
        'data_loader_kwargs': {
            **cfg.get('data_loader_kwargs', {}),
            # Positional: member coords may be 1-indexed (ECMWF perturbed
            # members) — matches the reference's isel(number=0).
            'isel_kwargs': {'number': 0},
        },
    }
  return out


# Single-member variants are CLI-reachable deterministic entries
# (reference merges them the same way, ``public_configs.py:285``).
deterministic_prediction_configs.update(single_member_configs())
