"""Synthetic datasets for tests (mirrors reference test_utils conventions).

The port of ``weatherbenchx_tpu/test_utils.py``: from the same seed, the
same values as port ``DimArray``s over torch tensors.

Produces dict[var, DimArray] datasets. ``canonical=True`` gives the
framework's canonical dims (init_time/lead_time/latitude/longitude[/number]);
``canonical=False`` gives raw ECMWF-style names
(time/prediction_timedelta/realization) to exercise loader renaming
(reference ``test_utils.py:27-90``).
"""

from typing import Mapping, Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch.darray import Coord, DimArray

DEFAULT_2D_VARIABLES = ('2m_temperature',)
DEFAULT_3D_VARIABLES = ('geopotential',)


def _grid_coords(spatial_resolution_in_degrees: float):
  num_latitudes = round(180 / spatial_resolution_in_degrees) + 1
  num_longitudes = round(360 / spatial_resolution_in_degrees)
  return (np.linspace(-90, 90, num_latitudes),
          np.linspace(0, 360, num_longitudes, endpoint=False))


def mock_target_data(
    *,
    variables_3d: Sequence[str] = DEFAULT_3D_VARIABLES,
    variables_2d: Sequence[str] = DEFAULT_2D_VARIABLES,
    levels: Sequence[int] = (500, 700, 850),
    spatial_resolution_in_degrees: float = 10.0,
    time_start: str = '2020-01-01',
    time_stop: str = '2021-01-01',
    time_resolution: np.timedelta64 = np.timedelta64(1, 'D'),
    dtype=np.float32,
    ensemble_size: Optional[int] = None,
    random: bool = False,
    seed: Optional[int] = 0,
    time_dim: str = 'time',
    ensemble_dim: str = 'realization',
) -> dict[str, DimArray]:
  """Mock truth dataset (zeros, or seeded uniform random)."""
  rng = np.random.default_rng(seed)

  def val_fn(shape):
    if random:
      return rng.random(size=shape).astype(dtype)
    return np.zeros(shape, dtype=dtype)

  lats, lons = _grid_coords(spatial_resolution_in_degrees)
  times = np.arange(np.datetime64(time_start), np.datetime64(time_stop),
                    time_resolution).astype('datetime64[ns]')
  coords: dict[str, np.ndarray] = {
      time_dim: times,
      'latitude': lats,
      'longitude': lons,
      'level': np.array(levels),
  }
  if ensemble_size is not None:
    coords[ensemble_dim] = np.arange(ensemble_size)

  dims_3d = tuple(coords.keys())
  shape_3d = tuple(len(coords[d]) for d in dims_3d)
  out: dict[str, DimArray] = {}
  for k in variables_3d:
    out[k] = DimArray(val_fn(shape_3d), dims_3d,
                      {d: coords[d] for d in dims_3d})
  dims_2d = tuple(d for d in coords.keys() if d != 'level')
  shape_2d = tuple(len(coords[d]) for d in dims_2d)
  for k in variables_2d:
    out[k] = DimArray(val_fn(shape_2d), dims_2d,
                      {d: coords[d] for d in dims_2d})
  return out


def mock_prediction_data(
    *,
    lead_start: np.timedelta64 = np.timedelta64(0, 'D'),
    lead_stop: np.timedelta64 = np.timedelta64(10, 'D'),
    lead_resolution: np.timedelta64 = np.timedelta64(1, 'D'),
    lead_dim: str = 'prediction_timedelta',
    **kwargs,
) -> dict[str, DimArray]:
  """Mock forecast dataset: target data + a lead-time dimension."""
  lead_times = np.arange(
      lead_start, lead_stop + lead_resolution, lead_resolution
  ).astype('timedelta64[ns]')
  ds = mock_target_data(**kwargs)
  out = {}
  for k, da in ds.items():
    expanded = da.expand_dims({lead_dim: len(lead_times)}, axis=0)
    expanded = expanded.assign_coords(
        **{lead_dim: Coord((lead_dim,), lead_times)})
    out[k] = expanded
  return out


def canonical_forecast_pair(
    *,
    n_init: int = 4,
    n_lead: int = 3,
    spatial_resolution_in_degrees: float = 10.0,
    ensemble_size: Optional[int] = None,
    seed: int = 0,
    dtype=np.float32,
    variables_2d: Sequence[str] = DEFAULT_2D_VARIABLES,
    variables_3d: Sequence[str] = (),
    levels: Sequence[int] = (500, 700, 850),
) -> tuple[dict[str, DimArray], dict[str, DimArray]]:
  """Random (predictions, targets) with canonical dims, ready for metrics.

  Predictions: (number?, init_time, lead_time, level?, latitude, longitude).
  Targets: same without the ensemble dim.
  """
  rng = np.random.default_rng(seed)
  lats, lons = _grid_coords(spatial_resolution_in_degrees)
  init_times = (np.datetime64('2020-01-01', 'ns')
                + np.arange(n_init) * np.timedelta64(12, 'h'))
  lead_times = (np.arange(n_lead) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')

  def build(shape, dims, coords):
    return DimArray(rng.standard_normal(shape).astype(dtype), dims, coords)

  base_dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  base_shape = (n_init, n_lead, len(lats), len(lons))
  base_coords = {'init_time': init_times, 'lead_time': lead_times,
                 'latitude': lats, 'longitude': lons}

  predictions: dict[str, DimArray] = {}
  targets: dict[str, DimArray] = {}
  for var in variables_2d:
    if ensemble_size:
      predictions[var] = build(
          (ensemble_size,) + base_shape, ('number',) + base_dims,
          {**base_coords, 'number': np.arange(ensemble_size)})
    else:
      predictions[var] = build(base_shape, base_dims, base_coords)
    targets[var] = build(base_shape, base_dims, base_coords)
  for var in variables_3d:
    dims = base_dims[:2] + ('level',) + base_dims[2:]
    shape = base_shape[:2] + (len(levels),) + base_shape[2:]
    coords = {**base_coords, 'level': np.array(levels)}
    if ensemble_size:
      predictions[var] = build(
          (ensemble_size,) + shape, ('number',) + dims,
          {**coords, 'number': np.arange(ensemble_size)})
    else:
      predictions[var] = build(shape, dims, coords)
    targets[var] = build(shape, dims, coords)
  return predictions, targets


def compute_all_metrics(metrics, predictions, targets, reduce_dims,
                        **aggregator_kwargs):
  """Full stats -> aggregate -> finalize path for tests.

  Mirrors reference ``metrics_test_utils.py:86-95``.
  """
  from weatherbenchx_tpu_torch import aggregation

  aggregator = aggregation.Aggregator(reduce_dims=reduce_dims,
                                      **aggregator_kwargs)
  return aggregation.compute_metric_values_for_single_chunk(
      metrics, aggregator, predictions, targets)
