"""The benchmark's ``hres.scorecard`` cell (configuration ``hres_0p25``,
WeatherBench 2's deterministic scorecard) at a tiny size on the CPU.

The cell's own generator (``wbxbench/generators/hres_0p25.py``), metric
set (``wb2_deterministic``) and ``spec.port_aggregator`` with the
land-sea mask run through the harness's ``run.run``: 4 upper-air variables
(geopotential, u, v and the wind speed) at 2 levels, 4 surface ones (2 m
temperature, 10 m u, v and wind speed), both precipitation accumulations,
2 inits x 3 leads a chunk on a 37 x 72 grid, 34 bins. Every metric,
variable, lead, level and region is held to the float64 reference
(``wbxbench/references/hres_0p25.py``) by the harness's checks; each fault
of the kind fails exactly the checks it touches, and the bfloat16 control
fails.

The grid is 5 degrees: each region's land part then holds tens of points,
so that no bin's statistic is exactly 0 in both the port and the reference
(a relative gap of 0 / 0) or a bias crosses 0 by sampling alone.
"""

import ast
import copy
import os
import types

import numpy as np
import pytest
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from weatherbenchx_tpu_torch.metrics import categorical
from wbxbench import run, spec

CELL = 'hres.scorecard'
SEED = 2**31 + 23456
LEVELS = [500, 850]
UPPER = ['geopotential', 'u_component_of_wind', 'v_component_of_wind',
         'wind_speed']
PRECIPITATION = ['total_precipitation_6hr', 'total_precipitation_24hr']
VARIABLES = UPPER + ['2m_temperature', '10m_u_component_of_wind',
                     '10m_v_component_of_wind', '10m_wind_speed'
                     ] + PRECIPITATION
WINDOW_S = 3600.0  # never reached: the window ends after WINDOW_CHUNKS
WINDOW_CHUNKS = 8  # > 2 pool chunks: some chunk keys are handed over twice


def tiny_cell():
  """The cell with the configuration and chunk cut to the tiny size; the
  generator's per-level statistics taken at the kept levels."""
  full = spec.resolve(CELL)
  gen = copy.deepcopy(full.traffic['generator'])
  keep = [full.config['levels'].index(x) for x in LEVELS]
  for field in gen['fields'].values():
    for key, value in field.items():
      if isinstance(value, list):
        field[key] = [value[i] for i in keep]
  return spec.resolve(CELL, overrides={
      'config': {'variables': VARIABLES, 'upper_air_variables': UPPER,
                 'levels': LEVELS, 'latitudes': 37, 'longitudes': 72,
                 'init_times': 6, 'climatology_days': 4},
      'chunk': {'init_times': 2, 'leads': 3},
      'traffic': {'generator': gen}})


@pytest.fixture(autouse=True)
def _window_of_fixed_chunks(monkeypatch):
  """The harness's window ends after WINDOW_CHUNKS chunks, however loaded
  the machine: its clock jumps past the window at that chunk's end mark."""
  ended = []
  mark = run._Marks.mark

  def counted(self):
    mark(self)
    if len(self.marks) == WINDOW_CHUNKS:
      ended.append(True)
  clock = run.time.perf_counter
  monkeypatch.setattr(run._Marks, 'mark', counted)
  monkeypatch.setattr(run, 'time', types.SimpleNamespace(
      perf_counter=lambda: clock() + (2 * WINDOW_S if ended else 0.0)))


def _run(cell, **kw):
  return run.run(cell, SEED, WINDOW_S, False, device='cpu', **kw)


def _keys(metrics, variables) -> set:
  return {f'{m}.{v}' for m in metrics for v in variables}


ALL = (_keys(['rmse', 'mse', 'bias', 'acc', 'prediction_activity'],
             VARIABLES)
       | _keys(['vector_rmse'], ['wind', '10m_wind'])
       | _keys(['seeps'], PRECIPITATION))


def _failed(result) -> set:
  return {k for k, c in result['checks'].items()
          if c['value'] is None or c['value'] > c['limit']}


def test_the_cell_reads_correct_at_a_tiny_size(monkeypatch):
  cell = tiny_cell()
  assert cell.values_per_chunk == 2 * 3 * 37 * 72 * (4 * 2 + 6)
  got = {}
  host_values = run._host_values

  def keep(values):
    got.update(host_values(values))
    return got
  monkeypatch.setattr(run, '_host_values', keep)
  result = _run(cell)
  assert result['correct'] is True, result['checks']
  assert set(result['checks']) == ALL
  assert result['attempted'] == WINDOW_CHUNKS > 2 * cell.traffic['pool']
  limit = cell.traffic['limits']['metric_rel_gap']
  assert all(c['limit'] == limit for c in result['checks'].values())
  regions = list(cell.config['regions'])
  assert len(regions) == 17
  dims, values, labels = got['acc.geopotential']
  assert sorted(dims) == ['lead_time', 'level', 'region']
  assert labels['region'] == regions + [f'{r}_land' for r in regions]
  assert values.shape[dims.index('region')] == 34
  assert sorted(got['vector_rmse.wind'][0]) == ['lead_time', 'level',
                                                'region']
  assert sorted(got['seeps.total_precipitation_6hr'][0]) == ['lead_time',
                                                            'region']


def test_every_precipitation_category_and_the_p1_mask_occur():
  cell = tiny_cell()
  pool = cell.generator.make_pool(cell.config, cell.traffic, SEED, 'cpu')
  clim = cell.generator.resources(cell.config, cell.traffic, SEED,
                                  'cpu')['climatology']
  for var, dry_mm in zip(PRECIPITATION, (0.1, 0.25)):
    wet = clim[f'{var}_seeps_threshold'].data.flatten(0, 1)[:3]
    for side in (pool[0].forecast, pool[0].target):
      x = side[var][0]
      assert bool((x >= 0).all())
      dry = x <= np.float32(dry_mm / 1000)
      heavy = x >= wet
      assert dry.any() and heavy.any() and (~dry & ~heavy).any()
    p1 = clim[f'{var}_seeps_dry_fraction'].data.double().mean((0, 1))
    assert bool(((p1 < 0.1) | (p1 > 0.85)).any())
    assert float(((p1 >= 0.1) & (p1 <= 0.85)).double().mean()) > 0.7


def test_wind_speeds_are_the_components_magnitude():
  cell = tiny_cell()
  (pc,) = cell.generator.make_pool(
      cell.config, dict(cell.traffic, pool=1), SEED, 'cpu')
  for speed, (u, v) in cell.traffic['generator']['speeds'].items():
    for side in (pc.forecast, pc.target):
      torch.testing.assert_close(side[speed], torch.hypot(side[u], side[v]),
                                 rtol=0, atol=0)


def _shift_climatology(monkeypatch):
  """The port aligns each valid time to the climatology's next slot."""
  align = metrics_base.climatology_alignment_indices

  def shifted(clim, valid_time):
    idx = align(clim, valid_time)
    hours = clim.sizes['hour']
    flat = (idx['dayofyear'] * hours + idx['hour'] + 1) % (
        clim.sizes['dayofyear'] * hours)
    return {'dayofyear': flat // hours, 'hour': flat % hours}
  monkeypatch.setattr(metrics_base, 'climatology_alignment_indices', shifted)


def _swap_dry_thresholds(monkeypatch):
  """The port's SEEPS scores each precipitation variable with the other's
  dry threshold."""
  init = categorical.SEEPS.__init__

  def swapped(self, *args, **kwargs):
    init(self, *args, **kwargs)
    self._dry_threshold_mm = self._dry_threshold_mm[::-1]
  monkeypatch.setattr(categorical.SEEPS, '__init__', swapped)


def _invert_land_sea_mask(monkeypatch):
  """The port's regions take the sea for the land."""
  init = binning.Regions.__init__

  def inverted(self, regions, *args, land_sea_mask=None, **kwargs):
    if land_sea_mask is not None:
      land_sea_mask = land_sea_mask.copy(data=1 - land_sea_mask.data)
    init(self, regions, *args, land_sea_mask=land_sea_mask, **kwargs)
  monkeypatch.setattr(binning.Regions, '__init__', inverted)


def _drop_a_level(monkeypatch):
  """The port's values of each variable with levels lose the last one."""
  values = aggregation.AggregationState.metric_values

  def dropped(self, metrics):
    out = values(self, metrics)
    return {k: (da.isel(level=slice(0, -1)) if 'level' in da.dims else da)
            for k, da in out.items()}
  monkeypatch.setattr(aggregation.AggregationState, 'metric_values', dropped)


# Each fault, and the checks it fails: those it touches.
FAULTS = {
    'climatology_one_slot_off': (
        _shift_climatology,
        _keys(['acc', 'prediction_activity'], VARIABLES)
        | _keys(['seeps'], PRECIPITATION)),
    'dry_thresholds_swapped': (_swap_dry_thresholds,
                               _keys(['seeps'], PRECIPITATION)),
    'land_sea_mask_inverted': (_invert_land_sea_mask, ALL),
    'level_dropped': (
        _drop_a_level,
        _keys(['rmse', 'mse', 'bias', 'acc', 'prediction_activity'], UPPER)
        | {'vector_rmse.wind'}),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_fails_exactly_the_checks_it_touches(fault, monkeypatch):
  plant, keys = FAULTS[fault]
  cell = tiny_cell()
  plant(monkeypatch)
  result = _run(cell)
  assert result['correct'] is False
  assert set(result['checks']) == ALL
  assert _failed(result) == keys, result['checks']


def test_the_bfloat16_control_reads_not_correct():
  cell = tiny_cell()
  result = _run(cell, control='bf16')
  assert result['correct'] is False
  limit = cell.traffic['limits']['metric_rel_gap']
  gaps = [c['value'] for c in result['checks'].values()]
  assert any(g is None or g > 10 * limit for g in gaps), gaps
  assert _failed(result) & _keys(['rmse', 'seeps'], PRECIPITATION)


def test_the_reference_imports_nothing_of_the_port_or_jax():
  path = os.path.join(spec.ROOT, 'wbxbench', 'references', 'hres_0p25.py')
  with open(path) as f:
    tree = ast.parse(f.read())
  names = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
      names.add(node.module)
  assert names == {'numpy', 'torch', 'wbxbench'}
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    cell = tiny_cell()
    pool = cell.generator.make_pool(cell.config, dict(cell.traffic, pool=1),
                                    SEED, 'cpu')
    resources = cell.generator.resources(cell.config, cell.traffic, SEED,
                                         'cpu')
    cell.reference.values(cell.config, cell.traffic, cell.scorings[0], pool,
                          resources, {(0, (0, 12)): 1}, 'cpu')
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
  finally:
    torch.backends.cuda.matmul.allow_tf32 = False
