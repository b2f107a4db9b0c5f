"""A configuration of another kind than an ensemble's, added to a copy of
the benchmark by new files and ``BENCHMARK.json`` entries alone: a tiny
deterministic configuration with 2 upper-air variables at 2 levels and a
surface variable, a climatology over 4 days of 6-hourly slots passed to
ACC as a resource, region bins with their land parts, its own generator
(``deterministic_generator.py``) and float64 reference
(``deterministic_reference.py``) of RMSE, bias (with a gap floor) and ACC.
It runs correct on the CPU, and each fault of its kind, and its control,
reads not correct."""

import json
import os
import shutil

import numpy as np
import pytest

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch.metrics import base as metrics_base
from wbxbench import run, spec
from wbxbench.tests.test_wbxbench_harness import SEED

ROOT = spec.ROOT
HERE = os.path.dirname(os.path.abspath(__file__))
CELL = 'det_tiny.scorecard'
VARIABLES = ['geopotential', 'temperature', '2m_temperature']
CONFIG = {
    'source': 'https://arxiv.org/abs/2308.15560',
    'generator_module': 'deterministic',
    'reference_module': 'deterministic',
    'variables': VARIABLES,
    'upper_air_variables': ['geopotential', 'temperature'],
    'levels': [500, 850],
    'latitudes': 37, 'longitudes': 72, 'mask': 'drop_pole_rows',
    'init_step_hours': 12, 'first_lead_hours': 0, 'lead_step_hours': 6,
    'climatology_days': 4, 'land_block_degrees': 20,
    'aggregation': {'land_sea_mask': {'resource': 'land_sea_mask'}},
    'regions': {'global': [[-90, 90], [0, 360]],
                'tropics': [[-20, 20], [0, 360]],
                'europe': [[35, 75], [-12.5, 42.5]]},
}
TRAFFIC = {
    'config': 'det_tiny', 'pool': 2,
    'chunk': {'init_times': 1, 'leads': 8},
    'scorings': [{'metric_set': 'det_scorecard', 'target': 'deterministic'}],
    'generator': {'climatology_mean': 0.0, 'climatology_sd': 3.0,
                  'slot_sd': 1.0, 'anomaly_sd': 1.0, 'bias': 0.0,
                  'error_sd': [1.0, 0.2]},
    'route': {}, 'trace_chunks': 2,
    # Sound runs read 3.4e-7 at most; bias without its floor 1.7e-5 at
    # least (4 seeds each).
    'limits': {'metric_rel_gap': 3e-6},
}
METRIC_SET = {
    'why': 'RMSE, bias and ACC against a climatology',
    'metrics': {
        'rmse': {'port': 'deterministic.RMSE', 'reference': 'rmse'},
        'bias': {'port': 'deterministic.Bias', 'reference': 'bias',
                 'gap_floor': 1.0},
        'acc': {'port': 'deterministic.ACC', 'reference': 'acc',
                'kwargs': {'climatology': {'resource': 'climatology'}}},
    },
}


def make_root(root, config=None, traffic=None) -> str:
  """A copy of the benchmark at ``root`` (a ``pathlib.Path``) with the new
  kind's files and entries (``CONFIG`` and ``TRAFFIC`` unless given)."""
  shutil.copytree(os.path.join(ROOT, 'wbxbench'), root / 'wbxbench',
                  ignore=shutil.ignore_patterns('__pycache__', 'tests'))
  bench = spec.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
  bench['configs'].append({
      'name': 'det_tiny', 'source': CONFIG['source'],
      'file': 'wbxbench/configs/det_tiny.json', 'reduced': [],
      'why': 'a deterministic scorecard with levels and a climatology'})
  bench['workloads'].append({
      'name': CELL, 'config': 'det_tiny', 'traffic': CELL, 'chips': 1,
      'why': 'RMSE, bias and ACC over regions and their land parts'})
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))
  files = {'configs/det_tiny.json': json.dumps(config or CONFIG),
           f'workloads/{CELL}.json': json.dumps(traffic or TRAFFIC),
           'metric_sets/det_scorecard.json': json.dumps(METRIC_SET)}
  for path, text in files.items():
    (root / 'wbxbench' / path).write_text(text)
  for folder, name in (('generators', 'deterministic_generator.py'),
                       ('references', 'deterministic_reference.py')):
    (root / 'wbxbench' / folder).mkdir()
    shutil.copy(os.path.join(HERE, name),
                root / 'wbxbench' / folder / 'deterministic.py')
  return str(root)


@pytest.fixture(name='root')
def _root(tmp_path):
  return make_root(tmp_path / 'checkout')


def _run(cell, **kw):
  return run.run(cell, SEED, 0.3, False, device='cpu', **kw)


def test_a_deterministic_kind_added_by_new_files_alone(root, monkeypatch):
  cell = spec.resolve(CELL, root)
  assert cell.values_per_chunk == 1 * 8 * 37 * 72 * (2 * 2 + 1)
  got = {}
  host_values = run._host_values

  def keep(values):
    got.update(host_values(values))
    return got
  monkeypatch.setattr(run, '_host_values', keep)
  result = _run(cell)
  assert result['correct'] is True, result['checks']
  assert list(result['checks']) == [f'{m}.{v}' for m in METRIC_SET['metrics']
                                    for v in VARIABLES]
  assert all(c['limit'] == 3e-6 for c in result['checks'].values())
  dims, _, labels = got['acc.geopotential']
  assert sorted(dims) == ['lead_time', 'level', 'region']
  assert labels['region'] == ['global', 'tropics', 'europe', 'global_land',
                              'tropics_land', 'europe_land']
  assert sorted(got['rmse.2m_temperature'][0]) == ['lead_time', 'region']


def _shift_climatology(monkeypatch, cell):
  """The port aligns each valid time to the climatology's next slot."""
  del cell
  align = metrics_base.climatology_alignment_indices

  def shifted(clim, valid_time):
    idx = align(clim, valid_time)
    hours = clim.sizes['hour']
    flat = (idx['dayofyear'] * hours + idx['hour'] + 1) % (
        clim.sizes['dayofyear'] * hours)
    return {'dayofyear': flat // hours, 'hour': flat % hours}
  monkeypatch.setattr(metrics_base, 'climatology_alignment_indices', shifted)


def _drop_a_level(monkeypatch, cell):
  """The port's values of each upper-air variable lose their last level."""
  del cell
  values = aggregation.AggregationState.metric_values

  def dropped(self, metrics):
    out = values(self, metrics)
    return {k: (da.isel(level=slice(0, -1)) if 'level' in da.dims else da)
            for k, da in out.items()}
  monkeypatch.setattr(aggregation.AggregationState, 'metric_values', dropped)


def _sum_per_pool_chunk(monkeypatch, cell):
  """Each hand-over counted under its pool chunk's first key of the
  window, as if the statistics depended on the pool chunk alone."""
  key = cell.generator.chunk_key
  monkeypatch.setattr(cell.generator, 'chunk_key',
                      lambda config, traffic, c, pool: key(
                          config, traffic, pool + c % pool, pool))


def _bias_without_floor(monkeypatch, cell):
  del monkeypatch
  del cell.scorings[0].metrics['bias']['gap_floor']


def _reference_drops_a_variable(monkeypatch, cell):
  """The reference gives nothing for the surface variable: the port's
  values of it are compared with nothing."""
  values = cell.reference.values

  def dropped(*args):
    out = values(*args)
    for per_variable in out.values():
      del per_variable['2m_temperature']
    return out
  monkeypatch.setattr(cell.reference, 'values', dropped)


def _keys(metrics, variables) -> set:
  return {f'{m}.{v}' for m in metrics for v in variables}


# Each fault, and the checks it fails: where it was planted.
FAULTS = {
    'climatology_shifted': (_shift_climatology, _keys(['acc'], VARIABLES)),
    'level_dropped': (_drop_a_level, _keys(METRIC_SET['metrics'],
                                           CONFIG['upper_air_variables'])),
    'summed_per_pool_chunk': (_sum_per_pool_chunk,
                              _keys(['acc'], VARIABLES)),
    'bias_without_floor': (_bias_without_floor, _keys(['bias'], VARIABLES)),
    'reference_drops_a_variable': (
        _reference_drops_a_variable,
        _keys(METRIC_SET['metrics'], ['2m_temperature'])),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_of_the_kind_reads_not_correct(fault, root, monkeypatch):
  plant, keys = FAULTS[fault]
  cell = spec.resolve(CELL, root)
  plant(monkeypatch, cell)
  result = _run(cell)
  assert result['correct'] is False, result['checks']
  assert result['attempted'] > 2 * TRAFFIC['pool']
  assert set(result['checks']) == _keys(METRIC_SET['metrics'], VARIABLES)
  failed = {k for k, c in result['checks'].items()
            if c['value'] is None or c['value'] > c['limit']}
  assert failed == keys, result['checks']


def test_control_of_the_kind_reads_not_correct(root):
  result = _run(spec.resolve(CELL, root), control='bf16')
  assert result['correct'] is False, result['checks']
  gaps = [c['value'] for c in result['checks'].values()]
  assert any(g is None or g > 3 * TRAFFIC['limits']['metric_rel_gap']
             for g in gaps), gaps


def test_chunk_keys_follow_the_init_times(root):
  cell = spec.resolve(CELL, root)
  keys = [cell.generator.chunk_key(cell.config, cell.traffic, c, 2)
          for c in range(12)]
  # 5 init positions inside 4 days of climatology (the last lead 42 h),
  # 2 pool chunks: 10 keys.
  assert len(set(keys)) == 10
  assert keys[0] == (0, (0,)) and keys[5] == (1, (0,))
  assert keys[4] == (0, (48,))
  assert np.all(np.array([k[1][0] for k in keys]) + 42 <= 4 * 24 - 6)
