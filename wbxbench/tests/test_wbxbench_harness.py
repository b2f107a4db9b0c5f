"""The harness on the CPU at tiny sizes: the last line, the JAX-import
check, the route guard, the generator, the trace reduction, and a cell
added by data files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from wbxbench import run, spec, trace, traffic

ROOT = spec.ROOT
TINY = {'ens50.crps': {'config': {'members': 6, 'latitudes': 19,
                                  'longitudes': 36, 'leads': 3},
                       'chunk': {'init_times': 2, 'leads': 3}},
        'hens7424.crps': {'config': {'members': 300, 'latitudes': 19,
                                     'longitudes': 36}}}
SEED = 2**31 + 12345


def tiny(name, root=ROOT):
  return spec.resolve(name, root, TINY.get(name, TINY['hens7424.crps']))


@pytest.mark.parametrize('trace_on', [False, True])
@pytest.mark.parametrize('name', sorted(TINY))
def test_last_line_keys(name, trace_on):
  cell = tiny(name)
  result = run.run(cell, SEED, 0.2, trace_on, device='cpu')
  keys = ['correct', 'attempted', 'failed', 'metrics', 'device']
  if trace_on:
    keys.append('breakdown')
  assert list(result) == keys + ['checks']
  assert result['correct'] is True, result['checks']
  assert result['attempted'] > 0 and result['failed'] == 0
  assert set(result['device']) >= {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
  want = [m['name'] for m in (cell.per_layer if trace_on
                              else cell.end_to_end)]
  if trace_on:  # no device kernels on the CPU: only the host span reads
    assert set(result['device']) >= {'busy_s', 'window_s'}
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    assert list(result['metrics']) == ['host_ms_per_chunk']
  else:
    assert list(result['metrics']) == want
  for name, m in result['metrics'].items():  # no device memory on the CPU
    assert set(m) == {'value', 'unit'}
    assert m['value'] > 0 or name == 'peak_mem_gib'
  metric_names = [f'{n}.2m_temperature' for s in cell.scorings
                  for n in s.metrics]
  assert list(result['checks']) == metric_names
  json.loads(json.dumps(result))  # every number is plain JSON


def test_forbidden_modules_compare_whole_top_level_names():
  names = ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
           'weatherbenchx_tpu', 'weatherbenchx_tpu.metrics.base',
           'weatherbenchx_tpu_torch', 'weatherbenchx_tpu_torch.ops',
           'jaxtyping', 'flaxen', 'torch']
  assert run.forbidden_modules(names) == sorted(
      ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
       'weatherbenchx_tpu', 'weatherbenchx_tpu.metrics.base'])


def test_a_run_leaves_the_jax_stack_unloaded():
  code = ('import sys; from wbxbench import run, spec; '
          'from wbxbench.tests import test_wbxbench_harness as t; '
          "run.run(t.tiny('hens7424.crps'), 5, 0.1, True, device='cpu'); "
          'print(run.forbidden_modules(sys.modules))')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True).stdout
  assert out.strip().splitlines()[-1] == '[]'


def test_route_guard():
  route = {'fused_ensemble_stats': {'launches': 1, 'members': [50],
                                    'form': 'network'},
           'pairwise_cross_sum': {'launches': 1, 'members': [[7424, 10]]}}
  form = {50: 'network', 300: 'blocksort'}.get
  good = {'fused_ensemble_stats': 3, 'pairwise_spread_sum': 0,
          'pairwise_cross_sum': 3}
  members = {'fused_ensemble_stats': {50}, 'pairwise_spread_sum': set(),
             'pairwise_cross_sum': {(7424, 10)}}
  run.check_route(route, good, members, 3, form)
  with pytest.raises(run.RouteError, match='launches'):
    run.check_route(route, dict(good, pairwise_spread_sum=3), members, 3,
                    form)
  with pytest.raises(run.RouteError, match='member counts'):
    run.check_route(route, good, dict(members, fused_ensemble_stats={300}),
                    3, form)
  with pytest.raises(run.RouteError, match='form'):
    run.check_route({**route, 'fused_ensemble_stats': {
        'launches': 1, 'members': [50], 'form': 'blocksort'}}, good,
                    members, 3, form)


def test_pool_repeats_from_its_seed_and_keeps_its_shapes():
  cell = tiny('hens7424.crps')
  a = traffic.make_pool(cell.config, cell.traffic, SEED, 'cpu')
  b = traffic.make_pool(cell.config, cell.traffic, SEED, 'cpu')
  c = traffic.make_pool(cell.config, cell.traffic, SEED + 1, 'cpu')
  for x, y, z in zip(a, b, c):
    for side in ('forecast', 'target', 'analysis'):
      u, v, w = (getattr(p, side)['2m_temperature'] for p in (x, y, z))
      assert torch.equal(u, v) and u.shape == w.shape
      assert not torch.equal(u, w)
  assert a[0].forecast['2m_temperature'].shape == (300, 1, 1, 19, 36)
  assert a[0].analysis['2m_temperature'].shape == (10, 1, 1, 19, 36)
  # The pool's chunks differ in their spread: a chunk lost or counted
  # twice moves the values.
  sd = [p.forecast['2m_temperature'].std(0).mean().item() for p in a]
  assert abs(sd[0] - sd[1]) > 0.01 * max(sd)


def _event(cat, name, ts, dur, **args):
  return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
          'args': args}


def test_trace_reduction(tmp_path):
  events = [
      _event('user_annotation', 'bench.traced', 0, 100),
      _event('user_annotation', 'bench.eval_accum', 1, 30),
      _event('user_annotation', 'wbx.fused_ensemble_stats', 2, 3),
      _event('cuda_runtime', 'cudaLaunchKernel', 3, 1, correlation=7),
      _event('cuda_runtime', 'cudaLaunchKernel', 10, 1, correlation=8),
      _event('kernel', 'register_kernel', 20, 40, correlation=7),
      _event('kernel', 'elementwise', 60, 10, correlation=8),
      _event('gpu_memcpy', 'copy', 80, 5),
      _event('user_annotation', 'bench.wait', 70, 9),
  ]
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': events}))
  r = trace.reduce(str(path), ['fused_ensemble_stats', 'pairwise_cross_sum'])
  assert r['window_s'] == pytest.approx(100e-6)
  assert r['busy_s'] == pytest.approx(55e-6)
  assert [k.range for k in r['kernels']] == ['fused_ensemble_stats', '']
  assert r['ranges'] == {'fused_ensemble_stats': 1}
  assert r['device_ops'][0] == ['register_kernel', pytest.approx(40e-6)]
  # Gaps: 0-20 in bench.eval_accum (from 1), 70-80 in bench.wait, 85-100.
  assert r['idle_gaps'][0] == ['bench.traced', pytest.approx(20e-6)]
  assert ['bench.wait', pytest.approx(10e-6)] in r['idle_gaps']
  ctx = trace.Context(chunks=1, window_s=r['window_s'], busy_s=r['busy_s'],
                      kernels=r['kernels'], ranges=r['ranges'],
                      calls={'fused_ensemble_stats': (50, 1000, 4)},
                      host_chunk_s=[0.002],
                      bytes_moved={'fused_ensemble_stats': spec.byte_count(
                          'fused_ensemble_stats')},
                      hbm_bytes_per_s=3.35e12)
  assert trace.roofline_pct(ctx, 'fused_ensemble_stats') == pytest.approx(
      100 * 4 * 55 * 1000 / 3.35e12 / 40e-6)
  assert trace.roofline_pct(ctx, 'pairwise_cross_sum') is None
  readers = {m['name']: spec.reader(m['name'])
             for m in spec.load_json(os.path.join(ROOT, 'BENCHMARK.json'))[
                 'per_layer']}
  assert readers['launches_per_chunk'](ctx) == 2
  assert readers['torch_ops_ms_per_chunk'](ctx) == pytest.approx(0.01)
  assert readers['device_idle_pct'](ctx) == pytest.approx(45.0)
  assert readers['host_ms_per_chunk'](ctx) == pytest.approx(2.0)


def test_a_cell_added_by_data_files_alone(tmp_path):
  """hens7424.spread_skill (PERF.md's first open question) from a traffic
  file, a metric-set file and BENCHMARK.json entries in a copy."""
  root = tmp_path / 'checkout'
  shutil.copytree(os.path.join(ROOT, 'wbxbench'), root / 'wbxbench',
                  ignore=shutil.ignore_patterns('__pycache__', 'tests'))
  bench = spec.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
  bench['workloads'].append({
      'name': 'hens7424.spread_skill', 'config': 'hens7424',
      'traffic': 'hens7424.spread_skill', 'chips': 1,
      'why': 'the HENS pool against the target, spread/skill and '
             'ensemble-mean RMSE alone: no CRPS term'})
  for m in bench['per_layer']:
    if 'hens7424.crps' in m.get('workloads', []) and 'cross' not in m[
        'name'] and 'spread_sum' not in m['name']:
      m['workloads'].append('hens7424.spread_skill')
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))
  (root / 'wbxbench' / 'metric_sets' / 'spread_skill.json').write_text(
      json.dumps({'why': 'spread/skill and ensemble-mean RMSE alone',
                  'metrics': {
                      'spread_skill': {
                          'port': 'probabilistic.UnbiasedSpreadSkillRatio',
                          'reference': 'spread_skill'},
                      'ensemble_mean_rmse': {
                          'port': 'probabilistic.UnbiasedEnsembleMeanRMSE',
                          'reference': 'ensemble_mean_rmse'}}}))
  hens = spec.load_json(os.path.join(ROOT, 'wbxbench', 'workloads',
                                     'hens7424.crps.json'))
  hens['scorings'] = [{'metric_set': 'spread_skill',
                       'target': 'deterministic'}]
  hens['route'] = {'fused_ensemble_stats': hens['route'][
      'fused_ensemble_stats']}
  (root / 'wbxbench' / 'workloads' / 'hens7424.spread_skill.json'
   ).write_text(json.dumps(hens))

  cell = spec.resolve('hens7424.spread_skill', str(root),
                      TINY['hens7424.crps'])
  assert [sorted(spec.port_metrics(s)) for s in cell.scorings] == [
      ['ensemble_mean_rmse', 'spread_skill']]
  result = run.run(cell, SEED, 0.2, False, device='cpu')
  assert result['correct'] is True
  assert list(result['checks']) == ['spread_skill.2m_temperature',
                                    'ensemble_mean_rmse.2m_temperature']
  # The command itself finds no card here: it fails and prints no result.
  shutil.copytree(os.path.join(ROOT, 'weatherbenchx_tpu_torch'),
                  root / 'weatherbenchx_tpu_torch',
                  ignore=shutil.ignore_patterns('__pycache__'))
  proc = subprocess.run(
      [sys.executable, '-m', 'wbxbench.run', '--workload',
       'hens7424.spread_skill', '--seed', '1', '--seconds', '1',
       '--trace', '0'], cwd=root, capture_output=True, text=True,
      timeout=300, check=False)
  assert proc.returncode == 2 and proc.stdout == ''
  assert 'CUDA' in proc.stderr


def test_without_the_program_a_run_fails(tmp_path):
  """In a directory holding only BENCHMARK.json and the benchmark's files,
  a run exits with an error and prints no result."""
  shutil.copytree(os.path.join(ROOT, 'wbxbench'), tmp_path / 'wbxbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
  proc = subprocess.run(
      [sys.executable, '-m', 'wbxbench.run', '--workload', 'ens50.crps',
       '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
      capture_output=True, text=True, timeout=300, check=False)
  assert proc.returncode != 0 and proc.stdout == ''


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(TINY))
def test_a_tiny_cell_on_the_card(name):
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  m = TINY[name]['config']['members']
  route = {'fused_ensemble_stats': {'launches': 1, 'members': [m]}}
  if name == 'hens7424.crps':
    route.update(pairwise_spread_sum={'launches': 1, 'members': [m]},
                 pairwise_cross_sum={'launches': 1, 'members': [[m, 10]]})
  cell = spec.resolve(name, ROOT, {**TINY[name], 'traffic': {'route': route}})
  for trace_on in (False, True):
    result = run.run(cell, SEED, 0.5, trace_on, device='cuda')
    assert result['correct'] is True, result['checks']
