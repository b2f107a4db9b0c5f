"""The reading of a traced stretch by the port's spans (``spans.py``) on a
fixed trace, beside ``trace.reduce``'s own reading of it, and the cell
``hens7424.spread_skill`` at a tiny size on the CPU."""

import json

import pytest

from wbxbench import run, spans, spec, trace
from wbxbench.tests import test_wbxbench_harness as harness

KERNELS = ['fused_ensemble_stats', 'pairwise_spread_sum',
           'pairwise_cross_sum']


def _event(cat, name, ts, dur, **args):
  return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
          'args': args}


def _launch(ts, corr, name='cudaLaunchKernel'):
  return _event('cuda_runtime', name, ts, 1, correlation=corr)


# One chunk of a stretch, as the harness and the port's spans open:
# bench.prepare_pair 1-5 (wbx.prepare_host, wbx.to_device), bench.eval_accum
# 6-60 (wbx.eval 6-55 holding one statistic 7-50 whose own math launches
# the fused kernel's wrapper at 9-12 and a multiply at 13, wbx.operands
# 20-24 a fill at 21, wbx.aggregate 25-45 a where at 26 and a GEMM at 30
# and a stream synchronize at 40; wbx.state_add 56-59 an add at 57), then
# bench.wait 61-79 (an event synchronize) and bench.sync 90-99.
EVENTS = [
    _event('user_annotation', 'bench.traced', 0, 100),
    _event('user_annotation', 'bench.prepare_pair', 1, 4),
    _event('user_annotation', 'wbx.prepare_host', 1, 1),
    _event('user_annotation', 'wbx.to_device', 3, 2),
    _event('user_annotation', 'bench.eval_accum', 6, 54),
    _event('user_annotation', 'wbx.eval', 6, 49),
    _event('user_annotation', 'wbx.statistic.CRPSSkill', 7, 43),
    _event('user_annotation', 'wbx.fused_ensemble_stats', 9, 3),
    _launch(10, 1),
    _launch(13, 2),
    _event('user_annotation', 'wbx.operands', 20, 4),
    _launch(21, 3),
    _event('user_annotation', 'wbx.aggregate', 25, 20),
    _launch(26, 4),
    _launch(30, 5),
    _event('cuda_runtime', 'cudaStreamSynchronize', 40, 2),
    _event('user_annotation', 'wbx.state_add', 56, 3),
    _launch(57, 6),
    _event('user_annotation', 'bench.wait', 61, 18),
    _event('cuda_runtime', 'cudaEventSynchronize', 62, 16),
    _event('user_annotation', 'bench.sync', 90, 9),
    _event('cuda_runtime', 'cudaDeviceSynchronize', 91, 7),
    _event('kernel', 'register_kernel', 11, 20, correlation=1),
    _event('kernel', 'mul', 31, 4, correlation=2),
    _event('kernel', 'fill', 35, 1, correlation=3),
    _event('kernel', 'where', 36, 3, correlation=4),
    _event('kernel', 'gemm', 39, 6, correlation=5),
    _event('kernel', 'add', 58, 4, correlation=6),
    # A kernel without a launch event: the device-side span holds it.
    _event('gpu_user_annotation', 'wbx.state_add', 80, 5),
    _event('kernel', 'add_unlaunched', 81, 2, correlation=99),
]


@pytest.fixture(name='path')
def _path(tmp_path):
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': EVENTS}))
  return str(path)


def test_each_kernel_carries_the_spans_of_its_launch(path):
  r = spans.reduce(path)
  assert [(k.name, k.dur, k.spans) for k in r['kernels']] == [
      ('register_kernel', 20.0, ('wbx.eval', 'wbx.statistic.CRPSSkill',
                                 'wbx.fused_ensemble_stats')),
      ('mul', 4.0, ('wbx.eval', 'wbx.statistic.CRPSSkill')),
      ('fill', 1.0, ('wbx.eval', 'wbx.statistic.CRPSSkill', 'wbx.operands')),
      ('where', 3.0, ('wbx.eval', 'wbx.statistic.CRPSSkill',
                      'wbx.aggregate')),
      ('gemm', 6.0, ('wbx.eval', 'wbx.statistic.CRPSSkill',
                     'wbx.aggregate')),
      ('add', 4.0, ('wbx.state_add',)),
      ('add_unlaunched', 2.0, ('wbx.state_add',)),
  ]
  assert r['host_s'] == pytest.approx(58e-6)


def test_a_wait_counts_unless_the_harness_holds_it(path):
  r = spans.reduce(path)
  # The stream synchronize inside wbx.aggregate counts; the event
  # synchronize in bench.wait and the device synchronize in bench.sync do
  # not.
  assert r['host_waits'] == ['wbx.aggregate']
  assert spans.host_waits_per_chunk(r, 1) == 1
  assert spans.host_waits_per_chunk(r, 2) == 0.5


def test_the_three_readings_and_the_split(path):
  r = spans.reduce(path)
  assert spans.contraction_ms_per_chunk(r, 1) == pytest.approx(9e-3)
  # The multiply alone: the fill is the operands', the kernel the wrapper's.
  assert spans.statistics_ms_per_chunk(r, 1, KERNELS) == pytest.approx(4e-3)
  assert spans.contraction_ms_per_chunk(r, 2) == pytest.approx(4.5e-3)
  split = spans.torch_ops_by_span(r, 1, KERNELS)
  assert split == pytest.approx({
      'wbx.aggregate': 9e-3, 'wbx.statistic.CRPSSkill': 4e-3,
      'wbx.state_add': 6e-3, 'wbx.operands': 1e-3})
  assert '' not in split
  # The split covers what torch_ops_ms_per_chunk reads, nothing more.
  t = trace.reduce(path, KERNELS)
  ctx = trace.Context(chunks=1, window_s=t['window_s'], busy_s=t['busy_s'],
                      kernels=t['kernels'], ranges=t['ranges'], calls={},
                      host_chunk_s=[], bytes_moved={}, hbm_bytes_per_s=1.0)
  assert sum(split.values()) == pytest.approx(
      spec.reader('torch_ops_ms_per_chunk')(ctx))


def test_trace_reduce_reads_the_spanned_trace_as_before(path):
  """The port's spans leave trace.reduce's readings as they were; only
  the idle gaps take their names."""
  t = trace.reduce(path, KERNELS)
  assert [k.range for k in t['kernels']] == [
      'fused_ensemble_stats', '', '', '', '', '', '']
  assert t['ranges'] == {'fused_ensemble_stats': 1}
  assert t['window_s'] == pytest.approx(100e-6)
  # Busy 11-45, 58-62, 81-83.
  assert t['busy_s'] == pytest.approx(40e-6)
  # Gaps 62-81 (from 62 in bench.wait), 83-100 and 0-11 (in bench.traced
  # alone), 45-58 (from 45, the end of wbx.aggregate).
  assert t['idle_gaps'] == [
      ['bench.wait', pytest.approx(19e-6)],
      ['bench.traced', pytest.approx(17e-6)],
      ['wbx.aggregate', pytest.approx(13e-6)],
      ['bench.traced', pytest.approx(11e-6)]]


def test_a_stretch_without_kernels_reads_nothing(tmp_path):
  path = tmp_path / 'trace.json'
  path.write_text(json.dumps({'traceEvents': EVENTS[:21]}))
  r = spans.reduce(str(path))
  assert r['kernels'] == []
  assert spans.contraction_ms_per_chunk(r, 1) is None
  assert spans.statistics_ms_per_chunk(r, 1, KERNELS) is None
  assert spans.host_waits_per_chunk(r, 1) is None
  with pytest.raises(ValueError, match='bench.traced'):
    path.write_text(json.dumps({'traceEvents': EVENTS[1:]}))
    spans.reduce(str(path))


@pytest.mark.parametrize('trace_on', [False, True])
def test_spread_skill_cell_runs_tiny_on_the_cpu(trace_on):
  cell = spec.resolve('hens7424.spread_skill', spec.ROOT,
                      harness.TINY['hens7424.crps'])
  assert [s.metric_set for s in cell.scorings] == ['spread_skill']
  assert list(cell.traffic['route']) == ['fused_ensemble_stats']
  assert cell.traffic['route']['fused_ensemble_stats']['members'] == [7424]
  assert [m['name'] for m in cell.per_layer] == [
      'host_ms_per_chunk', 'launches_per_chunk', 'torch_ops_ms_per_chunk',
      'fused_ensemble_stats_roofline', 'device_idle_pct']
  result = run.run(cell, harness.SEED, 0.2, trace_on, device='cpu')
  assert result['correct'] is True, result['checks']
  assert list(result['checks']) == ['spread_skill.2m_temperature',
                                    'ensemble_mean_rmse.2m_temperature']
