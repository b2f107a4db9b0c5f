"""``observability.span``: the port's spans, nested as a chunk's layers are,
and free while no profile records, on the CPU.

A chunk is a 4-member ensemble of 2 inits x 2 leads x 7 x 8, float32 from a
numpy seed, scored over two regions with a validity mask, as the
benchmark's cells score theirs: fair CRPS and ensemble-mean RMSE (the
fused kernel's wrapper) or a deterministic RMSE and bias.
"""

import contextlib
import json
import threading

import numpy as np
import pytest
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

LAT = np.linspace(-90, 90, 7)
LON = np.linspace(0, 360, 8, endpoint=False)
LEADS = (np.arange(2) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-20, 20), (0, 360))}
METRIC_SETS = {
    'ensemble': lambda: {
        'crps': probabilistic.CRPSEnsemble(),
        'rmse': probabilistic.UnbiasedEnsembleMeanRMSE()},
    'deterministic': lambda: {'rmse': deterministic.RMSE(),
                              'bias': deterministic.Bias()},
}
# The spans of one chunk's calls, in the order they open.
CHUNK_SPANS = ('wbx.prepare_host', 'wbx.to_device', 'wbx.eval',
               'wbx.state_add')


def _chunk(kind, c):
  rng = np.random.default_rng(c)
  inits = (np.datetime64('2020-01-01', 'ns')
           + (2 * c + np.arange(2)) * np.timedelta64(12, 'h'))
  mask = np.ones((7, 8), bool)
  mask[[0, -1]] = False
  coords = {'init_time': inits, 'lead_time': LEADS, 'latitude': LAT,
            'longitude': LON,
            'mask': Coord(('latitude', 'longitude'), torch.from_numpy(mask))}
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  shape = (2, 2, 7, 8)
  if kind == 'ensemble':
    preds = DimArray(
        rng.standard_normal((4,) + shape).astype(np.float32),
        ('number',) + dims, dict(coords, number=np.arange(4)))
  else:
    preds = DimArray(rng.standard_normal(shape).astype(np.float32), dims,
                     dict(coords))
  tgts = DimArray(rng.standard_normal(shape).astype(np.float32), dims,
                  dict(coords))
  return {'t2m': preds}, {'t2m': tgts}


def _evaluator(kind):
  return evaluator.ChunkEvaluator(
      METRIC_SETS[kind](),
      aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=[binning.Regions(REGIONS)], masked=True),
      device='cpu')


def _accumulate(ev, kind, chunks):
  """prepare_pair + eval_accum a chunk, as the pipeline and the benchmark
  call them."""
  state = aggregation.AggregationState.zero()
  for c in range(chunks):
    state = ev.eval_accum(ev.prepare_pair(*_chunk(kind, c)), state)
  return state


# Each public evaluation path over 2 chunks; each returns the states.
PATHS = {
    'prepare_pair+eval_accum': lambda ev, kind: _accumulate(ev, kind, 2),
    'eval_chunk': lambda ev, kind: [ev.eval_chunk(*_chunk(kind, c))
                                    for c in range(2)],
    'eval_with_statistics': lambda ev, kind: [
        ev.eval_with_statistics(*ev.prepare_host(*_chunk(kind, c)))[0]
        for c in range(2)],
    'eval_prepared': lambda ev, kind: ev.eval_prepared(
        [ev.prepare_host(*_chunk(kind, c)) for c in range(2)]),
    'place': lambda ev, kind: [
        ev.eval_accum(ev.to_device(*(ev.place(side) for side in ev.prepare_host(
            *_chunk(kind, c)))), aggregation.AggregationState.zero())
        for c in range(2)],
}


def _profiled_spans(tmp_path, run):
  """[(start, end, name)] of the ``wbx.*`` ranges of a CPU profile of
  ``run()``, by start."""
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    run()
  path = tmp_path / 'trace.json'
  prof.export_chrome_trace(str(path))
  events = json.loads(path.read_text())['traceEvents']
  return sorted((float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
                for e in events
                if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                and e['name'].startswith('wbx.'))


def _inside(inner, outer):
  return outer[0] <= inner[0] and inner[1] <= outer[1]


def _named(spans, name):
  return [s for s in spans if s[2] == name]


def test_span_is_one_shared_nullcontext_without_a_profile():
  assert not torch._C._autograd._profiler_enabled()
  a, b = observability.span('wbx.a'), observability.span('wbx.b')
  assert a is b and isinstance(a, contextlib.nullcontext)
  with a, b:  # reentrant: one context nests in itself
    pass


def test_span_is_a_record_function_under_a_profile(tmp_path):
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    span = observability.span('wbx.test_span')
    assert isinstance(span, torch.profiler.record_function)
    with span:
      torch.ones(3).sum()
  assert not isinstance(observability.span('wbx.test_span'),
                        torch.profiler.record_function)
  path = tmp_path / 'trace.json'
  prof.export_chrome_trace(str(path))
  names = [e['name'] for e in json.loads(path.read_text())['traceEvents']
           if e.get('cat') == 'user_annotation']
  assert names.count('wbx.test_span') == 1


def test_a_profile_in_another_thread_builds_no_span_here():
  """A profile records the ranges of the thread that started it; a span
  opened by another thread (the pipeline's loader threads place chunks)
  stays free."""
  seen = []
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    t = threading.Thread(target=lambda: seen.append(
        observability.span('wbx.to_device')))
    t.start()
    t.join()
  assert isinstance(seen[0], contextlib.nullcontext)


@pytest.mark.parametrize('kind', sorted(METRIC_SETS))
def test_a_chunk_nests_its_spans(tmp_path, kind):
  ev = _evaluator(kind)
  _accumulate(ev, kind, 1)  # the operands built and cached
  spans = _profiled_spans(tmp_path, lambda: _accumulate(ev, kind, 1))
  outer = [s for s in spans if s[2] in CHUNK_SPANS]
  assert [s[2] for s in outer] == list(CHUNK_SPANS)
  for a, b in zip(outer, outer[1:]):  # one after another, none nested
    assert a[1] <= b[0], (a, b)
  (ev_span,) = _named(spans, 'wbx.eval')
  stats = [s for s in spans if s[2].startswith('wbx.statistic.')]
  assert [s[2] for s in stats] == [f'wbx.statistic.{n}'
                                   for n in ev._stat_names]
  for stat in stats:
    assert _inside(stat, ev_span)
    inner = [s for s in spans if _inside(s, stat) and s is not stat]
    parts = [s for s in inner if s[2] in ('wbx.operands', 'wbx.aggregate')]
    assert [s[2] for s in parts] == ['wbx.operands', 'wbx.aggregate']
    assert parts[0][1] <= parts[1][0]
  # A kernel wrapper's span lies in a statistic's own compute, outside the
  # operands and the contraction.
  kernels = [s for s in spans if s[2] == 'wbx.fused_ensemble_stats']
  assert len(kernels) == (1 if kind == 'ensemble' else 0)
  for k in kernels:
    holders = [s[2] for s in spans if _inside(k, s) and s is not k]
    assert [h for h in holders if not h.startswith('wbx.statistic.')] == [
        'wbx.eval']
    assert sum(h.startswith('wbx.statistic.') for h in holders) == 1
  (add,) = _named(spans, 'wbx.state_add')
  assert add[0] >= ev_span[1]


@pytest.mark.parametrize('path', sorted(PATHS))
def test_every_evaluation_path_runs_in_a_compute_pass_span(tmp_path, path):
  ev = _evaluator('ensemble')
  spans = _profiled_spans(tmp_path, lambda: PATHS[path](ev, 'ensemble'))
  passes = _named(spans, 'wbx.eval')
  assert len(passes) == ev.dispatches == (1 if path == 'eval_prepared'
                                          else 2)
  stats = [s for s in spans if s[2].startswith('wbx.statistic.')]
  assert len(stats) == len(passes) * len(ev._stat_names)
  assert all(any(_inside(s, p) for p in passes) for s in stats)
  moves = _named(spans, 'wbx.to_device')
  assert len(moves) == {'eval_prepared': 1, 'place': 6}.get(path, 2)
  assert all(not _inside(m, p) for m in moves for p in passes)
  assert len(_named(spans, 'wbx.prepare_host')) == 2


def _refuse(*args, **kwargs):
  raise AssertionError('record_function called with no profile running')


@pytest.mark.parametrize('path', sorted(PATHS))
@pytest.mark.parametrize('kind', sorted(METRIC_SETS))
def test_without_a_profile_no_span_builds_a_record(monkeypatch, path, kind):
  ev = _evaluator(kind)
  want = PATHS[path](ev, kind)
  monkeypatch.setattr(torch.profiler, 'record_function', _refuse)
  monkeypatch.setattr(torch.autograd.profiler, 'record_function', _refuse)
  with pytest.raises(AssertionError, match='no profile'):
    torch.profiler.record_function('x')
  got = PATHS[path](_evaluator(kind), kind)
  if isinstance(want, aggregation.AggregationState):
    want, got = [want], [got]
  for w, g in zip(want, got):
    for var in w.sum_weighted_statistics:
      for k, da in w.sum_weighted_statistics[var].items():
        assert torch.equal(da.data, g.sum_weighted_statistics[var][k].data)


def test_kernel_wrappers_open_their_span_without_building_a_record(
    monkeypatch):
  monkeypatch.setattr(torch.profiler, 'record_function', _refuse)
  x = torch.randn(5, 6)
  crps_pairwise.fused_ensemble_stats(x, torch.randn(6))
  crps_pairwise.pairwise_spread_sum(x)
  crps_pairwise.pairwise_cross_sum(x, torch.randn(3, 6))


def test_no_span_takes_a_kernel_range_name(tmp_path):
  """The ``wbx.<kernel>`` names are the kernel wrappers' alone: a trace
  reader counts a kernel's calls by them."""
  ev = _evaluator('ensemble')
  names = {s[2] for s in _profiled_spans(
      tmp_path, lambda: _accumulate(ev, 'ensemble', 1))}
  kernel_names = {f'wbx.{k}' for k in crps_pairwise.LAUNCHES}
  assert kernel_names >= {'wbx.fused_ensemble_stats',
                          'wbx.pairwise_spread_sum', 'wbx.pairwise_cross_sum'}
  assert names - kernel_names >= set(CHUNK_SPANS) | {'wbx.operands',
                                                      'wbx.aggregate'}
  assert names & kernel_names == {'wbx.fused_ensemble_stats'}


def test_distribution_keeps_count_mean_min_max():
  d = observability.Distribution()
  for v in (0.002, 0.004, 0.003):
    d.update(v)
  assert (d.count, d.min, d.max) == (3, 0.002, 0.004)
  assert d.mean == pytest.approx(0.003)
  assert repr(d) == 'n=3 mean=3.0ms min=2.0ms max=4.0ms'
  assert not hasattr(d, 'std') and not hasattr(d, 'total_sq')
