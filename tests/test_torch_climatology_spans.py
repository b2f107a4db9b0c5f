"""The climatology gathers' spans and counters, and the evaluator's pass
counter, on the CPU.

A chunk is 2 inits x 2 leads x 7 x 8, float32 from a numpy seed, of a
temperature and a precipitation variable, scored by ACC (three statistics
that each align the climatology), RMSE and SEEPS (its wet thresholds
aligned the same way) over two regions against a climatology of 2 days x
4 hours. On the resident plan each statistic gathers on the device
(``wbx.climatology``, ``climatology_gather_bytes``); under a budget of one
byte the statistics' host hooks gather each array once a chunk
(``wbx.climatology_host``, ``climatology_host_gather_bytes``).
"""

import contextlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import observability
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.metrics import categorical
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

LAT = np.linspace(90, -90, 7)
LON = np.linspace(0, 360, 8, endpoint=False)
GRID = {'latitude': LAT, 'longitude': LON}
LEADS = (np.arange(2) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-20, 20), (0, 360))}
TP = 'total_precipitation_6hr'
VARIABLES = ('2m_temperature', TP)
# One variable's climatology at a chunk's valid times: 2 inits x 2 leads.
SLICE_BYTES = 2 * 2 * 7 * 8 * 4
READER = os.path.join(os.path.dirname(__file__), '..', 'wbxbench',
                      'layer_metrics', 'climatology_gather_gb_per_chunk.py')


def _climatology():
  rng = np.random.default_rng(0)
  coords = dict(GRID, dayofyear=np.arange(1, 3), hour=np.array([0, 6, 12,
                                                                  18]))
  dims = ('dayofyear', 'hour', 'latitude', 'longitude')

  def field(x):
    return DimArray(x.astype(np.float32), dims, coords)
  shape = (2, 4, 7, 8)
  return {
      '2m_temperature': field(rng.standard_normal(shape)),
      TP: field(rng.uniform(0, 2e-3, shape)),
      f'{TP}_seeps_threshold': field(rng.uniform(1e-3, 3e-3, shape)),
      f'{TP}_seeps_dry_fraction': field(rng.uniform(0.2, 0.8, shape)),
  }


def _chunk(c, device='cpu'):
  rng = np.random.default_rng(c + 1)
  inits = (np.datetime64('2020-01-01', 'ns')
           + (2 * c + np.arange(2)) * np.timedelta64(12, 'h'))
  coords = dict(GRID, init_time=inits, lead_time=LEADS)
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')

  def side():
    fields = {'2m_temperature': rng.standard_normal((2, 2, 7, 8)),
              TP: rng.uniform(0, 4e-3, (2, 2, 7, 8))}
    return {var: DimArray(torch.from_numpy(x.astype(np.float32)).to(device),
                          dims, coords) for var, x in fields.items()}
  return side(), side()


def _evaluator(device='cpu'):
  clim = _climatology()
  return evaluator.ChunkEvaluator(
      {'acc': deterministic.ACC(climatology=clim),
       'rmse': deterministic.RMSE(),
       'seeps': categorical.SEEPS([TP], clim, dry_threshold_mm=0.1)},
      aggregation.Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=[binning.Regions(REGIONS)], masked=True),
      device=device)


@pytest.fixture(name='plan', params=['resident', 'host'])
def _plan(request, monkeypatch):
  if request.param == 'host':
    monkeypatch.setenv('WBX_RESOURCE_BYTES', '1')
  else:
    monkeypatch.delenv('WBX_RESOURCE_BYTES', raising=False)
  return request.param


def _accumulate(ev, chunks, device='cpu'):
  state = aggregation.AggregationState.zero()
  for c in chunks:
    state = ev.eval_accum(ev.prepare_pair(*_chunk(c, device)), state)
  return state


def _counted(run) -> dict:
  """The default registry's counters that ``run()`` moved."""
  before = observability.default_metrics.counters
  run()
  after = observability.default_metrics.counters
  return {k: v - before.get(k, 0) for k, v in after.items()
          if v != before.get(k, 0)}


def _spans(tmp_path, run) -> list:
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


def test_the_plans_are_as_named(plan):
  demoted = _evaluator().host_gather_ids
  if plan == 'resident':
    assert not demoted
  else:
    # Both climatologies and the wet thresholds (and the raw dry
    # fractions, which no statistic aligns).
    assert len(demoted) == 4


def test_gathers_open_their_span_inside_the_statistic(tmp_path, plan):
  ev = _evaluator()
  _accumulate(ev, [0])
  spans = _spans(tmp_path, lambda: _accumulate(ev, [1]))
  device = [s for s in spans if s[2] == 'wbx.climatology']
  host = [s for s in spans if s[2] == 'wbx.climatology_host']
  stats = [s for s in spans if s[2].startswith('wbx.statistic.')]
  if plan == 'resident':
    # ACC's three statistics a variable each, and SEEPS's wet threshold.
    assert len(device) == 3 * len(VARIABLES) + 1 and not host
    for g in device:
      (holder,) = [s for s in stats if _inside(g, s)]
      assert 'Anomaly' in holder[2] or 'SEEPS' in holder[2]
  else:
    # Each array once a chunk, in the host hook of the first statistic
    # that aligns it; the device gathers nothing.
    assert len(host) == len(VARIABLES) + 1 and not device
    (prepare,) = [s for s in spans if s[2] == 'wbx.prepare_host']
    assert all(_inside(h, prepare) for h in host)


def test_gather_bytes_are_counted(plan):
  ev = _evaluator()
  got = _counted(lambda: _accumulate(ev, [0, 1]))
  if plan == 'resident':
    assert got == {'eval_passes': 2,
                   'climatology_gather_bytes': 2 * 7 * SLICE_BYTES}
  else:
    # Host hooks share a gathered slice: each array once a chunk.
    assert got == {'eval_passes': 2,
                   'climatology_host_gather_bytes': 2 * 3 * SLICE_BYTES}


@pytest.mark.parametrize('path,passes', [
    ('eval_chunk', 2), ('eval_prepared', 1), ('statistics', 0)])
def test_eval_passes_count_compute_passes(path, passes):
  ev = _evaluator()
  pairs = [_chunk(c) for c in range(2)]
  run = {
      'eval_chunk': lambda: [ev.eval_chunk(*p) for p in pairs],
      'eval_prepared': lambda: ev.eval_prepared(
          [ev.prepare_host(*p) for p in pairs]),
      'statistics': lambda: ev.statistics(*ev.prepare_host(*pairs[0])),
  }[path]
  assert _counted(run).get('eval_passes', 0) == passes == ev.dispatches


def test_a_chunk_aligns_its_valid_times_once(monkeypatch, plan):
  """The statistics' host hooks share one alignment of a chunk's valid
  times (ACC's three statistics and SEEPS, both variables): one set of
  index coords, copied to the device once, and the state of aligning
  them apart."""
  want = _accumulate(_evaluator(), [0])
  align = evaluator.metrics_base.climatology_alignment_indices
  calls = []

  def counted(clim, valid_time):
    calls.append(valid_time.shape)
    return align(clim, valid_time)
  monkeypatch.setattr(evaluator.metrics_base,
                      'climatology_alignment_indices', counted)
  ev = _evaluator()
  p, _ = ev.prepare_host(*_chunk(0))
  assert len(calls) == 1 + (plan == 'host') * (len(VARIABLES) + 1)
  names = [n for n in p['2m_temperature'].coords if n.startswith('_clim_idx')]
  assert sorted(names) == ['_clim_idx_dayofyear', '_clim_idx_hour']
  placed = ev.to_device(p, _)
  for n in names:
    assert p['2m_temperature'].coords[n] is p[TP].coords[n]
    assert (placed[0]['2m_temperature'].coords[n]
            is placed[0][TP].coords[n])
  got = ev.eval_accum(placed, aggregation.AggregationState.zero())
  for name, per_var in want.sum_weighted_statistics.items():
    for var, da in per_var.items():
      assert torch.equal(da.data, got.sum_weighted_statistics[name][var].data)


def _refuse(*args, **kwargs):
  raise AssertionError('record_function called with no profile running')


def test_without_a_profile_no_gather_builds_a_record(monkeypatch, plan):
  ev = _evaluator()
  want = _accumulate(ev, [0])
  monkeypatch.setattr(torch.profiler, 'record_function', _refuse)
  monkeypatch.setattr(torch.autograd.profiler, 'record_function', _refuse)
  assert isinstance(observability.span('wbx.climatology'),
                    contextlib.nullcontext)
  got = _accumulate(_evaluator(), [0])
  for name, per_var in want.sum_weighted_statistics.items():
    for var, da in per_var.items():
      assert torch.equal(da.data, got.sum_weighted_statistics[name][var].data)


def _reader():
  spec = importlib.util.spec_from_file_location('gather_reader', READER)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read


def test_the_reader_reads_gathered_gb_a_pass(monkeypatch):
  registry = observability.Metrics()
  monkeypatch.setattr(observability, 'default_metrics', registry)
  read = _reader()
  assert read(None) is None  # a port without the counters
  registry.counter('climatology_gather_bytes', 0)
  assert read(None) is None  # no pass
  registry.counter('eval_passes', 4)
  registry.counter('climatology_gather_bytes', 6_000_000_000)
  registry.counter('climatology_host_gather_bytes', 2_000_000_000)
  assert read(None) == pytest.approx(2.0)


def test_the_reader_reads_a_run(monkeypatch, plan):
  monkeypatch.setattr(observability, 'default_metrics',
                      observability.Metrics())
  _accumulate(_evaluator(), [0, 1, 0])
  per_pass = (7 if plan == 'resident' else 3) * SLICE_BYTES
  assert _reader()(None) == pytest.approx(per_pass / 1e9)


@pytest.mark.cuda
def test_a_climatology_chunk_on_the_card_waits_for_nothing():
  """With the chunk and the climatology on the card and the operands
  built, a chunk's preparation and evaluation make no call that waits for
  the device: the climatology index coords are copied without blocking,
  and SEEPS's scalar / tensor divides by a host scalar, one rounding as
  with a scalar on the device. The state is a CPU run's within 1e-5."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  ev = _evaluator('cuda')
  _accumulate(ev, [0], 'cuda')
  chunk = _chunk(1, 'cuda')
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    got = ev.eval_accum(ev.prepare_pair(*chunk),
                        aggregation.AggregationState.zero())
  finally:
    torch.cuda.set_sync_debug_mode(0)
  want = _accumulate(_evaluator(), [1])
  for name, per_var in want.sum_weighted_statistics.items():
    for var, da in per_var.items():
      g = got.sum_weighted_statistics[name][var].data.cpu().double()
      w = da.data.double()
      assert (g - w).abs().max() <= 1e-5 * w.abs().max(), (name, var)
  x = torch.rand(4096, device='cuda') + 0.05
  assert torch.equal((3 / DimArray(x, ('p',))).data,
                     torch.div(torch.tensor(3.0, device='cuda'), x))

