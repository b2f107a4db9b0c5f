"""The three cells read as they did before the harness took configurations
of other kinds: at their tiny sizes on the CPU, the pool's bytes, the
``Aggregator``'s arguments, the ``checks`` keys and limits and the metric
values of a window of one chunk, and ``values_per_chunk`` at full size,
against goldens taken from the harness before that change
(``unmoved_goldens.json``)."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

from weatherbenchx_tpu_torch.parallel import evaluator
from wbxbench import run, spec, traffic
from wbxbench.tests.test_wbxbench_harness import SEED, tiny

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'unmoved_goldens.json')) as f:
  GOLDENS = json.load(f)


def _described(aggregator) -> dict:
  """The Aggregator's fields, each weighting and binning as its class
  name and attributes (a DimArray attribute as 'DimArray')."""
  out = {}
  for field in dataclasses.fields(aggregator):
    value = getattr(aggregator, field.name)
    if field.name in ('bin_by', 'weigh_by'):
      value = [[type(b).__name__,
                {k: 'DimArray' if hasattr(v, 'dims') else v
                 for k, v in sorted(vars(b).items())}] for b in value]
    elif isinstance(value, tuple):
      value = list(value)
    out[field.name] = json.loads(json.dumps(value))
  return out


@pytest.mark.parametrize('name', sorted(GOLDENS))
def test_a_cell_reads_as_before(name, monkeypatch):
  golden = GOLDENS[name]
  assert spec.resolve(name).values_per_chunk == golden[
      'values_per_chunk_full']
  cell = tiny(name)
  assert cell.generator is traffic
  pool = traffic.make_pool(cell.config, cell.traffic, SEED, 'cpu')
  hashes = [[side, v, list(x.shape), str(x.dtype),
             hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()]
            for pc in pool for side in ('forecast', 'target', 'analysis')
            for v, x in sorted(getattr(pc, side).items())]
  assert hashes == golden['pool']

  aggregators, values = [], []
  init = evaluator.ChunkEvaluator.__init__

  def keep_aggregator(self, metrics, aggregator, *args, **kwargs):
    aggregators.append(_described(aggregator))
    init(self, metrics, aggregator, *args, **kwargs)
  host_values = run._host_values

  def keep_values(v):
    out = host_values(v)
    values.append(out)
    return out
  monkeypatch.setattr(evaluator.ChunkEvaluator, '__init__', keep_aggregator)
  monkeypatch.setattr(run, '_host_values', keep_values)
  result = run.run(cell, SEED, 0.0, False, device='cpu')  # one chunk
  assert result['correct'] is True and result['attempted'] == 1
  assert aggregators == golden['aggregators']
  assert {k: c['limit'] for k, c in result['checks'].items()} == golden[
      'checks']
  assert list(result['checks']) == list(golden['checks'])
  window = values[-len(cell.scorings):]
  assert len(window) == len(golden['values'])
  for got, want in zip(window, golden['values']):
    assert list(got) == list(want)
    for key, (dims, data, labels) in got.items():
      assert list(dims) == want[key]['dims']
      assert labels['region'] == want[key]['regions']
      # Float32 arithmetic on one chunk: the same route reads the same
      # numbers, up to the order of a sum on another CPU.
      np.testing.assert_allclose(data, want[key]['data'], rtol=1e-6,
                                 err_msg=key)
