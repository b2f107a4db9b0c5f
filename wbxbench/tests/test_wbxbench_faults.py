"""The comparison that decides ``correct`` sees each fault a cell can have,
and its control, at tiny sizes on the CPU: a run is driven past the
harness's look for a card with the timed path broken underneath.

The faults: a step that returns its state unchanged; half of the members
left out, the statistics taken over the rest; an answer altered where it
is produced (a kernel's output off by 1%). One card, so no exchange
between cards to leave out. The control is the port's own bfloat16 path
(``--control bf16``): the pool handed over in bfloat16.
"""

import pytest

from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator
from wbxbench import run
from wbxbench.tests.test_wbxbench_harness import SEED, TINY, tiny


def _unchanged_state(monkeypatch):
  monkeypatch.setattr(evaluator.ChunkEvaluator, 'eval_accum',
                      lambda self, pair, prev_state: prev_state)


def _half_members(monkeypatch):
  fused = crps_pairwise.fused_ensemble_stats
  spread = crps_pairwise.pairwise_spread_sum
  cross = crps_pairwise.pairwise_cross_sum

  def fused_half(x, y):
    m, h = x.shape[0], x.shape[0] // 2
    s, k, mean, sq = fused(x[:h], y)
    return (s * (m * (m - 1) / (h * (h - 1))), k * (m / h), mean,
            sq * ((m - 1) / (h - 1)))

  def spread_half(x):
    m, h = x.shape[0], x.shape[0] // 2
    return spread(x[:h]) * (m * (m - 1) / (h * (h - 1)))

  def cross_half(x, y):
    m, h = x.shape[0], x.shape[0] // 2
    return cross(x[:h], y) * (m / h)
  monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', fused_half)
  monkeypatch.setattr(crps_pairwise, 'pairwise_spread_sum', spread_half)
  monkeypatch.setattr(crps_pairwise, 'pairwise_cross_sum', cross_half)


def _altered(kernel):
  def plant(monkeypatch):
    original = getattr(crps_pairwise, kernel)

    def off(*args):
      out = original(*args)
      if isinstance(out, tuple):  # the fused kernel: its spread sum
        return (out[0] * 1.01,) + tuple(out[1:])
      return out * 1.01
    monkeypatch.setattr(crps_pairwise, kernel, off)
  return plant


FAULTS = {
    'unchanged_state': _unchanged_state,
    'half_members': _half_members,
    'altered_fused': _altered('fused_ensemble_stats'),
    'altered_spread': _altered('pairwise_spread_sum'),
    'altered_cross': _altered('pairwise_cross_sum'),
}
# The faults each cell's route can have: ens50.crps launches only the
# fused kernel.
CELL_FAULTS = [('ens50.crps', f) for f in ('unchanged_state', 'half_members',
                                           'altered_fused')] + [
    ('hens7424.crps', f) for f in FAULTS]


@pytest.mark.parametrize('name,fault', CELL_FAULTS)
def test_fault_reads_not_correct(name, fault, monkeypatch):
  FAULTS[fault](monkeypatch)
  result = run.run(tiny(name), SEED, 0.2, False, device='cpu')
  assert result['correct'] is False, result['checks']


@pytest.mark.parametrize('name', sorted(TINY))
def test_control_reads_not_correct(name):
  result = run.run(tiny(name), SEED, 0.2, False, device='cpu',
                   control='bf16')
  assert result['correct'] is False, result['checks']
  gaps = [c['value'] for c in result['checks'].values()]
  limit = next(iter(result['checks'].values()))['limit']
  assert any(g is None or g > 3 * limit for g in gaps), gaps
