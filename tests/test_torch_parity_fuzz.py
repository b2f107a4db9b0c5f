"""The port's randomized parity fuzz against the JAX package, on the CPU.

Each seed's config is drawn once (``parity_fuzz.draw``, call for call as
``TestRandomizedConfigParity`` in ``test_reference_parity.py`` draws it),
built in both packages from the same plain-data spec, and run through each
package's ``compute_metric_values_for_single_chunk``; the values are held
to each other at atol 1e-5 and rtol 1e-5 with the key sets, dims and
coords equal. ``large_k`` seeds hold the port's aggregation at 721 x 1440
to a float64 contraction and to the JAX ``Aggregator``.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import weatherbenchx_tpu
from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu_torch import parity_fuzz
from weatherbenchx_tpu_torch.ops import crps_pairwise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# TestRandomizedConfigParity's own seed counts.
SEEDS = {'config': 24, 'wrappers': 8, 'spatial_rank': 8, 'seeps': 8}
LARGE_K_SEEDS = 2


def jax_array(f: parity_fuzz.Field):
  return j_darray.DimArray(f.values, f.dims, dict(f.coords))


def run_jax(spec: parity_fuzz.Spec) -> dict:
  out = {}
  for case in spec.cases:
    out.update(j_aggregation.compute_metric_values_for_single_chunk(
        *parity_fuzz.build((case.metrics, case.aggregator, case.predictions,
                            case.targets), weatherbenchx_tpu, jax_array)))
  return out


@pytest.mark.parametrize('family,seed', [
    (family, seed) for family, n in SEEDS.items() for seed in range(n)])
def test_port_matches_jax(family, seed):
  spec = parity_fuzz.draw(family, seed)
  parity_fuzz.compare_results(run_jax(spec), parity_fuzz.run(spec, 'cpu'))


@pytest.mark.parametrize('seed', range(LARGE_K_SEEDS))
def test_large_k_aggregation_matches_float64_and_jax(seed):
  spec = parity_fuzz.draw('large_k', seed)
  agg, state, stats = parity_fuzz.large_k_state(spec, 'cpu')
  j_agg = parity_fuzz.build(spec.aggregator, weatherbenchx_tpu, jax_array)
  j_state = j_agg.aggregate_statistics(
      {name: {'v': jax_array(f)} for name, f in spec.statistics.items()})
  n_lead = next(iter(spec.statistics.values())).values.shape[0]
  for name in stats:
    got = state.sum_weighted_statistics[name]['v'].transpose(
        'lead_time', 'region')
    gv = got.data.numpy().astype(np.float64)
    want, bins = parity_fuzz.large_k_oracle(agg, stats[name]['v'])
    assert 12 <= bins <= 34 and want.shape == (n_lead, bins)
    assert parity_fuzz.scaled_error(gv, want) <= parity_fuzz.LARGE_K_LIMIT
    jv = np.asarray(j_state.sum_weighted_statistics[name]['v'].transpose(
        'lead_time', 'region').data, np.float64)
    assert parity_fuzz.scaled_error(gv, jv) <= parity_fuzz.LARGE_K_LIMIT
    assert [str(x) for x in got.coords['region'].values] == [
        str(x) for x in j_state.sum_weighted_statistics[name]['v'].coords[
            'region'].values]
  res = parity_fuzz.large_k_check(seed, 'cpu')
  assert res['error'] <= parity_fuzz.LARGE_K_LIMIT
  assert res['rows'] == 2 * len(stats) * n_lead


@pytest.mark.parametrize('family', parity_fuzz.FAMILIES)
def test_draw_is_deterministic_and_plain_data(family):
  """The same seed draws the same spec; a spec holds numpy arrays and
  plain Python only, so it pickles, and its copy runs to the same
  values."""
  spec = parity_fuzz.draw(family, 3)
  assert pickle.dumps(spec) == pickle.dumps(parity_fuzz.draw(family, 3))
  assert pickle.dumps(spec) != pickle.dumps(parity_fuzz.draw(family, 4))

  def leaves(obj):
    if isinstance(obj, (parity_fuzz.Spec, parity_fuzz.Case,
                        parity_fuzz.Call, parity_fuzz.Field)):
      for v in vars(obj).values():
        yield from leaves(v)
    elif isinstance(obj, dict):
      for k, v in obj.items():
        yield k
        yield from leaves(v)
    elif isinstance(obj, (list, tuple)):
      for v in obj:
        yield from leaves(v)
    else:
      yield obj
  plain = (np.ndarray, np.generic, str, int, float, bool, type(None))
  assert all(isinstance(x, plain) for x in leaves(spec))
  copy = pickle.loads(pickle.dumps(spec))
  parity_fuzz.compare_results(parity_fuzz.run(spec, 'cpu'),
                              parity_fuzz.run(copy, 'cpu'), atol=0, rtol=0)


def test_config_kinds_reach_the_kernel_wrappers(monkeypatch):
  """The ensemble configs call the fused wrapper and the two-ensemble ones
  the cross and spread wrappers (on the CPU they take the plain
  versions), at the fixture's 7 and 5 members."""
  seen = {k: set() for k in crps_pairwise.LAUNCHES}

  def spy(name, members):
    real = getattr(crps_pairwise, name)

    def wrapper(*args):
      seen[name].add(members(*args))
      return real(*args)
    monkeypatch.setattr(crps_pairwise, name, wrapper)
  spy('fused_ensemble_stats', lambda x, y: x.shape[0])
  spy('pairwise_spread_sum', lambda x: x.shape[0])
  spy('pairwise_cross_sum', lambda x, y: (x.shape[0], y.shape[0]))
  kinds = set()
  for seed in range(SEEDS['config']):
    spec = parity_fuzz.draw('config', seed)
    kinds.add(spec.kind)
    parity_fuzz.run(spec, 'cpu')
  assert kinds == set(parity_fuzz.CONFIG_KINDS)
  assert seen['fused_ensemble_stats'] == {parity_fuzz.N_ENS}
  assert seen['pairwise_spread_sum'] >= {parity_fuzz.N_ENS,
                                         parity_fuzz.N_TARGET_MEMBERS}
  assert seen['pairwise_cross_sum'] == {(parity_fuzz.N_ENS,
                                         parity_fuzz.N_TARGET_MEMBERS)}


def test_a_config_that_raises_is_a_failure(monkeypatch):
  real = parity_fuzz.run

  def run(spec, device):
    if spec.seed == 1:
      raise ValueError('boom')
    return real(spec, device)
  monkeypatch.setattr(parity_fuzz, 'run', run)
  failures = []
  report = parity_fuzz.fuzz_family('seeps', range(3), 'cpu', failures)
  assert report['configs'] == 3 and report['failures'] == 1
  assert failures == [{'family': 'seeps', 'seed': 1,
                       'error': 'ValueError: boom'}]


def test_device_cuda_raises_without_a_gpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    parity_fuzz.main(['--seeds', '1'])


def test_cli_runs_on_the_cpu():
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run(
      [sys.executable, '-m', 'weatherbenchx_tpu_torch.parity_fuzz',
       '--device', 'cpu', '--seeds', '2'],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
  report = json.loads(out.stdout.splitlines()[0])
  assert report['failures'] == 0 and report['large_k_seeds'] == 2
  assert set(report['families']) == (set(parity_fuzz.FAMILIES)
                                     | set(parity_fuzz.LAYER_FAMILIES)
                                     | {'large_k'})
  assert all(f['configs'] == 2 for f in report['families'].values())


def test_family_seeds_must_name_a_drawn_family(capsys):
  with pytest.raises(SystemExit):
    parity_fuzz.main(['--device', 'cpu', '--families', 'dispatch',
                      '--family_seeds', 'sparse=2'])
  assert "not in --families: ['sparse']" in capsys.readouterr().err
