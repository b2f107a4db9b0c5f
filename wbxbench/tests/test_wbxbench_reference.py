"""The benchmark's plain reference against direct float64 formulas, and
its byte counts, at tiny sizes on the CPU."""

import ast
import itertools
import math
import os

import numpy as np
import pytest
import torch

from wbxbench import reference, spec

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _direct(x, y, kind):
  """Per-point statistics by the pair sums themselves, one point at a time."""
  m, n = x.shape
  out = {k: np.empty(n) for k in ('skill', 'spread', 'var', 'umse')}
  for p in range(n):
    xs = [float(v) for v in x[:, p]]
    ys = [float(y[p])] if kind == 'deterministic' else [
        float(v) for v in y[:, p]]
    mean = sum(xs) / m
    var = sum((v - mean) ** 2 for v in xs) / (m - 1)
    out['skill'][p] = sum(abs(a - b) for a in xs for b in ys) / (m * len(ys))
    out['spread'][p] = sum(abs(a - b) for a, b in itertools.permutations(
        xs, 2)) / (m * (m - 1))
    out['var'][p] = var
    y_mean = sum(ys) / len(ys)
    umse = (mean - y_mean) ** 2 - var / m
    if kind != 'deterministic':
      umse -= sum((v - y_mean) ** 2 for v in ys) / (len(ys) - 1) / len(ys)
    out['umse'][p] = umse
  return out


@pytest.mark.parametrize('kind', ['deterministic', 'analysis_ensemble'])
@pytest.mark.parametrize('members', [2, 3, 7, 40])
def test_point_statistics_against_pair_sums(kind, members, monkeypatch):
  monkeypatch.setattr(reference, 'BLOCK_VALUES', 3 * members)  # many blocks
  g = torch.Generator().manual_seed(members)
  x = 280 + torch.randn((members, 11), generator=g)
  y = (280 + torch.randn(11, generator=g) if kind == 'deterministic'
       else 280 + torch.randn((4, 11), generator=g))
  got = reference.point_statistics(x, y, kind,
                                   ('skill', 'spread', 'var', 'umse'))
  want = _direct(x.double().numpy(), y.double().numpy(), kind)
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-12,
                               atol=1e-9, err_msg=k)


def test_area_weights_against_the_cell_integral():
  lat = np.linspace(90, -90, 7)
  w = reference.area_weights(lat)
  # Cells 30 degrees tall, the pole cells 15: sin(upper) - sin(lower).
  edges = np.deg2rad([90, 75, 45, 15, -15, -45, -75, -90])
  direct = np.sin(edges[:-1]) - np.sin(edges[1:])
  np.testing.assert_allclose(w, direct / direct.mean(), rtol=1e-14)


def test_region_masks_wrap_past_zero_and_hold_their_edges():
  lat = np.array([40.0, 35.0, 30.0])
  lon = np.array([0.0, 10.0, 40.0, 42.5, 180.0, 347.5, 350.0])
  masks = reference.region_masks(lat, lon, {'europe': ((35, 75),
                                                       (-12.5, 42.5)),
                                            'band': ((30, 35), (170, 190))})
  want_lon = [True, True, True, True, False, True, True]
  np.testing.assert_array_equal(masks[0], np.array(
      [want_lon, want_lon, [False] * 7]))
  np.testing.assert_array_equal(masks[1][:, 4], [False, True, True])
  assert masks[1][:, [0, 1, 2, 3, 5, 6]].sum() == 0


def test_values_are_weighted_means_over_the_run_of_each_pool_chunk():
  config = {'regions': {'north': ((0, 90), (0, 360)),
                        'all': ((-90, 90), (0, 360))}}
  lat, lon = np.array([60.0, 0.0, -60.0]), np.array([0.0, 120.0, 240.0])
  mask = np.array([[True] * 3, [True, False, True], [True] * 3])
  metrics = {'rmse': {'reference': 'ensemble_mean_rmse'},
             'crps': {'reference': 'fair_crps'}}
  ref = reference.Reference(config, metrics, 'deterministic', lat, lon,
                            mask, 'cpu')
  g = torch.Generator().manual_seed(3)
  chunks = [(torch.randn((5, 2, 2, 3, 3), generator=g),
             torch.randn((2, 2, 3, 3), generator=g)) for _ in range(2)]
  sums = [ref.chunk_sums(x, y) for x, y in chunks]
  counts = [3, 1]
  got = ref.values(sums, counts)
  w = reference.area_weights(lat)[:, None] * mask
  regions = reference.region_masks(lat, lon, config['regions'])
  for lead in range(2):
    for r in range(2):
      num = {'umse': 0.0, 'crps': 0.0}
      den = 0.0
      for (x, y), n in zip(chunks, counts):
        for i in range(2):
          st = _direct(x[:, i, lead].reshape(5, -1).double().numpy(),
                       y[i, lead].reshape(-1).double().numpy(),
                       'deterministic')
          wr = (w * regions[r]).reshape(-1)
          num['umse'] += n * (wr * st['umse']).sum()
          num['crps'] += n * (wr * (st['skill'] - 0.5 * st['spread'])).sum()
          den += n * wr.sum()
      assert math.isclose(float(got['rmse'][lead, r]),
                          math.sqrt(num['umse'] / den), rel_tol=1e-12)
      assert math.isclose(float(got['crps'][lead, r]), num['crps'] / den,
                          rel_tol=1e-12)


def test_relative_gap():
  assert reference.relative_gap([1.0, 2.0], [1.0, 2.0]) == 0.0
  assert reference.relative_gap([1.1, 2.0], [1.0, 2.0]) == pytest.approx(0.1)
  assert reference.relative_gap([np.nan, 2.0], [1.0, 2.0]) == math.inf
  assert reference.relative_gap([1.0], [1.0, 2.0]) == math.inf


@pytest.mark.parametrize('kernel,members,points,want', [
    ('fused_ensemble_stats', 50, 128741760, 4 * (50 + 1 + 4) * 128741760),
    ('fused_ensemble_stats', 7424, 1038240, 4 * (7424 + 5) * 1038240),
    ('pairwise_spread_sum', 7424, 1038240, 4 * (7424 + 1) * 1038240),
    ('pairwise_cross_sum', (7424, 10), 1038240,
     4 * (7424 + 10 + 1) * 1038240),
])
def test_byte_counts(kernel, members, points, want):
  assert spec.byte_count(kernel)(members, points, 4) == want


def test_reference_imports_nothing_of_the_port_or_jax():
  with open(os.path.join(PACKAGE_DIR, 'reference.py')) as f:
    tree = ast.parse(f.read())
  names = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
      names.add(node.module or '')
  assert names == {'math', 'numpy', 'torch'}, names
