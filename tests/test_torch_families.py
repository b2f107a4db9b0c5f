"""The metric-families slice as a whole, on the CPU: the port against the JAX
package.

The three benchmark families that have no kernel of their own (``fss``,
``rank_histogram``, ``rev``) and the three-binning drive, as
``weatherbenchx_tpu_torch.bench_families.family_case`` builds them (for the
card's smoke run too), at
73 x 144 through ``ChunkEvaluator(..., device='cpu').eval_chunk`` and
``metric_values``; the same numpy inputs go through the JAX package's
metrics, binnings and aggregator. Values agree to atol 1e-5 (the relative
economic value, which reaches -98 where a cheap protection is never taken,
to atol 1e-5 plus rtol 1e-5, its gaps from float64 printed), dims, coords,
bin labels and state keys exactly. ``bench_families``' float64 references,
made without the port's statistics, weights or bins, agree with both. Then
the import guard by the source: no file of the port, nor ``chip_smoke.py``,
names jax, pandas or the JAX package in an import statement, inside a
function either (``tests/test_torch_darray.py`` imports them all in a fresh
process).
"""

import ast
import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.apps import configs as j_configs
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import categorical as j_categorical
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu.metrics import spatial as j_spatial
from weatherbenchx_tpu.metrics import wrappers as j_wrappers
from weatherbenchx_tpu_torch import bench_families
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import evaluator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
GRID = (1, 4, 73, 144)
SEED = 6
FAMILIES = list(bench_families.FAMILIES)


def _to_jax(da):
  return jd.DimArray(da.values, da.dims,
                     {k: jd.Coord(c.dims, np.asarray(da.coord_values(k)))
                      for k, c in da.coords.items()})


def _jax_case(name):
  """The JAX package's metrics and aggregator of a family, as
  ``bench_families.family_case`` builds the port's."""
  coords = bench_families.family_coords(GRID)
  land = jd.DimArray(bench_families.family_land(GRID).astype(np.float32),
                     ('latitude', 'longitude'),
                     {k: coords[k] for k in ('latitude', 'longitude')})
  agg = j_aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      bin_by=[j_binning.Regions(j_configs.REGIONS, land_sea_mask=land)],
      weigh_by=[j_weighting.GridAreaWeighting()], masked=True)
  if name == 'fss':
    return {'fss': j_spatial.FSS(neighborhood_size_in_pixels=[3],
                                 wrap_longitude=True)}, agg
  if name == 'rank_histogram':
    return {'rank_histogram': j_probabilistic.RankHistogram()}, agg
  if name == 'rev':
    return {'rev': j_probabilistic.RelativeEconomicValue(
        probability_thresholds=bench_families.REV_THRESHOLDS,
        statistic_suffix='bench8',
        cost_loss_ratios=bench_families.REV_COST_LOSS)}, agg
  metrics = {
      'rmse': j_deterministic.RMSE(),
      'csi': j_wrappers.WrappedMetric(j_categorical.CSI(), [
          j_wrappers.ContinuousToBinary(
              'both', [bench_families.BINNINGS_THRESHOLD], 'threshold')])}
  return metrics, j_aggregation.Aggregator(
      reduce_dims=list(bench_families.DIMS),
      bin_by=[j_binning.LandSea(land),
              j_binning.LatitudeBins(bench_families.LATITUDE_BAND_DEGREES),
              j_binning.ByTimeUnit('hour', 'lead_time')],
      weigh_by=[j_weighting.GridAreaWeighting()], masked=True)


@pytest.fixture(scope='module')
def runs():
  """{family: (port state, port state again, port values, JAX state, JAX
  values, predictions, targets)}, each family evaluated once per module."""
  out = {}
  for name in FAMILIES:
    metrics, aggregator, preds, tgts = bench_families.family_case(
        name, SEED, GRID)
    ev = evaluator.ChunkEvaluator(metrics, aggregator, device='cpu')
    crps_pairwise.reset_launch_counts()
    state = ev.eval_chunk(preds, tgts)
    again = ev.eval_chunk(preds, tgts)
    assert not any(crps_pairwise.LAUNCHES.values())
    j_metrics, j_agg = _jax_case(name)
    j_state = j_agg.aggregate_statistics(
        j_base.compute_unique_statistics_for_all_metrics(
            j_metrics, {k: _to_jax(v) for k, v in preds.items()},
            {k: _to_jax(v) for k, v in tgts.items()}))
    out[name] = (state, again, state.metric_values(metrics), j_state,
                 j_state.metric_values(j_metrics), preds, tgts)
  return out


def _same(got, want, rtol=0.0):
  assert got.dims == tuple(want.dims), (got.dims, want.dims)
  np.testing.assert_allclose(got.values.astype(np.float64),
                             np.asarray(want.values, np.float64), rtol=rtol,
                             atol=ATOL, equal_nan=True)
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    g, w = got.coord_values(name), np.asarray(c.values)
    assert g.dtype.kind == w.dtype.kind, name
    np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('name', FAMILIES)
def test_family_values_match_jax(runs, name):
  _, _, values, _, j_values, _, _ = runs[name]
  assert set(values) == set(j_values) and values
  for key in j_values:
    _same(values[key], j_values[key], rtol=ATOL if name == 'rev' else 0.0)
    assert np.isfinite(values[key].values).all(), key


@pytest.mark.parametrize('name', FAMILIES)
def test_family_state_keys_and_sums_match_jax(runs, name):
  state, _, _, j_state, _, _, _ = runs[name]
  got, want = state.to_dataset(), j_state.to_dataset()
  assert list(got) == list(want)
  for key in want:
    assert got[key].dims == tuple(want[key].dims), key
    # float32 sums over up to 10,512 points: relative, as sums grow
    np.testing.assert_allclose(got[key].values, np.asarray(want[key].values),
                               rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize('name', FAMILIES)
def test_family_is_the_same_bits_twice(runs, name):
  state, again, _, _, _, _, _ = runs[name]
  for key, da in state.to_dataset().items():
    assert da.device.type == 'cpu'
    assert torch.equal(da.data, again.to_dataset()[key].data), key


@pytest.mark.parametrize('name', FAMILIES)
def test_float64_reference_agrees_with_both_packages(runs, name, capsys):
  """The card's check, at this grid: ``bench_families``' float64
  references against the port's values, and against the JAX package's."""
  _, _, values, _, j_values, preds, tgts = runs[name]
  weights = bench_families.family_weights(GRID, 'cpu')
  ref = bench_families.family_reference(name, preds, tgts, weights)
  # The card's run takes 6 standard errors on its 0.25 degree grid; this
  # grid is a hundredth of it, so the closed forms are held to 8. The CPU's
  # float32 products add in another order than the card's: the 51 ranks
  # sum to 1 within 1.5e-6 here.
  checked = bench_families.check_family_values(
      name, values, ref, weights, rtol=ATOL, sigmas=8.0, rank_sum_tol=1e-5)
  assert checked and max(rel for rel, _ in checked.values()) <= ATOL
  refs = ref if isinstance(ref, dict) else {name: ref}
  for metric, want in refs.items():
    j = j_values[f'{metric}.2m_temperature'].transpose(
        *bench_families.VALUE_DIMS[metric])
    jv = np.asarray(j.values, np.float64).reshape(tuple(want.shape))
    np.testing.assert_allclose(jv, want.numpy(), atol=ATOL,
                               rtol=ATOL if name == 'rev' else 0)
    if name == 'rev':
      g = values['rev.2m_temperature'].transpose(
          *bench_families.VALUE_DIMS['rev']).values.astype(np.float64)
      w = want.numpy()
      scale = np.maximum(np.abs(w), 1)
      with capsys.disabled():
        print(f'\nREV at {GRID}: values in [{w.min():.2f}, {w.max():.2f}]; '
              f'|port - float64| max {np.abs(g - w).max():.3e} '
              f'(relative {(np.abs(g - w) / scale).max():.3e}), '
              f'|jax - float64| max {np.abs(jv - w).max():.3e} '
              f'(relative {(np.abs(jv - w) / scale).max():.3e})')


def test_reference_weights_are_the_ports_weights_and_bins():
  """The references' own area weights and region masks equal the port's
  ``GridAreaWeighting`` and ``Regions``: two derivations, one answer."""
  _, aggregator, preds, _ = bench_families.family_case('fss', SEED, GRID)
  w, masks, n_eff = bench_families.family_weights(GRID, 'cpu')
  stat = preds['2m_temperature']
  np.testing.assert_allclose(
      w.numpy(), aggregator.weigh_by[0].weights(stat).values, rtol=1e-12)
  bins = aggregator.bin_by[0].create_bin_mask(stat)
  assert bins.shape[0] == 34
  np.testing.assert_array_equal(masks.numpy().astype(bool), bins.values)
  assert (n_eff.numpy() > 10).all()


def test_rank_histogram_family_shape_and_uniformity(runs):
  values = runs['rank_histogram'][2]['rank_histogram.2m_temperature']
  assert values.sizes == {'lead_time': 4, 'rank': 51, 'region': 34}
  v = values.transpose('lead_time', 'region', 'rank').values
  np.testing.assert_allclose(v.sum(-1), 1.0, atol=1e-5)
  labels = values.coord_values('region')
  assert labels[0] == 'global' and labels[17] == 'global_land'
  np.testing.assert_allclose(v[:, 0], 1 / 51, atol=0.012)


def test_rev_family_drops_true_negatives(runs):
  keys = list(runs['rev'][0].to_dataset())
  assert len(keys) == 6 and not any('TrueNegatives' in k for k in keys)
  assert all('threshold=bench8' in k for k in keys)


# -- the import guard ---------------------------------------------------------------


def _port_modules():
  modules = []
  pkg = os.path.join(REPO, 'weatherbenchx_tpu_torch')
  for root, _, files in os.walk(pkg):
    for f in sorted(files):
      if f.endswith('.py'):
        rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
        modules.append(rel.replace(os.sep, '.').removesuffix('.__init__'))
  return modules


def _imported_roots(path, module_level=False):
  """Top-level names of every import statement of a file, wherever in the
  file it stands (inside functions too), or of its module-level imports
  only (those outside any function)."""
  with open(path) as f:
    tree = ast.parse(f.read())
  if module_level:
    nodes, stack = [], list(tree.body)
    while stack:
      node = stack.pop()
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        continue
      nodes.append(node)
      stack.extend(ast.iter_child_nodes(node))
  else:
    nodes = ast.walk(tree)
  roots = set()
  for node in nodes:
    if isinstance(node, ast.Import):
      roots.update(a.name.split('.')[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      roots.add(node.module.split('.')[0])
  return roots


# The Parquet reader alone may import pandas and pyarrow, inside the
# functions that read Parquet (the card's machine has neither); the
# scorecard figure alone matplotlib, inside the functions that draw (the
# card's machine has none).
PARQUET_READERS = {os.path.join('weatherbenchx_tpu_torch', 'data',
                                'sparse_parquet')}
FIGURE_DRAWERS = {os.path.join('weatherbenchx_tpu_torch', 'apps',
                               'scorecard_figure')}


@pytest.mark.parametrize('path', ['chip_smoke.py'] + [
    m.replace('.', os.sep) for m in _port_modules()])
def test_no_file_of_the_port_names_a_banned_import(path):
  """By the source, so that an import inside a function counts too."""
  full = os.path.join(REPO, path)
  if not full.endswith('.py'):
    full = full + '.py' if os.path.exists(full + '.py') else os.path.join(
        full, '__init__.py')
  banned = {'jax', 'jaxlib', 'pandas', 'matplotlib', 'weatherbenchx_tpu'}
  if path in PARQUET_READERS:
    assert not _imported_roots(full, module_level=True) & (
        banned | {'pyarrow'}), path
    banned -= {'pandas'}
  if path in FIGURE_DRAWERS:
    assert not _imported_roots(full, module_level=True) & banned, path
    assert 'matplotlib' in _imported_roots(full), path
    banned -= {'matplotlib'}
  assert not _imported_roots(full) & banned, path


def test_the_guard_covers_the_new_modules():
  modules = set(_port_modules())
  for m in ('parallel.evaluator', 'parallel.pipeline', 'observability',
            'data.latency_wrappers', 'test_utils', 'apps.combine_results',
            'apps.pyjs', 'apps.jsmini', 'apps.scorecard_logic',
            'apps.scorecard_html', 'apps.scorecard_figure'):
    assert f'weatherbenchx_tpu_torch.{m}' in modules, m
