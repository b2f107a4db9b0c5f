"""The rest of the port's ``metrics/probabilistic`` against the JAX package,
on the CPU.

``RankHistogram``, ``RelativeEconomicValue`` (with ``_select_optimal_
thresholds``), ``EnsembleRankedProbabilityScore``, ``WassersteinDistance``,
``EnsembleErrorExceedance``, ``EnsembleAveragedStatistic`` / ``Metric`` and
``SpreadSkillRatio`` on the same seeded numpy inputs in both packages
(an ensemble with NaN members, float32): values to atol 1e-5, dims, coords,
unique names and state keys exactly. The relative economic value, whose
finalizer cancels, states its own tolerance and prints both packages'
distance from a float64 numpy reference.

The JAX statistics that reach a Pallas kernel here (the fair ranked
probability score wraps the unbiased ensemble-mean squared error) run as
the JAX package's own CPU tests run them: outside a compute pass, in jnp.
"""

import numpy as np
import pytest
import scipy.stats
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu.metrics import base as j_base
from weatherbenchx_tpu.metrics import deterministic as j_deterministic
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray as td
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise

torch.set_num_threads(1)

ATOL = 1e-5
M, N_INIT, N_LEAD, N_LAT, N_LON = 6, 2, 3, 5, 8
DIMS = ('init_time', 'lead_time', 'latitude', 'longitude')
COORDS = {
    'init_time': np.array(['2020-01-01T00', '2020-01-02T00'],
                          dtype='datetime64[ns]'),
    'lead_time': (np.arange(N_LEAD) * np.timedelta64(6, 'h')).astype(
        'timedelta64[ns]'),
    'latitude': np.linspace(-60, 60, N_LAT),
    'longitude': np.arange(N_LON) * 45.0}
REDUCE = ['init_time', 'latitude', 'longitude']
PKG = {'torch': (td, probabilistic, deterministic, aggregation, base),
       'jax': (jd, j_probabilistic, j_deterministic, j_aggregation, j_base)}


def _ensemble(mod, seed=0, nan=False, members=M, lattice=False):
  x = np.random.default_rng(seed).standard_normal(
      (members, N_INIT, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  if lattice:  # ties between members and with the target
    x = np.round(x * 2) / 2
  if nan:
    x[1, 0, 1, 2, 3] = np.nan
    x[:, 1, 2, 0, 0] = np.nan
  return mod.DimArray(x, ('number',) + DIMS,
                      {'number': np.arange(members), **COORDS})


def _truth(mod, seed=1, nan=False, lattice=False):
  x = np.random.default_rng(seed).standard_normal(
      (N_INIT, N_LEAD, N_LAT, N_LON)).astype(np.float32)
  if lattice:
    x = np.round(x * 2) / 2
  if nan:
    x[0, 0, 4, 7] = np.nan
  return mod.DimArray(x, DIMS, COORDS)


def _same(got, want, atol=ATOL):
  assert got.dims == tuple(want.dims), (got.dims, want.dims)
  w = np.asarray(want.values)
  np.testing.assert_allclose(got.values.astype(np.float64),
                             w.astype(np.float64), rtol=0, atol=atol,
                             equal_nan=True)
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    np.testing.assert_array_equal(got.coord_values(name),
                                  np.asarray(c.values), err_msg=name)


def _run(which, metrics_of, preds_of, tgts_of, **agg_kwargs):
  mod, prob, det, agg, base_mod = PKG[which]
  metrics = metrics_of(prob, det, mod)
  stats = base_mod.compute_unique_statistics_for_all_metrics(
      metrics, preds_of(mod), tgts_of(mod))
  state = agg.Aggregator(reduce_dims=REDUCE, **agg_kwargs
                         ).aggregate_statistics(stats)
  return state, state.metric_values(metrics)


# -- rank histogram ---------------------------------------------------------------


@pytest.mark.parametrize('lattice', [False, True], ids=['continuous', 'ties'])
@pytest.mark.parametrize('nan', [False, True])
def test_rank_histogram_matches_jax(nan, lattice):
  got = probabilistic.RankHistogram().compute(
      {'v': _ensemble(td, 2, nan, lattice=lattice)},
      {'v': _truth(td, 3, nan, lattice)})['v']
  want = j_probabilistic.RankHistogram().compute(
      {'v': _ensemble(jd, 2, nan, lattice=lattice)},
      {'v': _truth(jd, 3, nan, lattice)})['v']
  assert (probabilistic.RankHistogram().unique_name
          == j_probabilistic.RankHistogram().unique_name)
  _same(got, want, atol=0)
  assert got.dtype == torch.float32 and got.sizes['rank'] == M + 1
  rows = got.transpose(*DIMS, 'rank').values.reshape(-1, M + 1)
  missing = np.isnan(rows).any(1)
  assert missing.sum() == (3 if nan else 0)
  assert np.isnan(rows[missing]).all()
  np.testing.assert_array_equal(rows[~missing].sum(1), 1.0)


def test_rank_histogram_hand_counts_and_custom_dim():
  p = td.DimArray(np.array([[1.0, 5.0], [2.0, 6.0], [3.0, 7.0]], np.float32),
                  ('member', 'x'))
  t = td.DimArray(np.array([2.5, 4.0], np.float32), ('x',))
  stat = probabilistic.RankHistogram(ensemble_dim='member')
  assert stat.unique_name == 'RankHistogram_member'
  out = stat.compute({'v': p}, {'v': t})['v']
  np.testing.assert_array_equal(out.transpose('x', 'rank').values,
                                [[0, 0, 1, 0], [1, 0, 0, 0]])
  np.testing.assert_array_equal(out.coord_values('rank'), np.arange(4))


def test_rank_histogram_is_the_same_bits_twice_and_through_aggregation():
  args = (lambda prob, det, m: {'rh': prob.RankHistogram()},
          lambda m: {'v': _ensemble(m, 4, True)},
          lambda m: {'v': _truth(m, 5, True)})
  first, got = _run('torch', *args, skipna=True)
  second, _ = _run('torch', *args, skipna=True)
  for key, da in first.to_dataset().items():
    assert torch.equal(da.data, second.to_dataset()[key].data), key
  j_state, want = _run('jax', *args, skipna=True)
  assert list(first.to_dataset()) == list(j_state.to_dataset())
  _same(got['rh.v'], want['rh.v'])
  np.testing.assert_allclose(got['rh.v'].values.sum(-1), 1.0, atol=1e-6)


# -- Wasserstein ------------------------------------------------------------------


@pytest.mark.parametrize('target_members', [M, 4, 9])
def test_wasserstein_matches_jax_and_scipy(target_members):
  p = _ensemble(td, 6, lattice=target_members == 4)
  t = _ensemble(td, 7, members=target_members)
  got = probabilistic.WassersteinDistance().compute({'v': p}, {'v': t})['v']
  want = j_probabilistic.WassersteinDistance().compute(
      {'v': _ensemble(jd, 6, lattice=target_members == 4)},
      {'v': _ensemble(jd, 7, members=target_members)})['v']
  assert got.dims == tuple(want.dims) == DIMS
  np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=0,
                             atol=ATOL)
  pv = p.values.reshape(M, -1)
  tv = t.values.reshape(target_members, -1)
  for i in range(0, pv.shape[1], 37):
    assert got.values.reshape(-1)[i] == pytest.approx(
        scipy.stats.wasserstein_distance(pv[:, i], tv[:, i]), abs=ATOL)


def test_wasserstein_1d_batches_without_a_loop():
  rng = np.random.default_rng(8)
  u = rng.standard_normal((3, 4, 8)).astype(np.float32)
  v = rng.standard_normal((3, 4, 6)).astype(np.float32) + 0.3
  got = probabilistic._wasserstein_1d(torch.from_numpy(u),
                                      torch.from_numpy(v)).numpy()
  want = [[scipy.stats.wasserstein_distance(u[i, j], v[i, j])
           for j in range(4)] for i in range(3)]
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
  one = probabilistic._wasserstein_1d(torch.from_numpy(u[0, 0]),
                                      torch.from_numpy(v[0, 0]))
  assert one.shape == () and one.item() == pytest.approx(want[0][0], abs=ATOL)


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_wasserstein_names_the_side_without_an_ensemble(which):
  mod, prob = PKG[which][:2]
  assert prob.WassersteinDistance('m').unique_name == 'WassersteinDistance_m'
  with pytest.raises(ValueError, match='targets'):
    prob.WassersteinDistance().compute({'v': _ensemble(mod)},
                                       {'v': _truth(mod)})
  with pytest.raises(ValueError, match='predictions'):
    prob.WassersteinDistance().compute({'v': _truth(mod)},
                                       {'v': _ensemble(mod)})


# -- ensemble-averaged wrappers, error exceedance, spread/skill ------------------------


@pytest.mark.parametrize('skipna', [False, True])
def test_ensemble_averaged_metric_matches_jax(skipna):
  args = (lambda prob, det, m: {
      'rmse': prob.EnsembleAveragedMetric(det.RMSE(),
                                          skipna_ensemble=skipna),
      'mae': prob.EnsembleAveragedMetric(det.MAE(), ensemble_dim='number',
                                         skipna_ensemble=skipna)},
          lambda m: {'v': _ensemble(m, 9, True)}, lambda m: {'v': _truth(m, 10)})
  t_state, got = _run('torch', *args, skipna=True)
  j_state, want = _run('jax', *args, skipna=True)
  assert list(t_state.to_dataset()) == list(j_state.to_dataset())
  for key in ('rmse.v', 'mae.v'):
    _same(got[key], want[key])


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_ensemble_averaged_names_and_missing_dim(which):
  mod, prob, det = PKG[which][:3]
  a = prob.EnsembleAveragedStatistic(det.SquaredError(),
                                     ensemble_dim='number',
                                     skipna_ensemble=False)
  b = prob.EnsembleAveragedStatistic(det.SquaredError(),
                                     ensemble_dim='number',
                                     skipna_ensemble=True)
  assert a.unique_name == 'SquaredError_each_number'
  assert b.unique_name == 'SquaredError_each_number_skipna_ensemble'
  with pytest.raises(ValueError, match='number'):
    a.compute({'v': _truth(mod)}, {'v': _truth(mod)})


@pytest.mark.parametrize('dim', ['number', 'realization'])
def test_ensemble_error_exceedance_matches_jax(dim):
  def make(which):
    mod, prob = PKG[which][:2]
    stat = prob.EnsembleErrorExceedance([0.5, 1.0, 2.0], ensemble_dim=dim)
    return stat, stat.compute(
        {'v': _ensemble(mod, 11, True).rename({'number': dim})},
        {'v': _truth(mod, 12)})['v']
  (t_stat, got), (j_stat, want) = make('torch'), make('jax')
  assert t_stat.unique_name == j_stat.unique_name
  assert (t_stat.unique_name == 'EnsembleErrorExceedance') == (
      dim == 'number')
  _same(got, want)


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_spread_skill_ratio_is_refused(which):
  with pytest.raises(ValueError, match='UnbiasedSpreadSkillRatio'):
    PKG[which][1].SpreadSkillRatio(ensemble_dim='number')


# -- ensemble ranked probability score ----------------------------------------------


RPS_CASES = {
    'fair': dict(fair=True), 'biased': dict(fair=False),
    'fair_skipna': dict(fair=True, skipna_ensemble=True),
    'biased_skipna': dict(fair=False, skipna_ensemble=True),
    'left_exclusive': dict(fair=True, right_inclusive=False),
}


@pytest.mark.parametrize('name', sorted(RPS_CASES))
def test_ensemble_rps_matches_jax(name):
  def make(which):
    mod, prob = PKG[which][:2]
    stat = prob.EnsembleRankedProbabilityScore(
        prediction_bin_thresholds=[-1.0, -0.25, 0.5, 1.5],
        target_bin_thresholds=[-1.0, -0.25, 0.5, 1.5],
        bin_dim='bin', unique_name_suffix='four_bins', **RPS_CASES[name])
    nan = 'skipna' in name
    return stat, stat.compute(
        {'v': _ensemble(mod, 13, nan, lattice=True),
         'only_predicted': _ensemble(mod, 14)},
        {'v': _truth(mod, 15, lattice=True)})
  (t_stat, got), (j_stat, want) = make('torch'), make('jax')
  assert t_stat.unique_name == j_stat.unique_name
  assert set(got) == set(want) == {'v'}
  _same(got['v'], want['v'])
  assert got['v'].dims == DIMS


@pytest.mark.parametrize('fair,want', [(True, 0.0), (False, 0.25)])
def test_ensemble_rps_by_hand(fair, want):
  p = td.DimArray(np.array([[-0.5], [0.5]], np.float32), ('number', 'x'))
  t = td.DimArray(np.array([0.7], np.float32), ('x',))
  stat = probabilistic.EnsembleRankedProbabilityScore(
      prediction_bin_thresholds=[0.0, 1.0], target_bin_thresholds=[0.0, 1.0],
      bin_dim='b', unique_name_suffix='test', fair=fair)
  np.testing.assert_allclose(stat.compute({'v': p}, {'v': t})['v'].values,
                             [want], atol=1e-6)


def test_ensemble_rps_per_variable_thresholds():
  def thresholds(mod):
    return {'v': mod.DimArray(np.array([-0.5, 0.5]), ('bin',),
                              {'bin': np.array([-0.5, 0.5])}),
            'w': mod.DimArray(np.array([0.0, 1.0]), ('bin',),
                              {'bin': np.array([0.0, 1.0])})}

  def make(which):
    mod, prob = PKG[which][:2]
    stat = prob.EnsembleRankedProbabilityScore(
        thresholds(mod), thresholds(mod), 'bin', 'per_var')
    return stat.compute({'v': _ensemble(mod, 16), 'w': _ensemble(mod, 17)},
                        {'v': _truth(mod, 18), 'w': _truth(mod, 19)})
  got, want = make('torch'), make('jax')
  for var in ('v', 'w'):
    _same(got[var], want[var])


# -- relative economic value -----------------------------------------------------------


def _rev_inputs(mod, seed=20, nan=False):
  rng = np.random.default_rng(seed)
  shape = (N_INIT, N_LEAD, N_LAT, N_LON)
  prob = rng.random(shape).astype(np.float32)
  target = (rng.random(shape) < prob).astype(np.float32)
  # Forecasts on the decision thresholds themselves: ties.
  prob[0, 0, :, 0] = 0.3125
  prob[0, 1, :, 1] = 0.5625
  if nan:
    prob[1, 2, 3, 4] = np.nan
    target[0, 0, 1, 1] = np.nan
  return ({'v': mod.DimArray(prob, DIMS, COORDS)},
          {'v': mod.DimArray(target, DIMS, COORDS)})


def _rev_float64(prob, target, thresholds, ratios, skipna):
  """REV per lead time in float64 numpy, straight from its definition."""
  p, t = prob.astype(np.float64), target.astype(np.float64)
  out = np.full((N_LEAD, len(thresholds) + 2, len(ratios)), np.nan)
  for lead in range(N_LEAD):
    pl, tl = p[:, lead].reshape(-1), t[:, lead].reshape(-1)
    ok = ~(np.isnan(pl) | np.isnan(tl))
    if not skipna and not ok.all():
      continue
    pl, tl = pl[ok], tl[ok]
    base_rate = tl.mean()
    for k, th in enumerate([None] + list(thresholds) + [None]):
      if k == 0:
        warn = np.ones_like(pl, bool)
      elif k == len(thresholds) + 1:
        warn = np.zeros_like(pl, bool)
      else:
        warn = pl > th
      tp = (warn & (tl == 1)).mean()
      fp = (warn & (tl == 0)).mean()
      fn = (~warn & (tl == 1)).mean()
      for j, r in enumerate(ratios):
        clim = min(r, base_rate)
        out[lead, k, j] = (clim - (r * (tp + fp) + fn)) / (
            clim - r * base_rate)
  return out


REV_TOL = 1e-4  # of float64; see test_rev_matches_jax


@pytest.mark.parametrize('skipna', [False, True])
def test_rev_matches_jax(skipna, capsys):
  """The finalizer divides a difference of costs by a difference of costs:
  where the denominator nears zero (a cost/loss ratio near the base rate)
  the float32 statistics' last bits are magnified. Both packages stay
  within REV_TOL of the float64 reference (both gaps are printed: 1.6e-5
  at this size) and within atol 1e-5 of each other."""
  thresholds = (np.arange(8) + 0.5) / 8
  ratios = np.geomspace(0.01, 1, 9)[:-1]
  args = (lambda prob, det, m: {'rev': prob.RelativeEconomicValue(
      probability_thresholds=thresholds, statistic_suffix='bench8',
      cost_loss_ratios=ratios)},
          lambda m: _rev_inputs(m, nan=skipna)[0],
          lambda m: _rev_inputs(m, nan=skipna)[1])
  t_state, got = _run('torch', *args, skipna=skipna)
  j_state, want = _run('jax', *args, skipna=skipna)
  assert list(t_state.to_dataset()) == list(j_state.to_dataset())
  assert not any('TrueNegatives' in k for k in t_state.to_dataset())
  g, w = got['rev.v'], want['rev.v']
  assert set(g.dims) == set(w.dims) == {'lead_time', 'threshold',
                                        'cost_loss_ratio'}
  g = g.transpose('lead_time', 'threshold', 'cost_loss_ratio')
  wv = np.asarray(w.transpose('lead_time', 'threshold',
                              'cost_loss_ratio').values, np.float64)
  np.testing.assert_array_equal(g.coord_values('threshold'),
                                w.coord_values('threshold'))
  np.testing.assert_array_equal(g.coord_values('cost_loss_ratio'), ratios)
  p, t = _rev_inputs(td, nan=skipna)
  ref = _rev_float64(p['v'].values, t['v'].values, thresholds, ratios, skipna)
  gv = g.values.astype(np.float64)
  finite = np.isfinite(ref)
  assert finite.any()
  with capsys.disabled():
    print(f'\nREV skipna={skipna}: |port - float64| max '
          f'{np.abs(gv - ref)[finite].max():.3e}, |jax - float64| max '
          f'{np.abs(wv - ref)[finite].max():.3e}, |port - jax| max '
          f'{np.abs(gv - wv)[finite].max():.3e}')
  np.testing.assert_allclose(gv[finite], ref[finite], rtol=0, atol=REV_TOL)
  np.testing.assert_allclose(wv[finite], ref[finite], rtol=0, atol=REV_TOL)
  np.testing.assert_allclose(gv[finite], wv[finite], rtol=0, atol=ATOL)
  np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))


def test_rev_statistics_match_jax_exactly():
  """The three contingency statistics themselves (before the finalizer)
  are indicators: equal to the last bit, names included."""
  def make(which):
    mod, prob = PKG[which][:2]
    rev = prob.RelativeEconomicValue(ensemble_size=4)
    p, t = _rev_inputs(mod, nan=True)
    return rev, {n: s.compute(p, t)['v'] for n, s in rev.statistics.items()}
  (t_rev, got), (j_rev, want) = make('torch'), make('jax')
  assert list(got) == list(want) == ['TruePositives', 'FalsePositives',
                                     'FalseNegatives']
  for name in got:
    assert (t_rev.statistics[name].unique_name
            == j_rev.statistics[name].unique_name)
    _same(got[name], want[name], atol=0)


@pytest.mark.parametrize('nearest', [False, True])
def test_rev_optimal_thresholds_match_jax_and_the_full_matrix(nearest):
  ratios = np.geomspace(0.02, 0.9, 6)
  picks = np.array([0.125, 0.375, 0.0, 0.625, 1.0, 0.875])
  if nearest:
    picks = np.clip(picks + 0.01, 0, 1)

  def run(which, optimal):
    mod = PKG[which][0]
    opt = None if not optimal else {'v': mod.DimArray(
        picks, ('cost_loss_ratio',), {'cost_loss_ratio': ratios})}
    return _run(which, lambda prob, det, m: {'rev': prob.RelativeEconomicValue(
        ensemble_size=4, cost_loss_ratios=ratios, optimal_thresholds=opt,
        optimal_thresholds_select_nearest=nearest)},
                lambda m: _rev_inputs(m)[0], lambda m: _rev_inputs(m)[1])[1]
  got, want = run('torch', True)['rev.v'], run('jax', True)['rev.v']
  assert 'threshold' not in got.dims
  _same(got, want)
  full = run('torch', False)['rev.v'].transpose(
      'lead_time', 'threshold', 'cost_loss_ratio')
  idx = [int(np.abs(full.coord_values('threshold') - p).argmin())
         for p in picks]
  np.testing.assert_array_equal(
      got.transpose('lead_time', 'cost_loss_ratio').values,
      np.stack([full.values[:, i, j] for j, i in enumerate(idx)], axis=1))


def test_select_optimal_thresholds_matches_jax():
  rng = np.random.default_rng(21)
  values = rng.random((3, 5, 4)).astype(np.float32)
  thresholds = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
  ratios = np.array([0.1, 0.2, 0.4, 0.8])
  per_region = thresholds[rng.integers(0, 5, (3, 4))]

  def make(mod, optimal_dims, optimal):
    v = mod.DimArray(values, ('region', 'threshold', 'lead'),
                     {'region': np.array(['a', 'b', 'c']),
                      'threshold': thresholds, 'lead': np.arange(4)})
    o = mod.DimArray(optimal, optimal_dims, {'cost_loss_ratio': ratios})
    return v, o
  for dims, optimal in ((('cost_loss_ratio',), thresholds[[4, 0, 2, 2]]),
                        (('region', 'cost_loss_ratio'), per_region)):
    got = probabilistic._select_optimal_thresholds(*make(td, dims, optimal))
    want = j_probabilistic._select_optimal_thresholds(*make(jd, dims, optimal))
    _same(got, want, atol=0)
    assert got.dims == ('region', 'lead', 'cost_loss_ratio')
  with pytest.raises((KeyError, ValueError)):
    probabilistic._select_optimal_thresholds(
        *make(td, ('cost_loss_ratio',), np.array([0.1, 0.0, 0.5, 0.5])))


@pytest.mark.parametrize('which', ['torch', 'jax'])
def test_rev_refuses_what_it_must(which):
  mod, prob, _, _, base_mod = PKG[which]
  with pytest.raises(ValueError, match='Either'):
    prob.RelativeEconomicValue()
  with pytest.raises(ValueError, match='Only one'):
    prob.RelativeEconomicValue(ensemble_size=4,
                               probability_thresholds=np.array([0.5]))
  with pytest.raises(ValueError, match='statistic_suffix'):
    prob.RelativeEconomicValue(probability_thresholds=np.array([0.5]))
  with pytest.raises(ValueError, match=r'\[0, 1\]'):
    prob.RelativeEconomicValue(probability_thresholds=np.array([1.5]),
                               statistic_suffix='s')
  with pytest.raises(ValueError, match='cost_loss_ratio'):
    prob.RelativeEconomicValue(
        ensemble_size=4, optimal_thresholds=mod.DimArray(
            np.zeros(2), ('x',)))
  with pytest.raises(ValueError, match='same values'):
    prob.RelativeEconomicValue(
        ensemble_size=4, cost_loss_ratios=np.array([0.1, 0.2]),
        optimal_thresholds=mod.DimArray(
            np.zeros(2), ('cost_loss_ratio',),
            {'cost_loss_ratio': np.array([0.1, 0.3])}))
  with pytest.raises(ValueError, match='unique_name'):
    base_mod.unique_statistics_for_metrics({
        'rev4': prob.RelativeEconomicValue(ensemble_size=4),
        'rev8': prob.RelativeEconomicValue(ensemble_size=8)})
  assert prob.RelativeEconomicValue(
      ensemble_size=4)._cost_loss_ratio.sizes['cost_loss_ratio'] == 50


# -- ensembles past one shared-memory tile ---------------------------------------------


@pytest.mark.parametrize('edge', ['first', 'points', 'capacity', 'tiles'])
def test_member_tile_boundary(edge):
  """The block sort's edges: its first count (257, after the sorted runs'
  256); the first change of gridpoints per block (32 to 16 past 512, where
  a gridpoint takes 16 threads); one gridpoint's capacity (58,112 members
  fill a block's 227 KB, past it the merge sort of block-sorted runs); and
  the tiles of the cross kernel's staged ensemble (1,816
  members fill one tile of 227 KB at 32 gridpoints of 4 bytes, past it
  more tiles, and no size is turned away below the entry points' own
  bound)."""
  form = crps_pairwise.spread_form
  top = crps_pairwise.BLOCKSORT_MAX_MEMBERS
  if edge == 'first':
    assert (form(256), form(257)) == ('sorted', 'blocksort')
    assert crps_pairwise.blocksort_config(257) == (32, 8)
  elif edge == 'points':
    assert crps_pairwise.blocksort_config(512) == (32, 8)
    assert crps_pairwise.blocksort_config(513) == (16, 16)
    assert 32 * crps_pairwise.blocksort_stride(512, 32) * 4 <= 232448 // 2
  elif edge == 'capacity':
    assert top == 58112 == 232448 // 4
    assert (form(top), form(top + 1)) == ('blocksort', 'mergesort')
    assert crps_pairwise.blocksort_config(top) == (1, 256)
  else:
    assert crps_pairwise.TILE_MEMBERS == 1816 == 232448 // (32 * 4)
    assert [crps_pairwise.member_tiles(m)
            for m in (2, 1816, 1817, 3632, 3633, top + 1)
            ] == [1, 1, 2, 2, 3, 33]
    assert crps_pairwise.MAX_MEMBERS > 100 * crps_pairwise.TILE_MEMBERS


@pytest.mark.parametrize('route', ['fused', 'spread', 'cross'])
def test_metrics_hand_every_ensemble_size_to_the_kernel_wrappers(
    route, monkeypatch):
  """1,817 members, one past a tile: the metrics call the kernel wrappers
  (which on a CUDA tensor launch, and here route the CPU tensor to the
  plain versions), not the plain versions themselves, and give the
  float64 broadcast's values."""
  m, n = 1817, 3
  rng = np.random.default_rng(24)
  x = rng.standard_normal((m, n)).astype(np.float32)
  y = rng.standard_normal(n).astype(np.float32)
  yt = rng.standard_normal((m + 2, n)).astype(np.float32)
  p = {'v': td.DimArray(x, ('number', 'point'))}
  t = {'v': td.DimArray(yt if route == 'cross' else y,
                        ('number', 'point') if route == 'cross'
                        else ('point',))}
  metrics = {'fused': {'crps': probabilistic.CRPSEnsemble()},
             'spread': {'spread': probabilistic.CRPSSpread()},
             'cross': {'skill': probabilistic.CRPSSkill()}}[route]
  called = []
  for name in ('fused_ensemble_stats', 'pairwise_spread_sum',
               'pairwise_cross_sum'):
    wrapper = getattr(crps_pairwise, name)
    monkeypatch.setattr(
        crps_pairwise, name,
        lambda *a, _w=wrapper, _n=name: called.append(_n) or _w(*a))
  if route == 'spread':  # outside a compute pass: the spread-only kernel
    got = {k: v.compute(p, t) for k, v in
           base.unique_statistics_for_metrics(metrics).items()}
  else:
    with base.computation_cache():
      got = base.compute_unique_statistics_for_all_metrics(metrics, p, t)
  assert called == [{'fused': 'fused_ensemble_stats',
                     'spread': 'pairwise_spread_sum',
                     'cross': 'pairwise_cross_sum'}[route]]
  x64, y64, yt64 = (a.astype(np.float64) for a in (x, y, yt))
  spread = np.abs(x64[:, None] - x64[None]).sum((0, 1)) / (m * (m - 1))
  want = {'fused': {'CRPSSkill_number': np.abs(x64 - y64).mean(0),
                    'CRPSSpread_number_fair_predictions': spread},
          'spread': {'CRPSSpread_number_fair_predictions': spread},
          'cross': {'CRPSSkill_number': np.abs(
              x64[:, None] - yt64[None]).mean((0, 1))}}[route]
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name]['v'].values, want[name], rtol=1e-5)
