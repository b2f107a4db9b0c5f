"""Two-ensemble CRPS statistics of the port against the JAX package, on the CPU.

CRPSSkill against ensemble targets and CRPSEnsembleDistance: identical
float32 inputs made with numpy from a seed; the JAX side runs its Pallas
cross kernel in interpret mode, the port (CPU tensors) the kernel's plain
version. Tolerance rtol 1e-5 / atol 1e-6, the reference's own.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import binning as j_binning
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import weighting as j_weighting
from weatherbenchx_tpu.metrics import probabilistic as j_probabilistic
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import binning
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import weighting
from weatherbenchx_tpu_torch.metrics import base
from weatherbenchx_tpu_torch.metrics import probabilistic
from weatherbenchx_tpu_torch.ops import crps_pairwise

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
DIMS = ('number', 'lead_time', 'latitude', 'longitude')
MX, MY, SHAPE = 5, 4, (2, 6, 8)
REGIONS = {'global': ((-90, 90), (0, 360)), 'tropics': ((-30, 30), (0, 360))}


def _arrays(seed, nan=False):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((MX,) + SHAPE).astype(np.float32)
  y = (0.5 + rng.standard_normal((MY,) + SHAPE)).astype(np.float32)
  if nan:  # one NaN member on each side, at different points
    x[1, 0, 2, 3] = np.nan
    y[3, 1, 4, 5] = np.nan
  mask = rng.random(SHAPE[1:]) > 0.2
  return x, y, mask


def _pair(mod, x, y, mask=None):
  coords = {'lead_time': (np.arange(SHAPE[0]) * np.timedelta64(6, 'h')
                          ).astype('timedelta64[ns]'),
            'latitude': np.linspace(90, -90, SHAPE[1]),
            'longitude': np.linspace(0, 360, SHAPE[2], endpoint=False)}
  t_coords = dict(coords, number=np.arange(MY))
  if mask is not None:
    t_coords['mask'] = mod.Coord(('latitude', 'longitude'), mask)
  return ({'t2m': mod.DimArray(x.copy(), DIMS,
                               dict(coords, number=np.arange(MX)))},
          {'t2m': mod.DimArray(y.copy(), DIMS, t_coords)})


def _assert_close(got: np.ndarray, want: np.ndarray, msg=''):
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=msg)
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize('skipna', [False, True])
@pytest.mark.parametrize('nan', [False, True])
def test_crps_skill_ensemble_targets_matches_jax(skipna, nan, monkeypatch):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  x, y, _ = _arrays(1, nan=nan)
  jp, jt = _pair(j_darray, x, y)
  p, t = _pair(darray, x, y)
  want = j_probabilistic.CRPSSkill(
      skipna_ensemble=skipna)._compute_per_variable(jp['t2m'], jt['t2m'])
  crps_pairwise.reset_launch_counts()
  got = probabilistic.CRPSSkill(
      skipna_ensemble=skipna)._compute_per_variable(p['t2m'], t['t2m'])
  assert got.dims == want.dims == DIMS[1:]
  _assert_close(got.values, np.asarray(want.values))
  if nan and not skipna:
    assert np.isnan(got.values).sum() == 2  # each NaN member, its own point
  if skipna:
    assert np.isfinite(got.values).all()


def test_crps_skill_cross_path_equals_broadcast_form():
  """The kernel path (float32) and the pseudo-dim broadcast (float64)."""
  x, y, _ = _arrays(2)
  stat = probabilistic.CRPSSkill()
  p32, t32 = _pair(darray, x, y)
  p64, t64 = _pair(darray, x.astype(np.float64), y.astype(np.float64))
  got = stat._compute_per_variable(p32['t2m'], t32['t2m'])
  want = stat._compute_per_variable(p64['t2m'], t64['t2m'])
  assert want.dtype == torch.float64
  np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)
  brute = np.abs(x[:, None] - y[None, :]).mean((0, 1))
  np.testing.assert_allclose(got.values, brute, rtol=RTOL, atol=ATOL)


def test_targets_mask_coord_survives_cross_path():
  x, y, mask = _arrays(3)
  p, t = _pair(darray, x, y, mask)
  out = probabilistic.CRPSSkill()._compute_per_variable(p['t2m'], t['t2m'])
  assert 'mask' in out.coords
  np.testing.assert_array_equal(np.asarray(out.coords['mask'].values), mask)


def _aggregator(agg_mod, bin_mod, w_mod, masked):
  return agg_mod.Aggregator(
      reduce_dims=['latitude', 'longitude'],
      weigh_by=[w_mod.GridAreaWeighting()],
      bin_by=[bin_mod.Regions(REGIONS)], masked=masked)


@pytest.mark.parametrize('use_sort,skipna,nan', [
    (True, False, False), (False, False, False), (True, False, True),
    (False, True, True)])
@pytest.mark.parametrize('masked', [False, True])
def test_crps_ensemble_distance_matches_jax(use_sort, skipna, nan, masked,
                                            monkeypatch):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  x, y, mask = _arrays(4, nan=nan)
  mask = mask if masked else None

  def metrics(mod):
    return {'energy': mod.CRPSEnsembleDistance(use_sort=use_sort,
                                               skipna_ensemble=skipna),
            'crps': mod.CRPSEnsemble(use_sort=use_sort,
                                     skipna_ensemble=skipna)}

  want = j_aggregation.compute_metric_values_for_single_chunk(
      metrics(j_probabilistic),
      _aggregator(j_aggregation, j_binning, j_weighting, masked),
      *_pair(j_darray, x, y, mask))
  got = aggregation.compute_metric_values_for_single_chunk(
      metrics(probabilistic),
      _aggregator(aggregation, binning, weighting, masked),
      *_pair(darray, x, y, mask))
  assert sorted(got) == sorted(want) == ['crps.t2m', 'energy.t2m']
  for k in want:
    assert got[k].dims == want[k].dims == ('lead_time', 'region'), k
    _assert_close(got[k].values.astype(np.float64),
                  np.asarray(want[k].values, np.float64), k)
  finite = np.isfinite(got['energy.t2m'].values)
  assert finite.all() if skipna or not nan else not finite.all()


def test_ensemble_distance_shares_statistics_one_cross_launch(monkeypatch):
  """CRPSEnsemble and CRPSEnsembleDistance share CRPSSkill and the
  prediction spread: one cross sum and two spread sums per pass."""
  calls = {'cross': 0, 'spread': 0}
  cross, spread = (crps_pairwise.pairwise_cross_sum,
                   crps_pairwise.pairwise_spread_sum)

  def count(name, fn):
    def wrapped(*a):
      calls[name] += 1
      return fn(*a)
    return wrapped

  monkeypatch.setattr(crps_pairwise, 'pairwise_cross_sum',
                      count('cross', cross))
  monkeypatch.setattr(crps_pairwise, 'pairwise_spread_sum',
                      count('spread', spread))
  metrics = {'energy': probabilistic.CRPSEnsembleDistance(use_sort=True),
             'crps': probabilistic.CRPSEnsemble(use_sort=True),
             'umr': probabilistic.UnbiasedEnsembleMeanRMSE()}
  stats = base.compute_unique_statistics_for_all_metrics(
      metrics, *_pair(darray, *_arrays(5)[:2]))
  assert sorted(stats) == [
      'CRPSSkill_number', 'CRPSSpread_number_fair_predictions',
      'CRPSSpread_number_fair_targets',
      'UnbiasedEnsembleMeanSquaredError_number_skipna_ensemble_False']
  assert calls == {'cross': 1, 'spread': 2}
