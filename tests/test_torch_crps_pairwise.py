"""The port's ensemble-statistics ops against the JAX package, on the CPU.

On CPU tensors the port's wrappers take the kernels' plain versions; the
JAX functions run their Pallas kernels in interpret mode. M = 2 and 5 take
the JAX kernel's pair-enumeration body, M = 21 its sorting network (the
crossover is at 20). The cross sum is also held to a numpy brute force.
The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherbenchx_tpu.ops import crps_pairwise as j_crps
from weatherbenchx_tpu_torch.ops import _build
from weatherbenchx_tpu_torch.ops import crps_pairwise

torch.set_num_threads(1)

# float32 on both sides; the two spread forms sum in different orders.
RTOL, ATOL = 1e-5, 1e-5


def _brute_force_spread(x):
  return np.abs(x[:, None] - x[None, :]).sum((0, 1))


@pytest.mark.parametrize('m', [2, 5, 21])
@pytest.mark.parametrize('nan', [False, True])
def test_fused_matches_jax(m, nan):
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, 2, 9, 130)).astype(np.float32)
  y = rng.standard_normal((2, 9, 130)).astype(np.float32)
  if nan:
    x[m // 2, 1, 3, 7] = np.nan
    y[0, 4, 100] = np.nan
  want = j_crps.fused_ensemble_stats(jnp.asarray(x), jnp.asarray(y),
                                     interpret=True)
  got = crps_pairwise.fused_ensemble_stats(torch.from_numpy(x),
                                           torch.from_numpy(y))
  for name, g, w in zip(('spread', 'skill', 'mean', 'sq_dev'), got, want):
    w = np.asarray(w)
    assert g.dtype == torch.float32 and g.shape == w.shape, name
    np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w),
                                  err_msg=name)
    np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                               err_msg=name)
  if nan:
    # A NaN member poisons only its own gridpoint, in every output but
    # skill's own target NaN.
    assert all(np.isnan(g[1, 3, 7].item()) for g in got)
    assert np.isnan(got[1][0, 4, 100].item())
    assert np.isfinite(got[0][0, 4, 100].item())


def test_fused_sq_dev_is_two_pass():
  """|mean| >> std (temperatures near 288 K) must not cancel in float32."""
  rng = np.random.default_rng(0)
  x = (288 + 3 * rng.standard_normal((50, 4, 777))).astype(np.float32)
  y = (288 + 3 * rng.standard_normal((4, 777))).astype(np.float32)
  spread, skill, mean, sq_dev = crps_pairwise.fused_ensemble_stats(
      torch.from_numpy(x), torch.from_numpy(y))
  x64, y64 = x.astype(np.float64), y.astype(np.float64)
  truth = {'spread': _brute_force_spread(x64), 'skill': np.abs(x64 - y64).sum(0),
           'mean': x64.mean(0), 'sq_dev': ((x64 - x64.mean(0)) ** 2).sum(0)}
  for name, g in zip(truth, (spread, skill, mean, sq_dev)):
    rel = np.abs(g.numpy() - truth[name]) / np.maximum(np.abs(truth[name]), 1)
    assert rel.max() < 2e-6, (name, rel.max())


@pytest.mark.parametrize('shape', [
    (2, 1),            # rank-1 rest, single point
    (3, 130),          # rank-1 rest
    (5, 1, 7),
    (4, 9, 129),
    (2, 1, 1, 300),
    (6, 3, 2, 8, 128),
    (21, 8, 128),      # the JAX kernel's sort body
])
def test_spread_matches_jax_and_brute_force(shape):
  rng = np.random.default_rng(sum(shape))
  x = rng.standard_normal(shape).astype(np.float32)
  got = crps_pairwise.pairwise_spread_sum(torch.from_numpy(x)).numpy()
  want = np.asarray(j_crps.pairwise_spread_sum(jnp.asarray(x),
                                               interpret=True))
  assert got.shape == want.shape == shape[1:]
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(
      got, _brute_force_spread(x.reshape(shape[0], -1)).reshape(shape[1:]),
      rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('m', [3, 21])
def test_spread_nan_at_every_member_position(m):
  """Odd M: a NaN sorted to any rank must still poison its gridpoint."""
  base = np.random.default_rng(m).standard_normal((m, 64)).astype(np.float32)
  for pos in range(m):
    x = base.copy()
    x[pos, 5] = np.nan
    got = crps_pairwise.pairwise_spread_sum(torch.from_numpy(x)).numpy()
    assert np.isnan(got[5]), pos
    assert np.isfinite(np.delete(got, 5)).all(), pos


def test_spread_scalar_rest_and_along_axis():
  rng = np.random.default_rng(1)
  x = rng.standard_normal(7).astype(np.float32)
  got = crps_pairwise.pairwise_spread_sum(torch.from_numpy(x))
  assert got.shape == ()
  np.testing.assert_allclose(got.item(), _brute_force_spread(x), rtol=1e-5)
  x = rng.standard_normal((4, 6, 5)).astype(np.float32)
  got = crps_pairwise.spread_sum_along_axis(torch.from_numpy(x), 1).numpy()
  want = np.asarray(j_crps.spread_sum_along_axis(jnp.asarray(x), 1,
                                                 interpret=True))
  assert got.shape == (4, 5)
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bfloat16_computes_in_float32_and_stores_bfloat16():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((4, 9, 129)).astype(np.float32)
  y = rng.standard_normal((9, 129)).astype(np.float32)
  xb, yb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
  got = crps_pairwise.fused_ensemble_stats(xb, yb)
  want = crps_pairwise.fused_ensemble_stats(xb.float(), yb.float())
  for g, w in zip(got, want):
    assert g.dtype == torch.bfloat16
    # One bfloat16 rounding of the same float32 result.
    np.testing.assert_allclose(g.float().numpy(), w.bfloat16().float().numpy(),
                               rtol=0, atol=0)


def test_cpu_path_counts_no_launch():
  crps_pairwise.reset_launch_counts()
  x = torch.randn(5, 3, 4)
  crps_pairwise.fused_ensemble_stats(x, x[0])
  crps_pairwise.pairwise_spread_sum(x)
  crps_pairwise.pairwise_cross_sum(x, x[:2])
  assert crps_pairwise.LAUNCHES == {'fused_ensemble_stats': 0,
                                    'pairwise_spread_sum': 0,
                                    'pairwise_cross_sum': 0}


def test_wrappers_reject_bad_inputs():
  x = torch.zeros(3, 4, 5)
  with pytest.raises(ValueError, match='shape mismatch'):
    crps_pairwise.fused_ensemble_stats(x, torch.zeros(4, 6))
  with pytest.raises(TypeError, match='dtype mismatch'):
    crps_pairwise.fused_ensemble_stats(x, torch.zeros(4, 5, dtype=torch.float64))
  # Neither CPU nor CUDA: no kernel and no plain fallback.
  with pytest.raises(ValueError, match='unsupported device'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(3, 4, device='meta'))
  with pytest.raises(ValueError, match='different devices'):
    crps_pairwise.fused_ensemble_stats(x, torch.zeros(4, 5, device='meta'))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
  """No nvcc: a RuntimeError, never a silent fallback."""
  monkeypatch.setenv('PATH', str(tmp_path))
  monkeypatch.setenv('CUDA_HOME', str(tmp_path))
  monkeypatch.setattr(_build, 'DEFAULT_CUDA_HOME', str(tmp_path))
  monkeypatch.setattr(_build, '_library', None)
  with pytest.raises(RuntimeError, match='nvcc not found'):
    _build.load_library()
  with pytest.raises(RuntimeError, match='nvcc not found'):
    crps_pairwise._launch_spread(torch.zeros(3, 4))


def _brute_force_cross(x, y):
  return np.abs(x[:, None] - y[None, :]).sum((0, 1))


@pytest.mark.parametrize('mx,my', [(1, 1), (3, 5), (8, 2)])
def test_cross_matches_jax_and_brute_force(mx, my):
  rng = np.random.default_rng(10 * mx + my)
  x = rng.standard_normal((mx, 2, 9, 140)).astype(np.float32)
  y = rng.standard_normal((my, 2, 9, 140)).astype(np.float32)
  got = crps_pairwise.pairwise_cross_sum(torch.from_numpy(x),
                                         torch.from_numpy(y))
  assert got.dtype == torch.float32 and got.shape == (2, 9, 140)
  want = np.asarray(j_crps.pairwise_cross_sum(jnp.asarray(x), jnp.asarray(y),
                                              interpret=True))
  np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(got.numpy(), _brute_force_cross(x, y),
                             rtol=RTOL, atol=ATOL)


def test_cross_one_dimensional_inputs():
  """1-D inputs (no data dims) give a 0-d sum, as JAX's broadcast form."""
  rng = np.random.default_rng(2)
  x = rng.standard_normal(6).astype(np.float32)
  y = rng.standard_normal(4).astype(np.float32)
  got = crps_pairwise.pairwise_cross_sum(torch.from_numpy(x),
                                         torch.from_numpy(y))
  want = np.asarray(j_crps.pairwise_cross_sum(jnp.asarray(x), jnp.asarray(y),
                                              interpret=True))
  assert got.shape == () == want.shape
  np.testing.assert_allclose(got.item(), want, rtol=RTOL)
  np.testing.assert_allclose(got.item(), _brute_force_cross(x, y), rtol=RTOL)


@pytest.mark.parametrize('side', ['x', 'y'])
def test_cross_nan_poisons_only_its_point(side):
  rng = np.random.default_rng(3)
  x = rng.standard_normal((5, 3, 40)).astype(np.float32)
  y = rng.standard_normal((4, 3, 40)).astype(np.float32)
  (x if side == 'x' else y)[2, 1, 17] = np.nan
  got = crps_pairwise.pairwise_cross_sum(torch.from_numpy(x),
                                         torch.from_numpy(y)).numpy()
  nan = np.isnan(got)
  assert nan[1, 17] and nan.sum() == 1
  np.testing.assert_allclose(got[~nan], _brute_force_cross(x, y)[~nan],
                             rtol=RTOL, atol=ATOL)


def test_cross_bfloat16_computes_in_float32():
  rng = np.random.default_rng(4)
  x = torch.from_numpy(rng.standard_normal((5, 9, 129)).astype(np.float32))
  y = torch.from_numpy(rng.standard_normal((3, 9, 129)).astype(np.float32))
  xb, yb = x.bfloat16(), y.bfloat16()
  got = crps_pairwise.pairwise_cross_sum(xb, yb)
  want = crps_pairwise.pairwise_cross_sum(xb.float(), yb.float())
  assert got.dtype == torch.bfloat16
  # One bfloat16 rounding of the same float32 result.
  np.testing.assert_array_equal(got.float().numpy(),
                                want.bfloat16().float().numpy())


def test_cross_rejects_mismatched_inputs():
  x = torch.zeros(2, 3, 4, 5)
  with pytest.raises(ValueError, match='mismatch'):
    crps_pairwise.pairwise_cross_sum(x, torch.zeros(2, 3, 4, 6))
  with pytest.raises(ValueError, match='rank mismatch'):
    crps_pairwise.pairwise_cross_sum(x, torch.zeros(2, 3, 4))
  with pytest.raises(TypeError, match='dtype mismatch'):
    crps_pairwise.pairwise_cross_sum(x, x.double())
