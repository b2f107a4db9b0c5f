"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: these skip without an NVIDIA GPU. On a machine with one
(and without jax, which ``tests/conftest.py`` imports), run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu_torch.ops import crps_pairwise

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  return torch.device('cuda')


def _rel(got, want):
  got, want = got.double(), want.double()
  assert torch.equal(torch.isnan(got), torch.isnan(want))
  ok = ~torch.isnan(want)
  return ((got[ok] - want[ok]).abs() / want[ok].abs().clamp(min=1)).max().item()


@pytest.mark.parametrize('m,rest', [(2, (5,)), (3, (33,)), (21, (2, 3, 65)),
                                    (50, (1, 129)), (400, (40,))])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_kernels_match_plain(cuda, m, rest, dtype, tol):
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m,) + rest).astype(np.float32)
  x.reshape(m, -1)[m // 2, 0] = np.nan
  xd = torch.from_numpy(x).to(cuda, dtype)
  yd = torch.from_numpy(x[0].copy()).to(cuda, dtype)
  crps_pairwise.reset_launch_counts()
  got = crps_pairwise.fused_ensemble_stats(xd, yd) + (
      crps_pairwise.pairwise_spread_sum(xd),)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES == {'fused_ensemble_stats': 1,
                                    'pairwise_spread_sum': 1,
                                    'pairwise_cross_sum': 0}
  for g, w in zip(got, want):
    assert g.dtype == dtype and g.shape == rest
    assert _rel(g, w) <= tol
    assert torch.isnan(g.reshape(-1)[0])


def test_non_contiguous_input_and_empty_rest(cuda):
  x = torch.randn(6, 7, 5, device=cuda)
  xt = x.transpose(1, 2)  # the wrapper makes it contiguous
  got = crps_pairwise.pairwise_spread_sum(xt)
  want = crps_pairwise.pairwise_spread_sum_plain(xt)
  assert _rel(got, want) <= 1e-5
  assert crps_pairwise.pairwise_spread_sum(torch.randn(4, 0, device=cuda)
                                           ).shape == (0,)


def test_kernel_rejects_what_it_cannot_take(cuda):
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(3, 4, dtype=torch.float64,
                                                  device=cuda))
  with pytest.raises(ValueError, match='at least 2'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(1, 4, device=cuda))
  with pytest.raises(ValueError, match='shared memory'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(2000, 4, device=cuda))
  with pytest.raises(ValueError, match='different devices'):
    crps_pairwise.fused_ensemble_stats(torch.zeros(3, 4, device=cuda),
                                       torch.zeros(4))


@pytest.mark.parametrize('mx,my,rest', [
    (1, 1, (5,)), (3, 5, (33,)), (8, 2, (2, 3, 65)), (50, 10, (1, 129)),
    (50, 50, (2, 300)),
    (500, 600, (70,)),   # staged 500 rows: 64-thread blocks, 128 KB
    (2000, 3, (40,)),    # a large streamed ensemble needs no shared memory
])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cross_kernel_matches_plain(cuda, mx, my, rest, dtype, tol):
  rng = np.random.default_rng(mx + my)
  x = torch.from_numpy(rng.standard_normal((mx,) + rest).astype(np.float32))
  y = torch.from_numpy(rng.standard_normal((my,) + rest).astype(np.float32))
  xd, yd = x.to(cuda, dtype), y.to(cuda, dtype)
  crps_pairwise.reset_launch_counts()
  got = crps_pairwise.pairwise_cross_sum(xd, yd)
  want = crps_pairwise.pairwise_cross_sum_plain(xd, yd)
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES['pairwise_cross_sum'] == 1
  assert got.dtype == dtype and got.shape == rest
  assert _rel(got, want) <= tol


@pytest.mark.parametrize('side', ['x', 'y'])
def test_cross_kernel_nan_poisons_only_its_point(cuda, side):
  x = torch.randn(7, 3, 50, device=cuda)
  y = torch.randn(4, 3, 50, device=cuda)
  (x if side == 'x' else y)[2, 1, 17] = float('nan')
  got = crps_pairwise.pairwise_cross_sum(x, y)
  want = crps_pairwise.pairwise_cross_sum_plain(x, y)
  assert _rel(got, want) <= 1e-5
  assert torch.isnan(got).sum().item() == 1 and torch.isnan(got[1, 17])


def test_cross_kernel_one_dimensional_and_rejects(cuda):
  x, y = torch.randn(6, device=cuda), torch.randn(4, device=cuda)
  got = crps_pairwise.pairwise_cross_sum(x, y)
  assert got.shape == ()
  assert _rel(got, crps_pairwise.pairwise_cross_sum_plain(x, y)) <= 1e-5
  with pytest.raises(ValueError, match='shared memory'):
    crps_pairwise.pairwise_cross_sum(torch.zeros(2000, 4, device=cuda),
                                     torch.zeros(1900, 4, device=cuda))
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    crps_pairwise.pairwise_cross_sum(x.double(), y.double())
