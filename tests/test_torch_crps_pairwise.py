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
    crps_pairwise._launch_stats(torch.zeros(3, 4), None)


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


# -- the register kernels' routes and their sorting network ------------------------


def _jax_folded_network(m):
  """The JAX package's odd-even merge network on p = 2^k ≥ m wires with its
  own +inf pad fold (``_PAD``, ``_ce_min``, ``_ce_max``): a compare-exchange
  that meets a pad row is applied symbolically and dropped; one between two
  real rows is kept."""
  p = 1
  while p < m:
    p *= 2
  rows = list(range(m)) + [j_crps._PAD] * (p - m)
  kept = []
  for lo, hi, ascending in j_crps._sort_network(p, 'oem'):
    assert ascending
    a, b = rows[lo], rows[hi]
    if a is j_crps._PAD or b is j_crps._PAD:
      rows[lo], rows[hi] = j_crps._ce_min(a, b), j_crps._ce_max(a, b)
    else:
      kept.append((lo, hi))
  # The fold never moved a real row: wires 0..m-1 still hold them.
  assert all(r is not j_crps._PAD for r in rows[:m])
  return kept


@pytest.mark.parametrize('m', range(2, 65))
def test_sort_network_is_the_jax_network_folded(m):
  assert crps_pairwise.sort_network(m) == _jax_folded_network(m)


def test_sort_network_sizes():
  """The compare-exchange counts the kernel header cites."""
  assert [len(crps_pairwise.sort_network(m)) for m in (10, 20, 50, 64)] == [
      32, 103, 403, 543]


def _apply_network(v, m):
  """The kernel's compare-exchanges on rows of v: fmin/fmax, as CUDA's
  fminf/fmaxf, drop a NaN operand."""
  v = list(v)
  for lo, hi in crps_pairwise.sort_network(m):
    v[lo], v[hi] = np.fmin(v[lo], v[hi]), np.fmax(v[lo], v[hi])
  return np.stack(v)


@pytest.mark.parametrize('m', range(2, 17))
def test_sort_network_sorts_every_zero_one_input(m):
  """The 0-1 principle: a network that sorts every 0-1 input sorts all."""
  bits = (np.arange(2 ** m)[None, :] >> np.arange(m)[:, None]) & 1
  out = _apply_network(bits.astype(np.int8), m)
  assert (np.diff(out, axis=0) >= 0).all()
  np.testing.assert_array_equal(out.sum(0), bits.sum(0))


@pytest.mark.parametrize('m', range(17, 65))
def test_sort_network_sorts_random_inputs(m):
  x = np.random.default_rng(m).standard_normal((m, 10_000)).astype(np.float32)
  np.testing.assert_array_equal(_apply_network(x, m), np.sort(x, axis=0))


def _emulate_network_spread(x):
  """The network kernel's arithmetic at each point, in float32 numpy: the
  NaN flag from the loaded values, ``sort_network`` with fmin/fmax, the
  shift by the median x_(m//2) where it is finite (else 0),
  2 Σ_k (2k − m − 1)(x_(k) − c) in k order without the median's zero
  weight, and below JAX_SORT_MEMBERS NaN for two members at one
  infinity."""
  m = x.shape[0]
  nan = np.isnan(x).any(0)
  v = _apply_network(x.astype(np.float32), m)
  c = np.where(np.isfinite(v[m // 2]), v[m // 2], np.float32(0))
  acc = np.zeros_like(c)
  with np.errstate(invalid='ignore'):
    for k in range(m):
      if 2 * k + 1 != m:
        acc = acc + np.float32(2 * k + 1 - m) * (v[k] - c)
  out = np.float32(2) * acc
  if m < crps_pairwise.JAX_SORT_MEMBERS:
    nan |= (v[1] == -np.inf) | (v[m - 2] == np.inf)
  out[nan] = np.nan
  return out


@pytest.mark.parametrize('m,offset,scale', [
    (20, 0.0, 1.0), (21, 0.0, 1.0), (50, 0.0, 1.0), (64, 0.0, 1.0),
    (50, 288.0, 3.0)])
def test_network_emulation_matches_jax_and_plain(m, offset, scale):
  rng = np.random.default_rng(m)
  x = (offset + scale * rng.standard_normal((m, 8, 128))).astype(np.float32)
  got = _emulate_network_spread(x)
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  jax_ = np.asarray(j_crps.pairwise_spread_sum(jnp.asarray(x),
                                               interpret=True))
  truth = _brute_force_spread(x.astype(np.float64))
  np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(got, truth, rtol=RTOL, atol=ATOL)
  if offset:
    # The JAX sort form weights unshifted order statistics of size 288, so
    # its own float32 error is ~2e-5 of the spread here, past RTOL; the
    # port's median shift keeps every term >= 0 and within RTOL of float64.
    assert np.abs(jax_ - truth).max() / np.abs(truth).max() > RTOL
  else:
    np.testing.assert_allclose(got, jax_, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('m', [21, 49])
def test_network_emulation_nan_at_every_member_position(m):
  """Point p holds a NaN at member p: fmin/fmax lose it, the flag keeps it,
  and it poisons that point alone."""
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, 8, 16)).astype(np.float32)
  flat = x.reshape(m, -1)
  for p in range(m):
    flat[p, p] = np.nan
  got = _emulate_network_spread(x).reshape(-1)
  plain = crps_pairwise.pairwise_spread_sum_plain(
      torch.from_numpy(x)).numpy().reshape(-1)
  jax_ = np.asarray(j_crps.pairwise_spread_sum(
      jnp.asarray(x), interpret=True)).reshape(-1)
  want_nan = np.arange(flat.shape[1]) < m
  for out in (got, plain, jax_):
    np.testing.assert_array_equal(np.isnan(out), want_nan)
  np.testing.assert_allclose(got[m:], plain[m:], rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(got[m:], jax_[m:], rtol=RTOL, atol=ATOL)


# Member counts of the infinity checks: both sides of the JAX package's
# sort threshold (20), odd and even counts, and both sides of the register
# route's end (64).
INFINITY_MEMBERS = (2, 3, 10, 19, 20, 21, 49, 50, 64, 65, 100)


def _infinite_members(m):
  """(m, 7) columns by their numbers of +inf and -inf members, at rows
  drawn at random: one +inf; one -inf; one of each; two +inf; m//2 + 1
  +inf; m//2 + 1 -inf (the median infinite); m//2 + 2 +inf, where the JAX
  sort body's weights give terms of both signs. Counts are capped at m."""
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, 7)).astype(np.float32)
  counts = [(1, 0), (0, 1), (1, 1), (2, 0), (m // 2 + 1, 0),
            (0, m // 2 + 1), (m // 2 + 2, 0)]
  for col, (n_pos, n_neg) in enumerate(counts):
    rows = rng.permutation(m)
    n_pos = min(n_pos, m)
    x[rows[:n_pos], col] = np.inf
    x[rows[n_pos:n_pos + n_neg], col] = -np.inf
  return x


def _assert_same_spread(got, want, label):
  """Equal inf and NaN points, finite values within the file's
  tolerances."""
  for f in (np.isnan, np.isposinf, np.isneginf):
    np.testing.assert_array_equal(f(got), f(want), err_msg=label)
  ok = np.isfinite(want)
  np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL,
                             err_msg=label)


@pytest.mark.parametrize('m', INFINITY_MEMBERS)
def test_infinite_members_give_the_jax_kernels_result(m):
  """The plain versions (spread and fused), the emulation of the kernel
  form that m takes (the network to 64 members, the sorted runs past them)
  and the JAX kernel (interpret) agree on every inf and NaN point of the
  seven columns, whichever JAX body runs at m."""
  x = _infinite_members(m)
  y = np.random.default_rng(m + 1).standard_normal(7).astype(np.float32)
  jax_ = np.asarray(j_crps.pairwise_spread_sum(jnp.asarray(x),
                                               interpret=True))
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  fused = crps_pairwise.fused_ensemble_stats_plain(
      torch.from_numpy(x), torch.from_numpy(y))[0].numpy()
  _assert_same_spread(plain, jax_, 'plain')
  _assert_same_spread(fused, jax_, 'fused plain')
  _assert_same_spread(_emulate_form_spread(x), jax_,
                      crps_pairwise.spread_form(m))
  assert np.isnan(jax_[6]) and np.isinf(jax_[:3]).all()


@pytest.mark.parametrize('m', [21, 49])
def test_network_emulation_infinities_follow_the_plain_version(m):
  """From 20 members on, the JAX sort body's inf and NaN points: inf while
  the weights of the infinite members' ranks share one sign, a median
  infinite included (its weight is 0 at odd m), NaN at m//2 + 2 of +inf."""
  x = _infinite_members(m)
  got = _emulate_network_spread(x)
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  jax_ = np.asarray(j_crps.pairwise_spread_sum(jnp.asarray(x),
                                               interpret=True))
  np.testing.assert_array_equal(got, plain)
  np.testing.assert_array_equal(got, jax_)
  np.testing.assert_array_equal(got, [np.inf] * 6 + [np.nan])


@pytest.mark.parametrize('m', [10, 21, 65])
def test_pair_forms_give_nan_for_two_infinities_of_one_sign(m):
  """Below 20 members the JAX package's pair body takes |inf − inf| = NaN
  for two members at one infinity, and every form of the port gives it
  too; from 20 on its sort body gives inf there, and so do the port's
  network and its sorted runs past 64 members."""
  x = _infinite_members(m)
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  jax_ = np.asarray(j_crps.pairwise_spread_sum(jnp.asarray(x),
                                               interpret=True))
  want = ([np.inf] * 3 + [np.nan] * 4 if m < 20
          else [np.inf] * 6 + [np.nan])
  for out in (plain, jax_, _emulate_form_spread(x)):
    np.testing.assert_array_equal(out, want)


def _emulate_form_spread(x):
  """The spread of the kernel form that x's member count takes: the
  network's emulation here, the sorted runs' in
  ``test_torch_sorted_runs.py``, the block sort's in
  ``test_torch_blocksort.py``."""
  form = crps_pairwise.spread_form(x.shape[0])
  if form == 'network':
    return _emulate_network_spread(x)
  if form == 'blocksort':
    from test_torch_blocksort import _emulate_blocksort_stats
    return _emulate_blocksort_stats(x)[0]
  from test_torch_sorted_runs import _emulate_sorted_stats
  return _emulate_sorted_stats(x)[0]


@pytest.mark.parametrize('m', [2, 3, 4])
def test_network_emulation_infinities_at_few_members(m):
  """The fewest members, where the median is the larger of two: one +inf
  or one -inf gives inf, as the JAX pair body's |inf − x| does (the shift
  is 0 where the median is infinite), in the network, the plain version
  and the JAX kernel alike."""
  x = np.random.default_rng(m).standard_normal((m, 4)).astype(np.float32)
  x[0, 0] = np.inf
  x[m - 1, 1] = -np.inf
  x[:, 2] = np.nan
  got = _emulate_network_spread(x)
  plain = crps_pairwise.pairwise_spread_sum_plain(torch.from_numpy(x)).numpy()
  jax_ = np.asarray(j_crps.pairwise_spread_sum(jnp.asarray(x),
                                               interpret=True))
  np.testing.assert_array_equal(got, plain)
  _assert_same_spread(got, jax_, f'm={m}')
  assert np.isposinf(got[:2]).all() and np.isnan(got[2])
  assert np.isfinite(got[3])


def test_spread_form_routes_by_member_count():
  """The network for every count 2..64, the sorted runs for 65..256, the
  block sort past them up to one gridpoint's capacity (58,112 members),
  the merge sort of block-sorted runs past that, to 2^20."""
  assert list(crps_pairwise.REGISTER_MEMBERS) == list(range(2, 65))
  assert list(crps_pairwise.SORTED_MEMBERS) == list(range(65, 257))
  assert [crps_pairwise.spread_form(m) for m in range(2, 259)] == (
      ['network'] * 63 + ['sorted'] * 192 + ['blocksort'] * 2)
  assert crps_pairwise.spread_form(400) == 'blocksort'
  assert crps_pairwise.spread_form(4000) == 'blocksort'
  assert crps_pairwise.spread_form(58112) == 'blocksort'
  assert crps_pairwise.spread_form(58113) == 'mergesort'
  assert crps_pairwise.spread_form(crps_pairwise.MAX_MEMBERS) == 'mergesort'


def test_generated_header_writes_each_network_in_order():
  """wbx_sort_networks.cuh holds sort_network(M), compare-exchange by
  compare-exchange, for every M of REGISTER_MEMBERS; the parts instantiate
  every register kernel and every sorted-runs kernel once."""
  header = _build.network_header()
  bodies = {}
  for block in header.split('void sort_network<')[1:]:
    m = int(block.split('>', 1)[0])
    body = block.split('{', 1)[1].split('}', 1)[0]
    bodies[m] = [tuple(int(i) for i in line.strip()[len('compare_exchange(v['):
                                                   -len(']);')].split('], v['))
                 for line in body.strip().splitlines()]
  members = list(crps_pairwise.REGISTER_MEMBERS)
  assert sorted(bodies) == members
  for m in members:
    assert bodies[m] == crps_pairwise.sort_network(m), m
  entries = [line for text in _build.part_sources().values()
             for line in text.splitlines() if '_ENTRY(' in line]
  assert len(_build.part_sources()) == _build.PARTS
  assert sorted(entries) == sorted(
      [f'WBX_REGISTER_ENTRY({m})' for m in members]
      + [f'WBX_SORTED_ENTRY({r})' for r in crps_pairwise.SORTED_RUN_SIZES])


def test_library_name_covers_the_generated_networks(monkeypatch):
  name = _build.library_name(_build.generated_sources())
  assert name == _build.library_name(_build.generated_sources())
  monkeypatch.setattr(crps_pairwise, 'sort_network',
                      lambda m, f=crps_pairwise.sort_network: f(m)[::-1])
  assert _build.library_name(_build.generated_sources()) != name


def test_register_symbols_name_the_generated_entries():
  """The launcher's symbol for M is the one WBX_REGISTER_ENTRY(M) defines
  (``wbx_ensemble_stats_registers_##M`` in register_stats.cuh)."""
  with open(_build.SOURCE.replace('crps_pairwise.cu',
                                  'register_stats.cuh')) as f:
    text = f.read()
  assert 'extern "C" int wbx_ensemble_stats_registers_##M(' in text
  assert _build.register_symbol(50) == 'wbx_ensemble_stats_registers_50'


def test_sorted_symbols_name_the_generated_entries():
  """The launcher's symbol for runs of R is the one WBX_SORTED_ENTRY(R)
  defines (``wbx_ensemble_stats_sorted_##R`` in sorted_stats.cuh), and the
  parts include that header."""
  with open(_build.SOURCE.replace('crps_pairwise.cu',
                                  'sorted_stats.cuh')) as f:
    text = f.read()
  assert 'extern "C" int wbx_ensemble_stats_sorted_##R(' in text
  assert '#include "register_stats.cuh"' in text
  assert _build.sorted_symbol(51) == 'wbx_ensemble_stats_sorted_51'
  assert all('#include "sorted_stats.cuh"' in part
             for part in _build.part_sources().values())
