"""The port's neighborhood convolution (``ops/conv``) against the JAX
package's, on the CPU.

The same seeded numpy fields go through ``uniform_filter1d_wrap`` and
``convolve2d_wrap_longitude`` of both packages (jnp there, torch here; no
Pallas kernel on either side): values to atol 1e-5, exactly for binary
fields, whose window sums are whole numbers. Then scipy's wrap-mode
``uniform_filter1d`` as a third, independent form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from weatherbenchx_tpu.ops import conv as j_conv
from weatherbenchx_tpu_torch.ops import conv

torch.set_num_threads(1)

ATOL = 1e-5


def _field(shape, kind, seed=0):
  rng = np.random.default_rng(seed)
  if kind == 'binary':
    return (rng.random(shape) > 0.7).astype(np.float32)
  if kind == 'bool':
    return rng.random(shape) > 0.7
  if kind == 'float64':
    return rng.standard_normal(shape)
  return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('divide', [True, False])
@pytest.mark.parametrize('axis', [0, 1, -1, -2])
@pytest.mark.parametrize('size', [1, 3, 5, 9])
def test_uniform_filter1d_wrap_matches_jax(size, axis, divide):
  x = _field((3, 11, 14), 'float32', size)
  got = conv.uniform_filter1d_wrap(torch.from_numpy(x), size, axis, divide)
  want = j_conv.uniform_filter1d_wrap(jnp.asarray(x), size, axis, divide)
  assert tuple(got.shape) == want.shape == x.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize('size', [3, 7])
def test_uniform_filter1d_wrap_matches_scipy(size):
  x = _field((4, 25), 'float32', 1)
  got = conv.uniform_filter1d_wrap(torch.from_numpy(x), size, -1).numpy()
  want = scipy.ndimage.uniform_filter1d(x.astype(np.float64), size, axis=-1,
                                        mode='wrap')
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('wrap', [False, True])
@pytest.mark.parametrize('size', [1, 3, 5])
@pytest.mark.parametrize('kind', ['float32', 'binary', 'bool'])
def test_convolve2d_matches_jax(kind, size, wrap):
  x = _field((2, 3, 13, 16), kind, size)
  got = conv.convolve2d_wrap_longitude(torch.from_numpy(x), size, wrap)
  want = np.asarray(j_conv.convolve2d_wrap_longitude(jnp.asarray(x), size,
                                                     wrap))
  assert got.shape == want.shape
  if size > 1:
    assert got.dtype == torch.float32
  if kind == 'float32':
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
  else:  # whole-number window sums, one divide: the same bits
    np.testing.assert_array_equal(got.numpy().astype(np.float32),
                                  want.astype(np.float32))


@pytest.mark.parametrize('wrap', [False, True])
def test_edges_are_zeroed(wrap):
  x = torch.ones(9, 12)
  out = conv.convolve2d_wrap_longitude(x, 5, wrap).numpy()
  assert (out[:2] == 0).all() and (out[-2:] == 0).all()
  inner = out[2:-2]
  if wrap:
    np.testing.assert_allclose(inner, 1.0, atol=1e-6)
  else:
    assert (inner[:, :2] == 0).all() and (inner[:, -2:] == 0).all()
    np.testing.assert_allclose(inner[:, 2:-2], 1.0, atol=1e-6)


def test_wrap_longitude_sees_across_the_seam():
  x = np.zeros((5, 6), np.float32)
  x[2, 0] = 1.0
  wrapped = conv.convolve2d_wrap_longitude(torch.from_numpy(x), 3, True)
  assert wrapped[2, 5].item() == pytest.approx(1 / 9)
  assert conv.convolve2d_wrap_longitude(torch.from_numpy(x), 3,
                                        False)[2, 5].item() == 0.0


def test_even_size_raises():
  with pytest.raises(ValueError, match='odd'):
    conv.convolve2d_wrap_longitude(torch.zeros(5, 5), 4)


def test_binary_window_sums_are_exact_at_a_long_row():
  """At a 0.25 degree row length (1,440) the window sums of a binary field
  are whole numbers, so the one divide at the end gives float64's value
  rounded once."""
  x = _field((7, 1440), 'binary', 3)
  got = conv.convolve2d_wrap_longitude(torch.from_numpy(x), 3, True).numpy()
  x64 = x.astype(np.float64)
  rows = x64[:-2] + x64[1:-1] + x64[2:]
  sums = np.roll(rows, 1, axis=1) + rows + np.roll(rows, -1, axis=1)
  np.testing.assert_array_equal(got[1:-1], (sums / 9).astype(np.float32))
  sums_only = conv.uniform_filter1d_wrap(torch.from_numpy(x), 3, -1,
                                         divide=False).numpy()
  np.testing.assert_array_equal(sums_only, np.round(sums_only))


def test_float64_keeps_its_precision_and_lower_types_widen():
  x = _field((6, 40), 'float64', 4)
  got = conv.convolve2d_wrap_longitude(torch.from_numpy(x), 3, True)
  assert got.dtype == torch.float64
  rows = x[:-2] + x[1:-1] + x[2:]
  want = (np.roll(rows, 1, axis=1) + rows + np.roll(rows, -1, axis=1)) / 9
  np.testing.assert_allclose(got.numpy()[1:-1], want, rtol=0, atol=1e-13)
  half = torch.from_numpy(_field((6, 40), 'binary', 5)).to(torch.bfloat16)
  assert conv.convolve2d_wrap_longitude(half, 3).dtype == torch.float32
