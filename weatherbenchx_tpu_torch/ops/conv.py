"""Neighborhood averaging for the spatial metrics (FSS).

The port of ``weatherbenchx_tpu/ops/conv.py``, which is jnp there, not a
Pallas kernel, and torch ops here: the moving average is an O(N)
wrap-padded cumulative-sum difference, batched over all leading dims.
"""

import torch
import torch.nn.functional as F


def _accumulator(dtype: torch.dtype) -> torch.dtype:
  """At least float32, and never below the input's precision: a float64
  field keeps a float64 convolution's accuracy."""
  return torch.promote_types(dtype, torch.float32)


def uniform_filter1d_wrap(x: torch.Tensor, size: int, axis: int,
                          divide: bool = True) -> torch.Tensor:
  """Uniform moving average of odd window ``size`` with wraparound padding.

  ``divide=False`` returns the window SUM. Callers composing separable
  passes divide once at the end: for binary fields (FSS's inputs) the
  cumulative sums then stay exact integers far below 2^24, whatever order
  a parallel cumsum adds them in, where pre-divided fractions would gather
  float32 rounding along a 0.25 degree row.
  """
  if size == 1:
    return x
  half = (size - 1) // 2
  x = x.movedim(axis, -1)
  n = x.shape[-1]
  if half <= n:
    padded = torch.cat([x[..., n - half:], x, x[..., :half]], dim=-1)
  else:  # a window wider than the axis wraps more than once
    padded = x.index_select(
        -1, torch.arange(-half, n + half, device=x.device) % n)
  csum = F.pad(torch.cumsum(padded.to(_accumulator(x.dtype)), dim=-1), (1, 0))
  out = csum[..., size:] - csum[..., :-size]
  if divide:
    out = out / size
  return out.movedim(-1, axis)


def convolve2d_wrap_longitude(x: torch.Tensor, neighborhood_size: int,
                              wrap_longitude: bool = False) -> torch.Tensor:
  """Separable 2-D uniform convolution over the two trailing axes
  (latitude, longitude).

  Wrap padding on both axes; the outermost half-window rows (latitude)
  are zeroed always, and the longitude edges unless ``wrap_longitude``.
  """
  if neighborhood_size == 1:
    return x
  if neighborhood_size % 2 != 1:
    raise ValueError('neighborhood_size must be odd.')
  half = (neighborhood_size - 1) // 2
  out = uniform_filter1d_wrap(x.to(_accumulator(x.dtype)), neighborhood_size,
                              axis=-2, divide=False)
  out = uniform_filter1d_wrap(out, neighborhood_size, axis=-1, divide=False)
  out = out / (neighborhood_size * neighborhood_size)

  def inner(n: int) -> torch.Tensor:
    i = torch.arange(n, device=out.device)
    return (i >= half) & (i < n - half)

  out = out * inner(out.shape[-2])[:, None]
  if not wrap_longitude:
    out = out * inner(out.shape[-1])[None, :]
  return out
