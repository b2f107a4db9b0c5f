"""Ensemble statistics for the CRPS family: CUDA kernels and plain versions.

The port of ``weatherbenchx_tpu/ops/crps_pairwise.py:404-423, 583-603``.
Each public function routes by the device of its input alone:

* a CPU tensor takes the plain PyTorch version in this module;
* a CUDA tensor launches the hand-written kernel of
  ``csrc/crps_pairwise.cu`` (built at first use by ``_build``), or raises.

The kernels flatten the data axes: x is passed as a contiguous (M, N)
array and y as (N), N = prod(rest). (The TPU kernel's rule against
reshapes, which retile its memory layout, has no counterpart here.)

``LAUNCHES`` counts kernel launches per kernel, so that a run can show its
main path went through the kernels; the plain versions do not count.
"""

import torch

from weatherbenchx_tpu_torch.ops import _build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on Hopper, and the fewest gridpoints a
# block stages: the kernel needs M * 32 * 4 bytes at least.
_MAX_SHARED_BYTES = 232448
_MIN_BLOCK_POINTS = 32

LAUNCHES = {'fused_ensemble_stats': 0, 'pairwise_spread_sum': 0}


def reset_launch_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


# -- plain versions -----------------------------------------------------------


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
  """Half-width inputs are widened to float32, as the kernel does."""
  return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def pairwise_spread_sum_plain(x: torch.Tensor) -> torch.Tensor:
  """Σ_{i≠j}|x_i − x_j| over axis 0 by the sorted-members identity.

  With members sorted ascending, Σ_{i≠j}|x_i − x_j| = 2 Σ_k (2k − M − 1)
  x_(k). The weights sum to zero, so the sorted members are first shifted
  by their median: the weighted terms then stay of the spread's size, not
  of |mean|'s. torch.sort puts NaN last, where the weight M − 1 > 0 keeps
  it in the sum.
  """
  m = x.shape[0]
  s = torch.sort(x.to(_compute_dtype(x.dtype)), dim=0).values
  s = s - s[m // 2]
  coeff = (2 * torch.arange(1, m + 1, device=x.device, dtype=s.dtype)
           - m - 1).reshape((m,) + (1,) * (x.dim() - 1))
  return (2 * (coeff * s).sum(0)).to(x.dtype)


def fused_ensemble_stats_plain(x: torch.Tensor, y: torch.Tensor) -> tuple:
  """(spread_sum, skill_sum, mean, sq_dev_sum) by plain tensor code."""
  m = x.shape[0]
  xc = x.to(_compute_dtype(x.dtype))
  yc = y.to(xc.dtype)
  mean = xc.sum(0) / m
  outs = (pairwise_spread_sum_plain(xc), (xc - yc).abs().sum(0), mean,
          ((xc - mean) ** 2).sum(0))  # two-pass: see the kernel source
  return tuple(o.to(x.dtype) for o in outs)


# -- kernel wrappers ------------------------------------------------------------


def _check_kernel_input(x: torch.Tensor) -> None:
  if x.dtype not in KERNEL_DTYPES:
    raise TypeError(f'CUDA kernel takes float32 or bfloat16, got {x.dtype}')
  if not x.is_contiguous():
    raise ValueError('CUDA kernel input must be contiguous')
  m = x.shape[0]
  if m < 2:
    raise ValueError(f'need at least 2 ensemble members, got {m}')
  if m * _MIN_BLOCK_POINTS * 4 > _MAX_SHARED_BYTES:
    raise ValueError(
        f'{m} members do not fit one block\'s shared memory '
        f'({m} x {_MIN_BLOCK_POINTS} x 4 B > {_MAX_SHARED_BYTES} B)')


def _raise_on_error(rc: int, name: str) -> None:
  if rc != 0:
    raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


def _launch_fused(x: torch.Tensor, y: torch.Tensor) -> tuple:
  """x (M, N), y (N), both contiguous on one CUDA device."""
  _check_kernel_input(x)
  m, n = x.shape
  outs = tuple(torch.empty((n,), dtype=x.dtype, device=x.device)
               for _ in range(4))
  if n:
    rc = _build.load_library().wbx_fused_ensemble_stats(
        x.data_ptr(), y.data_ptr(), *(o.data_ptr() for o in outs), m, n,
        KERNEL_DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(rc, 'fused_ensemble_stats')
    LAUNCHES['fused_ensemble_stats'] += 1
  return outs


def _launch_spread(x: torch.Tensor) -> torch.Tensor:
  """x (M, N) contiguous on a CUDA device."""
  _check_kernel_input(x)
  m, n = x.shape
  out = torch.empty((n,), dtype=x.dtype, device=x.device)
  if n:
    rc = _build.load_library().wbx_pairwise_spread_sum(
        x.data_ptr(), out.data_ptr(), m, n, KERNEL_DTYPES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(rc, 'pairwise_spread_sum')
    LAUNCHES['pairwise_spread_sum'] += 1
  return out


def _route(*tensors: torch.Tensor) -> str:
  """'cpu' or 'cuda' for inputs that all live on one such device."""
  devices = {t.device for t in tensors}
  if len(devices) != 1:
    raise ValueError(f'inputs on different devices: {sorted(map(str, devices))}')
  kind = tensors[0].device.type
  if kind not in ('cpu', 'cuda'):
    raise ValueError(f'unsupported device {tensors[0].device}')
  return kind


def fused_ensemble_stats(x: torch.Tensor, y: torch.Tensor) -> tuple:
  """One ensemble pass → (spread_sum, skill_sum, mean, sq_dev_sum).

  spread_sum = Σ_{i≠j}|x_i − x_j|; skill_sum = Σ_i |x_i − y|;
  mean = (Σ_i x_i)/M; sq_dev_sum = Σ_i (x_i − mean)², each shaped like y,
  in x's dtype. x is (M, *rest) and y is rest-shaped. A NaN member poisons
  only its own gridpoint.
  """
  if x.dim() != y.dim() + 1 or tuple(x.shape[1:]) != tuple(y.shape):
    raise ValueError(f'shape mismatch: x {tuple(x.shape)} vs y '
                     f'{tuple(y.shape)}; want x = (M, *y.shape)')
  if x.dtype != y.dtype:
    raise TypeError(f'dtype mismatch: {x.dtype} vs {y.dtype}')
  if _route(x, y) == 'cpu':
    return fused_ensemble_stats_plain(x, y)
  rest = y.shape
  outs = _launch_fused(x.contiguous().reshape(x.shape[0], -1),
                       y.contiguous().reshape(-1))
  return tuple(o.reshape(rest) for o in outs)


def pairwise_spread_sum(x: torch.Tensor) -> torch.Tensor:
  """Σ_{i≠j} |x[i] − x[j]| over axis 0, elementwise over the rest.

  x is (M, *rest) with any rest rank; returns a rest-shaped sum counting
  both orderings (2·Σ_{i<j}).
  """
  if x.dim() < 1:
    raise ValueError('need an ensemble axis')
  if _route(x) == 'cpu':
    return pairwise_spread_sum_plain(x)
  return _launch_spread(x.contiguous().reshape(x.shape[0], -1)).reshape(
      x.shape[1:])


def spread_sum_along_axis(data: torch.Tensor, axis: int) -> torch.Tensor:
  """Pairwise |diff| sum over ``axis``; the result drops that axis."""
  return pairwise_spread_sum(torch.movedim(data, axis, 0))
