"""Ensemble statistics for the CRPS family: CUDA kernels and plain versions.

The port of ``weatherbenchx_tpu/ops/crps_pairwise.py:404-423, 571-603``.
Each public function routes by the device of its input alone:

* a CPU tensor takes the plain PyTorch version in this module;
* a CUDA tensor launches a hand-written kernel (built at first use by
  ``_build``), or raises.

The kernels flatten the data axes: x is passed as a contiguous (M, N)
array and y as (N) (or (My, N) for the cross sum), N = prod(rest). (The
TPU kernel's rule against reshapes, which retile its memory layout, has no
counterpart here.)

The fused and spread-only kernels take one of two forms, picked from the
member count M alone (``spread_form``), both hand-written CUDA:

* ``network`` (M in ``REGISTER_MEMBERS``): one thread per gridpoint, the M
  members in registers, sorted there by the compare-exchange list
  ``sort_network(M)``; the spread is the weighted sum of order statistics
  that ``pairwise_spread_sum_plain`` computes;
* ``shared`` (larger M): the members staged in shared memory and a pair
  loop run over them; past 256 members the pair sum is added in two
  levels, and past ``TILE_MEMBERS`` the ensemble is walked tile by tile.

``_build`` compiles one network kernel per M of ``REGISTER_MEMBERS``, the
networks written out as straight-line code from ``sort_network``.

``LAUNCHES`` counts kernel launches per kernel, so that a run can show its
main path went through the kernels; the plain versions do not count. Each
public function runs inside a ``torch.profiler.record_function`` range
named ``wbx.<function>``, so that a profiler trace names it.
"""

import torch

from weatherbenchx_tpu_torch.ops import _build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The members one shared-memory tile holds: 227 KB (232,448 bytes, what a
# block may use on Hopper) over 32 gridpoints of 4 bytes, the kernels'
# smallest block. A larger ensemble (for the cross sum, a larger SMALLER
# ensemble) is walked tile by tile inside the kernel, the later members
# streamed from device memory: no size takes another route on the card.
TILE_MEMBERS = 232448 // (32 * 4)
# The most members the kernels' entry points take.
MAX_MEMBERS = 1 << 20


def member_tiles(m: int) -> int:
  """How many shared-memory tiles the kernels walk for m staged members."""
  return -(-m // TILE_MEMBERS)


# The member counts whose kernels hold the ensemble in registers and sort
# it. Every one sorts: on an H100 a register pair loop tied the network
# within run-to-run noise from 8 to 24 members (both at 80-85% of the
# memory bound) and fell 8-9% behind at 32 (PERF.md, PR 4).
REGISTER_MAX_MEMBERS = 64
REGISTER_MEMBERS = range(2, REGISTER_MAX_MEMBERS + 1)

# The member count from which the JAX package's spread kernel takes its sort
# body, below it its pair body (weatherbenchx_tpu/ops/crps_pairwise.py:90).
# The two differ on infinite members, and every form here gives what the
# JAX kernel gives at M: a semantic constant, not a speed knob (the kernels'
# kJaxSortMembers, csrc/common.cuh).
JAX_SORT_MEMBERS = 20

LAUNCHES = {'fused_ensemble_stats': 0, 'pairwise_spread_sum': 0,
            'pairwise_cross_sum': 0}


def reset_launch_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


# -- the kernels' routes ----------------------------------------------------------


def sort_network(m: int) -> list:
  """Compare-exchanges [(lo, hi)] that sort m values ascending in place.

  Batcher's odd-even merge sort on p = 2^k ≥ m wires, with wires m..p−1
  held at +inf and folded away: a compare-exchange never moves a +inf pad
  below a real value (every pad starts above every real value), so those
  touching a pad do nothing and are dropped. Each (lo, hi) leaves min at
  lo and max at hi. 403 compare-exchanges at m = 50.
  """
  if m < 1:
    raise ValueError(f'need at least one wire, got {m}')
  p = 1
  while p < m:
    p *= 2
  ces = []
  length = 1
  while length < p:
    k = length
    while k >= 1:
      for j in range(k % length, p - k, 2 * k):
        for i in range(min(k, p - j - k)):
          lo, hi = i + j, i + j + k
          if lo // (2 * length) == hi // (2 * length) and hi < m:
            ces.append((lo, hi))
      k //= 2
    length *= 2
  return ces


def spread_form(m: int) -> str:
  """The kernel form for m members: 'network' or 'shared'."""
  return 'network' if m in REGISTER_MEMBERS else 'shared'


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

  Infinite members give the JAX kernel's inf or NaN at every M: the shift
  is 0 where the median is infinite, and the median's zero weight at odd M
  is left out (its sort body, from ``JAX_SORT_MEMBERS`` members); below
  that, two members at one infinity give NaN (its pair body's
  |inf − inf|).
  """
  m = x.shape[0]
  s = torch.sort(x.to(_compute_dtype(x.dtype)), dim=0).values
  median = s[m // 2]
  s = s - torch.where(torch.isfinite(median), median, 0)
  coeff = (2 * torch.arange(1, m + 1, device=x.device, dtype=s.dtype)
           - m - 1).reshape((m,) + (1,) * (x.dim() - 1))
  terms = coeff * s
  if m % 2:
    terms[m // 2] = 0
  out = 2 * terms.sum(0)
  if 2 <= m < JAX_SORT_MEMBERS:
    out = torch.where((s[1] == -torch.inf) | (s[m - 2] == torch.inf),
                      torch.nan, out)
  return out.to(x.dtype)


def fused_ensemble_stats_plain(x: torch.Tensor, y: torch.Tensor) -> tuple:
  """(spread_sum, skill_sum, mean, sq_dev_sum) by plain tensor code."""
  m = x.shape[0]
  xc = x.to(_compute_dtype(x.dtype))
  yc = y.to(xc.dtype)
  mean = xc.sum(0) / m
  outs = (pairwise_spread_sum_plain(xc), (xc - yc).abs().sum(0), mean,
          ((xc - mean) ** 2).sum(0))  # two-pass: see the kernel source
  return tuple(o.to(x.dtype) for o in outs)


def pairwise_cross_sum_plain(x: torch.Tensor, y: torch.Tensor
                             ) -> torch.Tensor:
  """Σ_{i,j}|x_i − y_j| over both leading axes, one member at a time.

  Loops over the smaller ensemble, so the largest temporary is the other
  ensemble's (M, *rest) difference, never the (Mx, My, *rest) broadcast.
  Not by the union-sort identity ½(S(x∪y) − S(x) − S(y)), which cancels in
  float32.
  """
  dtype = _compute_dtype(x.dtype)
  small, large = (x, y) if x.shape[0] <= y.shape[0] else (y, x)
  large = large.to(dtype)
  acc = torch.zeros(x.shape[1:], dtype=dtype, device=x.device)
  for member in small.to(dtype):
    acc += (large - member).abs_().sum(0)
  return acc.to(x.dtype)


# -- kernel wrappers ------------------------------------------------------------


def _check_kernel_input(x: torch.Tensor, min_members: int = 2) -> None:
  if x.dtype not in KERNEL_DTYPES:
    raise TypeError(f'CUDA kernel takes float32 or bfloat16, got {x.dtype}')
  if not x.is_contiguous():
    raise ValueError('CUDA kernel input must be contiguous')
  m = x.shape[0]
  if m < min_members:
    raise ValueError(f'need at least {min_members} ensemble members, got {m}')
  if m > MAX_MEMBERS:
    raise ValueError(f'CUDA kernel takes at most {MAX_MEMBERS} ensemble '
                     f'members, got {m}')


def _raise_on_error(rc: int, name: str) -> None:
  if rc != 0:
    raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


def _launch_stats(x: torch.Tensor, y):
  """The fused kernel (y given) or the spread-only kernel (y None).

  x (M, N) and y (N) contiguous on one CUDA device, in the form
  ``spread_form(M)``. Returns the four fused outputs, or the spread alone.
  """
  _check_kernel_input(x)
  m, n = x.shape
  fused = y is not None
  outs = tuple(torch.empty((n,), dtype=x.dtype, device=x.device)
               for _ in range(4 if fused else 1))
  name = 'fused_ensemble_stats' if fused else 'pairwise_spread_sum'
  if n:
    lib = _build.load_library()
    ptrs = (x.data_ptr(), y.data_ptr() if fused else None,
            *(o.data_ptr() for o in outs), *(None,) * (4 - len(outs)))
    dtype = KERNEL_DTYPES[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if spread_form(m) == 'shared':
      rc = lib.wbx_ensemble_stats_shared(*ptrs, m, n, dtype, fused,
                                         x.device.index, stream)
    else:
      rc = getattr(lib, _build.register_symbol(m))(
          *ptrs, n, dtype, fused, x.device.index, stream)
    _raise_on_error(rc, name)
    LAUNCHES[name] += 1
  return outs if fused else outs[0]


def _launch_cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """x (Mx, N), y (My, N), both contiguous on one CUDA device.

  The kernel stages the smaller ensemble in shared memory and streams the
  larger one past it.
  """
  mx, n = x.shape
  my = y.shape[0]
  _check_kernel_input(x, min_members=1)
  _check_kernel_input(y, min_members=1)
  out = torch.empty((n,), dtype=x.dtype, device=x.device)
  if n:
    rc = _build.load_library().wbx_pairwise_cross_sum(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), mx, my, n,
        KERNEL_DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(rc, 'pairwise_cross_sum')
    LAUNCHES['pairwise_cross_sum'] += 1
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
  with torch.profiler.record_function('wbx.fused_ensemble_stats'):
    if _route(x, y) == 'cpu':
      return fused_ensemble_stats_plain(x, y)
    rest = y.shape
    outs = _launch_stats(x.contiguous().reshape(x.shape[0], -1),
                         y.contiguous().reshape(-1))
    return tuple(o.reshape(rest) for o in outs)


def pairwise_spread_sum(x: torch.Tensor) -> torch.Tensor:
  """Σ_{i≠j} |x[i] − x[j]| over axis 0, elementwise over the rest.

  x is (M, *rest) with any rest rank; returns a rest-shaped sum counting
  both orderings (2·Σ_{i<j}).
  """
  if x.dim() < 1:
    raise ValueError('need an ensemble axis')
  with torch.profiler.record_function('wbx.pairwise_spread_sum'):
    if _route(x) == 'cpu':
      return pairwise_spread_sum_plain(x)
    return _launch_stats(x.contiguous().reshape(x.shape[0], -1),
                         None).reshape(x.shape[1:])


def pairwise_cross_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Σ_{i,j} |x[i] − y[j]| over both leading axes (two-ensemble CRPS skill).

  x is (Mx, *rest) and y (My, *rest) with identical trailing shapes, any
  rest rank (1-D inputs give a 0-d sum); returns a rest-shaped sum in x's
  dtype without materializing the (Mx, My, *rest) broadcast. A NaN member
  poisons only its own gridpoint.
  """
  if x.dim() != y.dim():
    raise ValueError(f'rank mismatch: {tuple(x.shape)} vs {tuple(y.shape)}')
  if x.dim() < 1 or tuple(x.shape[1:]) != tuple(y.shape[1:]):
    raise ValueError(f'mismatched trailing shapes: {tuple(x.shape)} vs '
                     f'{tuple(y.shape)}')
  if x.dtype != y.dtype:
    raise TypeError(f'dtype mismatch: {x.dtype} vs {y.dtype}')
  with torch.profiler.record_function('wbx.pairwise_cross_sum'):
    if _route(x, y) == 'cpu':
      return pairwise_cross_sum_plain(x, y)
    return _launch_cross(x.contiguous().reshape(x.shape[0], -1),
                         y.contiguous().reshape(y.shape[0], -1)).reshape(
                             x.shape[1:])


def spread_sum_along_axis(data: torch.Tensor, axis: int) -> torch.Tensor:
  """Pairwise |diff| sum over ``axis``; the result drops that axis."""
  return pairwise_spread_sum(torch.movedim(data, axis, 0))
