"""Randomized op-chain equivalence: the port's DimArray against the JAX
package's.

The chains of ``test_darray_fuzz.py`` (broadcast arithmetic, reductions,
``where``, ``isel``/``sel``, ``transpose``, ``expand_dims``, ``rename``,
``fillna``), drawn from the same seeds, applied at once to a port
``DimArray`` and to a JAX-package ``DimArray`` built from the same numpy
data; values, dims and coords are compared after every step at that
fuzz's tolerance (rtol 1e-5, atol 1e-4: float32 chains accumulate in
another order in each library).
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu_torch import darray

DIM_SIZES = {'time': 4, 'level': 3, 'latitude': 5, 'longitude': 6}


def _coords_for(dims, rng):
  out = {}
  for d in dims:
    n = DIM_SIZES[d]
    if d == 'time':
      out[d] = (np.datetime64('2020-01-01', 'ns')
                + np.arange(n) * np.timedelta64(6, 'h'))
    elif rng.random() < 0.8:  # sometimes leave a dim label-less
      out[d] = np.linspace(0, 10, n) + (0 if d != 'level' else 100)
  return out


def _rand_var(rng, nan_frac=0.1):
  dims = tuple(d for d in DIM_SIZES
               if rng.random() < 0.75) or ('latitude',)
  shape = tuple(DIM_SIZES[d] for d in dims)
  data = rng.standard_normal(shape).astype(np.float32)
  if rng.random() < nan_frac:
    flat = data.reshape(-1)
    flat[rng.integers(0, flat.size)] = np.nan
  return data, dims, _coords_for(dims, rng)


def _host(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Pair:
  """One value in both packages: ``t`` the port's, ``r`` the JAX
  package's."""

  def __init__(self, t, r):
    self.t, self.r = t, r

  @classmethod
  def new(cls, rng):
    data, dims, coords = _rand_var(rng)
    return cls(darray.DimArray(data, dims, coords),
               j_darray.DimArray(data.copy(), dims, coords))

  def check(self, step):
    assert tuple(self.t.dims) == tuple(self.r.dims), (
        step, self.t.dims, self.r.dims)
    tv = np.asarray(_host(self.t.data), dtype=np.float64)
    rv = np.asarray(self.r.data, dtype=np.float64)
    np.testing.assert_allclose(tv, rv, rtol=1e-5, atol=1e-4,
                               equal_nan=True, err_msg=step)
    for d in self.t.dims:
      t_has, r_has = self.t.has_coord(d), self.r.has_coord(d)
      assert t_has == r_has, (step, d, t_has, r_has)
      if t_has:
        np.testing.assert_array_equal(_host(self.t.coords[d].values),
                                      np.asarray(self.r.coords[d].values),
                                      err_msg=f'{step}:{d}')


def _apply_op(pair, other, op_id, rng):
  """Applies one random op to both sides; returns (Pair, description)."""
  t, r = pair.t, pair.r
  if op_id == 'add':
    return Pair(t + other.t, r + other.r), 'add'
  if op_id == 'mul':
    return Pair(t * other.t, r * other.r), 'mul'
  if op_id == 'sub_scalar':
    return Pair(t - 1.5, r - 1.5), 'sub_scalar'
  if op_id == 'abs_sq':
    return Pair(abs(t) ** 2, abs(r) ** 2), 'abs_sq'
  if op_id == 'reduce':
    dims = [d for d in t.dims if rng.random() < 0.5]
    if not dims:
      return pair, 'noop'
    how = str(rng.choice(['mean', 'sum']))
    skipna = bool(rng.integers(2))
    return Pair(getattr(t, how)(dims, skipna=skipna),
                getattr(r, how)(dims, skipna=skipna)
                ), f'{how}({dims},skipna={skipna})'
  if op_id == 'where':
    return Pair(t.where(t > 0), r.where(r > 0)), 'where>0'
  if op_id == 'transpose':
    perm = list(t.dims)
    rng.shuffle(perm)
    return Pair(t.transpose(*perm), r.transpose(*perm)), f'transpose{perm}'
  if op_id == 'isel':
    if not t.dims:
      return pair, 'noop'
    d = str(rng.choice(list(t.dims)))
    n = t.sizes[d]
    lo = int(rng.integers(0, n))
    hi = int(rng.integers(lo + 1, n + 1))
    return (Pair(t.isel(**{d: slice(lo, hi)}),
                 r.isel(**{d: slice(lo, hi)})), f'isel({d},{lo}:{hi})')
  if op_id == 'expand':
    if 'member' in t.dims:
      return pair, 'noop'
    return (Pair(t.expand_dims('member'), r.expand_dims('member')),
            'expand_dims')
  if op_id == 'sel':
    # Label-based slice on a labeled, sorted-coord dim.
    cands = [d for d in t.dims
             if t.has_coord(d) and t.coords[d].dims == (d,)
             and _host(t.coords[d].values).dtype.kind in 'fiM'
             and t.sizes[d] > 1]
    if not cands:
      return pair, 'noop'
    d = str(rng.choice(cands))
    vals = _host(t.coords[d].values)
    if not np.all(vals[:-1] <= vals[1:]):
      return pair, 'noop'
    lo, hi = sorted(rng.choice(len(vals), 2, replace=False))
    sl = slice(vals[lo], vals[hi])
    return Pair(t.sel(**{d: sl}), r.sel(**{d: sl})), f'sel({d})'
  if op_id == 'rename':
    if 'latitude' not in t.dims:
      return pair, 'noop'
    return (Pair(t.rename({'latitude': 'y'}), r.rename({'latitude': 'y'})),
            'rename(latitude->y)')
  if op_id == 'fillna':
    return Pair(t.fillna(-2.0), r.fillna(-2.0)), 'fillna'
  return pair, 'noop'


OPS = ['add', 'mul', 'sub_scalar', 'abs_sq', 'reduce', 'where',
       'transpose', 'isel', 'expand', 'sel', 'rename', 'fillna']


@pytest.mark.parametrize('seed', range(40))
def test_random_chain(seed):
  rng = np.random.default_rng(7000 + seed)
  pair = Pair.new(rng)
  pair.check('init')
  for step in range(6):
    op = str(rng.choice(OPS))
    # Binary ops draw a fresh operand whose dims may only partially
    # overlap: broadcast by name and coord merging.
    other = Pair.new(rng)
    if op in ('add', 'mul'):
      # Labeled coords on shared dims must agree for arithmetic: take
      # this side's labels where both have them.
      shared = [d for d in other.t.dims if d in pair.t.dims]
      for d in shared:
        has_t = pair.t.has_coord(d)
        if has_t != other.r.has_coord(d):
          op = 'mul' if op == 'add' else 'add'  # keep the draw count stable
        if has_t and other.r.has_coord(d):
          vals = _host(pair.t.coords[d].values)
          if other.t.sizes[d] != len(vals):
            break
          other = Pair(other.t.assign_coords(**{d: vals}),
                       other.r.assign_coords(**{d: vals}))
      # The JAX fuzz skips draws whose shared dims disagree in labels or
      # size (xarray refuses them); the same draws are skipped here.
      mismatch = any(
          (pair.t.has_coord(d) != other.r.has_coord(d))
          or other.t.sizes[d] != pair.t.sizes[d]
          for d in shared)
      if mismatch:
        continue
    pair, desc = _apply_op(pair, other, op, rng)
    pair.check(f'seed{seed}:step{step}:{desc}')
