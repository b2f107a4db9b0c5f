"""The port's DimArray against the JAX package's, op by op, on the CPU.

Identical float32 inputs from a numpy seed; values, dims and coords must
agree. Also pins the port's import-time guarantees: full float32 matmul
precision (no TF32) and no jax anywhere in the port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu_torch import darray as td

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(data, dims, coords=None):
  return (jd.DimArray(np.array(data), dims, coords),
          td.DimArray(np.array(data), dims, coords))


def _assert_same(j, t, rtol=1e-6, atol=1e-6):
  assert t.dims == j.dims
  assert sorted(t.coords) == sorted(j.coords)
  for name, c in j.coords.items():
    assert t.coords[name].dims == c.dims, name
    np.testing.assert_array_equal(t.coord_values(name),
                                  np.asarray(c.values), err_msg=name)
  jv = np.asarray(j.values)
  tv = t.values
  assert tv.shape == jv.shape
  if jv.dtype == bool:
    assert tv.dtype == bool
    np.testing.assert_array_equal(tv, jv)
  else:
    np.testing.assert_allclose(tv.astype(np.float64), jv.astype(np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture
def arrays():
  rng = np.random.default_rng(0)
  lat = np.linspace(90, -90, 5)
  lon = np.arange(6) * 60.0
  a = rng.standard_normal((3, 5, 6)).astype(np.float32)
  a[1, 2, 3] = np.nan
  b = rng.standard_normal((6, 2)).astype(np.float32)
  coords_a = {'time': np.arange(3), 'latitude': lat, 'longitude': lon,
              'mask': (('latitude', 'longitude'), rng.random((5, 6)) > 0.3)}
  ja, ta = _both(a, ('time', 'latitude', 'longitude'), coords_a)
  jb, tb = _both(b, ('longitude', 'level'),
                 {'longitude': lon, 'level': np.array([500, 850])})
  return ja, ta, jb, tb


@pytest.mark.parametrize('op', [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: a / (abs(b) + 1), lambda a, b: b - a, lambda a, b: a ** 2,
    lambda a, b: 2.0 - a, lambda a, b: 3 * a + 1, lambda a, b: 1 / (abs(a) + 1),
    lambda a, b: a > b, lambda a, b: a <= 0.5, lambda a, b: a == a,
    lambda a, b: a != b, lambda a, b: (a > 0) & (b < 0),
    lambda a, b: (a > 0) | (b < 0), lambda a, b: (a > 0) ^ (b < 0),
    lambda a, b: ~(a > 0), lambda a, b: -a, lambda a, b: abs(a),
])
def test_binary_and_unary_ops(arrays, op):
  ja, ta, jb, tb = arrays
  _assert_same(op(ja, jb), op(ta, tb))


@pytest.mark.parametrize('name,kw', [
    ('sum', {}), ('sum', {'dim': 'time'}),
    ('sum', {'dim': ['latitude', 'longitude'], 'skipna': True}),
    ('sum', {'dim': []}), ('mean', {'dim': 'latitude'}),
    ('mean', {'dim': ('time', 'longitude'), 'skipna': True}),
    ('mean', {'skipna': True}),
    ('var', {'dim': 'time'}), ('var', {'dim': 'time', 'ddof': 1}),
    ('var', {'dim': 'time', 'ddof': 1, 'skipna': True}),
    ('var', {'skipna': True}),
])
def test_reductions(arrays, name, kw):
  ja, ta, _, _ = arrays
  _assert_same(getattr(ja, name)(**kw), getattr(ta, name)(**kw), rtol=2e-6)


def test_count_isnull_notnull_where(arrays):
  ja, ta, jb, tb = arrays
  for dim in (None, 'time', ('latitude', 'longitude')):
    _assert_same(ja.count(dim), ta.count(dim))
  _assert_same(ja.isnull(), ta.isnull())
  _assert_same(ja.notnull(), ta.notnull())
  _assert_same(ja.where(ja > 0), ta.where(ta > 0))
  _assert_same(ja.where(jb > 0, 0), ta.where(tb > 0, 0))
  _assert_same(ja.where(ja > 0, jb), ta.where(ta > 0, tb))
  mask_j = jd.DimArray(ja.coords['mask'].values, ('latitude', 'longitude'))
  mask_t = td.DimArray(ta.coords['mask'].values, ('latitude', 'longitude'))
  _assert_same(mask_j.broadcast_like(ja), mask_t.broadcast_like(ta))
  _assert_same(jd.ones_like(ja, dtype=bool), td.ones_like(ta, dtype=bool))
  _assert_same(jd.sqrt(abs(ja)), td.sqrt(abs(ta)))
  _assert_same(ja.astype(np.float64), ta.astype(np.float64))
  assert ta.astype(np.float64).dtype == torch.float64
  assert (ta > 0).astype(torch.float32).dtype == torch.float32


def test_shape_and_coord_ops(arrays):
  ja, ta, _, _ = arrays
  for dims in [('longitude', 'time', 'latitude'), ('...', 'time'), ()]:
    _assert_same(ja.transpose(*dims), ta.transpose(*dims))
  _assert_same(ja.rename({'time': 't', 'latitude': 'lat'}),
               ta.rename({'time': 't', 'latitude': 'lat'}))
  _assert_same(ja.isel(time=1), ta.isel(time=1))
  _assert_same(ja.isel(latitude=[0, 3], longitude=slice(1, 4)),
               ta.isel(latitude=[0, 3], longitude=slice(1, 4)))
  _assert_same(ja.sel(latitude=slice(50, -50)), ta.sel(latitude=slice(50, -50)))
  _assert_same(ja.sel(longitude=[120.0, 0.0]), ta.sel(longitude=[120.0, 0.0]))
  _assert_same(ja.sel(latitude=44.0, method='nearest'),
               ta.sel(latitude=44.0, method='nearest'))
  with pytest.raises(KeyError):
    ta.sel(longitude=[7.0])
  _assert_same(ja.assign_coords(extra=('time', np.arange(3) * 2)),
               ta.assign_coords(extra=('time', np.arange(3) * 2)))
  _assert_same(ja.drop_coords('mask'), ta.drop_coords('mask'))
  with pytest.raises(ValueError, match='do not match'):
    ta.transpose('time')
  with pytest.raises(ValueError, match='mismatched sizes'):
    _ = ta + td.DimArray(np.zeros(4, np.float32), ('time',))
  with pytest.raises(ValueError, match='labels but dim'):
    td.DimArray(np.zeros(3), ('time',), {'time': np.arange(4)})


@pytest.mark.parametrize('bool_mask', [False, True])
def test_dot_matches_jax(arrays, bool_mask):
  ja, ta, jb, tb = arrays
  ja, ta = ja.fillna(0.0), ta.where(~ta.isnull(), 0.0)
  rng = np.random.default_rng(1)
  w = rng.random(5)
  bins = rng.random((4, 5, 6)) > 0.5
  jw, tw = _both(w.astype(np.float32), ('latitude',))
  data = bins if bool_mask else bins.astype(np.float32)
  jm, tm = _both(data, ('region', 'latitude', 'longitude'),
                 {'region': np.array(list('abcd'))})
  dims = ('latitude', 'longitude')
  _assert_same(jd.dot(ja, jw, jm, dim=dims), td.dot(ta, tw, tm, dim=dims),
               rtol=1e-5)
  _assert_same(jd.dot(ja, jb, dim='longitude'), td.dot(ta, tb, dim='longitude'),
               rtol=1e-5)
  # All-bool operands count in float32, not as a logical reduction.
  got = td.dot(tm, tm, dim=dims) if bool_mask else None
  if got is not None:
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.values, bins.sum((1, 2)))
  scalar = td.dot(ta, td.DimArray(np.float32(2.0)), dim='time')
  _assert_same(jd.dot(ja, jd.DimArray(np.float32(2.0)), dim='time'), scalar,
               rtol=1e-5)


def test_full_float32_matmul_precision():
  import weatherbenchx_tpu_torch  # noqa: F401
  assert not torch.backends.cuda.matmul.allow_tf32
  assert not torch.backends.cudnn.allow_tf32
  assert torch.get_float32_matmul_precision() == 'highest'


def test_port_never_imports_jax():
  """Every module of the port, and chip_smoke.py, imports in a fresh
  process without jax, pandas, matplotlib or the JAX package."""
  modules = ['chip_smoke']
  pkg = os.path.join(REPO, 'weatherbenchx_tpu_torch')
  for root, _, files in os.walk(pkg):
    for f in sorted(files):
      if f.endswith('.py'):
        rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
        modules.append(rel.replace(os.sep, '.').removesuffix('.__init__'))
  assert len(modules) >= 30
  code = ('import importlib, sys\n'
          f'for m in {modules!r}:\n'
          '  importlib.import_module(m)\n'
          "banned = ('jax', 'jaxlib', 'pandas', 'matplotlib',"
          " 'weatherbenchx_tpu')\n"
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
          'assert not bad, bad\n'
          'print(len(sys.modules))\n')
  proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                        capture_output=True, text=True, timeout=120,
                        check=False)
  assert proc.returncode == 0, proc.stderr[-2000:]
