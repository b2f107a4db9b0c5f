"""The rest of the port's ``darray`` against the JAX package, on the CPU.

The same numpy inputs (from a seed, with NaNs) go through each ``DimArray``
method and module function of both packages: ``fillna``, ``clip``, ``%``,
``std``/``var``/``min``/``max`` with and without skipna, ``any``, ``all``,
``cumsum``, ``quantile``, ``diff``, ``stack_to_new_dim``, ``squeeze``,
``where``, ``maximum``, ``minimum``, ``full_like``, the unary functions,
``concat``, ``dot_batched`` and ``apply_ufunc``. Values agree to atol 1e-5
(the JAX package's own tolerance), dims and coords exactly. ``quantile`` is
also held to ``np.quantile`` / ``np.nanquantile`` (method 'linear') on a
tensor past 16,777,216 elements, ``torch.quantile``'s long-standing limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as jd
from weatherbenchx_tpu_torch import darray as td

torch.set_num_threads(1)

ATOL = 1e-5
SHAPE = (3, 4, 5)
DIMS = ('time', 'latitude', 'longitude')
COORDS = {'time': np.array(['2020-01-01', '2020-01-02', '2020-01-03'],
                           dtype='datetime64[ns]'),
          'latitude': np.array([60.0, 20.0, -20.0, -60.0]),  # descending
          'longitude': np.arange(5) * 72.0,
          'station': ('longitude', np.array(['a', 'b', 'c', 'd', 'e'])),
          'mask': (('latitude', 'longitude'),
                   np.arange(20).reshape(4, 5) % 3 > 0)}


def _data(seed=0, nan=True):
  x = np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)
  if nan:
    x[0, 1, 2] = np.nan
    x[:, 2, 3] = np.nan  # an all-NaN slice along time
    x[1, 0, :] = np.nan  # an all-NaN slice along longitude
  return x


def _pair(x=None, dims=DIMS, coords=None):
  x = _data() if x is None else x
  coords = COORDS if coords is None else coords
  return td.DimArray(x, dims, coords), jd.DimArray(x, dims, coords)


def _same_coords(got, want):
  assert set(got.coords) == set(want.coords)
  for name, c in want.coords.items():
    assert got.coords[name].dims == tuple(c.dims), name
    g, w = got.coord_values(name), np.asarray(c.values)
    if w.dtype.kind == 'f':
      np.testing.assert_allclose(g, w, rtol=0, atol=0, equal_nan=True,
                                 err_msg=name)
    else:
      np.testing.assert_array_equal(g, w, err_msg=name)


def _same(got, want, atol=ATOL):
  assert isinstance(got, td.DimArray)
  assert got.dims == tuple(want.dims)
  w = np.asarray(want.values)
  g = got.values
  assert g.shape == w.shape
  if w.dtype == bool:
    assert g.dtype == bool
    np.testing.assert_array_equal(g, w)
  else:
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=0, atol=atol, equal_nan=True)
  _same_coords(got, want)


# One entry per method and argument form: the same expression on both sides.
METHOD_CASES = {
    'fillna': lambda a, m: a.fillna(0.5),
    'clip_both': lambda a, m: a.clip(-0.5, 0.5),
    'clip_min': lambda a, m: a.clip(min=0.0),
    'clip_max': lambda a, m: a.clip(max=0.25),
    'mod_positive': lambda a, m: (a * 3) % 2,
    'mod_negative_divisor': lambda a, m: (a * 3) % -2,
    'mod_array_divisor': lambda a, m: (a * 3) % (abs(a) + 0.5),
    'std': lambda a, m: a.std('time'),
    'std_ddof1_all': lambda a, m: a.fillna(0).std(ddof=1),
    'std_skipna': lambda a, m: a.std('time', skipna=True),
    'std_skipna_ddof1': lambda a, m: a.std(('time', 'latitude'), skipna=True,
                                          ddof=1),
    'var_skipna_ddof1': lambda a, m: a.var('time', skipna=True, ddof=1),
    'var_skipna_two_left': lambda a, m: a.isel(time=slice(0, 2)).var(
        'time', skipna=True, ddof=1),
    'min': lambda a, m: a.min('time'),
    'max_two_dims': lambda a, m: a.max(('latitude', 'longitude')),
    'min_all': lambda a, m: a.fillna(0).min(),
    'max_all_nan': lambda a, m: a.max(),
    'min_skipna': lambda a, m: a.min('time', skipna=True),
    'max_skipna': lambda a, m: a.max('longitude', skipna=True),
    'min_skipna_two_dims': lambda a, m: a.min(('time', 'longitude'),
                                              skipna=True),
    'max_skipna_all': lambda a, m: a.max(skipna=True),
    'min_empty_dims_is_noop': lambda a, m: a.min(()),
    'any': lambda a, m: (a > 1).any('time'),
    'any_all_dims': lambda a, m: (a > 5).any(),
    'all_two_dims': lambda a, m: (a < 5).all(('time', 'longitude')),
    'all': lambda a, m: a.notnull().all('latitude'),
    'cumsum': lambda a, m: a.fillna(0).cumsum('longitude'),
    'cumsum_first_dim': lambda a, m: a.fillna(0).cumsum('time'),
    'diff': lambda a, m: a.diff('longitude'),
    'diff_n2': lambda a, m: a.diff('time', n=2),
    'diff_coord_over_dim': lambda a, m: a.diff('latitude'),
    'stack_to_new_dim': lambda a, m: a.stack_to_new_dim(
        ('latitude', 'longitude'), 'point'),
    'stack_outer_dims': lambda a, m: a.stack_to_new_dim(
        ('time', 'longitude'), 'sample'),
    'squeeze_named': lambda a, m: a.isel(time=slice(1, 2)).squeeze('time'),
    'squeeze_all': lambda a, m: a.isel(time=slice(0, 1),
                                       longitude=slice(2, 3)).squeeze(),
    'squeeze_nothing': lambda a, m: a.squeeze(),
    'where_fn': lambda a, m: m.where(a > 0, a, 0),
    'where_fn_scalar_x': lambda a, m: m.where(a > 0, 1.0, a),
    'relu_form': lambda a, m: m.where(a > 0, a, 0).where(~a.isnull()),
    'bool_where_nan': lambda a, m: (a > 0).where(~a.isnull()).astype(
        np.float32),
    'maximum_scalar': lambda a, m: m.maximum(a, 0.0),
    'minimum_scalar': lambda a, m: m.minimum(a, 0.25),
    'maximum_arrays': lambda a, m: m.maximum(a, a.isel(time=0) * 2),
    'minimum_arrays': lambda a, m: m.minimum(a.isel(latitude=1), a),
    'full_like': lambda a, m: m.full_like(a, 7.0),
    'full_like_dtype': lambda a, m: m.full_like(a, True, dtype=bool),
    'zeros_like': lambda a, m: m.zeros_like(a),
    'ones_like_bool': lambda a, m: m.ones_like(a, dtype=bool),
    'sqrt': lambda a, m: m.sqrt(abs(a)),
    'exp': lambda a, m: m.exp(a),
    'log': lambda a, m: m.log(abs(a) + 1e-3),
    'log1p': lambda a, m: m.log1p(abs(a)),
    'abs_': lambda a, m: m.abs_(a),
    'sign': lambda a, m: m.sign(a),
    'floor': lambda a, m: m.floor(a * 3),
    'ceil': lambda a, m: m.ceil(a * 3),
}


@pytest.mark.parametrize('name', sorted(METHOD_CASES))
def test_method_matches_jax(name):
  t, j = _pair()
  _same(METHOD_CASES[name](t, td), METHOD_CASES[name](j, jd))


def test_mod_takes_the_divisors_sign():
  t = td.DimArray(np.array([-5.0, 5.0, -0.5], np.float32), ('x',))
  np.testing.assert_array_equal((t % 3).values, [1.0, 2.0, 2.5])
  np.testing.assert_array_equal((t % -3).values, [-2.0, -1.0, -0.5])


@pytest.mark.parametrize('skipna', [False, True])
@pytest.mark.parametrize('nan', [False, True])
@pytest.mark.parametrize('dim', DIMS)
def test_quantile_matches_jax_and_numpy(dim, nan, skipna):
  q = [0.0, 0.1, 0.5, 0.9, 1.0]
  t, j = _pair(_data(1, nan))
  got = t.quantile(q, dim, skipna=skipna)
  _same(got, j.quantile(q, dim, skipna=skipna))
  assert got.dims[0] == 'quantile' and got.dtype == torch.float32
  assert got.coord_values('quantile').dtype == np.float64
  fn = np.nanquantile if skipna else np.quantile
  with np.errstate(all='ignore'):
    want = fn(_data(1, nan).astype(np.float64), q, axis=DIMS.index(dim),
              method='linear')
  np.testing.assert_allclose(got.values, want, rtol=0, atol=ATOL,
                             equal_nan=True)


def test_quantile_scalar_q_custom_dim_and_int_data():
  t, j = _pair(_data(2, False))
  _same(t.quantile(0.3, 'time', quantile_dim='level'),
        j.quantile(0.3, 'time', quantile_dim='level'))
  ints = np.arange(24).reshape(4, 6)
  got = td.DimArray(ints, ('a', 'b')).quantile([0.25, 0.5], 'b')
  np.testing.assert_allclose(got.values,
                             np.quantile(ints, [0.25, 0.5], axis=1),
                             atol=ATOL)


def test_quantile_past_the_size_torch_quantile_refuses():
  """17.8 million elements, past what ``torch.quantile`` took for long:
  the sort form matches numpy's 'linear' method, with and without NaN
  members."""
  m, n = 5, 3_560_000
  assert m * n > 16_777_216
  rng = np.random.default_rng(3)
  x = rng.standard_normal((m, n), dtype=np.float32)
  q = [0.0, 0.1, 0.5, 0.9, 1.0]
  da = td.DimArray(x, ('number', 'point'))
  np.testing.assert_allclose(da.quantile(q, 'number').values,
                             np.quantile(x, q, axis=0, method='linear'),
                             rtol=0, atol=ATOL)
  x[rng.integers(0, m, n // 7), np.arange(0, n, 7)[:n // 7]] = np.nan
  x[:, 14] = np.nan
  got = td.DimArray(x, ('number', 'point')).quantile(q, 'number',
                                                     skipna=True).values
  assert got.shape == (5, n) and np.isnan(got[:, 14]).all()
  # np.nanquantile walks NaN-holding columns one by one: a strided sample.
  cols = np.arange(0, n, 1789)
  with np.errstate(all='ignore'):
    want = np.nanquantile(x[:, cols], q, axis=0, method='linear')
  np.testing.assert_allclose(got[:, cols], want, rtol=0, atol=ATOL,
                             equal_nan=True)
  loud = td.DimArray(x, ('number', 'point')).quantile(q, 'number').values
  assert np.isnan(loud[:, 0]).all() and not np.isnan(loud[:, 1]).any()


def test_reduce_over_an_empty_dim_list_is_a_noop():
  t, j = _pair()
  for method in ('sum', 'mean', 'std', 'var', 'min', 'max', 'any', 'all'):
    assert getattr(t, method)(()) is t, method
    assert getattr(j, method)(()) is j, method


def test_squeeze_drops_the_dim_of_a_coord_over_it():
  t, j = _pair()
  got = t.isel(longitude=slice(1, 2)).squeeze('longitude')
  want = j.isel(longitude=slice(1, 2)).squeeze('longitude')
  _same(got, want)
  assert got.coords['station'].dims == () and got.coords['mask'].dims == (
      'latitude',)
  assert str(got.coord_values('station')) == 'b'


# -- concat ---------------------------------------------------------------------


def _concat_parts(mod, device_coord=False, drop_in_second=False):
  def part(offset, flag):
    x = (np.arange(6, dtype=np.float32).reshape(2, 3) + offset)
    ok = np.full((2, 3), flag)
    coords = {'x': np.arange(2), 'y': np.arange(3) + 10,
              'label': ('x', np.array(['p', 'q'])),
              'ok': (('x', 'y'), (jnp.asarray(ok) if mod is jd
                                  else torch.from_numpy(ok))
                     if device_coord else ok)}
    return mod.DimArray(x, ('x', 'y'), coords)
  a, b = part(0, True), part(100, False)
  if drop_in_second:
    b = b.drop_coords('ok')
  return a, b


CONCAT_CASES = {
    'existing_dim': lambda m: m.concat(list(_concat_parts(m)), 'x'),
    'new_dim': lambda m: m.concat(list(_concat_parts(m)), 'size'),
    'transposed_part': lambda m: m.concat(
        [_concat_parts(m)[0], _concat_parts(m)[1].transpose('y', 'x')], 'y'),
    'identical_coords_stay': lambda m: m.concat(
        [_concat_parts(m)[0], _concat_parts(m)[0] * 2], 'size'),
    'differing_coords_stack': lambda m: m.concat(
        [p.expand_dims('size') for p in _concat_parts(m)], 'size'),
    'multi_size_parts_repeat': lambda m: m.concat(
        [m.concat([_concat_parts(m)[0].expand_dims('size')] * 2, 'size'),
         _concat_parts(m)[1].expand_dims('size')], 'size'),
    'missing_in_one_part': lambda m: m.concat(
        list(_concat_parts(m, drop_in_second=True)), 'size'),
    'device_coords_stack': lambda m: m.concat(
        list(_concat_parts(m, device_coord=True)), 'size'),
    'single_part': lambda m: m.concat([_concat_parts(m)[0]], 'size'),
}


@pytest.mark.parametrize('name', sorted(CONCAT_CASES))
def test_concat_matches_jax(name):
  _same(CONCAT_CASES[name](td), CONCAT_CASES[name](jd))


def test_concat_keeps_tensor_coords_as_tensors():
  got = CONCAT_CASES['device_coords_stack'](td)
  assert isinstance(got.coords['ok'].values, torch.Tensor)
  assert got.coords['ok'].dims == ('size', 'x', 'y')
  same = td.concat([_concat_parts(td, True)[0]] * 2, 'size')
  assert same.coords['ok'].dims == ('x', 'y')  # one object: kept once


# -- dot_batched and apply_ufunc ----------------------------------------------------


@pytest.mark.parametrize('n_stats', [1, 2, 5])
@pytest.mark.parametrize('reduce', [('latitude', 'longitude'), ('time',),
                                    DIMS])
def test_dot_batched_gives_the_list_of_dots(n_stats, reduce):
  rng = np.random.default_rng(n_stats)
  stats_t, stats_j = zip(*[
      _pair(_data(k, False)) for k in range(n_stats)])
  w = np.cos(np.deg2rad(COORDS['latitude'])).astype(np.float32)
  bins = rng.random((3, 4, 5)) > 0.4
  ops_t = [td.DimArray(w, ('latitude',)),
           td.DimArray(bins, ('region', 'latitude', 'longitude'),
                       {'region': np.array(['a', 'b', 'c'])})]
  ops_j = [jd.DimArray(w, ('latitude',)),
           jd.DimArray(bins, ('region', 'latitude', 'longitude'),
                       {'region': np.array(['a', 'b', 'c'])})]
  got = td.dot_batched(list(stats_t), *ops_t, dim=reduce)
  want = jd.dot_batched(list(stats_j), *ops_j, dim=reduce)
  assert len(got) == len(want) == n_stats
  for g, wnt, s in zip(got, want, stats_t):
    _same(g, wnt)
    one = td.dot(s, *ops_t, dim=reduce)
    np.testing.assert_allclose(g.values, one.values, rtol=1e-6, atol=1e-6)
    assert set(g.coords) == set(one.coords)


def test_dot_batched_refuses_mixed_layouts_and_takes_none():
  t, _ = _pair(_data(0, False))
  assert td.dot_batched([], dim='time') == []
  with pytest.raises(ValueError, match='identical dims/shape'):
    td.dot_batched([t, t.isel(time=slice(0, 2))], dim='time')


def test_apply_ufunc_core_dims_and_broadcast():
  t, j = _pair(_data(4, False))
  other = np.random.default_rng(5).standard_normal((5, 2)).astype(np.float32)
  to = td.DimArray(other, ('longitude', 'member'))
  jo = jd.DimArray(other, ('longitude', 'member'))
  got = td.apply_ufunc(
      lambda a, b: (a[..., :, None] * b).sum(-2), t, to,
      input_core_dims=[('longitude',), ('longitude', 'member')],
      output_core_dims=[('member',)])
  want = jd.apply_ufunc(
      lambda a, b: (a[..., :, None] * b).sum(-2), j, jo,
      input_core_dims=[('longitude',), ('longitude', 'member')],
      output_core_dims=[('member',)])
  _same(got, want)
  assert got.dims == ('time', 'latitude', 'member')
  _same(td.apply_ufunc(lambda a: a.mean(-1), t,
                       input_core_dims=[('time',)]),
        jd.apply_ufunc(lambda a: a.mean(-1), j, input_core_dims=[('time',)]))
  # Batch dims broadcast by name against an operand that lacks them.
  row = td.DimArray(np.arange(5, dtype=np.float32), ('longitude',))
  jrow = jd.DimArray(np.arange(5, dtype=np.float32), ('longitude',))
  _same(td.apply_ufunc(lambda a, b: a + b, t, row),
        jd.apply_ufunc(lambda a, b: a + b, j, jrow))


def test_size_property():
  t, j = _pair()
  assert t.size == j.size == 60
  assert td.DimArray(np.float32(1.0)).size == 1
