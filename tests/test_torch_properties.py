"""Property-based tests (hypothesis) of the port: codec round trips, zarr
windows and DimArray semantics.

The properties of ``test_properties.py`` on the port's ``codecs``,
``zarr_io`` and ``DimArray``, at its ``max_examples=40, deadline=None``;
the codec properties also decode the port's output with the JAX
package's codecs.
"""

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip('hypothesis')
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from weatherbenchx_tpu import codecs as j_codecs  # noqa: E402
from weatherbenchx_tpu_torch import codecs, darray, zarr_io  # noqa: E402
from weatherbenchx_tpu_torch.darray import Coord, DimArray  # noqa: E402

_SETTINGS = dict(max_examples=40, deadline=None)

_DTYPES = [np.uint8, np.int16, np.float32, np.float64]


@settings(**_SETTINGS)
@given(
    n=st.integers(0, 70000),
    dtype_i=st.integers(0, len(_DTYPES) - 1),
    cname=st.sampled_from(['lz4', 'zstd', 'zlib']),
    shuffle=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_blosc_roundtrip_property(n, dtype_i, cname, shuffle, seed):
  dtype = np.dtype(_DTYPES[dtype_i])
  rng = np.random.default_rng(seed)
  # Mix of compressible (repeats) and incompressible (noise) content.
  raw = rng.integers(0, 8, n).astype(dtype).tobytes()
  chunk = codecs.blosc_compress(raw, dtype.itemsize, cname=cname,
                                shuffle=shuffle)
  assert bytes(codecs.blosc_decompress(chunk)) == raw
  assert bytes(j_codecs.blosc_decompress(chunk)) == raw


@settings(**_SETTINGS)
@given(
    codec=st.sampled_from([None, 'zlib', 'zstd', 'blosc']),
    n=st.integers(0, 30000),
    seed=st.integers(0, 2**31 - 1),
)
def test_cell_roundtrip_property(codec, n, seed):
  rng = np.random.default_rng(seed)
  raw = rng.standard_normal(n).astype(np.float32).tobytes()
  enc = codecs.encode_cell(raw, codec, 4)
  assert bytes(memoryview(codecs.decode_cell(enc, codec, len(raw)))) == raw
  assert bytes(memoryview(j_codecs.decode_cell(enc, codec, len(raw)))) == raw


@st.composite
def _window(draw, n):
  """A slice or integer-array indexer over an axis of length n."""
  kind = draw(st.integers(0, 2))
  if kind == 0:
    lo = draw(st.integers(0, n))
    hi = draw(st.integers(lo, n))
    step = draw(st.integers(1, 3))
    return slice(lo, hi, step)
  if kind == 1:
    return slice(None)
  k = draw(st.integers(1, max(n, 1)))
  return np.asarray(
      draw(st.lists(st.integers(0, n - 1), min_size=k, max_size=k)),
      np.intp)


@settings(**_SETTINGS)
@given(
    shape=st.tuples(st.integers(1, 9), st.integers(1, 7), st.integers(1, 8)),
    chunk0=st.integers(1, 9), chunk1=st.integers(1, 7),
    comp=st.sampled_from([None, 'zstd']),
    data=st.data(),
)
def test_zarr_window_matches_numpy(tmp_path_factory, shape, chunk0, chunk1,
                                   comp, data):
  arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
  da = DimArray(arr, ('a', 'b', 'c'), {
      'a': Coord(('a',), np.arange(shape[0])),
      'b': Coord(('b',), np.arange(shape[1])),
      'c': Coord(('c',), np.arange(shape[2]))})
  root = str(tmp_path_factory.mktemp('prop') / 'w.zarr')
  zarr_io.save_dataset_zarr(root, {'v': da},
                            chunks={'a': chunk0, 'b': chunk1},
                            compressor=comp)
  lazy = zarr_io.open_dataset_zarr(root)['v']
  assert lazy.is_lazy
  idx = tuple(data.draw(_window(n)) for n in shape)
  got = lazy._data.source.read(idx)
  expect = arr
  for axis, e in enumerate(idx):
    expect = expect[(slice(None),) * axis
                    + (e if isinstance(e, slice) else np.asarray(e),)]
  np.testing.assert_array_equal(got, expect)


# -- DimArray core semantics (named-axis arithmetic, reductions, dot) ---------

_DIM_POOL = ('a', 'b', 'c', 'd')


@st.composite
def _dimarray(draw, dims_from=_DIM_POOL, max_len=5):
  names = draw(st.permutations(dims_from))
  k = draw(st.integers(1, min(3, len(dims_from))))
  dims = tuple(names[:k])
  shape = tuple(draw(st.integers(1, max_len)) for _ in dims)
  seed = draw(st.integers(0, 2**31 - 1))
  return _normal_dimarray(dims, shape, seed)


def _normal_dimarray(dims, shape, seed) -> DimArray:
  """Standard normals in float32 from a seed, integer coords."""
  data = np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)
  coords = {d: Coord((d,), np.arange(n)) for d, n in zip(dims, shape)}
  return DimArray(data, dims, coords)


def _np(x: DimArray) -> np.ndarray:
  return x.data.numpy()


def _truncate_shared(x, y):
  for d in set(x.dims) & set(y.dims):
    m = min(x.sizes[d], y.sizes[d])
    x = x.isel({d: slice(0, m)})
    y = y.isel({d: slice(0, m)})
  return x, y


@settings(**_SETTINGS)
@given(x=_dimarray(), y=_dimarray())
def test_binary_op_broadcasts_by_name(x, y):
  """x + y broadcasts by dim name, whatever the axis orders (shared dims
  must agree in size: truncate)."""
  x, y = _truncate_shared(x, y)
  got = x + y
  out_dims = got.dims
  assert set(out_dims) == set(x.dims) | set(y.dims)
  xe = _np(x.transpose(*[d for d in out_dims if d in x.dims]))
  ye = _np(y.transpose(*[d for d in out_dims if d in y.dims]))
  xe = xe.reshape([x.sizes[d] if d in x.dims else 1 for d in out_dims])
  ye = ye.reshape([y.sizes[d] if d in y.dims else 1 for d in out_dims])
  np.testing.assert_allclose(_np(got), xe + ye, rtol=1e-6)


def _assert_mean_close(got: np.ndarray, x: np.ndarray, axis: int) -> None:
  """A float32 mean held to the float64 mean of the same float32 inputs,
  within rtol 1e-5 plus the float32 sum's error bound, n 2^-24 mean(|x|)
  over the reduced axis with n its terms. numpy's own float32 mean is not
  the reference: in a cancelling sum its rounding misses the exact mean
  as much as any other order does."""
  x64 = x.astype(np.float64)
  want = x64.mean(axis=axis)
  bound = x.shape[axis] * 2.0**-24 * np.abs(x64).mean(axis=axis)
  err = np.abs(got.astype(np.float64) - want)
  limit = 1e-5 * np.abs(want) + bound
  if not (err <= limit).all():
    raise AssertionError(f'mean off by {err.max():.3e}, beyond '
                         f'{limit[err > limit].min():.3e}')


# DIM_PICK % len(dims) is uniform over 1, 2 or 3 dims.
_DIM_PICK = st.integers(0, 5)


@settings(**_SETTINGS)
@given(x=_dimarray(), pick=_DIM_PICK)
# A draw that missed numpy's float32 mean (-1.866e-3) by 4.76e-8, beyond
# rtol 1e-5; 2.4e-8 from the float64 mean, within its bound of 3.6e-7.
@example(x=_normal_dimarray(('a', 'b', 'c'), (5, 5, 5), 104021), pick=0)
def test_reduce_then_transpose_matches_numpy(x, pick):
  dim = x.dims[pick % len(x.dims)]
  got = x.mean(dim)
  _assert_mean_close(_np(got), _np(x), x.dims.index(dim))
  assert dim not in got.dims


@settings(**_SETTINGS)
@given(x=_dimarray(), pick=_DIM_PICK, sign=st.sampled_from([-1.0, 1.0]))
def test_mean_check_refuses_twice_its_bound(x, pick, sign):
  """A mean moved by twice the check's limit fails the check."""
  axis = pick % len(x.dims)
  x32 = _np(x)
  x64 = x32.astype(np.float64)
  want = x64.mean(axis=axis)
  limit = 1e-5 * np.abs(want) + (x32.shape[axis] * 2.0**-24
                                 * np.abs(x64).mean(axis=axis))
  with pytest.raises(AssertionError, match='mean off by'):
    _assert_mean_close(want + sign * 2 * limit, x32, axis)


@settings(**_SETTINGS)
@given(x=_dimarray(), data=st.data())
def test_isel_sel_agree_on_integer_coords(x, data):
  dim = data.draw(st.sampled_from(x.dims))
  n = x.sizes[dim]
  idx = data.draw(st.lists(st.integers(0, n - 1), min_size=1, max_size=n))
  via_isel = x.isel({dim: np.asarray(idx, np.intp)})
  # Integer coords equal positions here, so label-sel must agree.
  via_sel = x.sel({dim: np.asarray(idx)})
  assert torch.equal(via_isel.data, via_sel.data)


@settings(**_SETTINGS)
@given(x=_dimarray(), y=_dimarray(), data=st.data())
def test_dot_matches_manual_sum(x, y, data):
  shared = sorted(set(x.dims) & set(y.dims))
  if not shared:
    return
  x, y = _truncate_shared(x, y)
  dim = data.draw(st.sampled_from(shared))
  got = darray.dot(x, y, dim=dim)
  expect = (x * y).sum(dim)
  np.testing.assert_allclose(_np(got.transpose(*expect.dims)), _np(expect),
                             rtol=1e-4, atol=1e-5)
