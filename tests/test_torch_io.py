"""The port's host I/O and bookkeeping against the JAX package, on the CPU.

The ``.npz`` container in both directions, ``AggregationState`` save/load,
the zero-filled outer join of ``combining_sum``, the atomic local file
I/O and ``time_chunks``.
"""

import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import aggregation as j_aggregation
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu import time_chunks as j_time_chunks
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import fileio
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import time_chunks

torch.set_num_threads(1)


def _dataset(mod, seed=0):
  """Float data with datetime64, timedelta64, string and 2-D coords."""
  rng = np.random.default_rng(seed)
  coords = {
      'init_time': np.array(['2020-01-01T00', '2020-01-01T12'],
                            dtype='datetime64[ns]'),
      'lead_time': np.array([0, 6, 12], dtype='timedelta64[h]').astype(
          'timedelta64[ns]'),
      'region': np.array(['global', 'tropics', 'extra-tropics']),
      'mask': mod.Coord(('lead_time', 'region'), rng.random((3, 3)) > 0.5),
  }
  dims = ('init_time', 'lead_time', 'region')
  return {
      't2m': mod.DimArray(rng.standard_normal((2, 3, 3)).astype(np.float32),
                          dims, coords),
      'count': mod.DimArray(np.arange(18, dtype=np.int64).reshape(2, 3, 3),
                            dims, coords),
      'scalar': mod.DimArray(np.float64(2.5)),
  }


def _host(values) -> np.ndarray:
  if isinstance(values, torch.Tensor):
    return values.numpy()
  return np.asarray(values)


def _assert_datasets_equal(got, want):
  assert list(got) == list(want)
  for k in want:
    assert got[k].dims == want[k].dims, k
    g, w = _host(got[k].data), _host(want[k].data)
    assert g.dtype == w.dtype, k
    np.testing.assert_array_equal(g, w, err_msg=k)
    assert list(got[k].coords) == list(want[k].coords), k
    for name, c in want[k].coords.items():
      gc = got[k].coords[name]
      assert gc.dims == c.dims, (k, name)
      gv, wv = _host(gc.values), _host(c.values)
      assert gv.dtype == wv.dtype, (k, name, gv.dtype, wv.dtype)
      np.testing.assert_array_equal(gv, wv, err_msg=f'{k}.{name}')


def test_npz_round_trip_keeps_time_and_string_coords(tmp_path):
  ds = _dataset(darray)
  path = str(tmp_path / 'ds.npz')
  io.save_dataset(path, ds)
  _assert_datasets_equal(io.load_dataset(path), ds)
  _assert_datasets_equal(io.loads_dataset(io.dumps_dataset(ds)), ds)


def test_npz_written_by_jax_reads_in_the_port(tmp_path):
  path = str(tmp_path / 'jax.npz')
  j_io.save_dataset(path, _dataset(j_darray))
  _assert_datasets_equal(io.load_dataset(path), _dataset(darray))


def test_npz_written_by_the_port_reads_in_jax(tmp_path):
  path = str(tmp_path / 'port.npz')
  io.save_dataset(path, _dataset(darray))
  _assert_datasets_equal(j_io.load_dataset(path), _dataset(j_darray))
  _assert_datasets_equal(
      j_io.loads_dataset(io.dumps_dataset(_dataset(darray))),
      _dataset(j_darray))


def test_bfloat16_is_written_widened():
  da = darray.DimArray(torch.tensor([1.5, -2.25], dtype=torch.bfloat16), 'x')
  got = io.loads_dataset(io.dumps_dataset({'v': da}))['v']
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.values, [1.5, -2.25])


@pytest.mark.parametrize('suffix', ['.wbx', '.zarr', '.nc'])
def test_unported_containers_raise(tmp_path, suffix):
  path = str(tmp_path / f'ds{suffix}')
  with pytest.raises(NotImplementedError, match='not ported'):
    io.save_dataset(path, _dataset(darray))
  with pytest.raises(NotImplementedError, match='not ported'):
    io.load_dataset(path)
  with pytest.raises(NotImplementedError, match='not ported'):
    fileio.save_dataset_atomic(path, _dataset(darray))
  assert os.listdir(tmp_path) == []


def _state(mod, seed, lead_hours=(0, 6)):
  rng = np.random.default_rng(seed)
  lead = np.array(lead_hours, dtype='timedelta64[h]').astype(
      'timedelta64[ns]')
  coords = {'lead_time': lead, 'region': np.array(['global', 'tropics'])}
  def leaf():
    return mod.DimArray(rng.random((len(lead), 2)), ('lead_time', 'region'),
                        coords)
  return mod.AggregationState({'SquaredError': {'t2m': leaf()}},
                              {'SquaredError': {'t2m': leaf()}})


def test_aggregation_state_save_load(tmp_path):
  state = _state(aggregation, 0)
  path = str(tmp_path / 'state.npz')
  state.save(path)
  loaded = aggregation.AggregationState.load(path)
  _assert_datasets_equal(loaded.to_dataset(), state.to_dataset())
  # A state saved by the JAX package loads in the port.
  j_path = str(tmp_path / 'jax_state.npz')
  _state(j_aggregation, 0).save(j_path)
  _assert_datasets_equal(aggregation.AggregationState.load(j_path).to_dataset(),
                         state.to_dataset())


@pytest.mark.parametrize('leads', [
    ((0, 6), (12, 18)),          # disjoint: concatenation
    ((0, 6, 12), (6, 12, 18)),   # overlapping
    ((6, 0), (12,)),             # unsorted, ragged
])
def test_outer_join_combining_sum_matches_jax(leads):
  states = [_state(aggregation, s, l) for s, l in enumerate(leads)]
  j_states = [_state(j_aggregation, s, l) for s, l in enumerate(leads)]
  got = aggregation.AggregationState.sum(states)
  want = j_aggregation.AggregationState.sum(j_states)
  _assert_datasets_equal(got.to_dataset(), want.to_dataset())
  union = np.unique(np.concatenate(
      [np.array(l, dtype='timedelta64[h]') for l in leads]))
  assert len(got.sum_weights['SquaredError']['t2m'].coords['lead_time']
             .values) == len(union)


def test_combining_sum_of_host_float64_stays_float64():
  a = darray.DimArray(np.array([0.1, 0.2]), 'x', {'x': [0, 1]})
  got = aggregation.combining_sum([a, a, a])
  assert got.dtype == torch.float64 and got.device.type == 'cpu'
  np.testing.assert_array_equal(got.values, a.values + a.values + a.values)


def test_outer_join_needs_coords_on_ragged_dims():
  a = darray.DimArray(np.ones(2), 'x')
  b = darray.DimArray(np.ones(3), 'x')
  with pytest.raises(ValueError, match='without coordinates'):
    aggregation.combining_sum([a, b])
  with pytest.raises(ValueError, match='different dims'):
    aggregation.combining_sum([a, darray.DimArray(np.ones(2), 'y')])


def test_atomic_writes_leave_no_temporaries(tmp_path):
  path = str(tmp_path / 'out.npz')
  fileio.save_dataset_atomic(path, _dataset(darray))
  fileio.write_text_atomic(str(tmp_path / 'm.json'), '{"a": 1}')
  assert sorted(os.listdir(tmp_path)) == ['m.json', 'out.npz']
  assert fileio.read_text(str(tmp_path / 'm.json')) == '{"a": 1}'
  assert fileio.exists(path)
  _assert_datasets_equal(fileio.load_dataset_any(path), _dataset(darray))


def test_remote_paths_raise():
  for fn, args in ((fileio.exists, ()), (fileio.read_text, ()),
                   (fileio.write_text_atomic, ('x',)),
                   (fileio.save_dataset_atomic, (_dataset(darray),)),
                   (fileio.load_dataset_any, ())):
    with pytest.raises(NotImplementedError, match='remote'):
      fn('gs://bucket/file.npz', *args)
  assert not fileio.is_remote('file:///tmp/x.npz')


def _init_times():
  return np.arange('2020-01-01T00', '2020-01-02T00', np.timedelta64(6, 'h'),
                   dtype='datetime64[h]')


LEADS = np.arange(0, 18, 6, dtype='timedelta64[h]')
SLICE = slice(np.timedelta64(0, 'h'), np.timedelta64(6, 'h'))


@pytest.mark.parametrize('lead_times,init_chunk,lead_chunk', [
    (LEADS, 2, 2), (LEADS, None, None), (LEADS, 3, 1), (LEADS, 1, None),
    (SLICE, 2, None), (SLICE, None, None)])
def test_time_chunks_enumerate_as_jax(lead_times, init_chunk, lead_chunk):
  got = time_chunks.TimeChunks(_init_times(), lead_times, init_chunk,
                               lead_chunk)
  want = j_time_chunks.TimeChunks(_init_times(), lead_times, init_chunk,
                                  lead_chunk)
  assert len(got) == len(want)
  for (go, (gi, gl)), (wo, (wi, wl)) in zip(got.iter_with_chunk_offsets(),
                                            want.iter_with_chunk_offsets()):
    assert (go.init_time, go.lead_time) == (wo.init_time, wo.lead_time)
    assert gi.dtype == wi.dtype == np.dtype('datetime64[ns]')
    np.testing.assert_array_equal(gi, wi)
    if isinstance(wl, slice):
      assert gl == wl
    else:
      assert gl.dtype == wl.dtype == np.dtype('timedelta64[ns]')
      np.testing.assert_array_equal(gl, wl)
  with pytest.raises(IndexError):
    got[len(got)]


@pytest.mark.parametrize('lead_times,kwargs', [
    (SLICE, {'lead_time_chunk_size': 2}),
    (slice(None, np.timedelta64(6, 'h')), {}),
    (slice(np.timedelta64(0, 'h'), np.timedelta64(6, 'h'),
           np.timedelta64(1, 'h')), {}),
    (LEADS, {'init_time_chunk_size': -1}),
    (LEADS, {'init_time_chunk_size': 0}),
    (list(LEADS), {}),
])
def test_time_chunks_reject_what_jax_rejects(lead_times, kwargs):
  with pytest.raises(ValueError):
    j_time_chunks.TimeChunks(_init_times(), lead_times, **kwargs)
  with pytest.raises(ValueError):
    time_chunks.TimeChunks(_init_times(), lead_times, **kwargs)
