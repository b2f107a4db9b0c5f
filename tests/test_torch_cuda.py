"""The port's CUDA kernels on the card, against their plain versions; and
the benchmark path on the card: the device climatology gather against the
host gather, SEEPS against its CPU run, the resource planner's budget, and
the probabilistic CLI branch's fused-kernel launches.

Marked ``cuda``: these skip without an NVIDIA GPU. On a machine with one
(and without jax, which ``tests/conftest.py`` imports), run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package.
"""

import numpy as np
import pytest
import torch

from weatherbenchx_tpu_torch.ops import crps_pairwise

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  return torch.device('cuda')


def _rel(got, want):
  got, want = got.double(), want.double()
  assert torch.equal(torch.isnan(got), torch.isnan(want))
  ok = ~torch.isnan(want)
  return ((got[ok] - want[ok]).abs() / want[ok].abs().clamp(min=1)).max().item()


# The route boundaries: the network from 2 to 64 members, the sorted runs
# from 65 to 256 (two runs to 128, three to 192, four to 256), the block
# sort past 256 (300, 1,817 and HENS's 7,424 too).
@pytest.mark.parametrize('m,rest', [(2, (5,)), (3, (33,)), (21, (2, 3, 65)),
                                    (50, (1, 129)), (400, (40,)),
                                    (10, (3, 70)), (16, (3, 70)),
                                    (63, (2, 99)), (64, (2, 99)),
                                    (65, (2, 99)), (100, (2, 99)),
                                    (101, (2, 99)), (128, (2, 99)),
                                    (129, (2, 99)), (193, (2, 40)),
                                    (256, (2, 40)), (257, (2, 40)),
                                    (300, (2, 99)), (1817, (1, 70)),
                                    (7424, (1, 20))])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_kernels_match_plain(cuda, m, rest, dtype, tol):
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m,) + rest).astype(np.float32)
  x.reshape(m, -1)[m // 2, 0] = np.nan
  xd = torch.from_numpy(x).to(cuda, dtype)
  yd = torch.from_numpy(x[0].copy()).to(cuda, dtype)
  crps_pairwise.reset_launch_counts()
  got = crps_pairwise.fused_ensemble_stats(xd, yd) + (
      crps_pairwise.pairwise_spread_sum(xd),)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES == {'fused_ensemble_stats': 1,
                                    'pairwise_spread_sum': 1,
                                    'pairwise_cross_sum': 0}
  for g, w in zip(got, want):
    assert g.dtype == dtype and g.shape == rest
    assert _rel(g, w) <= tol
    assert torch.isnan(g.reshape(-1)[0])


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_every_register_kernel_matches_plain(cuda, dtype, tol):
  """Each M built, fused and spread-only, with a NaN member, a +inf and a
  -inf member at other points."""
  for m in crps_pairwise.REGISTER_MEMBERS:
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 300)).astype(np.float32)
    x[m // 2, 0] = np.nan
    x[0, 1] = np.inf
    x[m - 1, 2] = -np.inf
    xd = torch.from_numpy(x).to(cuda, dtype)
    yd = torch.from_numpy(rng.standard_normal(300).astype(np.float32)).to(
        cuda, dtype)
    got = crps_pairwise._launch_stats(xd, yd) + (
        crps_pairwise._launch_stats(xd, None),)
    want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
        crps_pairwise.pairwise_spread_sum_plain(xd),)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
      assert torch.equal(torch.isnan(g), torch.isnan(w)), m
      assert torch.equal(torch.isinf(g), torch.isinf(w)), m
      fin = torch.isfinite(w)
      assert _rel(g[fin], w[fin]) <= tol, m
      assert torch.isnan(g[0]), m


def _infinite_members(m):
  """(m, 7) columns by their numbers of +inf and -inf members: one +inf;
  one -inf; one of each; two +inf; m//2 + 1 +inf; m//2 + 1 -inf; m//2 + 2
  +inf (tests/test_torch_crps_pairwise.py holds these patterns to the JAX
  kernels)."""
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


@pytest.mark.parametrize('m', [2, 3, 10, 19, 20, 21, 49, 50, 64, 65, 100,
                               101, 256, 257, 300, 7424])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_infinite_members_match_plain(cuda, m, dtype):
  """Every kernel form gives the plain version's inf and NaN points, the
  JAX kernels' pattern at m (the sort body from 20 members, the pair body
  below)."""
  x = torch.from_numpy(_infinite_members(m)).to(cuda, dtype)
  y = torch.zeros(7, device=cuda, dtype=dtype)
  got = crps_pairwise._launch_stats(x, y)[0], crps_pairwise._launch_stats(
      x, None)
  want = crps_pairwise.pairwise_spread_sum_plain(x)
  torch.cuda.synchronize()
  for g in got:
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
      assert torch.equal(f(g), f(want)), (m, g, want)
  assert torch.isnan(want[6]) and torch.isposinf(want[:3]).all()


@pytest.mark.parametrize('m', [65, 101, 129, 193, 256, 257, 300, 1817])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_run_edges_match_plain(cuda, m, dtype, tol):
  """+inf, -inf and NaN members on both sides of the first runs' edge
  (past 256: of member 256), at the last member and beside the last run's
  +inf pads, fused and spread-only: the plain version's points."""
  edge = (crps_pairwise.sorted_runs(m)[1]
          if crps_pairwise.spread_form(m) == 'sorted'
          else crps_pairwise.SORTED_MAX_MEMBERS)
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, 300)).astype(np.float32)
  cols = [((edge - 1,), np.inf), ((edge,), np.inf),
          ((edge - 1, edge), np.inf), ((edge - 1,), -np.inf),
          ((edge,), -np.inf), ((m - 1,), np.inf), ((m - 1,), -np.inf),
          ((edge - 1,), np.nan), ((edge,), np.nan), ((m - 1,), np.nan)]
  for col, (rows, value) in enumerate(cols):
    x[list(rows), col] = value
  xd = torch.from_numpy(x).to(cuda, dtype)
  yd = torch.from_numpy(rng.standard_normal(300).astype(np.float32)).to(
      cuda, dtype)
  got = crps_pairwise._launch_stats(xd, yd) + (
      crps_pairwise._launch_stats(xd, None),)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  torch.cuda.synchronize()
  for g, w in zip(got, want):
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
      assert torch.equal(f(g), f(w)), (m, f.__name__)
    assert torch.isnan(g[7:10]).all()
    fin = torch.isfinite(w)
    assert _rel(g[fin], w[fin]) <= tol


@pytest.mark.parametrize('m', [65, 67, 100, 128, 129, 130, 192, 193, 205,
                               256, 257, 300, 1817, 7424, 58112])
@pytest.mark.parametrize('value', [np.inf, -np.inf])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_all_members_one_infinity_match_plain(cuda, m, value, dtype):
  """Points whose members are all one infinity, all but one finite member
  (in the first run, in the last), all but one of the other infinity, and
  m//2 + 2 at it: a merge walk toward that infinity exhausts a run and
  then meets only the infinity, and must read no row past the run's end.
  Fused and spread-only: the plain version's NaN points, the finite point
  within its tolerance."""
  edge = (crps_pairwise.sorted_runs(m)[1]
          if crps_pairwise.spread_form(m) == 'sorted'
          else crps_pairwise.SORTED_MAX_MEMBERS)
  rng = np.random.default_rng(m)
  x = rng.standard_normal((m, 300)).astype(np.float32)
  x[:, :4] = value
  x[0, 1] = 0.0
  x[m - 1, 2] = 0.0
  x[edge, 3] = -value
  x[:m // 2 + 2, 4] = value
  xd = torch.from_numpy(x).to(cuda, dtype)
  yd = torch.from_numpy(rng.standard_normal(300).astype(np.float32)).to(
      cuda, dtype)
  got = crps_pairwise._launch_stats(xd, yd) + (
      crps_pairwise._launch_stats(xd, None),)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  torch.cuda.synchronize()
  tol = 1e-5 if dtype == torch.float32 else 1e-2
  for g, w in zip(got, want):
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
      assert torch.equal(f(g), f(w)), (m, f.__name__)
    fin = torch.isfinite(w)
    assert _rel(g[fin], w[fin]) <= tol
  for spread in (got[0], got[4]):
    assert torch.isnan(spread[:5]).all() and torch.isfinite(spread[5:]).all()


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_every_run_size_matches_plain(cuda, dtype, tol):
  """Each sorted-runs kernel built (``SORTED_RUN_SIZES``), at every member
  count that takes it with two runs, three and four, near 288 K, with a
  NaN member and a +-inf member at other points."""
  for m in crps_pairwise.SORTED_MEMBERS:
    rng = np.random.default_rng(m)
    x = (288 + 3 * rng.standard_normal((m, 200))).astype(np.float32)
    x[m // 2, 0] = np.nan
    x[0, 1] = np.inf
    x[m - 1, 2] = -np.inf
    xd = torch.from_numpy(x).to(cuda, dtype)
    yd = torch.from_numpy(
        (288 + 3 * rng.standard_normal(200)).astype(np.float32)).to(
            cuda, dtype)
    crps_pairwise.reset_launch_counts()
    got = crps_pairwise.fused_ensemble_stats(xd, yd) + (
        crps_pairwise.pairwise_spread_sum(xd),)
    want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
        crps_pairwise.pairwise_spread_sum_plain(xd),)
    torch.cuda.synchronize()
    assert crps_pairwise.MEMBER_COUNTS['fused_ensemble_stats'] == {m}
    for g, w in zip(got, want):
      assert torch.equal(torch.isnan(g), torch.isnan(w)), m
      assert torch.equal(torch.isinf(g), torch.isinf(w)), m
      fin = torch.isfinite(w)
      assert _rel(g[fin], w[fin]) <= tol, m
      assert torch.isnan(g[0]), m


def test_native_io_builds_and_a_lazy_zarr_window_lands_on_the_card(
    cuda, tmp_path):
  """The native blockstore and zarr codec build on the card's machine; a
  chunk read lazily from a blosc zarr store and a sharded zstd v3 store
  through the loaders reaches the card equal to the in-memory store's."""
  from weatherbenchx_tpu_torch import native, zarr_io
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.data import loaders
  assert native.blockstore_available() and native.zarrcodec_available()
  rng = np.random.default_rng(5)
  valid = (np.datetime64('2020-01-01', 'ns')
           + np.arange(16) * np.timedelta64(6, 'h'))
  ds = {'t2m': DimArray(
      rng.standard_normal((16, 2, 33, 64)).astype(np.float32),
      ('time', 'level', 'latitude', 'longitude'),
      {'time': valid, 'level': np.array([500, 850]),
       'latitude': np.linspace(90, -90, 33),
       'longitude': np.arange(64) * 5.625})}
  inits = valid[:4]
  leads = np.array([0, 6], 'timedelta64[h]').astype('timedelta64[ns]')
  want = loaders.TargetsFromDataset(ds=ds).load_chunk(inits, leads)['t2m']
  for name, kwargs in (('v2.zarr', {'compressor': 'blosc'}),
                       ('v3.zarr', {'compressor': 'zstd', 'zarr_format': 3,
                                    'shards': {'time': 8}})):
    path = str(tmp_path / name)
    zarr_io.save_dataset_zarr(path, ds, chunks={'time': 1, 'level': 1},
                              **kwargs)
    native.reset_call_counts()
    chunk = loaders.TargetsFromDataset(path=path).load_chunk(inits, leads)
    assert native.CALLS['decode_ranges' if 'shards' in kwargs
                        else 'decode_cells'] > 0
    on_card = chunk['t2m'].data.to(cuda)
    assert torch.equal(on_card.cpu(), want.data)


def test_non_contiguous_input_and_empty_rest(cuda):
  x = torch.randn(6, 7, 5, device=cuda)
  xt = x.transpose(1, 2)  # the wrapper makes it contiguous
  got = crps_pairwise.pairwise_spread_sum(xt)
  want = crps_pairwise.pairwise_spread_sum_plain(xt)
  assert _rel(got, want) <= 1e-5
  assert crps_pairwise.pairwise_spread_sum(torch.randn(4, 0, device=cuda)
                                           ).shape == (0,)


def test_kernel_rejects_what_it_cannot_take(cuda):
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(3, 4, dtype=torch.float64,
                                                  device=cuda))
  with pytest.raises(ValueError, match='at least 2'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(1, 4, device=cuda))
  with pytest.raises(ValueError, match='at most'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(
        crps_pairwise.MAX_MEMBERS + 1, 2, device=cuda))
  with pytest.raises(ValueError, match='different devices'):
    crps_pairwise.fused_ensemble_stats(torch.zeros(3, 4, device=cuda),
                                       torch.zeros(4))


@pytest.mark.parametrize('mx,my,rest', [
    (1, 1, (5,)), (3, 5, (33,)), (8, 2, (2, 3, 65)), (50, 10, (1, 129)),
    (50, 50, (2, 300)),
    (64, 128, (70,)), (64, 129, (70,)),  # 8,192 pairs, and the tiled form
    (500, 600, (70,)),   # staged 500 rows: 64-thread blocks, 128 KB
    (2000, 3, (40,)),    # a large streamed ensemble needs no shared memory
    (1900, 2000, (40,)),  # staged 1,900 rows: two tiles of shared memory
])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cross_kernel_matches_plain(cuda, mx, my, rest, dtype, tol):
  rng = np.random.default_rng(mx + my)
  x = torch.from_numpy(rng.standard_normal((mx,) + rest).astype(np.float32))
  y = torch.from_numpy(rng.standard_normal((my,) + rest).astype(np.float32))
  xd, yd = x.to(cuda, dtype), y.to(cuda, dtype)
  crps_pairwise.reset_launch_counts()
  got = crps_pairwise.pairwise_cross_sum(xd, yd)
  want = crps_pairwise.pairwise_cross_sum_plain(xd, yd)
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES['pairwise_cross_sum'] == 1
  assert got.dtype == dtype and got.shape == rest
  assert _rel(got, want) <= tol


@pytest.mark.parametrize('side', ['x', 'y'])
def test_cross_kernel_nan_poisons_only_its_point(cuda, side):
  x = torch.randn(7, 3, 50, device=cuda)
  y = torch.randn(4, 3, 50, device=cuda)
  (x if side == 'x' else y)[2, 1, 17] = float('nan')
  got = crps_pairwise.pairwise_cross_sum(x, y)
  want = crps_pairwise.pairwise_cross_sum_plain(x, y)
  assert _rel(got, want) <= 1e-5
  assert torch.isnan(got).sum().item() == 1 and torch.isnan(got[1, 17])


def test_cross_kernel_one_dimensional_and_rejects(cuda):
  x, y = torch.randn(6, device=cuda), torch.randn(4, device=cuda)
  got = crps_pairwise.pairwise_cross_sum(x, y)
  assert got.shape == ()
  assert _rel(got, crps_pairwise.pairwise_cross_sum_plain(x, y)) <= 1e-5
  with pytest.raises(ValueError, match='at most'):
    crps_pairwise.pairwise_cross_sum(
        torch.zeros(crps_pairwise.MAX_MEMBERS + 1, 2, device=cuda),
        torch.zeros(3, 2, device=cuda))
  with pytest.raises(TypeError, match='float32 or bfloat16'):
    crps_pairwise.pairwise_cross_sum(x.double(), y.double())


# -- the deterministic benchmark path on the card ---------------------------------


def _doy_hour_climatology(seed=0, n_lat=9, n_lon=12):
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng(seed)
  return DimArray(
      rng.standard_normal((366, 4, 2, n_lat, n_lon)).astype(np.float32),
      ('dayofyear', 'hour', 'level', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
       'level': np.array([500, 850]), 'latitude': np.linspace(-90, 90, n_lat),
       'longitude': np.arange(n_lon) * 30.0})


def test_device_gather_equals_host_gather_bit_for_bit(cuda):
  from weatherbenchx_tpu_torch.metrics import base
  clim = _doy_hour_climatology()
  valid = (np.datetime64('2020-12-30', 'ns')
           + np.arange(12).reshape(3, 4) * np.timedelta64(6, 'h'))
  idx = base.climatology_alignment_indices(clim, valid)
  on_card = clim.copy(data=clim.data.to(cuda))
  dev_idx = {d: torch.as_tensor(i.astype(np.int32), device=cuda)
             for d, i in idx.items()}
  got = base.gather_climatology(on_card, dev_idx, ('init_time', 'lead_time'))
  want = base.gather_climatology_host(clim, idx, ('init_time', 'lead_time'))
  assert got.data.device.type == 'cuda'
  assert got.dims == want.dims and sorted(got.coords) == sorted(want.coords)
  assert torch.equal(got.data.cpu(), want.data)


def _seeps_inputs(seed=1):
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  rng = np.random.default_rng(seed)
  inits = (np.datetime64('2020-01-01', 'ns')
           + np.arange(2) * np.timedelta64(12, 'h'))
  leads = (np.arange(4) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
  space = {'latitude': np.linspace(-90, 90, 33),
           'longitude': np.arange(64) * 5.625}
  shape = (2, 4, 33, 64)
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  p = np.abs(rng.standard_normal(shape)).astype(np.float32) * 2e-3
  t = np.abs(rng.standard_normal(shape)).astype(np.float32) * 2e-3
  p[0, 0, :4, :4] = np.nan
  valid = Coord(('init_time', 'lead_time'), inits[:, None] + leads[None, :])
  coords = {'init_time': inits, 'lead_time': leads, **space}
  cshape = (3, 4, 33, 64)
  cdims = ('dayofyear', 'hour', 'latitude', 'longitude')
  ccoords = {'dayofyear': np.arange(1, 4), 'hour': np.array([0, 6, 12, 18]),
             **space}
  thr = (1.5e-3 + 2e-4 * rng.standard_normal(cshape)).astype(np.float32)
  thr[:, :, 5] = np.nan
  clim = {'tp_seeps_threshold': DimArray(thr, cdims, ccoords),
          'tp_seeps_dry_fraction': DimArray(
              rng.uniform(0.05, 0.95, cshape).astype(np.float32), cdims,
              ccoords)}
  return ({'tp': DimArray(p, dims, coords)},
          {'tp': DimArray(t, dims, dict(coords, valid_time=valid))}, clim)


def test_seeps_on_the_card_equals_its_cpu_run(cuda):
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.metrics import base, categorical
  from weatherbenchx_tpu_torch.parallel import evaluator
  p, t, clim = _seeps_inputs()
  metrics = {'seeps': categorical.SEEPS(['tp'], clim)}
  want = metrics['seeps'].compute(p, t)['tp']
  ev = evaluator.ChunkEvaluator(
      metrics, aggregation.Aggregator(reduce_dims=['latitude']), device=cuda)
  dp, dt = ev.prepare_pair(p, t)
  with base.device_resources(ev.resources()):
    got = metrics['seeps'].compute(dp, dt)['tp']
  assert got.data.device.type == 'cuda'
  g, w = got.data.cpu(), want.data
  assert torch.equal(torch.isnan(g), torch.isnan(w))
  assert torch.equal(g.nan_to_num(), w.nan_to_num())
  assert torch.equal(got.coords['mask'].values.cpu(),
                     torch.as_tensor(want.coords['mask'].values))


def test_planner_budget_comes_from_mem_get_info(cuda, monkeypatch):
  from weatherbenchx_tpu_torch.parallel import evaluator
  monkeypatch.delenv('WBX_RESOURCE_BYTES', raising=False)
  free, _ = torch.cuda.mem_get_info(cuda)
  budget = evaluator._resource_budget_bytes(cuda)
  assert budget == pytest.approx(evaluator._RESOURCE_SHARE * free, rel=0.01)
  monkeypatch.setenv('WBX_RESOURCE_BYTES', '12345')
  assert evaluator._resource_budget_bytes(cuda) == 12345


def test_probabilistic_cli_launches_the_fused_kernel(cuda, tmp_path):
  from weatherbenchx_tpu_torch import io
  from weatherbenchx_tpu_torch.apps import run_benchmark_evaluation as cli
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng(3)
  inits = np.arange('2020-01-01', '2020-01-03', np.timedelta64(12, 'h'),
                    dtype='datetime64[ns]')
  leads = np.arange(0, 24, 6, dtype='timedelta64[h]').astype('timedelta64[ns]')
  valid = np.arange('2020-01-01', '2020-01-04', np.timedelta64(6, 'h'),
                    dtype='datetime64[ns]')
  space = {'latitude': np.linspace(-90, 90, 32),
           'longitude': np.arange(64) * 5.625}
  io.save_dataset(str(tmp_path / 'ens.npz'), {'2m_temperature': DimArray(
      rng.standard_normal((8, len(inits), len(leads), 32, 64)).astype(
          np.float32),
      ('number', 'time', 'prediction_timedelta', 'latitude', 'longitude'),
      {'number': np.arange(8), 'time': inits, 'prediction_timedelta': leads,
       **space})})
  io.save_dataset(str(tmp_path / 'era5.npz'), {'2m_temperature': DimArray(
      rng.standard_normal((len(valid), 32, 64)).astype(np.float32),
      ('time', 'latitude', 'longitude'), {'time': valid, **space})})
  crps_pairwise.reset_launch_counts()
  cli.main(['--prediction=ens', f'--prediction_path={tmp_path}/ens.npz',
            f'--target_path={tmp_path}/era5.npz', '--lead_time_stop_days=1',
            '--init_time_start=2020-01-01', '--init_time_stop=2020-01-03',
            '--variables=2m_temperature', f'--output_dir={tmp_path}/out',
            '--device=cuda'])
  n_chunks = len(inits)  # one init per chunk, all 4 leads in one
  assert crps_pairwise.LAUNCHES['fused_ensemble_stats'] >= n_chunks
  out = io.load_dataset(
      f'{tmp_path}/out/ens_vs_era5_64x32_2020-init12h.npz')
  crps = out['crps.2m_temperature']
  glob = crps.values[:, list(crps.coord_values('region')).index('global')]
  assert np.isfinite(glob).all() and abs(glob.mean() - 0.5642) < 0.05


# -- ensembles past one shared-memory tile, and the metric families on the card --


def _tiled_inputs(cuda, m, n=80):
  from weatherbenchx_tpu_torch.darray import DimArray
  rng = np.random.default_rng(m)
  x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
  y = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
  yt = torch.from_numpy(rng.standard_normal((m + 2, n)).astype(np.float32))
  x[m // 3, 5] = float('nan')
  das = ({'v': DimArray(x.to(cuda), ('number', 'point'))},
         {'v': DimArray(y.to(cuda), ('point',))},
         {'v': DimArray(yt.to(cuda), ('number', 'point'))})
  return das, tuple(t.to(cuda, torch.float64) for t in (x, y, yt))


def _pair_sum_f64(a, b):
  """sum_{i,j} |a_i - b_j| per point by the float64 broadcast, as many
  points at a time as keep it near 2 GB."""
  step = max(1, 2 ** 28 // (a.shape[0] * b.shape[0]))
  return torch.cat([
      (a[:, None, lo:lo + step] - b[None, :, lo:lo + step]).abs().sum((0, 1))
      for lo in range(0, a.shape[1], step)])


# The block sort's edges: its first count, both sides of the first change
# of gridpoints per block (512 and 513), and HENS's 7,424.
@pytest.mark.parametrize('m', [257, 512, 513, 7424])
@pytest.mark.parametrize('route', ['fused', 'spread', 'cross'])
def test_ensembles_past_one_tile_launch_the_kernels(cuda, route, m):
  """Past 256 members the fused and spread-only kernels sort each point's
  members in a block; the cross sum against m + 2 members takes its tiled
  form (one tile to 1,816 members, five at 7,424). Through the metrics,
  at the block sort's edges, every size launches its kernel and gives the
  float64 broadcast's values within 1e-5."""
  from weatherbenchx_tpu_torch.metrics import base, probabilistic
  points = crps_pairwise.blocksort_config(m)[0]
  assert crps_pairwise.spread_form(m) == 'blocksort'
  assert crps_pairwise.member_tiles(m) == {257: 1, 512: 1, 513: 1, 7424: 5}[m]
  assert points == {257: 32, 512: 32, 513: 16, 7424: 2}[m]
  (preds, tgts, ens_tgts), (xd, yd, ytd) = _tiled_inputs(cuda, m)
  crps_pairwise.reset_launch_counts()
  if route == 'fused':
    with base.computation_cache():
      got = {'skill': probabilistic.CRPSSkill().compute(preds, tgts)['v'],
             'spread': probabilistic.CRPSSpread().compute(preds, tgts)['v'],
             'umse': probabilistic.UnbiasedEnsembleMeanSquaredError().compute(
                 preds, tgts)['v']}
    mean = xd.mean(0)
    want = {'skill': (xd - yd).abs().mean(0),
            'spread': _pair_sum_f64(xd, xd) / (m * (m - 1)),
            'umse': (mean - yd) ** 2 - xd.var(0, correction=1) / m}
    launched = {'fused_ensemble_stats': 1}
  elif route == 'spread':
    got = {'spread': probabilistic.CRPSSpread().compute(preds, tgts)['v'],
           'unfair': probabilistic.CRPSSpread(fair=False).compute(
               preds, tgts)['v']}
    total = _pair_sum_f64(xd, xd)
    want = {'spread': total / (m * (m - 1)), 'unfair': total / (m * m)}
    launched = {'pairwise_spread_sum': 2}
  else:
    got = {'cross': probabilistic.CRPSSkill().compute(preds, ens_tgts)['v'],
           'swapped': probabilistic.CRPSSkill().compute(ens_tgts, preds)['v']}
    total = _pair_sum_f64(xd, ytd)
    want = {'cross': total / (m * (m + 2)), 'swapped': total / (m * (m + 2))}
    launched = {'pairwise_cross_sum': 2}
  torch.cuda.synchronize()
  assert {k: v for k, v in crps_pairwise.LAUNCHES.items() if v} == launched
  for name, da in got.items():
    assert da.device.type == 'cuda' and da.dtype == torch.float32
    assert _rel(da.data, want[name]) <= 1e-5, name
    assert torch.isnan(da.data[5]) and torch.isnan(da.data).sum() == 1


@pytest.mark.parametrize('m', [1817 + 370, 58113])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_tiled_kernels_match_plain_with_infinities(cuda, m, dtype, tol):
  """+-inf and NaN members about member 1,816 (a run's edge of the block
  sort) and in a ragged last run, on the block sort (2,187 members) and
  past one point's capacity on the merge sort (58,113, four runs): the
  plain version's points."""
  n = 70
  rng = np.random.default_rng(3)
  x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
  y = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
  x[3, 0] = x[2000, 1] = float('inf')
  x[1815, 2] = x[1816, 2] = float('-inf')
  x[5, 3], x[2100, 3] = float('inf'), float('-inf')
  x[2186, 4] = float('nan')
  xd, yd = x.to(cuda, dtype), y.to(cuda, dtype)
  got = crps_pairwise.fused_ensemble_stats(xd, yd) + (
      crps_pairwise.pairwise_spread_sum(xd),)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  for g, w in zip(got, want):
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.equal(torch.isinf(g), torch.isinf(w))
    finite = torch.isfinite(w)
    assert _rel(g[finite], w[finite]) <= tol


@pytest.mark.parametrize('m', [257, 300, 7424])
def test_block_sort_two_launches_give_equal_bits(cuda, m):
  """No atomics and a fixed order of addition: the fused and spread-only
  block sorts, and the cross kernel beside them, give the same bits on the
  same input."""
  rng = np.random.default_rng(m)
  x = torch.from_numpy(rng.standard_normal((m, 999)).astype(np.float32)).to(
      cuda)
  y = torch.from_numpy(rng.standard_normal(999).astype(np.float32)).to(cuda)
  yt = torch.from_numpy(rng.standard_normal((m + 5, 999)).astype(
      np.float32)).to(cuda)
  for run in (lambda: crps_pairwise.fused_ensemble_stats(x, y),
              lambda: (crps_pairwise.pairwise_spread_sum(x),),
              lambda: (crps_pairwise.pairwise_cross_sum(x, yt),)):
    first, again = run(), run()
    for a, b in zip(first, again):
      assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize('m', [257, 1817, 58113])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_block_sort_ties_and_signed_zeros_match_plain(cuda, m, dtype, tol):
  """Members quantized to 0.5 (many ties), all +-0.0 mixed, all -0.0 but
  one, and a NaN at the first shared stage's half: the plain version's
  values and points."""
  rng = np.random.default_rng(m)
  x = (np.round(2 * rng.standard_normal((m, 200))) / 2).astype(np.float32)
  x[:, 1] = np.where(rng.random(m) < 0.5, np.float32(-0.0), np.float32(0.0))
  x[:, 2] = np.float32(-0.0)
  x[m // 3, 2] = 1.5
  x[1 << ((m - 1).bit_length() - 1), 3] = np.nan
  xd = torch.from_numpy(x).to(cuda, dtype)
  yd = torch.from_numpy(rng.standard_normal(200).astype(np.float32)).to(
      cuda, dtype)
  got = crps_pairwise._launch_stats(xd, yd) + (
      crps_pairwise._launch_stats(xd, None),)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  torch.cuda.synchronize()
  for g, w in zip(got, want):
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    fin = torch.isfinite(w)
    assert _rel(g[fin], w[fin]) <= tol
  assert got[0][1] == 0
  if dtype == torch.float32:  # exact in float32, not in bfloat16
    assert got[4][2] == 2 * 1.5 * (m - 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cross_of_two_large_ensembles_edge_values_match_plain(cuda, dtype):
  """Two ensembles past 8,192 pairs (the cross kernel's tiled form): NaN
  on either side; +inf on both sides (or -inf on both), NaN as the pair
  loop's |inf - inf|; other infinities +inf; ties between the ensembles
  and signed zeros: the plain version's points."""
  mx, my = 170, 166
  rng = np.random.default_rng(11)
  x = (np.round(2 * rng.standard_normal((mx, 40))) / 2).astype(np.float32)
  y = (np.round(2 * rng.standard_normal((my, 40))) / 2).astype(np.float32)
  x[5, 0] = np.nan
  y[my - 1, 1] = np.nan
  x[0, 2], y[3, 2] = np.inf, np.inf
  x[mx - 1, 3], y[0, 3] = -np.inf, -np.inf
  x[7, 4], y[7, 4] = np.inf, -np.inf
  x[:, 5] = np.inf
  y[9, 6] = -np.inf
  x[:, 7], y[:, 7] = np.float32(-0.0), np.float32(0.0)
  xd, yd = (torch.from_numpy(a).to(cuda, dtype) for a in (x, y))
  got = crps_pairwise.pairwise_cross_sum(xd, yd)
  want = crps_pairwise.pairwise_cross_sum_plain(xd, yd)
  for f in (torch.isnan, torch.isposinf, torch.isneginf):
    assert torch.equal(f(got), f(want))
  assert torch.isnan(got[:4]).all() and torch.isposinf(got[4:7]).all()
  fin = torch.isfinite(want)
  assert _rel(got[fin], want[fin]) <= (1e-5 if dtype == torch.float32
                                       else 1e-2)


_FAMILY_GRID = (1, 4, 73, 144)


def _family_states(name, device):
  """The family's state and values on ``device``, through the evaluator."""
  from weatherbenchx_tpu_torch import bench_families
  from weatherbenchx_tpu_torch.parallel import evaluator
  metrics, aggregator, preds, tgts = bench_families.family_case(
      name, 3, _FAMILY_GRID)
  ev = evaluator.ChunkEvaluator(metrics, aggregator, device=device)
  state = ev.eval_chunk(preds, tgts)
  return state, ev.eval_chunk(preds, tgts), state.metric_values(metrics)


@pytest.mark.parametrize('name', ['fss', 'rank_histogram', 'rev', 'binnings'])
def test_family_on_the_card_matches_the_cpu(cuda, name):
  crps_pairwise.reset_launch_counts()
  state, again, values = _family_states(name, 'cuda')
  _, _, want = _family_states(name, 'cpu')
  assert not any(crps_pairwise.LAUNCHES.values())
  for key, da in state.to_dataset().items():
    assert da.device.type == 'cuda', key
    assert torch.equal(da.data, again.to_dataset()[key].data), key
  assert set(values) == set(want)
  for key, da in values.items():
    assert da.dims == want[key].dims
    assert _rel(da.data.cpu(), want[key].data) <= 1e-5, key


def test_rank_histogram_is_deterministic_on_the_card(cuda):
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.metrics import probabilistic
  rng = np.random.default_rng(4)
  x = torch.from_numpy(rng.standard_normal((50, 4, 181, 360)).astype(
      np.float32)).to(cuda)
  y = torch.from_numpy(rng.standard_normal((4, 181, 360)).astype(
      np.float32)).to(cuda)
  y[0, 0, 0] = float('nan')
  p = {'v': DimArray(x, ('number', 'lead_time', 'latitude', 'longitude'))}
  t = {'v': DimArray(y, ('lead_time', 'latitude', 'longitude'))}
  first = probabilistic.RankHistogram().compute(p, t)['v']
  second = probabilistic.RankHistogram().compute(p, t)['v']
  assert first.device.type == 'cuda' and first.sizes['rank'] == 51
  both_nan = torch.isnan(first.data) & torch.isnan(second.data)
  assert torch.equal(first.data[~both_nan], second.data[~both_nan])
  assert int(both_nan.sum()) == 51
  counts = torch.nansum(first.data, dim=(0, 1, 2))
  assert counts.sum().item() == 4 * 181 * 360 - 1
  want = torch.bincount((x < y).sum(0).reshape(-1)[1:], minlength=51)
  assert torch.equal(counts.long(), want)


@pytest.mark.parametrize('skipna', [False, True])
def test_quantile_on_the_card(cuda, skipna):
  """Past 16,777,216 elements, on a CUDA tensor, against numpy's 'linear'
  method on a sample of columns."""
  from weatherbenchx_tpu_torch.darray import DimArray
  m, n = 10, 2_000_000
  rng = np.random.default_rng(5)
  x = rng.standard_normal((m, n)).astype(np.float32)
  x[3, ::11] = np.nan
  x[:, 22] = np.nan
  q = [0.0, 0.1, 0.5, 0.9, 1.0]
  got = DimArray(torch.from_numpy(x).to(cuda), ('number', 'point')).quantile(
      q, 'number', skipna=skipna)
  assert got.device.type == 'cuda' and got.dims == ('quantile', 'point')
  assert got.dtype == torch.float32
  cols = np.arange(0, n, 997)
  fn = np.nanquantile if skipna else np.quantile
  with np.errstate(all='ignore'):
    want = fn(x[:, cols].astype(np.float64), q, axis=0, method='linear')
  np.testing.assert_allclose(got.data[:, cols].cpu().numpy(), want, rtol=0,
                             atol=1e-5, equal_nan=True)


def test_fair_ensemble_rps_takes_the_fused_kernel(cuda):
  """Inside a compute pass the fair ranked probability score's inner
  statistic, the unbiased ensemble-mean squared error, launches the fused
  kernel on the CDF indicators; the value is the plain form's."""
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.metrics import base, probabilistic
  rng = np.random.default_rng(6)
  x = rng.standard_normal((12, 3, 500)).astype(np.float32)
  y = rng.standard_normal((3, 500)).astype(np.float32)

  def run(device):
    p = {'v': DimArray(torch.from_numpy(x).to(device),
                       ('number', 'lead_time', 'point'))}
    t = {'v': DimArray(torch.from_numpy(y).to(device),
                       ('lead_time', 'point'))}
    stat = probabilistic.EnsembleRankedProbabilityScore(
        [-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0], 'bin', 'three')
    with base.computation_cache():
      return stat.compute(p, t)['v']
  crps_pairwise.reset_launch_counts()
  got = run('cuda')
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES['fused_ensemble_stats'] >= 1
  assert _rel(got.data.cpu(), run('cpu').data) <= 1e-5


def test_fused_kernel_on_a_nan_padded_station_layout(cuda):
  """Fair CRPS at stations: the fused kernel over (members, init, lead,
  index) with the padded rows NaN, against its plain version; padded rows
  stay NaN and real rows agree to 1e-5."""
  rng = np.random.default_rng(12)
  n, pad = 1000, 24  # padded to a multiple of 1024
  x = rng.standard_normal((50, 1, 4, n + pad)).astype(np.float32)
  y = rng.standard_normal((1, 4, n + pad)).astype(np.float32)
  x[..., n:] = np.nan
  y[..., n:] = np.nan
  xd, yd = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
  crps_pairwise.reset_launch_counts()
  got = crps_pairwise.fused_ensemble_stats(xd, yd)
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd)
  assert crps_pairwise.LAUNCHES['fused_ensemble_stats'] == 1
  for g, w in zip(got, want):
    assert torch.isnan(g[..., n:]).all()
    assert _rel(g, w) < 1e-5


def test_inference_on_a_cuda_state_matches_the_cpu(cuda):
  """t-tests, bootstraps and the delta method on a state on the card:
  float64 on the card, equal to the same calls on the CPU to 1e-9."""
  from weatherbenchx_tpu_torch.aggregation import AggregationState
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  from weatherbenchx_tpu_torch.inference import bootstrap, t_test
  from weatherbenchx_tpu_torch.metrics import deterministic

  rng = np.random.default_rng(13)
  n = 60
  inits = (np.datetime64('2020-01-01', 'ns')
           + np.arange(n) * np.timedelta64(12, 'h'))
  coords = {'init_time': inits, 'lead_time': np.arange(3),
            'day': Coord(('init_time',), inits.astype('datetime64[D]'))}
  dims = ('init_time', 'lead_time')
  err = rng.standard_normal((n, 3)) + 0.3
  w = np.full((n, 3), 10.0)

  def state(device):
    def da(v):
      return DimArray(torch.from_numpy(v.astype(np.float32)).to(device),
                      dims, coords)
    return AggregationState(
        {'SquaredError': {'t': da(err ** 2 * 10)},
         'Error': {'t': da(err * 10)}},
        {'SquaredError': {'t': da(w)}, 'Error': {'t': da(w)}})

  metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
  methods = {
      'iid': lambda s: t_test.IID(metrics, s, 'init_time'),
      'hac': lambda s: t_test.LazarusHACEWC(metrics, s, 'init_time'),
      'iid_bootstrap': lambda s: bootstrap.IIDBootstrap(
          metrics, s, 'init_time', n_replicates=300, seed=1),
      'cluster': lambda s: bootstrap.ClusterBootstrap(
          metrics, s, 'day', n_replicates=300, seed=2),
  }
  for name, make in methods.items():
    on_card, on_cpu = make(state(cuda)), make(state('cpu'))
    for fn in ('point_estimates', 'standard_error_estimates', 'p_values'):
      got, want = getattr(on_card, fn)(), getattr(on_cpu, fn)()
      for m in want:
        g = got[m]['t']
        assert g.device.type == 'cuda' and g.dtype == torch.float64, name
        np.testing.assert_allclose(g.values, want[m]['t'].values,
                                   rtol=1e-9, atol=1e-12,
                                   err_msg=f'{name} {fn} {m}')


def _ensemble_chunks(n_chunks=3, members=50, shape=(2, 91, 180)):
  """Host-prepared 50-member chunks (one init each) and an evaluator of
  fair CRPS and ensemble-mean RMSE over two regions."""
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.metrics import probabilistic
  from weatherbenchx_tpu_torch.parallel import evaluator
  rng = np.random.default_rng(15)
  lat = np.linspace(-90, 90, shape[1])
  lon = np.linspace(0, 360, shape[2], endpoint=False)
  lead = (np.arange(shape[0]) * np.timedelta64(6, 'h')).astype(
      'timedelta64[ns]')
  pairs = []
  for k in range(n_chunks):
    init = np.array([np.datetime64('2020-01-01', 'ns')
                     + k * np.timedelta64(12, 'h')])
    coords = {'init_time': init, 'lead_time': lead, 'latitude': lat,
              'longitude': lon}
    dims = ('init_time', 'lead_time', 'latitude', 'longitude')
    x = rng.standard_normal((members, 1) + shape).astype(np.float32)
    y = rng.standard_normal((1,) + shape).astype(np.float32)
    pairs.append(({'t': DimArray(x, ('number',) + dims,
                                 {**coords, 'number': np.arange(members)})},
                  {'t': DimArray(y, dims, coords)}))
  ev = evaluator.ChunkEvaluator(
      {'crps': probabilistic.CRPSEnsemble(),
       'mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE()},
      aggregation.Aggregator(
          reduce_dims=['latitude', 'longitude'],
          weigh_by=[weighting.GridAreaWeighting()],
          bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                                   'tropics': ((-30, 30), (0, 360))})]),
      'cuda')
  return ev, pairs


def test_batched_dispatch_launches_the_fused_kernel_once(cuda):
  ev, pairs = _ensemble_chunks()
  crps_pairwise.reset_launch_counts()
  states = ev.eval_prepared(pairs)
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES['fused_ensemble_stats'] == 1
  assert ev.dispatches == 1 and ev.signature_splits == 0
  for pair, state in zip(pairs, states):
    want = ev.eval_host_prepared(*pair).to_dataset()
    got = state.to_dataset()
    assert sorted(got) == sorted(want)
    for k in want:
      assert got[k].dims == want[k].dims, k
      np.testing.assert_array_equal(got[k].coord_values('init_time'),
                                    want[k].coord_values('init_time'))
      assert _rel(got[k].data, want[k].data) < 1e-5, k
  assert crps_pairwise.LAUNCHES['fused_ensemble_stats'] == 4


def test_profiled_cuda_run_names_the_fused_kernel(cuda, tmp_path):
  from weatherbenchx_tpu_torch import observability
  ev, pairs = _ensemble_chunks(n_chunks=2)
  ev.eval_prepared(pairs)  # the library built and the operands cached
  torch.cuda.synchronize()
  with observability.maybe_profile(str(tmp_path), cuda):
    ev.eval_prepared(pairs)
    torch.cuda.synchronize()
  summary = observability.trace_summary(str(tmp_path))
  assert summary['ranges']['wbx.fused_ensemble_stats'] == 1
  for name in ev._stat_names:
    assert summary['ranges'][f'wbx.statistic.{name}'] == 1, name
  assert summary['kernels'] > 0 and summary['busy_seconds'] > 0
  # CUPTI records the ctypes-launched kernel too.
  assert sum(n for name, n in summary['kernel_names'].items()
             if 'register_stats_kernel' in name) == 1


def test_two_ranks_sharing_the_card_with_longitude_sharded(cuda):
  """2 gloo ranks on the card (NCCL refuses two ranks on one GPU), each
  with half the longitudes: every rank's total equals one rank's, and
  each launched the fused kernel once per chunk on its half."""
  import os
  import torch_rank_cases as cases
  from weatherbenchx_tpu_torch import multichip
  path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_rank_cases.py')
  ranks = multichip.run_ranks(f'{path}:case_cuda_longitude', 2,
                              timeout_s=300.0)
  want, launches = cases.cuda_case_values(cases.port())
  _, _, inits, _ = cases.cuda_case_inputs()
  assert launches == len(inits) // 2
  for values, rank_launches in ranks:
    assert rank_launches == launches
    assert set(values) == set(want)
    for k, (dims, v) in want.items():
      assert values[k][0] == dims
      np.testing.assert_allclose(values[k][1], v, rtol=1e-5, atol=1e-6,
                                 err_msg=k)


@pytest.mark.parametrize('family', ['config', 'wrappers', 'spatial_rank',
                                    'seeps', 'large_k', 'time_bins',
                                    'sparse', 'dispatch', 'inference',
                                    'large_members'])
def test_parity_fuzz_on_the_card_matches_the_cpu(cuda, family):
  """Ten seeds of a fuzz family on the card, each held to its CPU run (the
  large-K family to float64, large_members to float64 too); the ensemble
  configs launch their kernels."""
  from weatherbenchx_tpu_torch import parity_fuzz
  failures = []
  if family == 'large_k':
    report = parity_fuzz.fuzz_large_k(range(2), cuda, failures)
    assert report['max_error'] <= parity_fuzz.LARGE_K_LIMIT
  else:
    report = parity_fuzz.fuzz_family(family, range(10), cuda, failures)
  assert not failures, failures
  if family == 'config':
    assert report['launches']['fused_ensemble_stats'] > 0
    assert report['launches']['pairwise_cross_sum'] > 0
  if family == 'large_members':
    assert report['launches']['fused_ensemble_stats'] > 0
    assert report['max_gap_float64'] <= 1e-3


# -- the merge sort past one point's block sort (58,113..2^20 members) -------


@pytest.mark.parametrize('m,n', [(58113, 40), (59392, 40), (115712, 24),
                                 (115713, 24), (1 << 20, 12)])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_mergesort_edges_match_plain(cuda, m, n, dtype, tol):
  """58,113, phase 4d's 59,392, both sides of the change from 4 to 8 runs
  and 2^20: +-inf and NaN members on both sides of the first runs' edge and
  of the last merge's, members all at one infinity and all but one, ties
  across the edges, +-0.0 mixed: the plain versions' values and NaN/+-inf
  points, one launch of each kernel."""
  rng = np.random.default_rng(m)
  runs, size = crps_pairwise.merge_runs(m)
  mid = runs // 2 * size
  x = rng.standard_normal((m, n)).astype(np.float32)
  inf, nan = np.inf, np.nan
  x[size - 1, 0] = inf
  x[size, 1] = inf
  x[size - 1, 2], x[size, 2] = -inf, inf
  x[mid - 1, 3] = x[mid, 3] = -inf
  x[size, 4] = nan
  x[mid - 1, 5] = nan
  x[:, 6] = inf
  x[:, 7] = -inf
  x[1:, 8] = inf
  x[:, 9] = np.round(2 * x[:, 9]) / 2
  x[[size - 1, size, mid - 1, mid], 9] = 0.5
  x[:, 10] = np.where(rng.random(m) < 0.5, np.float32(-0.0), np.float32(0.0))
  x[m - 1, 11] = nan
  xd = torch.from_numpy(x).to(cuda, dtype)
  yd = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
      cuda, dtype)
  assert crps_pairwise.spread_form(m) == 'mergesort'
  crps_pairwise.reset_launch_counts()
  got = crps_pairwise.fused_ensemble_stats(xd, yd) + (
      crps_pairwise.pairwise_spread_sum(xd),)
  torch.cuda.synchronize()
  assert crps_pairwise.LAUNCHES == {'fused_ensemble_stats': 1,
                                    'pairwise_spread_sum': 1,
                                    'pairwise_cross_sum': 0}
  assert crps_pairwise.MEMBER_COUNTS['fused_ensemble_stats'] == {m}
  want = crps_pairwise.fused_ensemble_stats_plain(xd, yd) + (
      crps_pairwise.pairwise_spread_sum_plain(xd),)
  for g, w in zip(got, want):
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
      assert torch.equal(f(g), f(w))
    fin = torch.isfinite(w)
    assert _rel(g[fin], w[fin]) <= tol
  assert torch.isnan(got[0][[4, 5, 6, 7, 8, 11]]).all()
  assert got[0][10] == 0


def test_mergesort_two_launches_give_equal_bits(cuda):
  """No atomics and a fixed order of addition across runs, tiles and
  batches: the fused and spread-only merge sorts give the same bits on the
  same input, in one batch and in several."""
  m = 59392
  rng = np.random.default_rng(m)
  x = torch.from_numpy(rng.standard_normal((m, 999)).astype(np.float32)).to(
      cuda)
  y = torch.from_numpy(rng.standard_normal(999).astype(np.float32)).to(cuda)
  first = crps_pairwise._launch_stats(x, y) + (
      crps_pairwise._launch_stats(x, None),)
  again = crps_pairwise._launch_stats(x, y) + (
      crps_pairwise._launch_stats(x, None),)
  for a, b in zip(first, again):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
  # The same points cut into batches of 100: each point's sums keep their
  # order, so the bits do not change.
  scratch = crps_pairwise.SCRATCH_BYTES
  try:
    words = crps_pairwise.mergesort_plan(m, 999)[2]
    crps_pairwise.SCRATCH_BYTES = 100 * 4 * words
    assert crps_pairwise.mergesort_plan(m, 999)[3] == 100
    batched = crps_pairwise._launch_stats(x, y) + (
        crps_pairwise._launch_stats(x, None),)
  finally:
    crps_pairwise.SCRATCH_BYTES = scratch
  for a, b in zip(first, batched):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_masked_aggregation_on_the_card_waits_for_nothing(cuda):
  """A masked, region-binned float32 statistic with device operands and a
  device mask, NaN at masked points: ``aggregate_statistics`` makes no
  synchronizing call (sync debug mode 'error' raises on one), two calls
  give equal bits, and the values are the CPU path's."""
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  rng = np.random.default_rng(21)
  n_lat, n_lon = 61, 120
  lat = np.linspace(90, -90, n_lat)
  lon = np.arange(n_lon) * 3.0
  mask = np.ones((n_lat, n_lon), bool)
  mask[[0, -1]] = False
  x = rng.standard_normal((4, 5, n_lat, n_lon)).astype(np.float32)
  x[..., 0, :7] = np.nan
  dims = ('init_time', 'lead_time', 'latitude', 'longitude')
  inits = np.datetime64('2020-01-01', 'ns') + np.arange(4) * np.timedelta64(
      12, 'h')
  leads = (np.arange(5) * np.timedelta64(12, 'h')).astype('timedelta64[ns]')

  def stats(device):
    coords = {'init_time': inits, 'lead_time': leads, 'latitude': lat,
              'longitude': lon, 'mask': Coord(('latitude', 'longitude'),
                                               torch.from_numpy(mask).to(device))}
    return {name: {'t2m': DimArray(torch.from_numpy(x * k).to(device), dims,
                                   coords)}
            for k, name in enumerate(['a', 'b', 'c'], 1)}

  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                               'tropics': ((-20, 20), (0, 360)),
                               'box': ((25, 60), (240, 285))})],
      masked=True)
  on_card = stats(cuda)
  operands = agg.prepare_operands(on_card, {}, cuda)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    first = agg.aggregate_statistics(on_card, operands).to_dataset()
    again = agg.aggregate_statistics(on_card, operands).to_dataset()
  finally:
    torch.cuda.set_sync_debug_mode(0)
  want = agg.aggregate_statistics(stats('cpu')).to_dataset()
  assert sorted(first) == sorted(want)
  for k, w in want.items():
    assert first[k].dims == w.dims, k
    assert first[k].data.is_cuda and torch.equal(first[k].data, again[k].data)
    assert torch.isfinite(first[k].data).all(), k
    assert _rel(first[k].data.cpu(), w.data) < 1e-5, k
