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


# The route boundaries: the network from 2 to 64 members, the
# shared-memory form past 64.
@pytest.mark.parametrize('m,rest', [(2, (5,)), (3, (33,)), (21, (2, 3, 65)),
                                    (50, (1, 129)), (400, (40,)),
                                    (10, (3, 70)), (16, (3, 70)),
                                    (63, (2, 99)), (64, (2, 99)),
                                    (65, (2, 99))])
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


@pytest.mark.parametrize('m', [2, 3, 10, 19, 20, 21, 49, 50, 64, 65, 100])
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
  with pytest.raises(ValueError, match='shared memory'):
    crps_pairwise.pairwise_spread_sum(torch.zeros(2000, 4, device=cuda))
  with pytest.raises(ValueError, match='different devices'):
    crps_pairwise.fused_ensemble_stats(torch.zeros(3, 4, device=cuda),
                                       torch.zeros(4))


@pytest.mark.parametrize('mx,my,rest', [
    (1, 1, (5,)), (3, 5, (33,)), (8, 2, (2, 3, 65)), (50, 10, (1, 129)),
    (50, 50, (2, 300)),
    (500, 600, (70,)),   # staged 500 rows: 64-thread blocks, 128 KB
    (2000, 3, (40,)),    # a large streamed ensemble needs no shared memory
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
  with pytest.raises(ValueError, match='shared memory'):
    crps_pairwise.pairwise_cross_sum(torch.zeros(2000, 4, device=cuda),
                                     torch.zeros(1900, 4, device=cuda))
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
