"""The port's benchmark CLI against the JAX package's, on the CPU.

Small ``.npz`` stores written by the JAX package's ``io`` (8 x 16 grid,
ECMWF dim names, latitude descending in the analyses and the climatology
as ERA5 stores it, a land-sea mask, the demo recipe target = clim + z_c +
z_t and prediction = clim + z_c + z_p) go through
``weatherbenchx_tpu.apps.run_benchmark_evaluation.main`` (its Pallas
kernels in interpret mode) and through the port's with ``--device=cpu``,
in both branches, for each special prediction kind and with
``--temporal``. The written ``.npz`` outputs agree to rtol 1e-5 /
atol 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu.apps import run_benchmark_evaluation as j_cli
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch import native
from weatherbenchx_tpu_torch import zarr_io
from weatherbenchx_tpu_torch.apps import run_benchmark_evaluation as cli
from weatherbenchx_tpu_torch.apps import run_evaluation

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_LAT, N_LON = 8, 16
LAT = np.linspace(-90, 90, N_LAT)
LON = np.linspace(0, 360, N_LON, endpoint=False)
LEVELS = np.array([300, 500, 850])
UPPER = ('geopotential', 'u_component_of_wind', 'v_component_of_wind')
SURFACE = ('2m_temperature', '10m_u_component_of_wind',
           '10m_v_component_of_wind', 'total_precipitation_24hr')
INITS = np.arange('2020-01-01T00', '2020-01-02T12', np.timedelta64(12, 'h'),
                  dtype='datetime64[ns]')
LEADS = np.arange(0, 24, 6, dtype='timedelta64[h]').astype('timedelta64[ns]')
VALID = np.arange('2020-01-01T00', '2020-01-03T00', np.timedelta64(6, 'h'),
                  dtype='datetime64[ns]')
# The probabilistic climatology takes the same (dayofyear, hour) of every
# year 1990-2019 as its members.
PAST = np.concatenate([
    np.datetime64(f'{y}-01-01', 'ns') + np.arange(8) * np.timedelta64(6, 'h')
    for y in range(1990, 2020)])
N_MEMBERS = 8


def _doy_hour_slot(times):
  day = times.astype('datetime64[D]')
  doy = (day - times.astype('datetime64[Y]')).astype(int)
  hour = (times.astype('datetime64[h]') - day).astype(int)
  return doy * 4 + hour // 6


def _write_stores(tmp_path) -> dict:
  rng = np.random.default_rng(2020)
  space_up = {'latitude': LAT, 'longitude': LON}
  space_down = {'latitude': LAT[::-1].copy(), 'longitude': LON}
  ccoords = {'dayofyear': np.arange(1, 6), 'hour': np.array([0, 6, 12, 18])}
  analysis_times = np.concatenate([PAST, VALID])
  pred, tgt, clim, ens = {}, {}, {}, {}
  for name in UPPER + SURFACE:
    lev = name in UPPER
    fshape = ((len(LEVELS),) if lev else ()) + (N_LAT, N_LON)
    fdims = (('level',) if lev else ()) + ('latitude', 'longitude')
    lcoords = {'level': LEVELS} if lev else {}

    def rand(*lead):
      return rng.standard_normal(lead + fshape).astype(np.float32)

    c = rand(5, 4)
    flat = c.reshape((20,) + fshape)
    zc = rand(len(analysis_times))
    t = flat[_doy_hour_slot(analysis_times)] + zc + rand(len(analysis_times))
    vt = (INITS[:, None] + LEADS[None, :]).reshape(-1)
    pos = np.searchsorted(analysis_times, vt)
    p = (flat[_doy_hour_slot(vt)] + zc[pos]).reshape(
        (len(INITS), len(LEADS)) + fshape) + rand(len(INITS), len(LEADS))
    if name.startswith('total_precipitation'):
      t, p, c = (np.abs(a) * 1e-3 for a in (t, p, c))
      for suffix, values in (
          ('seeps_threshold', 1.5e-3 + rand(5, 4) * 2e-4),
          ('seeps_dry_fraction',
           rng.uniform(0.05, 0.95, (5, 4) + fshape).astype(np.float32))):
        clim[f'{name}_{suffix}'] = j_darray.DimArray(
            values[:, :, ::-1].copy(), ('dayofyear', 'hour') + fdims,
            {**ccoords, **space_down})
    down = (slice(None),) * (1 + lev) + (slice(None, None, -1),)
    tgt[name] = j_darray.DimArray(
        t[down].copy(), ('time',) + fdims,
        {'time': analysis_times, **space_down, **lcoords})
    clim[name] = j_darray.DimArray(
        c[(slice(None),) + down].copy(), ('dayofyear', 'hour') + fdims,
        {**ccoords, **space_down, **lcoords})
    pred[name] = j_darray.DimArray(
        p, ('time', 'prediction_timedelta') + fdims,
        {'time': INITS, 'prediction_timedelta': LEADS, **space_up, **lcoords})
    ens[name] = j_darray.DimArray(
        rng.standard_normal((N_MEMBERS, len(INITS), len(LEADS)) + fshape
                            ).astype(np.float32),
        ('number', 'time', 'prediction_timedelta') + fdims,
        {'number': np.arange(N_MEMBERS), 'time': INITS,
         'prediction_timedelta': LEADS, **space_up, **lcoords})
  land = (np.cos(np.deg2rad(LAT))[:, None]
          * np.sin(3 * np.deg2rad(LON))[None, :]) > 0.1
  tgt['land_sea_mask'] = j_darray.DimArray(
      land[::-1].astype(np.float32).copy(), ('latitude', 'longitude'),
      space_down)
  paths = {}
  for key, ds in (('hres', pred), ('era5', tgt), ('clim', clim),
                  ('ens', ens)):
    paths[key] = str(tmp_path / f'{key}.npz')
    j_io.save_dataset(paths[key], ds)
  return paths


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
  return _write_stores(tmp_path_factory.mktemp('stores'))


def _argv(stores, prediction, out_dir, extra=()):
  pred_path = {'hres': stores['hres'], 'ens': stores['ens'],
               'persistence': stores['era5'],
               'probabilistic_climatology': stores['era5'],
               'climatology': stores['clim']}[prediction]
  return [f'--prediction={prediction}', f'--prediction_path={pred_path}',
          f'--target_path={stores["era5"]}',
          f'--climatology_path={stores["clim"]}',
          '--init_time_start=2020-01-01T00', '--init_time_stop=2020-01-02T12',
          '--lead_time_stop_days=1', '--lead_time_chunk_size=2',
          '--levels=500,850', f'--output_dir={out_dir}', *extra]


def _run_both(stores, tmp_path, prediction, extra=(), variables=None):
  variables = [f'--variables={variables or ",".join(UPPER + SURFACE)}']
  j_cli.main(_argv(stores, prediction, f'{tmp_path}/jax', extra) + variables)
  cli.main(_argv(stores, prediction, f'{tmp_path}/port', extra) + variables
           + ['--device=cpu'])
  name = sorted(os.listdir(f'{tmp_path}/jax'))
  assert sorted(os.listdir(f'{tmp_path}/port')) == name
  name = [n for n in name if not n.endswith('_stats.zarr')]
  return (io.load_dataset(f'{tmp_path}/port/{name[0]}'),
          j_io.load_dataset(f'{tmp_path}/jax/{name[0]}'))


def _assert_outputs_match(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    g, w = got[k], want[k]
    assert g.dims == tuple(w.dims), k
    for d in g.dims:
      np.testing.assert_array_equal(g.coord_values(d),
                                    np.asarray(w.coords[d].values), err_msg=k)
    np.testing.assert_allclose(g.values.astype(np.float64),
                               np.asarray(w.values, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=k)


DETERMINISTIC_KEYS = {'rmse', 'mse', 'bias', 'acc', 'prediction_activity'}


@pytest.mark.parametrize('prediction,extra', [
    ('hres', ()), ('hres', ('--temporal',)), ('persistence', ()),
    ('climatology', ())])
def test_deterministic_branch_matches_jax(stores, tmp_path, prediction,
                                          extra):
  got, want = _run_both(stores, tmp_path, prediction, extra)
  _assert_outputs_match(got, want)
  metrics = {k.split('.')[0] for k in got}
  assert metrics == DETERMINISTIC_KEYS | {'vector_rmse', 'seeps'}
  assert {'vector_rmse.wind', 'vector_rmse.10m_wind',
          'seeps.total_precipitation_24hr'} <= set(got)
  z = got['rmse.geopotential']
  lead_dims = ('init_time', 'lead_time') if extra else ('lead_time',)
  assert z.dims == lead_dims + ('level', 'region')
  np.testing.assert_array_equal(z.coord_values('level'), [500, 850])
  assert z.sizes['region'] == 34  # 17 regions and their land parts
  if prediction == 'hres' and not extra:
    # The demo recipe: ACC = 1/2 and RMSE = sqrt(2), loosely at this size.
    glob = list(z.coord_values('region')).index('global')
    assert abs(np.nanmean(got['acc.geopotential'].values[..., glob])
               - 0.5) < 0.2
    assert abs(np.nanmean(z.values[..., glob]) - np.sqrt(2)) < 0.3


@pytest.mark.parametrize('prediction', ['ens', 'probabilistic_climatology'])
def test_probabilistic_branch_matches_jax(stores, tmp_path, prediction,
                                          monkeypatch, capsys):
  monkeypatch.setenv('WBX_PALLAS_INTERPRET', '1')
  got, want = _run_both(stores, tmp_path, prediction,
                        variables='geopotential,2m_temperature')
  _assert_outputs_match(got, want)
  assert {k.split('.')[0] for k in got} == {
      'crps', 'unbiased_spread_skill', 'unbiased_mean_rmse', 'mean_rmse'}
  # On the CPU no kernel launches; the line reports the counts.
  line = [l for l in capsys.readouterr().out.splitlines()
          if l.startswith('Kernel launches: ')][-1]
  assert json.loads(line.removeprefix('Kernel launches: ')) == {
      'fused_ensemble_stats': 0, 'pairwise_spread_sum': 0,
      'pairwise_cross_sum': 0}


def test_checkpoints_and_retries_leave_the_result_unchanged(stores, tmp_path):
  args = _argv(stores, 'hres', f'{tmp_path}/plain') + [
      '--variables=geopotential,total_precipitation_24hr', '--device=cpu']
  cli.main(args)
  cli.main([a.replace('/plain', '/ckpt') for a in args]
           + ['--checkpoint_every=1', '--load_retries=2',
              '--load_retry_backoff=0'])
  name = os.listdir(f'{tmp_path}/plain')
  assert len(name) == 1
  plain = io.load_dataset(f'{tmp_path}/plain/{name[0]}')
  ckpt = io.load_dataset(f'{tmp_path}/ckpt/{name[0]}')
  assert os.path.exists(f'{tmp_path}/ckpt/{name[0]}.ckpt.manifest.json')
  for k in plain:  # bit-identical; NaN (empty land bins) in the same places
    np.testing.assert_array_equal(plain[k].values, ckpt[k].values, err_msg=k)


# The stores rewritten by the port's writers, and the output format each
# run writes: .wbx and netCDF; zarr v2 with blosc-lz4 and byte shuffle, one
# (init, lead, level) field per cell, as WeatherBench 2's public stores;
# zarr v3 sharded with zstd.
CONTAINERS = {
    'wbx': ('.wbx', {}, 'wbx'),
    'nc': ('.nc', {}, 'nc'),
    'zarr2_blosc': ('.zarr', {'compressor': 'blosc', 'chunks': {
        'time': 1, 'prediction_timedelta': 1, 'level': 1, 'number': 1}},
                    'zarr'),
    'zarr3_sharded_zstd': ('.3.zarr', {
        'compressor': 'zstd', 'zarr_format': 3,
        'chunks': {'time': 1, 'prediction_timedelta': 1, 'level': 1},
        'shards': {'time': 4}}, 'npz'),
}


@pytest.fixture(scope='module')
def container_stores(stores):
  out = {}
  for name, (suffix, zarr_kwargs, _) in CONTAINERS.items():
    out[name] = {}
    for key, path in stores.items():
      new = path[:-len('.npz')] + suffix
      ds = io.load_dataset(path)
      if zarr_kwargs:
        zarr_io.save_dataset_zarr(new, ds, **zarr_kwargs)
      else:
        io.save_dataset(new, ds)
      out[name][key] = new
  return out


def _output(out_dir: str) -> dict:
  (name,) = os.listdir(out_dir)
  return io.load_dataset(os.path.join(out_dir, name))


@pytest.mark.parametrize('container', list(CONTAINERS))
@pytest.mark.parametrize('prediction', ['hres', 'ens'])
def test_cli_from_every_container_equals_the_npz_run(
    stores, container_stores, tmp_path, prediction, container):
  """The benchmark CLI from each container's stores, writing its metrics in
  another container, equals its run from the .npz stores bit for bit (the
  codecs are lossless and the windows read the same data)."""
  _, _, fmt = CONTAINERS[container]
  variables = ['--variables=geopotential,2m_temperature'
               + (',total_precipitation_24hr' if prediction == 'hres' else '')]
  cli.main(_argv(stores, prediction, f'{tmp_path}/npz') + variables
           + ['--device=cpu'])
  cli.main(_argv(container_stores[container], prediction,
                 f'{tmp_path}/{container}', [f'--output_format={fmt}'])
           + variables + ['--device=cpu'])
  got, want = _output(f'{tmp_path}/{container}'), _output(f'{tmp_path}/npz')
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dims == want[k].dims, k
    for d in want[k].dims:
      np.testing.assert_array_equal(got[k].coord_values(d),
                                    want[k].coord_values(d))
    np.testing.assert_array_equal(got[k].values, want[k].values, err_msg=k)


@pytest.mark.parametrize('container', list(CONTAINERS))
def test_cli_from_every_container_matches_the_jax_cli(
    stores, container_stores, tmp_path, container):
  """Both CLIs read the port-written stores of each container."""
  got, want = _run_both(container_stores[container], tmp_path, 'hres',
                        variables='geopotential,u_component_of_wind,'
                        'v_component_of_wind,total_precipitation_24hr')
  _assert_outputs_match(got, want)


@pytest.mark.parametrize('flag,item', [
    ('--unaggregated_zarr', 'A11'), ('--chunks_per_dispatch=2', 'A7')])
def test_unported_options_raise(stores, tmp_path, flag, item):
  """--chunks_per_dispatch > 1 (ROADMAP A7) still raises. The refusal of
  --unaggregated_zarr is lifted: the flag now writes its statistics store."""
  argv = _argv(stores, 'hres', str(tmp_path)) + [flag, '--device=cpu']
  if item == 'A11':
    cli.main(argv + ['--variables=geopotential,2m_temperature'])
    assert any(n.endswith('_stats.zarr') for n in os.listdir(tmp_path))
    return
  with pytest.raises(NotImplementedError, match=f'ROADMAP {item}'):
    cli.main(argv)


def _tree_bytes(root):
  out = {}
  for dirpath, _, names in os.walk(root):
    for n in names:
      with open(os.path.join(dirpath, n), 'rb') as f:
        out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
  return out


@pytest.mark.parametrize('extra', [
    ('--zarr_compressor=blosc',),
    ('--zarr_format=3', '--zarr_compressor=zstd',
     '--zarr_shards=init_time=2,lead_time=2')])
def test_unaggregated_zarr_matches_the_jax_cli(stores, tmp_path, extra):
  """--unaggregated_zarr: the port's statistics store against the JAX
  CLI's. The deterministic statistics of float32 data are the same bits
  in both packages (ACC's anomalies included), so the stores are the same
  files, byte for byte; the metric outputs agree as elsewhere."""
  got, want = _run_both(stores, tmp_path, 'hres',
                        ('--unaggregated_zarr',) + extra,
                        variables='geopotential,2m_temperature')
  _assert_outputs_match(got, want)
  name = [n for n in os.listdir(f'{tmp_path}/jax') if n.endswith('.zarr')]
  assert len(name) == 1 and name[0].endswith('_stats.zarr')
  port = _tree_bytes(f'{tmp_path}/port/{name[0]}')
  jax_store = _tree_bytes(f'{tmp_path}/jax/{name[0]}')
  assert sorted(port) == sorted(jax_store)
  for f in port:
    assert port[f] == jax_store[f], f
  ds = zarr_io.open_dataset_zarr(f'{tmp_path}/port/{name[0]}')
  assert {'SquaredError.geopotential', 'Error.2m_temperature'} <= set(ds)


class _Opened(Exception):
  pass


def test_registry_paths_and_missing_gpu_raise(stores, tmp_path, monkeypatch):
  # A registry entry's gs:// store goes to the zarr reader, which opens it
  # through fsspec; the reader is stubbed, so no remote host is contacted.
  opened = []

  def open_zarr(path):
    opened.append(path)
    raise _Opened(path)

  monkeypatch.setattr(zarr_io, 'open_dataset_zarr', open_zarr)
  with pytest.raises(_Opened):
    cli.main(['--prediction=hres', f'--output_dir={tmp_path}',
              '--variables=geopotential', '--device=cpu'])
  assert opened and opened[0].startswith('gs://weatherbench2/')
  monkeypatch.undo()
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    cli.main(_argv(stores, 'hres', str(tmp_path)))
  assert not os.listdir(tmp_path)
  with pytest.raises(SystemExit, match='Unknown prediction config'):
    cli.main(['--prediction=nomodel', f'--output_dir={tmp_path}',
              '--device=cpu'])


@pytest.mark.parametrize('which', ['benchmark', 'evaluation'])
@pytest.mark.parametrize('library', ['blockstore', 'zarrcodec'])
def test_gpu_runs_need_the_native_io(stores, tmp_path, monkeypatch, which,
                                     library):
  """On a GPU a native I/O library that did not build is an error, not the
  pure-Python path; on the CPU that path stays."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(native, f'{library}_available', lambda: False)
  if which == 'benchmark':
    main, argv = cli.main, _argv(stores, 'hres', str(tmp_path))
  else:
    main = run_evaluation.main
    argv = [f'--prediction_path={stores["hres"]}',
            f'--target_path={stores["era5"]}',
            f'--output_path={tmp_path / "out.npz"}']
  with pytest.raises(RuntimeError, match=f'native I/O .*{library}'):
    main(argv + ['--device=cuda'])
  assert not os.listdir(tmp_path)
  assert run_evaluation.resolve_device('cpu') == torch.device('cpu')
