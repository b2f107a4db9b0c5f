"""The port's drivers against the JAX package's tools, on the CPU.

``weatherbenchx_tpu_torch.tools.{stream_scale_demo,sparse_scale_demo,
gen_demo_fixtures}`` against ``tools/*.py``:

* the streaming month (4 inits x 5 members x 19 x 36, one init per chunk)
  and the year (40 inits, chunks of 32): the JAX tool is loaded by path
  with its module constants set to these sizes (in memory; the file is
  not edited) and run in this process; its JSON line rounds each value
  to 5 decimals, so the port's unrounded values must be within 5e-6 of it
  plus 1e-5. Each side's stores decode to equal arrays and coords. The
  fused ensemble wrapper is called ``FUSED_LAUNCHES_PER_CHUNK`` times per
  chunk (the count ``chip_smoke.py`` holds the card's launches to), and a
  run stopped after 2 chunks resumes from its checkpoint to the
  uninterrupted run's values bit for bit;
* the METAR month (200 stations x 4 days on 64 x 32; the JAX tool as a
  subprocess under JAX_PLATFORMS=cpu): the same Parquet rows, equal
  ``obs_rows``, ``rmse_global`` within the JAX line's rounding (5e-5)
  plus 1e-5, and at most one operand build per padded index size (200
  stations pad to one multiple of 8,192: one);
* the demo fixtures: equal array by array.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.tools import gen_demo_fixtures
from weatherbenchx_tpu_torch.tools import sparse_scale_demo
from weatherbenchx_tpu_torch.tools import stream_scale_demo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX tools round their printed values to 5 (stream) and 4 (sparse)
# decimals; the port's must sit within that rounding plus ATOL.
ATOL = 1e-5
STREAM_ROUNDING, SPARSE_ROUNDING = 5e-6, 5e-5
MONTH = {'ENS_N_INIT': 4, 'ENS_MEMBERS': 5, 'NLAT': 19, 'NLON': 36}
YEAR = {'N_INIT': 40, 'NLAT': 19, 'NLON': 36}


def _jax_tool(name: str, **constants):
  """tools/<name>.py loaded by path, with module constants overridden."""
  spec = importlib.util.spec_from_file_location(
      f'jax_tool_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  for k, v in constants.items():
    setattr(module, k, v)
  return module


@pytest.fixture
def jax_stream(tmp_path, monkeypatch):
  """The JAX stream tool at the month's and the year's small sizes. Its
  pipelines get no compilation cache: the tool's cache directory is a
  fixed path outside the test's, and JAX keeps the setting for the rest
  of the process."""
  from weatherbenchx_tpu.parallel import pipeline as j_pipeline
  orig = j_pipeline.EvaluationPipeline
  monkeypatch.setattr(
      j_pipeline, 'EvaluationPipeline',
      lambda **kw: orig(**dict(kw, compilation_cache_dir=None)))
  return _jax_tool('stream_scale_demo', STORE_DIR=str(tmp_path / 'jax'),
                   **{**MONTH, **YEAR})


def _last_json(text: str) -> dict:
  return json.loads(text.strip().splitlines()[-1])


def _assert_stores_equal(paths_a, paths_b):
  for a, b in zip(paths_a, paths_b):
    da, db = io_lib.load_dataset(a), io_lib.load_dataset(b)
    assert sorted(da) == sorted(db)
    for k in da:
      assert da[k].dims == db[k].dims
      np.testing.assert_array_equal(da[k].values, db[k].values)
      assert sorted(da[k].coords) == sorted(db[k].coords)
      for c in da[k].coords:
        np.testing.assert_array_equal(da[k].coord_values(c),
                                      db[k].coord_values(c))


def _count_fused_calls(monkeypatch) -> list:
  calls = []
  fused = crps_pairwise.fused_ensemble_stats

  def counted(*args, **kwargs):
    calls.append(args[0].shape)
    return fused(*args, **kwargs)

  monkeypatch.setattr(crps_pairwise, 'fused_ensemble_stats', counted)
  return calls


def _port_sizes(tmp_path, n_init, members=5):
  return stream_scale_demo.Sizes(str(tmp_path / 'port'), n_init, members,
                                 19, 36)


def test_stream_month_matches_jax(jax_stream, tmp_path, capsys, monkeypatch):
  jax_stream.make_ens_store('zarr', 'blosc')
  # 'cpu-jax' rather than 'cpu': the tool keeps its RSS assertion, a bound
  # of the full deterministic size, for 'cpu'; this names the same backend.
  jax_stream.run_ens('cpu-jax', 1, 'zarr')
  want = _last_json(capsys.readouterr().out)

  calls = _count_fused_calls(monkeypatch)
  flags = ['--ens', '--format', 'zarr', '--store_dir', str(tmp_path / 'port'),
           '--n_init', '4', '--members', '5', '--grid', '36x19']
  stream_scale_demo.main(['--make_store', '--compressor', 'blosc'] + flags)
  got = stream_scale_demo.main(['--run', '--device', 'cpu', '--chunk', '1',
                                '--output', str(tmp_path / 'v.npz')]
                               + flags)['report']
  assert got['chunks'] == want['chunks'] == 4
  for key in ('crps_global', 'spread_skill'):
    assert abs(got[key] - want[key]) <= STREAM_ROUNDING + ATOL, key
  assert np.isfinite(got['mean_rmse']) and got['mean_rmse'] > 0
  assert len(calls) == 4 * stream_scale_demo.FUSED_LAUNCHES_PER_CHUNK
  assert all(shape == (5, 1, 1, 19, 36) for shape in calls)
  # On the CPU the wrappers launch nothing: the plain versions ran.
  assert got['launches']['fused_ensemble_stats'] == 0
  assert got['chunks_run'] == len(got['chunk_seconds']) == 4
  assert got['rss_after_chunk_3_gb'] > 0
  _assert_stores_equal(
      stream_scale_demo.store_paths(_port_sizes(tmp_path, 4), 'zarr', True),
      jax_stream._store_paths('zarr', ens=True))


def test_stream_month_resumes_bit_identical(tmp_path, monkeypatch):
  """A run stopped once 2 of its 4 chunks are checkpointed, run again,
  ends equal to an uninterrupted run (the values file)."""
  sizes = _port_sizes(tmp_path, 4)
  stream_scale_demo.make_ens_store(sizes, 'zarr', 'blosc')
  device = torch.device('cpu')
  whole = tmp_path / 'whole.npz'
  stream_scale_demo.run_ens(sizes, device, 1, 'zarr', output=str(whole))

  class Stop(Exception):
    pass

  counter = stream_scale_demo.ChunkRecorder.counter

  def stop_at_third(self, name, increment=1):
    counter(self, name, increment)
    if name == 'chunks_done' and len(self.done_at) == 3:
      raise Stop

  ckpt = str(tmp_path / 'ckpt')
  resumed = tmp_path / 'resumed.npz'
  with monkeypatch.context() as m:
    m.setattr(stream_scale_demo.ChunkRecorder, 'counter', stop_at_third)
    with pytest.raises(Stop):
      stream_scale_demo.run_ens(sizes, device, 1, 'zarr', ckpt, 1,
                                str(resumed))
  with open(f'{ckpt}.manifest.json') as f:
    assert json.load(f)['next_chunk'] == 2
  report = stream_scale_demo.run_ens(sizes, device, 1, 'zarr', ckpt, 1,
                                     str(resumed))
  assert report['chunks_run'] == 2
  got, want = io_lib.load_dataset(str(resumed)), io_lib.load_dataset(
      str(whole))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k].values, want[k].values)


def test_stream_year_matches_jax(jax_stream, tmp_path, capsys):
  jax_stream.make_store('wbx', None)
  jax_stream.run('cpu-jax', 32, 'wbx')  # 'cpu-jax': see the month's test
  want = _last_json(capsys.readouterr().out)
  flags = ['--store_dir', str(tmp_path / 'port'), '--n_init', '40',
           '--grid', '36x19']
  stream_scale_demo.main(['--make_store'] + flags)
  got = stream_scale_demo.main(['--run', '--device', 'cpu'] + flags)['report']
  assert got['chunks'] == want['chunks'] == 2
  assert got['gridpoints'] == want['gridpoints']
  assert abs(got['rmse_global'] - want['rmse_global']) <= (
      STREAM_ROUNDING + ATOL)
  _assert_stores_equal(
      stream_scale_demo.store_paths(_port_sizes(tmp_path, 40), 'wbx'),
      jax_stream._store_paths('wbx'))


@pytest.mark.parametrize('main, argv', [
    (stream_scale_demo.main, ['--run']),
    (stream_scale_demo.main, ['--run', '--ens']),
    (sparse_scale_demo.main, []),
    (gen_demo_fixtures.main, []),
], ids=['stream_year', 'stream_month', 'sparse', 'fixtures'])
def test_drivers_default_to_cuda(main, argv, tmp_path):
  """Without --device each driver asks for a GPU, and raises without one
  before it writes anything."""
  if torch.cuda.is_available():
    pytest.skip('a GPU is present: the default device is usable')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    main(argv + ['--store_dir', str(tmp_path)] if main is stream_scale_demo.main
         else argv + ['--workdir', str(tmp_path)] if main is sparse_scale_demo.main
         else argv + [str(tmp_path)])
  assert not os.listdir(tmp_path)


def test_sparse_month_matches_jax(tmp_path):
  import pandas as pd
  flags = ['--stations', '200', '--days', '4', '--grid', '64x32']
  jax_run = subprocess.run(
      [sys.executable, os.path.join(REPO, 'tools', 'sparse_scale_demo.py'),
       '--workdir', str(tmp_path / 'jax')] + flags,
      capture_output=True, text=True, timeout=300, cwd=REPO,
      env=dict(os.environ, JAX_PLATFORMS='cpu'))
  assert jax_run.returncode == 0, jax_run.stderr
  want = _last_json(jax_run.stdout)
  got = sparse_scale_demo.main(
      flags + ['--workdir', str(tmp_path / 'port'), '--device', 'cpu'])
  part = os.path.join('obs_200_4_1', 'year=2020', 'month=1',
                      '2020-01.parquet')
  pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / 'port' / part),
                                pd.read_parquet(tmp_path / 'jax' / part))
  assert got['obs_rows'] == want['obs_rows']
  assert got['chunks'] == want['chunks']
  assert abs(got['rmse_global'] - want['rmse_global']) <= (
      SPARSE_ROUNDING + ATOL)
  buckets = 1  # every chunk's 200 stations pad to 8,192 rows
  assert 0 < got['operand_builds'] <= buckets


def test_demo_fixtures_equal_jax(tmp_path):
  jax_fixtures = _jax_tool('gen_demo_fixtures')
  jax_fixtures.main(str(tmp_path / 'jax'))
  paths = gen_demo_fixtures.main([str(tmp_path / 'port'), '--device', 'cpu'])
  assert sorted(paths) == ['clim', 'era5', 'hres']
  for name, path in paths.items():
    got, want = np.load(path), np.load(tmp_path / 'jax' / f'{name}.npz')
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
      assert got[k].dtype == want[k].dtype, (name, k)
      np.testing.assert_array_equal(got[k], want[k], err_msg=f'{name} {k}')
