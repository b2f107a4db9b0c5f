"""The port's examples against the JAX package's, on the CPU.

Each of ``examples/{quickstart,significance_testing,
ensemble_zarr_pipeline}.py`` runs as a subprocess with ``--cpu`` under
JAX_PLATFORMS=cpu (the three at once, started by a module fixture), and
its counterpart ``weatherbenchx_tpu_torch.examples.<name>`` runs here with
``--device cpu``. The printed lines must be equal: each example prints its
values rounded (3 or 4 decimals, a p-value to 3 significant digits), so
equality holds the port within that rounding of the JAX package.
"""

import os
import subprocess
import sys
import tempfile

import pytest
import torch

from weatherbenchx_tpu_torch.examples import ensemble_zarr_pipeline
from weatherbenchx_tpu_torch.examples import quickstart
from weatherbenchx_tpu_torch.examples import significance_testing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {'quickstart': quickstart,
            'significance_testing': significance_testing,
            'ensemble_zarr_pipeline': ensemble_zarr_pipeline}


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
  """{name: Popen} of the JAX examples, started together."""
  tmp = str(tmp_path_factory.mktemp('jax_examples'))
  env = dict(os.environ, JAX_PLATFORMS='cpu', TMPDIR=tmp)
  procs = {name: subprocess.Popen(
      [sys.executable, os.path.join(REPO, 'examples', f'{name}.py'), '--cpu'],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
      env=env) for name in EXAMPLES}
  yield procs
  for proc in procs.values():
    proc.kill()
    proc.wait(timeout=60)


@pytest.mark.parametrize('name', sorted(EXAMPLES))
def test_example_prints_the_jax_examples_lines(name, jax_runs, capsys,
                                               tmp_path, monkeypatch):
  monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
  returned = EXAMPLES[name].main(['--device', 'cpu'])
  got = capsys.readouterr().out.splitlines()
  out, err = jax_runs[name].communicate(timeout=300)
  assert jax_runs[name].returncode == 0, err
  assert got == out.splitlines()
  assert returned


@pytest.mark.parametrize('name', sorted(EXAMPLES))
def test_example_defaults_to_cuda(name):
  if torch.cuda.is_available():
    pytest.skip('a GPU is present: the default device is usable')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    EXAMPLES[name].main([])
