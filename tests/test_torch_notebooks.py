"""The port's executed how-to notebooks (docs/torch/notebooks/), on the CPU.

``weatherbenchx_tpu_torch/tools/make_notebooks.py`` builds and executes
them (``--device cpu``). These tests hold the committed artifacts: every
topic of the JAX package's ``docs/notebooks/`` is present, parseable and
error-free with outputs; each builder's cells, run here in-process, have
the committed sources and print the committed outputs; the numbers each
port notebook prints equal those its JAX counterpart committed, cell for
cell, within 1e-5 relative or one unit in the last printed digit, with
the rest of the text (dims, names, booleans) equal; no notebook names jax
or the JAX package.
"""

import glob
import os

import pytest
import torch

from weatherbenchx_tpu_torch.tools import make_notebooks as mn

nbformat = pytest.importorskip('nbformat')

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DOCS = os.path.join(REPO, 'docs', 'notebooks')
EXPECTED = ['quickstart', 'data_loaders', 'implement_metrics',
            'metric_wrappers', 'nan_handling', 'sparse_data',
            'forecast_latency']


def _path(name: str) -> str:
  return os.path.join(mn.OUT, f'{name}.ipynb')


def test_all_topics_present():
  have = {os.path.basename(p)[:-6]
          for p in glob.glob(os.path.join(mn.OUT, '*.ipynb'))}
  assert set(EXPECTED) == have == set(mn.NOTEBOOKS)
  jax_have = {os.path.basename(p)[:-6]
              for p in glob.glob(os.path.join(JAX_DOCS, '*.ipynb'))}
  assert jax_have == have


@pytest.mark.parametrize('name', EXPECTED)
def test_executed_without_errors(name):
  nb = nbformat.read(_path(name), as_version=4)
  nbformat.validate(nb)
  code_cells = [c for c in nb.cells if c.cell_type == 'code']
  assert code_cells
  errors = [o for c in code_cells for o in c.outputs
            if o.output_type == 'error']
  assert not errors, errors[0]
  assert [c for c in code_cells if c.outputs], f'{name}: no outputs'


@pytest.mark.parametrize('name', EXPECTED)
def test_builder_cells_are_the_committed_ones(name):
  nb = nbformat.read(_path(name), as_version=4)
  assert [(('md' if c.cell_type == 'markdown' else 'code'), c.source)
          for c in nb.cells] == mn.NOTEBOOKS[name]('cpu')


@pytest.mark.parametrize('name', EXPECTED)
def test_builder_cells_print_the_committed_outputs(name):
  assert mn.run_cells(mn.NOTEBOOKS[name]('cpu')) == mn.committed_outputs(
      _path(name))


@pytest.mark.parametrize('name', EXPECTED)
def test_printed_numbers_match_the_jax_notebook(name):
  port = mn.committed_outputs(_path(name))
  jax_out = mn.committed_outputs(os.path.join(JAX_DOCS, f'{name}.ipynb'))
  assert len(port) == len(jax_out)
  assert any(port), f'{name}: prints nothing'
  for k, (got, want) in enumerate(zip(port, jax_out)):
    assert mn.compare_printed(got, want) is None, (name, k)


@pytest.mark.parametrize('name', EXPECTED)
def test_no_source_names_jax(name):
  nb = nbformat.read(_path(name), as_version=4)
  for cell in nb.cells:
    assert 'jax' not in cell.source.lower(), cell.source
    assert 'weatherbenchx_tpu.' not in cell.source, cell.source
  assert "DEVICE = torch.device('cpu')" in nb.cells[1].source


@pytest.mark.parametrize('got,want,close', [
    ('[1.4211 1.4281]', '[1.4211 1.4281]', True),
    ('[1.4212 1.4281]', '[1.4211 1.4281]', True),  # one unit in the last
    ('[1.4213 1.4281]', '[1.4211 1.4281]', False),  # two units
    ("{'x': 1.0404903888702393}", "{'x': 1.0404903998246764}", True),
    ("{'x': 1.0405903888702393}", "{'x': 1.0404903998246764}", False),
    ('[0.35   0.343 ]', '[0.35 0.343]', True),  # numpy's padding
    ('default: nan', 'default: nan', True),
    ('default: nan', 'default: 1.0', False),
    ('chunked == direct: True', 'chunked == direct: False', False),
    ("('lead_time',) [1.0]", "('latitude',) [1.0]", False),
    ('2020-01-01T12:00:00.000000000', '2020-01-01T12:00:00.000000000', True),
    ('2020-01-01T13:00:00.000000000', '2020-01-01T12:00:00.000000000', False),
    ('[1.0 2.0]', '[1.0 2.0 3.0]', False),
])
def test_compare_printed(got, want, close):
  assert (mn.compare_printed(got, want) is None) == close


def test_generator_refuses_cuda_without_a_gpu():
  if torch.cuda.is_available():
    pytest.skip('a GPU is present: the generator would run on it')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    mn.main(['--device', 'cuda', '--out', os.devnull])
