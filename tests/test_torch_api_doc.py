"""The port's API page (docs/torch/api.md) against its docstrings and the
JAX package's page, on the CPU.

The committed page equals a fresh ``gen_api_doc.render()``; every public
name of the JAX package's ``docs/api.md`` is either in the port's page, in
its module's section, or listed there as a deliberate omission with a
reason; each omission names a real JAX package name that the port indeed
lacks.
"""

import importlib
import os
import re

import pytest

from weatherbenchx_tpu_torch.tools import gen_api_doc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sections(path: str) -> dict[str, list[str]]:
  """{module: [symbol, ...]} of an API page."""
  out, module = {}, None
  with open(path) as f:
    for line in f:
      m = re.match(r'## `(.+)`', line)
      if m:
        module = m.group(1)
        out[module] = []
        continue
      m = re.match(r'\| `(\w+)` \| (class|fn) \|', line)
      if m and module is not None:
        out[module].append(m.group(1))
  return out


def _omitted(path: str) -> dict[str, str]:
  """{JAX package name: reason} of the port page's last table."""
  with open(path) as f:
    text = f.read()
  tail = text[text.index('# Not in the port'):]
  return dict(re.findall(r'^\| `([\w.]+)` \| (.+) \|$', tail, re.M))


JAX_PAGE = _sections(os.path.join(REPO, 'docs', 'api.md'))


def test_committed_page_is_fresh():
  with open(gen_api_doc.OUT) as f:
    assert f.read() == gen_api_doc.render()


def test_page_covers_the_jax_modules_in_order_then_the_ports_own():
  port = list(_sections(gen_api_doc.OUT))
  want = [m.replace('weatherbenchx_tpu', 'weatherbenchx_tpu_torch', 1)
          for m in JAX_PAGE]
  assert port[:len(want)] == want
  assert port[len(want):] == gen_api_doc.PORT_MODULES


@pytest.mark.parametrize('module', sorted(JAX_PAGE))
def test_every_jax_public_name_is_documented_or_omitted(module):
  port = _sections(gen_api_doc.OUT)
  omitted = _omitted(gen_api_doc.OUT)
  port_module = module.replace('weatherbenchx_tpu', 'weatherbenchx_tpu_torch',
                               1)
  missing = [sym for sym in JAX_PAGE[module]
             if sym not in port[port_module]
             and not omitted.get(f'{module}.{sym}', '').strip()]
  assert not missing, (module, missing)


@pytest.mark.parametrize('name', [n for n, _ in gen_api_doc.OMITTED])
def test_each_omission_is_a_jax_name_the_port_lacks(name):
  parts = name.split('.')
  for split in range(len(parts) - 1, 0, -1):
    try:
      module = importlib.import_module('.'.join(parts[:split]))
      break
    except ImportError:
      continue
  obj = module
  for attr in parts[split:]:
    obj = getattr(obj, attr)  # raises if the JAX package has no such name
  port_name = name.replace('weatherbenchx_tpu', 'weatherbenchx_tpu_torch', 1)
  port = importlib.import_module('.'.join(port_name.split('.')[:split]))
  for attr in parts[split:]:
    if not hasattr(port, attr):
      return
    port = getattr(port, attr)
  pytest.fail(f'the port has {port_name}')
