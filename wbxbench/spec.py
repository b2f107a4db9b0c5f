"""Finds a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), the configurations (``configs``, each with its ``file``)
and the metrics. Everything else is found by name under this folder:

* ``workloads/<traffic>.json``: a cell's traffic: its pool of chunks, the
  chunk's shape, the scorings (each a metric set against a target kind),
  the generator's parameters, the kernel route, the traced stretch and
  the limits of the comparison that decides ``correct``;
* ``metric_sets/<name>.json``: the port's metric classes with their
  arguments, and for each the reference's metric (``reference.py``);
* ``layer_metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(ctx)`` of a ``trace.Context`` that returns a number or None;
* ``counts/<kernel>.py``: a kernel's bytes a call, ``bytes_moved(members,
  points, itemsize)``.

A later cell, configuration, metric set or per-layer metric is a new file
and a new entry of ``BENCHMARK.json``; no file here changes.
"""

import copy
import dataclasses
import importlib
import importlib.util
import json
import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


@dataclasses.dataclass
class Scoring:
  """One metric set scored against one target kind, each chunk."""
  metric_set: str
  target: str  # 'deterministic' or 'analysis_ensemble'
  metrics: dict  # {name: {'port': 'module.Class', 'kwargs', 'reference'}}


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: dict
  traffic: dict
  scorings: list
  end_to_end: list  # BENCHMARK.json entries this cell reports
  per_layer: list
  root: str

  @property
  def points(self) -> int:
    """Gridpoints a chunk: inits x leads x latitudes x longitudes."""
    c, t = self.config, self.traffic['chunk']
    return (t['init_times'] * t['leads'] * c['latitudes']
            * c['longitudes'] * len(c['variables']))

  @property
  def values_per_chunk(self) -> int:
    """Forecast values a chunk: members x the chunk's gridpoints."""
    return self.config['members'] * self.points


def load_json(path: str) -> dict:
  with open(path) as f:
    return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
  return 'workloads' not in entry or cell in entry['workloads']


def resolve(name: str, root: str = ROOT, overrides: dict = None) -> Cell:
  """The cell ``name`` of ``root``'s BENCHMARK.json with its files read.

  ``overrides`` ({'config': {...}, 'chunk': {...}, 'traffic': {...}})
  replaces keys of the configuration, of the traffic's chunk and of the
  traffic: the tests run a cell at a tiny size so.
  """
  bench = load_json(os.path.join(root, 'BENCHMARK.json'))
  cells = {w['name']: w for w in bench['workloads']}
  if name not in cells:
    raise KeyError(f'no workload {name!r} in BENCHMARK.json (has '
                   f'{sorted(cells)})')
  entry = cells[name]
  configs = {c['name']: c for c in bench['configs']}
  config = load_json(os.path.join(root, configs[entry['config']]['file']))
  traffic = load_json(os.path.join(root, 'wbxbench', 'workloads',
                                   f'{entry["traffic"]}.json'))
  if traffic['config'] != entry['config']:
    raise ValueError(f'traffic {entry["traffic"]!r} is for configuration '
                     f'{traffic["config"]!r}, not {entry["config"]!r}')
  overrides = overrides or {}
  config = {**config, **copy.deepcopy(overrides.get('config', {}))}
  traffic = {**copy.deepcopy(traffic),
             **copy.deepcopy(overrides.get('traffic', {}))}
  traffic['chunk'].update(overrides.get('chunk', {}))
  scorings = []
  for s in traffic['scorings']:
    metric_set = load_json(os.path.join(root, 'wbxbench', 'metric_sets',
                                        f'{s["metric_set"]}.json'))
    scorings.append(Scoring(s['metric_set'], s['target'],
                            metric_set['metrics']))
  return Cell(
      name=name, chips=int(entry['chips']), config=config, traffic=traffic,
      scorings=scorings,
      end_to_end=[m for m in bench['end_to_end'] if _reports(m, name)],
      per_layer=[m for m in bench['per_layer'] if _reports(m, name)],
      root=root)


def port_metrics(scoring: Scoring) -> dict:
  """{name: Metric} of the port, built from the metric set's class paths
  (relative to ``weatherbenchx_tpu_torch.metrics``) and arguments."""
  out = {}
  for name, m in scoring.metrics.items():
    module, cls = m['port'].rsplit('.', 1)
    mod = importlib.import_module(f'weatherbenchx_tpu_torch.metrics.{module}')
    out[name] = getattr(mod, cls)(**m.get('kwargs', {}))
  return out


def _load_file(path: str, label: str):
  spec = importlib.util.spec_from_file_location(label, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def reader(metric: str, root: str = ROOT):
  """The ``read(ctx)`` of ``layer_metrics/<metric>.py``."""
  path = os.path.join(root, 'wbxbench', 'layer_metrics', f'{metric}.py')
  return _load_file(path, 'wbxbench_layer_' + metric.replace('.', '_')).read


def byte_count(kernel: str, root: str = ROOT):
  """The ``bytes_moved(members, points, itemsize)`` of
  ``counts/<kernel>.py``."""
  path = os.path.join(root, 'wbxbench', 'counts', f'{kernel}.py')
  return _load_file(path, f'wbxbench_count_{kernel}').bytes_moved
