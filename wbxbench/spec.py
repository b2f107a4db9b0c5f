"""Finds a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), the configurations (``configs``, each with its ``file``)
and the metrics. Everything else is found by name under this folder:

* ``workloads/<traffic>.json``: a cell's traffic: its pool of chunks, the
  chunk's shape, the scorings (each a metric set against a target kind),
  the generator's parameters, the kernel route, the traced stretch and
  the limits of the comparison that decides ``correct``;
* ``metric_sets/<name>.json``: the port's metric classes with their
  arguments, and for each the reference's metric;
* ``generators/<name>.py`` and ``references/<name>.py``: a configuration
  of another kind than an ensemble's, named by the configuration's
  ``generator_module`` and ``reference_module``; without them,
  ``traffic.py`` and ``reference.py``;
* ``layer_metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(ctx)`` of a ``trace.Context`` that returns a number or None;
* ``counts/<kernel>.py``: a kernel's bytes a call, ``bytes_moved(members,
  points, itemsize)``.

A later cell, configuration, metric set or per-layer metric is a new file
and a new entry of ``BENCHMARK.json``; no file here changes. That holds for
a configuration of a new kind too: its generator, its reference, its
resources (climatologies, a land-sea mask) and its aggregation are files
and keys of its own.

**A generator module** has these functions (``traffic.py`` is the
default's):

* ``make_pool(config, traffic, seed, device, dtype=None)``: the list of
  distinct pool chunks, made on ``device`` from ``seed``; with a
  ``dtype``, the same pool in that type, made chunk by chunk (the
  control's);
* ``resources(config, traffic, seed, device)``: ``{name: object}`` that
  metric sets and the aggregation name (below): a climatology as
  ``{variable: DimArray}`` over ``dayofyear`` and ``hour`` (and ``level``
  where the variable has levels), a land-sea mask as a ``DimArray`` over
  latitude and longitude; ``{}`` where there are none;
* ``handover(config, traffic, pool_chunk, c, target_kind, mask)``: chunk
  ``c`` of a run as fresh (predictions, targets) dicts of ``DimArray``,
  ``mask`` the validity mask (``reference.validity_mask``) as a bool
  tensor on the device;
* ``chunk_key(config, traffic, c, pool)``: a hashable key that decides
  chunk ``c``'s statistics, given ``pool`` distinct pool chunks: two
  chunks of one key give the same statistics. ``c % pool`` where they
  depend on the pool chunk alone; with a climatology, also the slots
  that the chunk's valid times hit.

**A reference module** has ``values(config, traffic, scoring, pool,
resources, counts, device)``: from the same pool and resources, without
anything of the port, ``{metric: {variable: (dims, values, labels)}}`` for
the scoring's metrics (a ``Scoring``), ``values`` a float64 numpy array,
where ``counts`` is ``{chunk key: hand-overs}`` of the run: each key's
statistics summed once, times its count. ``dims`` names every dim of ``values`` (``region`` among
them), ``labels`` ``{dim: [label, ...]}`` the dims matched by label (as
strings; the others by position). The check ``<metric>.<variable>``
holds the port's value of that key to it over every dim, in the
reference's order: a dim missing or extra fails, and so does a value of
the port that the reference gives nothing for.

**Resources by name.** A metric-set kwarg whose value is
``{"resource": "<name>"}`` is the generator's resource of that name,
passed to the port as the object itself: the evaluator's own resource
plan decides where it lives. A metric may state ``gap_floor``: the
check's gap is then ``max |got - want| / max(|want|, gap_floor)``, 0 by
default; every check's limit is the traffic's ``limits.metric_rel_gap``.

**Aggregation.** Over ``REDUCE_DIMS`` with area weights, masked and not
skipna, binned by the configuration's ``regions``; the configuration's
``aggregation`` may name a ``land_sea_mask`` resource, and each region
then gains its ``<region>_land`` part.
"""

import copy
import dataclasses
import importlib
import importlib.util
import json
import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)
REDUCE_DIMS = ('init_time', 'latitude', 'longitude')


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
  generator: object  # the generator module
  reference: object  # the reference module

  @property
  def field_levels(self) -> int:
    """Fields a gridpoint: each variable once, an upper-air one
    (``upper_air_variables``) once a level of ``levels``."""
    upper = len(self.config.get('upper_air_variables', ()))
    return (len(self.config['variables'])
            + upper * (len(self.config.get('levels', ())) - 1))

  @property
  def points(self) -> int:
    """Gridpoints a chunk: inits x leads x latitudes x longitudes x
    field-levels."""
    c, t = self.config, self.traffic['chunk']
    return (t['init_times'] * t['leads'] * c['latitudes']
            * c['longitudes'] * self.field_levels)

  @property
  def values_per_chunk(self) -> int:
    """Forecast values a chunk: members (1 where there is no ensemble) x
    the chunk's gridpoints."""
    return self.config.get('members', 1) * self.points


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

  def module(key: str, folder: str, default: str):
    named = config.get(key)
    if named is None:
      return importlib.import_module(f'wbxbench.{default}')
    return _load_file(os.path.join(root, 'wbxbench', folder, f'{named}.py'),
                      f'wbxbench_{folder}_{named}')
  return Cell(
      name=name, chips=int(entry['chips']), config=config, traffic=traffic,
      scorings=scorings,
      end_to_end=[m for m in bench['end_to_end'] if _reports(m, name)],
      per_layer=[m for m in bench['per_layer'] if _reports(m, name)],
      root=root,
      generator=module('generator_module', 'generators', 'traffic'),
      reference=module('reference_module', 'references', 'reference'))


def with_resources(kwargs: dict, resources: dict) -> dict:
  """``kwargs`` with each value ``{"resource": name}`` replaced by
  ``resources[name]``."""
  out = dict(kwargs)
  for key, value in kwargs.items():
    if isinstance(value, dict) and set(value) == {'resource'}:
      if value['resource'] not in resources:
        raise KeyError(f'no resource {value["resource"]!r} (the generator '
                       f'gives {sorted(resources)})')
      out[key] = resources[value['resource']]
  return out


def port_metrics(scoring: Scoring, resources: dict = None) -> dict:
  """{name: Metric} of the port, built from the metric set's class paths
  (relative to ``weatherbenchx_tpu_torch.metrics``) and arguments, each
  ``{"resource": name}`` among them the generator's resource."""
  out = {}
  for name, m in scoring.metrics.items():
    module, cls = m['port'].rsplit('.', 1)
    mod = importlib.import_module(f'weatherbenchx_tpu_torch.metrics.{module}')
    out[name] = getattr(mod, cls)(**with_resources(m.get('kwargs', {}),
                                                   resources or {}))
  return out


def port_aggregator(cell: Cell, resources: dict = None):
  """The port's ``Aggregator`` of the cell (module docstring): area
  weights and the configuration's regions, with their land parts where
  its ``aggregation`` names a ``land_sea_mask``, over ``REDUCE_DIMS``."""
  from weatherbenchx_tpu_torch import aggregation, binning, weighting
  agg = with_resources(cell.config.get('aggregation', {}), resources or {})
  return aggregation.Aggregator(
      reduce_dims=list(REDUCE_DIMS),
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(cell.config['regions'],
                              land_sea_mask=agg.get('land_sea_mask'))],
      masked=True)


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
