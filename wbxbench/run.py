"""Runs one cell of the port's benchmark once, on the card it is started on.

  python3 -m wbxbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout. The cell's files are found by name
(``spec.py``, which also gives the contracts of a generator module, a
reference module and a resource named in a metric set). Set-up (counted
in ``setup_s``, from the start of the process): ``import torch`` and the
port, the CUDA context, the pool of distinct chunks made on the card from
``--seed`` and the resources its metric sets and aggregation name
(climatologies, a land-sea mask), by the cell's generator module
(``traffic.py`` unless the configuration names another), one evaluator
per scoring, and each pool chunk handed over once through the timed
calls (the kernel library is loaded, and on a checkout's first run
built, there), its values taken to the host; then the kernel route of
those chunks is held to the traffic's ``route`` (launches and member
counts a chunk, the fused kernel's form), and a cell that takes another
route stops here, untimed.

The window: chunk after chunk of the pool, each as fresh ``DimArray``s
with init times of its own, goes through the calls
``EvaluationPipeline.run`` makes a chunk (``ChunkEvaluator.prepare_pair``
then ``eval_accum``, into one state a scoring), a CUDA event recorded after
its last call, the host kept at most ``AHEAD`` chunks ahead of the card,
until ``--seconds`` have passed; then the metric values
(``AggregationState.metric_values``) are copied to the host. With
``--trace 1`` a profiled stretch of the traffic's ``trace_chunks`` chunks
follows the window, in the same states, before the values are taken.

Then, the peak memory read and the port's states freed, the plain
reference (``reference.py`` unless the configuration names another) works
every metric value out again in float64 from the same pool and resources,
summed over as many chunks of each chunk key (the generator's
``chunk_key``: the pool chunk, and whatever else decides a chunk's
statistics) as the run handed over, and each metric's largest relative
gap, over every dim of the reference's values, is held to its limit (a
value of the port that the reference leaves out fails): that decides
``correct``. The last line of standard output is the result, one
JSON object; the numbers compared, each beside its limit, end both it
(``checks``) and standard error.

Without a CUDA card (or with fewer than the cell's chips) it exits with 2
and prints no result; so it does, with 3, where a module whose top-level
name is jax, jaxlib, flax or weatherbenchx_tpu (the JAX package) is loaded
once the window has closed. ``--control bf16`` runs the control of the
comparison, the port's own bfloat16 path (the pool handed over in
bfloat16, as the generator makes it with ``dtype``); the benchmark's own
runs never do.
"""

import time

_PROCESS_START = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse
import collections
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'weatherbenchx_tpu')
# Chunks the host may run ahead of the card.
AHEAD = 2


class RouteError(RuntimeError):
  """The cell's chunks took another kernel route than its traffic names."""


def forbidden_modules(names) -> list:
  """The names among ``names`` whose top-level name (before the first
  dot), compared whole, is one of FORBIDDEN_MODULES."""
  return sorted(n for n in names if n.split('.')[0] in FORBIDDEN_MODULES)


def log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
  """'<name>, <power limit>' of the card by nvidia-smi, or what failed."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30, check=True).stdout
    return out.strip().splitlines()[0]
  except (OSError, subprocess.SubprocessError, IndexError) as e:
    return f'nvidia-smi failed: {e!r}'


def check_route(route: dict, launches: dict, members: dict, chunks: int,
                spread_form) -> None:
  """Raises RouteError unless ``chunks`` chunks launched each kernel
  ``route[kernel]['launches']`` times a chunk at the member counts
  ``route[kernel]['members']``, the fused and spread-only kernels in the
  form ``route[kernel]['form']`` (``spread_form(members)``)."""
  problems = []
  for kernel, count in launches.items():
    want = route.get(kernel, {'launches': 0})
    if count != chunks * want['launches']:
      problems.append(f'{kernel}: {count} launches in {chunks} chunks, want '
                      f'{want["launches"]} a chunk')
    want_members = {tuple(m) if isinstance(m, list) else m
                    for m in want.get('members', [])}
    if set(members.get(kernel, ())) != want_members:
      problems.append(f'{kernel}: member counts {sorted(members[kernel])}, '
                      f'want {sorted(want_members)}')
    if 'form' in want:
      forms = {spread_form(m) for m in want_members}
      if forms != {want['form']}:
        problems.append(f'{kernel}: form {sorted(forms)}, want '
                        f'{want["form"]!r}')
  if problems:
    raise RouteError('kernel route: ' + '; '.join(problems))


class _Marks:
  """An end mark after each chunk's last call, and the wait that keeps the
  host AHEAD chunks ahead: CUDA events on a card, the host clock (the CPU
  runs each call to its end) elsewhere."""

  def __init__(self, torch, device):
    self._torch = torch
    self._cuda = torch.device(device).type == 'cuda'
    self.marks = []
    self._start = self._new()

  def _new(self):
    if self._cuda:
      event = self._torch.cuda.Event(enable_timing=True)
      event.record()
      return event
    return time.perf_counter()

  def mark(self) -> None:
    self.marks.append(self._new())

  def wait_for(self, i: int) -> None:
    if self._cuda and i >= 0:
      self.marks[i].synchronize()

  def intervals_ms(self) -> list:
    """Each chunk's interval, from the previous chunk's end (the window's
    start for the first) to its own."""
    out, prev = [], self._start
    for m in self.marks:
      out.append(prev.elapsed_time(m) if self._cuda else 1e3 * (m - prev))
      prev = m
    return out


def _host_values(values: dict) -> dict:
  """{key: (dims, float64 numpy, {dim: [label as str]} of the dims with
  coords)} of metric values."""
  out = {}
  for key, da in values.items():
    labels = {d: list(map(str, da.coord_values(d))) for d in da.dims
              if da.has_coord(d)}
    out[key] = (da.dims, da.data.detach().cpu().double().numpy(), labels)
  return out


def _gap(got, want, floor: float) -> float:
  """The relative gap (``reference.relative_gap``) of port values ``got``
  (from _host_values) against the reference's ``want`` (dims, values,
  labels), laid out as ``want``: its dims in its order, the dims it labels
  in its label order; inf if missing or laid out otherwise."""
  from wbxbench import reference
  if got is None:
    return math.inf
  dims, data, labels = got
  want_dims, want_data, want_labels = want
  if sorted(dims) != sorted(want_dims):
    return math.inf
  data = data.transpose([dims.index(d) for d in want_dims])
  for axis, d in enumerate(want_dims):
    if d in want_labels:
      have, order = labels.get(d), [str(x) for x in want_labels[d]]
      if have is None or sorted(have) != sorted(order):
        return math.inf
      data = data.take([have.index(x) for x in order], axis=axis)
  return reference.relative_gap(data, want_data, floor)


def run(cell, seed: int, seconds: float, trace: bool, device='cuda',
        control: str = None) -> dict:
  """One run of ``cell`` (a ``spec.Cell``) on ``device``; returns the
  result (the last line's object; its ``checks`` last)."""
  import torch
  from weatherbenchx_tpu_torch import aggregation
  from weatherbenchx_tpu_torch.ops import crps_pairwise
  from weatherbenchx_tpu_torch.parallel import evaluator
  from wbxbench import reference, spec
  torch.set_num_threads(1)
  cuda = torch.device(device).type == 'cuda'
  if control not in (None, 'bf16'):
    raise ValueError(f'unknown control {control!r}')
  config, traffic, gen = cell.config, cell.traffic, cell.generator
  mask = torch.from_numpy(reference.validity_mask(config)).to(device)
  if control == 'bf16':
    program_pool = gen.make_pool(config, traffic, seed, device,
                                 dtype=torch.bfloat16)
  else:
    pool = program_pool = gen.make_pool(config, traffic, seed, device)
  resources = gen.resources(config, traffic, seed, device)
  scorers = []
  for scoring in cell.scorings:
    metrics = spec.port_metrics(scoring, resources)
    scorers.append((scoring, metrics, evaluator.ChunkEvaluator(
        metrics, spec.port_aggregator(cell, resources), device=device)))
  n_pool = len(program_pool)

  def hand_over(c: int, states: list, ranges: bool) -> float:
    """Chunk c through every scoring; the host seconds in the port's
    calls."""
    host = 0.0
    pc = program_pool[c % n_pool]
    for k, (scoring, _, ev) in enumerate(scorers):
      preds, tgts = gen.handover(config, traffic, pc, c, scoring.target,
                                 mask)
      t = time.perf_counter()
      with _range(torch, 'bench.prepare_pair', ranges):
        pair = ev.prepare_pair(preds, tgts)
      with _range(torch, 'bench.eval_accum', ranges):
        states[k] = ev.eval_accum(pair, states[k])
      host += time.perf_counter() - t
    return host

  def zero() -> list:
    return [aggregation.AggregationState.zero() for _ in scorers]

  def route(chunks: int) -> None:
    if cuda:
      check_route(traffic['route'], dict(crps_pairwise.LAUNCHES),
                  {k: set(v) for k, v in crps_pairwise.MEMBER_COUNTS.items()},
                  chunks, crps_pairwise.spread_form)

  # Set-up: every pool chunk once through the timed calls, and the values.
  crps_pairwise.reset_launch_counts()
  warm = zero()
  for c in range(n_pool):
    hand_over(c, warm, False)
  for (_, metrics, _), state in zip(scorers, warm):
    _host_values(state.metric_values(metrics))
  if cuda:
    torch.cuda.synchronize()
  route(n_pool)
  del warm
  crps_pairwise.reset_launch_counts()

  # The window.
  states = zero()
  host_chunk_s = []
  full_gc = _FullCollections()
  gc.callbacks.append(full_gc)
  t0 = time.perf_counter()
  setup_s = t0 - _PROCESS_START
  marks = _Marks(torch, device)
  c = 0
  while True:
    marks.wait_for(c - AHEAD)
    host_chunk_s.append(hand_over(n_pool + c, states, False))
    marks.mark()
    c += 1
    if time.perf_counter() - t0 >= seconds:
      break
  window_chunks = c
  traced = None
  if trace:
    traced = _traced_stretch(torch, device, traffic['trace_chunks'],
                             lambda k: hand_over(n_pool + k, states, True),
                             window_chunks, list(crps_pairwise.LAUNCHES))
    c += traffic['trace_chunks']
  chunks = c
  values = [_host_values(state.metric_values(metrics))
            for (_, metrics, _), state in zip(scorers, states)]
  t_values = time.perf_counter()
  gc.callbacks.remove(full_gc)
  route(chunks)
  peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
  kind = torch.cuda.get_device_name(0) if cuda else 'cpu'
  card = card_line() if cuda else 'cpu'

  # The port's state freed; the reference from the same pool.
  del states, scorers, program_pool
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  if control == 'bf16':
    pool = gen.make_pool(config, traffic, seed, device)
  counts = collections.Counter(
      gen.chunk_key(config, traffic, k, n_pool)
      for k in range(n_pool, n_pool + chunks))
  t_ref = time.perf_counter()
  checks = _checks(cell, values, pool, resources, counts, device)
  reference_s = time.perf_counter() - t_ref
  correct = bool(checks) and all(
      v['value'] is not None and v['value'] <= v['limit']
      for v in checks.values())

  device_info = {'platform': 'gpu' if cuda else 'cpu', 'kind': kind,
                 'count': cell.chips, 'memory_peak_bytes': int(peak_bytes),
                 'card': card}
  if trace:
    metrics_out = _layer_metrics(cell, traced, host_chunk_s)
    device_info.update(busy_s=traced['busy_s'], window_s=traced['window_s'])
  else:
    intervals = marks.intervals_ms()
    e2e = {
        'values_per_s': window_chunks * cell.values_per_chunk / (
            t_values - t0),
        'chunk_ms_p90': (statistics.quantiles(intervals, n=10,
                                              method='inclusive')[8]
                         if len(intervals) > 1 else intervals[0]),
        'peak_mem_gib': peak_bytes / 2**30,
        'setup_s': setup_s,
    }
    metrics_out = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
  log(f'{cell.name} seed {seed}: {window_chunks} chunks in the window, '
      f'{chunks} in all ({len(counts)} chunk keys: {dict(counts)}), setup '
      f'{setup_s:.3f} s, window to values {t_values - t0:.3f} s '
      f'({full_gc.count} full collections of the Python heap, '
      f'{full_gc.seconds:.3f} s), reference '
      f'{reference_s:.3f} s, card {card}, control {control}')
  result = {'correct': correct, 'attempted': chunks, 'failed': 0,
            'metrics': metrics_out, 'device': device_info}
  if trace:
    result['breakdown'] = {'device_ops': traced['device_ops'],
                           'idle_gaps': traced['idle_gaps']}
  result['checks'] = checks
  return result


class _FullCollections:
  """A ``gc.callbacks`` entry that counts the interpreter's collections of
  its oldest generation, and their seconds: with torch loaded each takes
  about a tenth of a second, in which the host enqueues nothing."""

  def __init__(self):
    self.count, self.seconds, self._start = 0, 0.0, None

  def __call__(self, phase: str, info: dict) -> None:
    if info.get('generation') != 2:
      return
    if phase == 'start':
      self._start = time.perf_counter()
    elif self._start is not None:
      self.count += 1
      self.seconds += time.perf_counter() - self._start
      self._start = None


def _range(torch, name: str, on: bool):
  return (torch.profiler.record_function(name) if on
          else contextlib.nullcontext())


def _traced_stretch(torch, device, n: int, hand_over, first: int,
                    kernels: list) -> dict:
  """``n`` chunks (``first``, ``first + 1``, ...) under ``torch.profiler``
  in a ``bench.traced`` range, after and before a synchronize; the trace
  reduced by ``trace.reduce``. The stretch starts after a full collection
  of the Python heap: the profiler's own objects would otherwise bring the
  next one into a stretch of about a second, where its 0.1-0.2 s reads as
  10-20% idle, against a few tenths of a percent over the window."""
  from wbxbench import trace as trace_lib
  cuda = torch.device(device).type == 'cuda'
  activities = [torch.profiler.ProfilerActivity.CPU]
  if cuda:
    activities.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
  gc.collect()
  marks = _Marks(torch, device)
  with tempfile.TemporaryDirectory() as tmp:
    with torch.profiler.profile(activities=activities) as prof:
      with torch.profiler.record_function(trace_lib.WINDOW_RANGE):
        for k in range(n):
          with torch.profiler.record_function('bench.wait'):
            marks.wait_for(k - AHEAD)
          hand_over(first + k)
          marks.mark()
        with torch.profiler.record_function('bench.sync'):
          if cuda:
            torch.cuda.synchronize()
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    return trace_lib.reduce(path, kernels)


def _checks(cell, values: list, pool: list, resources: dict,
            counts: collections.Counter, device) -> dict:
  """{'<metric>.<variable>': {'value': the largest relative gap to the
  cell's reference module (each metric's ``gap_floor``, else 0), or None
  where a value is missing, not finite or not in the reference; 'limit':
  the traffic's ``metric_rel_gap``}}."""
  limit = cell.traffic['limits']['metric_rel_gap']
  checks = {}
  for scoring, got in zip(cell.scorings, values):
    want = cell.reference.values(cell.config, cell.traffic, scoring, pool,
                                 resources, counts, device)
    for name, per_variable in want.items():
      floor = scoring.metrics[name].get('gap_floor', 0.0)
      for var, w in per_variable.items():
        gap = _gap(got.get(f'{name}.{var}'), w, floor)
        checks[f'{name}.{var}'] = {
            'value': gap if math.isfinite(gap) else None, 'limit': limit}
    for key in got:
      checks.setdefault(key, {'value': None, 'limit': limit})
  return checks


def _layer_metrics(cell, traced: dict, host_chunk_s: list) -> dict:
  """{name: {'value', 'unit'}} of the cell's per-layer metrics that its
  readers find something to read for."""
  from wbxbench import peaks, spec, trace as trace_lib
  calls = _kernel_calls(cell)
  ctx = trace_lib.Context(
      chunks=cell.traffic['trace_chunks'], window_s=traced['window_s'],
      busy_s=traced['busy_s'], kernels=traced['kernels'],
      ranges=traced['ranges'], calls=calls, host_chunk_s=host_chunk_s,
      bytes_moved={k: spec.byte_count(k, cell.root) for k in calls},
      hbm_bytes_per_s=peaks.HBM_BYTES_PER_S)
  out = {}
  for entry in cell.per_layer:
    value = spec.reader(entry['name'], cell.root)(ctx)
    if value is not None:
      out[entry['name']] = {'value': value, 'unit': entry['unit']}
  return out


def _kernel_calls(cell) -> dict:
  """{kernel: (members, points, itemsize)} of one call, from the traffic's
  route and the chunk's shape: the member count of the route's call (one
  count a kernel on these routes) over a chunk's gridpoints, float32."""
  out = {}
  for kernel, want in cell.traffic['route'].items():
    if want.get('launches') and want.get('members'):
      m = want['members'][0]
      out[kernel] = (tuple(m) if isinstance(m, list) else m, cell.points, 4)
  return out


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  p.add_argument('--control', choices=('bf16',), default=None)
  args = p.parse_args(argv)
  from wbxbench import spec
  cell = spec.resolve(args.workload)
  import torch
  if not torch.cuda.is_available() or (
      torch.cuda.device_count() < cell.chips):
    log(f'{args.workload} needs {cell.chips} CUDA card(s); '
        f'torch.cuda.is_available() is {torch.cuda.is_available()}')
    return 2
  try:
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 control=args.control)
  except RouteError as e:
    log(str(e))
    return 4
  found = forbidden_modules(sys.modules)
  if found:
    log(f'modules of the JAX stack or the JAX package loaded: {found}')
    return 3
  for name, check in result['checks'].items():
    log(f'check {name}: {check["value"]!r} (limit {check["limit"]!r})')
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
