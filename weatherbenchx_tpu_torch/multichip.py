"""Ranks on one machine: the launcher, and the multi-device dryrun.

``run_ranks`` starts ``world`` processes with the ``spawn`` method (a
forked CUDA context is unusable), each a rank of a ``torch.distributed``
process group met through a ``file://`` rendezvous in a fresh directory
(no TCP port to collide with), calls ``target(rank, world, **kwargs)`` in
each and returns the ranks' results in rank order. A rank that raises, or
a run past its time limit, fails the call and stops every rank.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: ``n`` gloo ranks (sharing the one
GPU by default; ``device='cpu'`` runs them on the CPU) run the six phases its
``MULTICHIP`` record lists, on the mesh shapes the JAX code uses
(``(2, n/4, 2)`` as batch x space x ensemble, else ``(2, n/2)``, else
``(n,)``), and each phase is held to the direct single-chunk result:

1. the sharded step (fair CRPS, spread/skill, ensemble-mean RMSE, area
   weights and two regions; ``number`` sharded, so gathered first);
2. the sharded multi-chunk pipeline with checkpoints and a sink;
3. the unaggregated zarr stream that sink wrote;
4. a failure mid-run, then the resume from the checkpoint, on the mesh;
5. ragged sparse chunks over chunk-parallel ranks (``distributed``): the
   stations differ per chunk, so the cross-rank sum takes the outer join;
6. padded sparse chunks with the station ``index`` sharded over the mesh.

Rank 0 prints one line per phase. Run it as ``python -m
weatherbenchx_tpu_torch.multichip [n] [--device cuda|cpu]`` (``cuda`` is the
default and raises without a GPU).
"""

import datetime
import importlib
import importlib.util
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np


def _resolve(target: str):
  """``'package.module:function'`` or ``'/path/file.py:function'``."""
  module_name, _, fn = target.rpartition(':')
  if module_name.endswith('.py'):
    spec = importlib.util.spec_from_file_location(
        '_wbx_rank_' + os.path.basename(module_name)[:-3], module_name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
  else:
    module = importlib.import_module(module_name)
  return getattr(module, fn)


def _rank_main(rank, world, target, kwargs, rendezvous, out_dir, backend,
               timeout_s, num_threads):
  import torch
  import torch.distributed as dist
  if num_threads:
    torch.set_num_threads(num_threads)
  try:
    dist.init_process_group(
        backend, init_method=f'file://{rendezvous}', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
      result = ('ok', _resolve(target)(rank, world, **kwargs))
    finally:
      dist.destroy_process_group()
  except BaseException:  # reported to the parent, which raises it
    result = ('error', traceback.format_exc())
  with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(result, f)
  sys.stdout.flush()
  if result[0] == 'error':
    sys.exit(1)  # the parent then stops the other ranks


def run_ranks(target: str, world: int, kwargs: dict | None = None,
              backend: str = 'gloo', timeout_s: float = 300.0,
              num_threads: int | None = None) -> list:
  """Each rank's ``target(rank, world, **kwargs)``, in rank order.

  Args:
    target: ``'module:function'`` or ``'/path/file.py:function'``; it and
      its result must pickle (the result is read back by this process).
    world: number of ranks.
    kwargs: keyword arguments for every rank.
    backend: the process group's backend, e.g. ``'gloo'`` or
      ``'cpu:gloo,cuda:nccl'``.
    timeout_s: the collectives' timeout, and (plus a minute) the whole
      run's: past it the ranks are killed and this raises.
    num_threads: torch's intra-op threads in each rank, if given.
  """
  ctx = multiprocessing.get_context('spawn')
  with tempfile.TemporaryDirectory(prefix='wbx_ranks_') as tmp:
    rendezvous = os.path.join(tmp, 'rendezvous')
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, target, kwargs or {}, rendezvous, tmp, backend, timeout_s,
        num_threads)) for r in range(world)]
    for p in procs:
      p.start()
    deadline = time.monotonic() + timeout_s + 60
    try:
      while any(p.is_alive() for p in procs):
        if (any(p.exitcode not in (None, 0) for p in procs)
            or time.monotonic() > deadline):
          break
        time.sleep(0.05)
    finally:
      for p in procs:
        if p.is_alive():
          p.kill()
        p.join(30)
    results, errors = [], []
    for r, p in enumerate(procs):
      path = os.path.join(tmp, f'rank{r}.pkl')
      if not os.path.exists(path):
        errors.append(f'rank {r} ended (exit code {p.exitcode}) without a '
                      'result: killed past the time limit, or by a failing '
                      'rank')
        continue
      with open(path, 'rb') as f:
        status, value = pickle.load(f)  # written by this call's own ranks
      if status == 'error':
        errors.append(f'rank {r} raised:\n{value}')
      results.append(value)
    if errors:
      raise RuntimeError('\n'.join(errors))
    return results


def mesh_shape(n: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
  """The JAX dryrun's mesh for ``n`` devices: (shape, axis names)."""
  if n % 4 == 0:
    return (2, n // 4, 2), ('batch', 'space', 'ensemble')
  if n % 2 == 0:
    return (2, n // 2), ('batch', 'space')
  return (n,), ('space',)


# -- the dryrun --------------------------------------------------------------


def _row_error(h, lt, j):
  lead_h = int(lt // np.timedelta64(6, 'h'))
  return 1.0 + ((h * 7 + j * 13 + lead_h * 5) % 17) / 17.0


def _ragged_loader_class():
  from weatherbenchx_tpu_torch.darray import Coord, DimArray
  from weatherbenchx_tpu_torch.data import base as data_base

  class RaggedSparseLoader(data_base.DataLoader):
    """Station rows whose station set changes from init to init; the
    per-row error is a function of (init hour, lead, station), so a join
    that drops or double-counts a row moves that station's MSE."""

    def __init__(self, init0, with_error=False, **kw):
      super().__init__(**kw)
      self._init0 = init0
      self._with_error = with_error

    def _load_chunk_from_source(self, init_times_, lead_times_=None):
      rows = []
      for it in init_times_:
        h = int((it - self._init0) // np.timedelta64(6, 'h'))
        stations = [f'S{j:03d}' for j in range(2 + (h % 3))]
        for lt in lead_times_:
          for j, s in enumerate(stations):
            rows.append((it, lt, s,
                         _row_error(h, lt, j) if self._with_error else 0.0))
      n = len(rows)
      coords = {
          'init_time': Coord(('index',), np.array(
              [r[0] for r in rows], dtype='datetime64[ns]')),
          'lead_time': Coord(('index',), np.array(
              [r[1] for r in rows], dtype='timedelta64[ns]')),
          'stationName': Coord(('index',), np.array([r[2] for r in rows])),
          'index': Coord(('index',), np.arange(n)),
      }
      base = 280.0 + np.random.default_rng(n).standard_normal(n)
      return {'t': DimArray(
          (base + np.array([r[3] for r in rows])).astype(np.float32),
          ('index',), coords)}

  return RaggedSparseLoader


def _assert_close(got, want, label, atol=1e-5):
  for k, d in want.items():
    g = got[k]
    g = g.transpose(*d.dims) if set(g.dims) == set(d.dims) else g
    a = np.asarray(g.values, np.float64)
    b = np.asarray(d.values, np.float64)
    if a.shape != b.shape or not np.allclose(a, b, atol=atol):
      raise AssertionError(f'{label}: {k} differs from the direct result: '
                           f'{a} vs {b}')


def _dryrun_rank(rank, world, work_dir, device):
  """One rank of ``dryrun_multichip``; returns the lines rank 0 printed."""
  from torch.distributed.device_mesh import init_device_mesh
  from weatherbenchx_tpu_torch import aggregation, binning, test_utils
  from weatherbenchx_tpu_torch import time_chunks as tc
  from weatherbenchx_tpu_torch import weighting
  from weatherbenchx_tpu_torch.darray import DimArray
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.metrics import base as metrics_base
  from weatherbenchx_tpu_torch.metrics import deterministic, probabilistic
  from weatherbenchx_tpu_torch.metrics import wrappers
  from weatherbenchx_tpu_torch.parallel import distributed as dist_lib
  from weatherbenchx_tpu_torch.parallel import evaluator as evaluator_lib
  from weatherbenchx_tpu_torch.parallel import pipeline as pl
  from weatherbenchx_tpu_torch.parallel import unaggregated

  lines = []

  def say(line):
    if rank == 0:
      print(line, flush=True)
      lines.append(line)

  shape, axes = mesh_shape(world)
  # A gloo mesh: its groups serve tensors on any device.
  mesh = init_device_mesh('cpu', shape, mesh_dim_names=axes)
  dim_to_axis = {d: a for d, a in (('init_time', 'batch'),
                                   ('longitude', 'space'),
                                   ('number', 'ensemble')) if a in axes}

  # Phase 1: the flagship step on the mesh.
  preds, tgts = test_utils.canonical_forecast_pair(
      n_init=2 * shape[0], n_lead=2, spatial_resolution_in_degrees=10.0,
      ensemble_size=8, seed=0)
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'unbiased_spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
      'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
      'mean_rmse': wrappers.WrappedMetric(
          deterministic.RMSE(), [wrappers.EnsembleMean(which='predictions')]),
  }
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                               'nh': ((20, 90), (0, 360))})])
  ev = evaluator_lib.ChunkEvaluator(metrics, agg, device, mesh=mesh,
                                    dim_to_axis=dim_to_axis)
  vals = ev.eval_chunk(preds, tgts).to_host().metric_values(metrics)
  _assert_close(vals, aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, preds, tgts), 'sharded step')
  crps = vals['crps.2m_temperature'].values
  if not np.all(np.isfinite(crps)):
    raise AssertionError(f'non-finite CRPS {crps}')
  say(f'dryrun_multichip({world}) OK: mesh={dict(zip(axes, shape))} '
      f'crps[global]={crps[..., 0]}')

  # Phases 2-4: the pipeline on the mesh.
  rng = np.random.default_rng(11)
  lats = np.linspace(-90, 90, 19)
  lons = np.linspace(0, 360, 36, endpoint=False)
  n_valid, n_lead, ens = 12, 2, 8
  valid_times = (np.datetime64('2020-01-01', 'ns')
                 + np.arange(n_valid) * np.timedelta64(6, 'h'))
  lead_times = (np.arange(n_lead) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')
  init_times = valid_times[:n_valid - n_lead]
  tgt = {'2m_temperature': DimArray(
      rng.standard_normal((n_valid, 19, 36)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})}
  pred = {'2m_temperature': DimArray(
      rng.standard_normal(
          (ens, len(init_times), n_lead, 19, 36)).astype(np.float32),
      ('number', 'init_time', 'lead_time', 'latitude', 'longitude'),
      {'number': np.arange(ens), 'init_time': init_times,
       'lead_time': lead_times, 'latitude': lats, 'longitude': lons})}
  metrics = {
      'crps': probabilistic.CRPSEnsemble(use_sort=True),
      'mean_rmse': wrappers.WrappedMetric(
          deterministic.RMSE(), [wrappers.EnsembleMean(which='predictions')]),
  }
  agg = aggregation.Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()])
  times = tc.TimeChunks(init_times, lead_times, init_time_chunk_size=2,
                        lead_time_chunk_size=2)

  def mk_loaders():
    return (loaders.PredictionsFromDataset(ds=pred, rename_dimensions=None),
            loaders.TargetsFromDataset(ds=tgt, rename_dimensions=None))

  p_loader, t_loader = mk_loaders()
  p_all = p_loader.load_chunk(init_times, lead_times)
  t_all = t_loader.load_chunk(init_times, lead_times)
  direct = aggregation.compute_metric_values_for_single_chunk(
      metrics, agg, p_all, t_all)

  first = pl.first_of_mesh(mesh)
  store_path = os.path.join(work_dir, 'unagg.zarr')
  store = unaggregated.ZarrStatsStore(times, store_path) if first else None
  p_loader, t_loader = mk_loaders()
  state = pl.EvaluationPipeline(
      metrics=metrics, aggregator=agg, predictions_loader=p_loader,
      targets_loader=t_loader, times=times, device=device, mesh=mesh,
      dim_to_axis=dim_to_axis,
      checkpoint_path=os.path.join(work_dir, 'ckpt'), checkpoint_every=2,
      chunk_stats_sink=store.write_chunk if first else lambda *a: None).run()
  _assert_close(state.metric_values(metrics), direct, 'sharded pipeline')
  say('dryrun pipeline: sharded multi-chunk run == direct OK')

  if first:
    store.finalize()
  dist_lib.barrier()
  unagg = unaggregated.load_unaggregated(store_path)
  stats = metrics_base.compute_unique_statistics_for_all_metrics(
      metrics, p_all, t_all)
  se_keys = [k for k in unagg if k.startswith('SquaredError_')]
  if not se_keys:
    raise AssertionError(f'no SquaredError statistic in {sorted(unagg)}')
  for key in se_keys:
    stat_name, var = key.rsplit('.', 1)
    _assert_close({key: unagg[key]}, {key: stats[stat_name][var]},
                  'unaggregated zarr stream')
  se = unagg[se_keys[0]]
  say('dryrun pipeline: unaggregated Zarr stream OK '
      f'{dict(zip(se.dims, se.shape))}')

  p_loader, t_loader = mk_loaders()
  calls = {'n': 0}
  load = p_loader.load_chunk

  def failing(init_times_, lead_times_, reference=None):
    if calls['n'] >= 3:
      raise RuntimeError('injected')
    calls['n'] += 1
    return load(init_times_, lead_times_, reference=reference)

  p_loader.load_chunk = failing

  def resumable(p_loader_, t_loader_):
    return pl.EvaluationPipeline(
        metrics=metrics, aggregator=agg, predictions_loader=p_loader_,
        targets_loader=t_loader_, times=times, device=device, mesh=mesh,
        dim_to_axis=dim_to_axis,
        checkpoint_path=os.path.join(work_dir, 'ckpt2'), checkpoint_every=1)

  try:
    resumable(p_loader, t_loader).run()
    raise AssertionError('expected the injected failure')
  except RuntimeError as e:
    if 'injected' not in str(e):
      raise
  dist_lib.barrier()
  _assert_close(resumable(*mk_loaders()).run().metric_values(metrics),
                direct, 'failure + resume')
  say('dryrun pipeline: failure + resume == direct OK')

  # Phase 5: ragged sparse chunks over chunk-parallel ranks.
  loader_cls = _ragged_loader_class()
  sparse_metrics = {'mse': deterministic.MSE()}
  sparse_agg = aggregation.Aggregator(
      reduce_dims=['index'], bin_by=[binning.ByExactCoord('stationName')])
  joins = {'n': 0}
  join = aggregation._outer_join_sum

  def counting_join(arrays):
    joins['n'] += 1
    return join(arrays)

  aggregation._outer_join_sum = counting_join
  try:
    sparse_state = pl.EvaluationPipeline(
        metrics=sparse_metrics, aggregator=sparse_agg,
        predictions_loader=loader_cls(init_times[0], with_error=True),
        targets_loader=loader_cls(init_times[0]), times=times,
        device=device, distributed=True).run()
  finally:
    aggregation._outer_join_sum = join
  if not joins['n']:
    raise AssertionError('the ragged phase never took the outer join')
  sp = loader_cls(init_times[0], with_error=True).load_chunk(
      init_times, lead_times)
  st = loader_cls(init_times[0]).load_chunk(init_times, lead_times)
  sparse_direct = aggregation.compute_metric_values_for_single_chunk(
      sparse_metrics, sparse_agg, sp, st)

  def by_station(da):
    return dict(zip(np.asarray(da.coord_values('stationName')),
                    np.asarray(da.values, np.float64).reshape(-1)))

  got = by_station(sparse_state.metric_values(sparse_metrics)['mse.t'])
  want = by_station(sparse_direct['mse.t'])
  if set(got) != set(want) or np.std(list(want.values())) <= 0.01 or any(
      abs(got[s] - w) >= 1e-4 for s, w in want.items()):
    raise AssertionError(f'ragged sparse: {got} vs {want}')
  say(f'dryrun pipeline: ragged sparse outer-join OK (joins={joins["n"]}) '
      'mse/station=' + ','.join(f'{v:.3f}' for v in got.values()))

  # Phase 6: padded sparse chunks, the index sharded over the mesh.
  index_axis = 'space' if 'space' in axes else axes[0]
  pad = 8 * shape[axes.index(index_axis)]
  shard_agg = aggregation.Aggregator(reduce_dims=['index'], masked=True)
  shard_state = pl.EvaluationPipeline(
      metrics=sparse_metrics, aggregator=shard_agg,
      predictions_loader=loader_cls(init_times[0], with_error=True,
                                    pad_index_multiple=pad),
      targets_loader=loader_cls(init_times[0], pad_index_multiple=pad),
      times=times, device=device, mesh=mesh,
      dim_to_axis={'index': index_axis}).run()
  got = float(shard_state.metric_values(sparse_metrics)['mse.t'].values)
  want = float(aggregation.compute_metric_values_for_single_chunk(
      sparse_metrics, shard_agg, sp, st)['mse.t'].values)
  if abs(got - want) >= 1e-4:
    raise AssertionError(f'sharded padded sparse: {got} vs {want}')
  say(f'dryrun pipeline: sharded padded sparse OK mse={got:.4f}')
  return lines


def dryrun_multichip(n_devices: int, device: str = 'cuda',
                     timeout_s: float = 300.0) -> list[str]:
  """Runs the six phases on ``n_devices`` gloo ranks; returns the lines
  rank 0 printed. ``device`` is every rank's device: one GPU the ranks
  share (the default; raises without one), or ``'cpu'``."""
  import torch
  if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'dryrun_multichip(device={device!r}): no CUDA device is available '
        "(pass device='cpu' to run the ranks on the CPU)")
  with tempfile.TemporaryDirectory(prefix='wbx_dryrun_') as work_dir:
    return run_ranks('weatherbenchx_tpu_torch.multichip:_dryrun_rank',
                     n_devices, {'work_dir': work_dir, 'device': device},
                     backend='gloo', timeout_s=timeout_s,
                     num_threads=1 if device == 'cpu' else None)[0]


def main(argv=None) -> None:
  import argparse
  p = argparse.ArgumentParser(description='The six-phase multi-device dryrun '
                              'on gloo ranks of this machine.')
  p.add_argument('n_devices', type=int, nargs='?', default=4,
                 help='Number of ranks (default 4)')
  p.add_argument('--device', default='cuda',
                 help="Every rank's device: 'cuda' (the default; one GPU the "
                      "ranks share, raises without one) or 'cpu'")
  args = p.parse_args(argv)
  dryrun_multichip(args.n_devices, device=args.device)


if __name__ == '__main__':
  main()
