"""Rank bodies for the port's multi-process tests.

``tests/test_torch_distributed.py``, ``test_torch_mesh.py`` and
``test_torch_unaggregated.py`` start real gloo ranks on the CPU with
``weatherbenchx_tpu_torch.multichip.run_ranks``, which loads this file by
path in each rank: it imports torch, numpy and the port, never jax. The
test files import it too, for the numpy inputs that both packages get.
Each ``case_*`` function runs in every rank of one spawn and returns
numpy results (metric values as ``{name: (dims, float64 values)}``).
"""

import os

import numpy as np

# -- inputs shared with the JAX package's tests --------------------------------


def source_arrays(n_valid=16, n_lead=4, seed=0, ens=None, n_lat=7, n_lon=8):
  """``tests/test_pipeline.py:_source_datasets`` as numpy: ({var: (values,
  dims, coords)} predictions, targets, init_times, lead_times)."""
  rng = np.random.default_rng(seed)
  lats = np.linspace(-90, 90, n_lat)
  lons = np.linspace(0, 360, n_lon, endpoint=False)
  valid_times = (np.datetime64('2020-01-01', 'ns')
                 + np.arange(n_valid) * np.timedelta64(6, 'h'))
  lead_times = (np.arange(n_lead) * np.timedelta64(6, 'h')
                ).astype('timedelta64[ns]')
  init_times = valid_times[:n_valid - n_lead]
  tgt = {'2m_temperature': (
      rng.standard_normal((n_valid, n_lat, n_lon)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': valid_times, 'latitude': lats, 'longitude': lons})}
  pshape = (len(init_times), n_lead, n_lat, n_lon)
  pdims = ('init_time', 'lead_time', 'latitude', 'longitude')
  pcoords = {'init_time': init_times, 'lead_time': lead_times,
             'latitude': lats, 'longitude': lons}
  if ens:
    pshape = (ens,) + pshape
    pdims = ('number',) + pdims
    pcoords = {**pcoords, 'number': np.arange(ens)}
  pred = {'2m_temperature': (
      rng.standard_normal(pshape).astype(np.float32), pdims, pcoords)}
  return pred, tgt, init_times, lead_times


def multiprocess_arrays():
  """``tests/test_multiprocess.py:_build_inputs`` as numpy."""
  return source_arrays(n_valid=20, n_lead=2, seed=7)


def climatology_arrays(n_lat=7, n_lon=8, seed=7):
  """A dayofyear x hour climatology of 2m_temperature, as
  ``tests/test_pipeline.py``'s batched and ACC tests build it."""
  return {'2m_temperature': (
      np.random.default_rng(seed).standard_normal(
          (366, 4, n_lat, n_lon)).astype(np.float32),
      ('dayofyear', 'hour', 'latitude', 'longitude'),
      {'dayofyear': np.arange(1, 367), 'hour': np.array([0, 6, 12, 18]),
       'latitude': np.linspace(-90, 90, n_lat),
       'longitude': np.linspace(0, 360, n_lon, endpoint=False)})}


def host_gather_arrays(seed=7, n_valid=12, n_lead=3, n_lat=5, n_lon=6):
  """``tests/test_host_gather_clim.py:_datasets`` as numpy, on an
  ``n_lat`` x ``n_lon`` grid: (pred, tgt, clim, inits, leads)."""
  rng = np.random.default_rng(seed)
  lats = np.linspace(-90, 90, n_lat)
  lons = np.linspace(0, 360, n_lon, endpoint=False)
  valid = (np.datetime64('2020-01-01', 'ns')
           + np.arange(n_valid) * np.timedelta64(6, 'h'))
  leads = (np.arange(n_lead) * np.timedelta64(6, 'h')
           ).astype('timedelta64[ns]')
  inits = valid[:n_valid - n_lead]
  space = {'latitude': lats, 'longitude': lons}

  def rand(shape):
    return rng.standard_normal(shape).astype(np.float32)

  g = (n_lat, n_lon)
  tdims = ('valid_time', 'latitude', 'longitude')
  pdims = ('init_time', 'lead_time', 'latitude', 'longitude')
  tgt = {'2m_temperature': (rand((n_valid,) + g), tdims,
                            {'valid_time': valid, **space}),
         'precip': (np.abs(rand((n_valid,) + g)) * 0.01, tdims,
                    {'valid_time': valid, **space})}
  pcoords = {'init_time': inits, 'lead_time': leads, **space}
  pred = {'2m_temperature': (rand((len(inits), n_lead) + g), pdims, pcoords),
          'precip': (np.abs(rand((len(inits), n_lead) + g)) * 0.01, pdims,
                     pcoords)}
  cdims = ('dayofyear', 'hour', 'latitude', 'longitude')
  ccoords = {'dayofyear': np.arange(1, 367),
             'hour': np.array([0, 6, 12, 18]), **space}
  c = (366, 4) + g
  clim = {'2m_temperature': (rand(c), cdims, ccoords),
          'precip': (np.abs(rand(c)) * 0.01, cdims, ccoords),
          'precip_seeps_dry_fraction': (
              np.clip(np.abs(rand(c)), 0.2, 0.8), cdims, ccoords),
          'precip_seeps_threshold': (
              np.abs(rand(c)) * 0.005 + 0.002, cdims, ccoords)}
  return pred, tgt, clim, inits, leads


# tests/test_torch_unaggregated.py's grids.
UNAGG_INIT = np.arange('2020-01-01T00', '2020-01-03T12',
                       np.timedelta64(12, 'h'), dtype='datetime64[ns]')
UNAGG_LEAD = np.arange(0, 24, 6, dtype='timedelta64[h]').astype(
    'timedelta64[ns]')
UNAGG_VALID = np.arange('2020-01-01T00', '2020-01-04T06',
                        np.timedelta64(6, 'h'), dtype='datetime64[ns]')


def unagg_arrays():
  """``tests/test_torch_unaggregated.py:_loaders``' data as numpy."""
  rng = np.random.default_rng(0)
  space = {'latitude': np.linspace(-60, 60, 5),
           'longitude': np.arange(8) * 45.0}
  pred = {'2m_temperature': (
      rng.standard_normal((len(UNAGG_INIT), len(UNAGG_LEAD), 5, 8)).astype(
          np.float32), ('init_time', 'lead_time', 'latitude', 'longitude'),
      {'init_time': UNAGG_INIT, 'lead_time': UNAGG_LEAD, **space})}
  tgt = {'2m_temperature': (
      rng.standard_normal((len(UNAGG_VALID), 5, 8)).astype(np.float32),
      ('valid_time', 'latitude', 'longitude'),
      {'valid_time': UNAGG_VALID, **space})}
  return pred, tgt


def wrap(mod, arrays):
  """``{var: (values, dims, coords)}`` as DimArrays of package ``mod``."""
  return {var: mod.DimArray(values, dims, coords)
          for var, (values, dims, coords) in arrays.items()}


def as_numpy(values) -> dict:
  """Metric values (of either package) as ``{name: (dims, float64)}``."""
  return {k: (tuple(da.dims), np.asarray(da.values, np.float64))
          for k, da in values.items()}


# -- port-side builders (imported only inside the ranks' functions) -------------


def port():
  from weatherbenchx_tpu_torch import aggregation, binning, darray
  from weatherbenchx_tpu_torch import time_chunks, weighting
  from weatherbenchx_tpu_torch.data import loaders
  from weatherbenchx_tpu_torch.metrics import base, categorical
  from weatherbenchx_tpu_torch.metrics import deterministic, probabilistic
  from weatherbenchx_tpu_torch.metrics import spatial, wrappers
  from weatherbenchx_tpu_torch.parallel import distributed, evaluator
  from weatherbenchx_tpu_torch.parallel import pipeline, unaggregated
  return dict(aggregation=aggregation, binning=binning, darray=darray,
              time_chunks=time_chunks, weighting=weighting, loaders=loaders,
              base=base, categorical=categorical,
              deterministic=deterministic, probabilistic=probabilistic,
              spatial=spatial, wrappers=wrappers, distributed=distributed,
              evaluator=evaluator, pipeline=pipeline,
              unaggregated=unaggregated)


def _loaders(P, pred, tgt, **target_kw):
  return (P['loaders'].PredictionsFromDataset(
              ds=wrap(P['darray'], pred), rename_dimensions=None),
          P['loaders'].TargetsFromDataset(
              ds=wrap(P['darray'], tgt), rename_dimensions=None,
              **target_kw))


def _mesh(shape, names):
  from torch.distributed.device_mesh import init_device_mesh
  return init_device_mesh('cpu', tuple(shape), mesh_dim_names=tuple(names))


def _rmse_bias(P):
  return {'rmse': P['deterministic'].RMSE(), 'bias': P['deterministic'].Bias()}


def _pipe(P, metrics, agg, pred, tgt, times, **kw):
  pl, tl = _loaders(P, pred, tgt)
  return P['pipeline'].EvaluationPipeline(
      metrics=metrics, aggregator=agg, predictions_loader=pl,
      targets_loader=tl, times=times, device='cpu', **kw)


def ensemble_mean_se(P):
  """``test_ensemble_axis_sharding``'s custom statistic: it means over
  ``number`` and declares nothing."""

  class EnsMeanSE(P['base'].PerVariableStatistic):

    def _compute_per_variable(self, predictions, targets):
      return (predictions.mean('number') - targets) ** 2

  return EnsMeanSE()


# -- chunk-parallel ranks (distributed) ----------------------------------------


def case_partition(rank, world):
  """``distributed=True``: the chunks a rank keeps, and the total."""
  P = port()
  pred, tgt, inits, leads = source_arrays()
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[P['weighting'].GridAreaWeighting()])
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=1,
                                      lead_time_chunk_size=2)
  kept = [i for i, _, _ in P['pipeline'].stream_chunk_pairs(
      lambda chunk: chunk, times, distributed=True)]
  state = _pipe(P, _rmse_bias(P), agg, pred, tgt, times,
                distributed=True).run()
  return {'kept': kept, 'values': as_numpy(state.metric_values(
      _rmse_bias(P)))}


def _resume_pipe(P, ckpt, fail_after=None, loads=None, every=1):
  pred, tgt, inits, leads = multiprocess_arrays()
  pl, tl = _loaders(P, pred, tgt)
  inner = pl.load_chunk
  seen = {'n': 0}

  def load_chunk(init_times, lead_times=None, reference=None):
    if fail_after is not None and seen['n'] >= fail_after:
      raise RuntimeError('injected failure for the resume test')
    seen['n'] += 1
    if loads is not None:
      loads.append(1)
    return inner(init_times, lead_times, reference=reference)

  pl.load_chunk = load_chunk
  return P['pipeline'].EvaluationPipeline(
      metrics=_rmse_bias(P),
      aggregator=P['aggregation'].Aggregator(
          reduce_dims=['init_time', 'latitude', 'longitude'],
          weigh_by=[P['weighting'].GridAreaWeighting()]),
      predictions_loader=pl, targets_loader=tl,
      times=P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=2,
                                        lead_time_chunk_size=2),
      device='cpu', distributed=True, checkpoint_path=ckpt,
      checkpoint_every=every, prefetch=1)


def case_resume(rank, world, work_dir):
  """Per-rank checkpoints: a failure mid-run, then the resume; the partial
  state of each rank bit-identical to its uninterrupted one; the cadence
  of local completions; a changed rank count refused."""
  import torch
  P = port()
  dist_lib = P['distributed']
  partial = {}
  real_sum = dist_lib.allgather_sum_states

  def own_state(run):
    # The cross-rank sum, skipped: this rank's partial state.
    dist_lib.allgather_sum_states = lambda state, contribute=True: state
    try:
      return run()
    finally:
      dist_lib.allgather_sum_states = real_sum

  partial['full'] = own_state(_resume_pipe(P, None).run)
  ckpt = os.path.join(work_dir, 'state')
  try:
    _resume_pipe(P, ckpt, fail_after=2).run()
    failed = False
  except RuntimeError as e:
    failed = 'injected' in str(e)
  dist_lib.barrier()
  manifests = sorted(n for n in os.listdir(work_dir)
                     if n.endswith('.manifest.json'))
  loads = []
  partial['resumed'] = own_state(_resume_pipe(P, ckpt, loads=loads).run)
  full, resumed = (partial[k].to_dataset() for k in ('full', 'resumed'))
  bit_identical = set(full) == set(resumed) and all(
      torch.equal(full[k].data, resumed[k].data) for k in full)
  dist_lib.barrier()
  # A run with every chunk done resumes at the end: the total, summed.
  total = _resume_pipe(P, ckpt).run()
  try:
    P['pipeline'].EvaluationPipeline(
        metrics=_rmse_bias(P),
        aggregator=P['aggregation'].Aggregator(reduce_dims=['latitude']),
        predictions_loader=None, targets_loader=None, times=None,
        device='cpu', checkpoint_path=f'{ckpt}.p{rank}')._load_checkpoint()
    mismatch = None
  except ValueError as e:
    mismatch = str(e)
  cadence_dir = os.path.join(work_dir, 'cadence')
  os.makedirs(cadence_dir, exist_ok=True)
  _resume_pipe(P, os.path.join(cadence_dir, 'ck'), every=2).run()
  dist_lib.barrier()
  return {'failed': failed, 'manifests': manifests, 'loads': len(loads),
          'bit_identical': bit_identical, 'mismatch': mismatch,
          'values': as_numpy(total.metric_values(_rmse_bias(P))),
          'cadence': sorted(n for n in os.listdir(cadence_dir)
                            if n.endswith('.manifest.json'))}


def case_ragged_states(rank, world):
  """``allgather_sum_states`` over real ranks: ragged station sets and
  ranks with the zero state (they send ``b''``)."""
  import torch
  P = port()
  layouts = {0: ([1, 2, 3], [1.0, 2.0, 3.0]), 2: ([2, 4], [10.0, 40.0])}
  if rank in layouts:
    stations, values = layouts[rank]
    da = P['darray'].DimArray(torch.tensor(values, dtype=torch.float64),
                              ('station',), {'station': np.asarray(stations)})
    state = P['aggregation'].AggregationState(
        {'SquaredError': {'t': da}},
        {'SquaredError': {'t': da.copy(data=torch.ones_like(da.data))}})
  else:
    state = P['aggregation'].AggregationState.zero()
  total = P['distributed'].allgather_sum_states(state)
  out = total.sum_weighted_statistics['SquaredError']['t']
  return {'station': np.asarray(out.coord_values('station')),
          'values': np.asarray(out.values)}


def case_groups(rank, world):
  """``distributed`` + ``mesh``: groups of 2 consecutive ranks, each a
  mesh with ``longitude`` sharded (test_multiprocess.py's mesh run)."""
  P = port()
  mesh = P['distributed'].group_mesh('cpu', (2,), ('space',))
  pred, tgt, inits, leads = multiprocess_arrays()
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[P['weighting'].GridAreaWeighting()])
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=2,
                                      lead_time_chunk_size=2)
  kept = [i for i, _, _ in P['pipeline'].stream_chunk_pairs(
      lambda chunk: chunk, times, distributed=True, mesh=mesh)]
  state = _pipe(P, _rmse_bias(P), agg, pred, tgt, times, distributed=True,
                mesh=mesh, dim_to_axis={'longitude': 'space'}).run()
  return {'mesh': sorted(mesh.mesh.reshape(-1).tolist()), 'kept': kept,
          'values': as_numpy(state.metric_values(_rmse_bias(P)))}


# -- a chunk sharded over a mesh ----------------------------------------------------


def _direct_pipe_values(P, metrics, agg, pred, tgt, times, mesh, dim_to_axis,
                        **kw):
  state = _pipe(P, metrics, agg, pred, tgt, times, mesh=mesh,
                dim_to_axis=dim_to_axis, **kw).run()
  return as_numpy(state.metric_values(metrics))


def case_mesh8(rank, world):
  """8 ranks: ``test_mesh_equivalence`` (both reduce configs),
  ``test_ensemble_axis_sharding`` (a custom statistic, and the CRPS
  family, whose kernel then sees every member), ``test_batched_on_mesh``."""
  P = port()
  out = {}
  bs = _mesh((2, 4), ('batch', 'space'))
  pred, tgt, inits, leads = source_arrays()
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=6,
                                      lead_time_chunk_size=4)
  for name, reduce_dims in (
      ('all', ['init_time', 'lead_time', 'latitude', 'longitude']),
      ('keep_lead', ['init_time', 'latitude', 'longitude'])):
    agg = P['aggregation'].Aggregator(
        reduce_dims=reduce_dims,
        weigh_by=[P['weighting'].GridAreaWeighting()])
    out[f'equivalence_{name}'] = _direct_pipe_values(
        P, _rmse_bias(P), agg, pred, tgt, times, bs,
        {'init_time': 'batch', 'longitude': 'space'})

  ens = _mesh((8,), ('ensemble',))
  pred, tgt, inits, leads = source_arrays(seed=5, ens=8)
  times = P['time_chunks'].TimeChunks(inits, leads)
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'lead_time', 'latitude', 'longitude'])
  out['ensemble_custom'] = _direct_pipe_values(
      P, {'emse': ensemble_mean_se(P)}, agg, pred, tgt, times, ens,
      {'number': 'ensemble'})
  prob = P['probabilistic']
  out['ensemble_crps'] = _direct_pipe_values(
      P, {'crps': prob.CRPSEnsemble(),
          'spread_skill': prob.UnbiasedSpreadSkillRatio()},
      agg, pred, tgt, times, ens, {'number': 'ensemble'})

  pred, tgt, inits, leads = source_arrays()
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[P['weighting'].GridAreaWeighting()],
      bin_by=[P['binning'].Regions({'global': ((-90, 90), (0, 360)),
                                    'nh': ((20, 90), (0, 360))})])
  clim = wrap(P['darray'], climatology_arrays())
  metrics = dict(_rmse_bias(P),
                 acc=P['deterministic'].ACC(climatology=clim))
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=1,
                                      lead_time_chunk_size=2)
  out['batched'] = _direct_pipe_values(
      P, metrics, agg, pred, tgt, times, bs,
      {'lead_time': 'batch', 'longitude': 'space'}, chunks_per_dispatch=4)
  return out


def _host_gather_values(P, n_lat, dim_to_axis, mesh, budget):
  pred, tgt, clim, inits, leads = host_gather_arrays(n_lat=n_lat)
  clim = wrap(P['darray'], clim)
  metrics = {
      'acc': P['deterministic'].ACC(climatology=clim),
      'activity': P['deterministic'].PredictionActivity(climatology=clim),
      'seeps': P['categorical'].SEEPS(variables=['precip'],
                                      climatology=clim),
      'rmse': P['deterministic'].RMSE(),
  }
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'], masked=True)
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=3,
                                      lead_time_chunk_size=2)
  if budget is None:
    os.environ.pop('WBX_RESOURCE_BYTES', None)
  else:
    os.environ['WBX_RESOURCE_BYTES'] = str(budget)
  try:
    return _direct_pipe_values(P, metrics, agg, pred, tgt, times, mesh,
                               dim_to_axis)
  finally:
    os.environ.pop('WBX_RESOURCE_BYTES', None)


def two_pairs_aggregator(P):
  """``init_time`` kept and binned by hour, the grid reduced."""
  return P['aggregation'].Aggregator(
      reduce_dims=['latitude', 'longitude'],
      weigh_by=[P['weighting'].GridAreaWeighting()],
      bin_by=[P['binning'].ByTimeUnit('hour', 'init_time')])


def _two_pairs_values(P):
  """Two chunks placed on a ``{'batch': 2, 'space': 2}`` mesh (``init_time``
  over batch, kept) before the first is evaluated, then ``eval_accum``-ed
  in turn: each pair must keep its own slice and coords."""
  mesh = _mesh((2, 2), ('batch', 'space'))
  pred, tgt, inits, leads = source_arrays()
  metrics = _rmse_bias(P)
  ev = P['evaluator'].ChunkEvaluator(
      metrics, two_pairs_aggregator(P), 'cpu', mesh=mesh,
      dim_to_axis={'init_time': 'batch', 'longitude': 'space'})
  pl, tl = _loaders(P, pred, tgt)
  pairs = [ev.prepare_pair(pl.load_chunk(inits[k:k + 4], leads),
                           tl.load_chunk(inits[k:k + 4], leads))
           for k in (0, 4)]
  state = P['aggregation'].AggregationState.zero()
  for pair in pairs:
    state = ev.eval_accum(pair, state)
  return as_numpy(state.metric_values(metrics))


def case_mesh4(rank, world):
  """4 ranks: ``latitude`` sharded under area weights and region bins; FSS
  with ``longitude`` sharded; the host-gathered climatology on a mesh
  (``test_forced_host_gather_on_mesh``, and with the latitudes sharded),
  the resident one sliced; two pairs placed before either is evaluated; a
  statistic that hides a reduction refused."""
  P = port()
  out = {}
  space = _mesh((4,), ('space',))
  pred, tgt, inits, leads = source_arrays(n_lat=8, seed=3)
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=4,
                                      lead_time_chunk_size=2)
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[P['weighting'].GridAreaWeighting()],
      bin_by=[P['binning'].Regions({'global': ((-90, 90), (0, 360)),
                                    'sh': ((-90, -20), (0, 360)),
                                    'tropics': ((-30, 30), (90, 270))})])
  out['latitude_regions'] = _direct_pipe_values(
      P, _rmse_bias(P), agg, pred, tgt, times, space,
      {'latitude': 'space'})

  pred, tgt, inits, leads = fss_arrays()
  times = P['time_chunks'].TimeChunks(inits, leads, init_time_chunk_size=2)
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'])
  out['fss'] = _direct_pipe_values(
      P, fss_metrics(P['spatial']), agg, pred, tgt, times, space,
      {'longitude': 'space'})

  out['host_gather_replicated'] = _host_gather_values(
      P, 5, {'latitude': 'space'}, space, 1)
  out['host_gather_sharded'] = _host_gather_values(
      P, 8, {'latitude': 'space'}, space, 1)
  out['resident_sharded'] = _host_gather_values(
      P, 8, {'latitude': 'space'}, space, None)

  out['two_pairs_placed'] = _two_pairs_values(P)

  class HiddenMean(P['base'].PerVariableStatistic):

    def reads_across(self):
      return ()  # wrong: it means over the members

    def _compute_per_variable(self, predictions, targets):
      return (predictions.mean('number') - targets) ** 2

  pred, tgt, inits, leads = source_arrays(seed=5, ens=4)
  try:
    _direct_pipe_values(
        P, {'hidden': HiddenMean()},
        P['aggregation'].Aggregator(reduce_dims=['latitude', 'longitude']),
        pred, tgt, P['time_chunks'].TimeChunks(inits, leads), space,
        {'number': 'space'})
    out['undeclared'] = None
  except ValueError as e:
    out['undeclared'] = str(e)
  return out


def fss_arrays():
  """Binary fields for FSS, 8 x 16, 4 inits x 2 leads."""
  pred, tgt, inits, leads = source_arrays(n_valid=6, n_lead=2, seed=9,
                                          n_lat=8, n_lon=16)

  def binary(arrays):
    return {v: ((vals > 0.3).astype(np.float32), dims, coords)
            for v, (vals, dims, coords) in arrays.items()}

  return binary(pred), binary(tgt), inits, leads


def fss_metrics(spatial):
  return {'fss': spatial.FSS(neighborhood_size_in_pixels=[1, 3, 5],
                             wrap_longitude=True)}


# -- unaggregated stores -----------------------------------------------------------


UNAGG_STORES = {
    'v2': dict(),
    'v3_sharded': dict(compressor='zstd', zarr_format=3,
                       zarr_shards={'init_time': 2, 'lead_time': 3}),
}


def unagg_times(P):
  return P['time_chunks'].TimeChunks(UNAGG_INIT, UNAGG_LEAD,
                                     init_time_chunk_size=2,
                                     lead_time_chunk_size=3)


def case_unagg_distributed(rank, world, out_dir):
  """2 ranks writing one store each way (the standalone pipeline, and the
  aggregated pipeline's sink), and the distributed refusals."""
  P = port()
  pred, tgt = unagg_arrays()
  unagg = P['unaggregated']
  for name, kw in UNAGG_STORES.items():
    pl, tl = _loaders(P, pred, tgt)
    unagg.UnaggregatedPipeline(
        metrics=_rmse_bias(P), predictions_loader=pl, targets_loader=tl,
        times=unagg_times(P), out_path=os.path.join(out_dir, name, 's.zarr'),
        device='cpu', distributed=True, **kw).run()
    store = unagg.ZarrStatsStore(
        unagg_times(P), os.path.join(out_dir, f'sink_{name}', 's.zarr'),
        distributed=True, **kw)
    _pipe(P, _rmse_bias(P),
          P['aggregation'].Aggregator(reduce_dims=['latitude', 'longitude']),
          pred, tgt, unagg_times(P), distributed=True,
          chunk_stats_sink=store.write_chunk).run()
    store.finalize()
  refusals = {}
  times = P['time_chunks'].TimeChunks(UNAGG_INIT, UNAGG_LEAD,
                                      init_time_chunk_size=3,
                                      lead_time_chunk_size=2)
  for name, build in (
      ('chunks', lambda: unagg.ZarrStatsStore(
          times, os.path.join(out_dir, f'r{rank}_c.zarr'), distributed=True,
          zarr_chunks={'init_time': 4})),
      ('shards', lambda: unagg.ZarrStatsStore(
          P['time_chunks'].TimeChunks(UNAGG_INIT, UNAGG_LEAD,
                                      init_time_chunk_size=4,
                                      lead_time_chunk_size=2),
          os.path.join(out_dir, f'r{rank}_s.zarr'), distributed=True,
          zarr_format=3, zarr_shards={'init_time': 8})),
      ('shard_mode', lambda: unagg.UnaggregatedPipeline(
          metrics=_rmse_bias(P), predictions_loader=None,
          targets_loader=None, times=unagg_times(P),
          out_path=os.path.join(out_dir, f'r{rank}_shards'), device='cpu',
          distributed=True).run())):
    try:
      build()
      refusals[name] = None
    except ValueError as e:
      refusals[name] = str(e)
  unagg.ZarrStatsStore(times, os.path.join(out_dir, f'r{rank}_ok.zarr'),
                       distributed=True, zarr_chunks={'lead_time': 1})
  return refusals


def case_unagg_mesh(rank, world, out_dir):
  """A (2, 2) mesh, ``init_time`` over batch and ``longitude`` over space:
  the standalone pipeline and the aggregated pipeline's sink each write
  whole statistics from the mesh's first rank."""
  P = port()
  mesh = _mesh((2, 2), ('batch', 'space'))
  dim_to_axis = {'init_time': 'batch', 'longitude': 'space'}
  pred, tgt = unagg_arrays()
  unagg = P['unaggregated']
  for name, kw in UNAGG_STORES.items():
    pl, tl = _loaders(P, pred, tgt)
    unagg.UnaggregatedPipeline(
        metrics=_rmse_bias(P), predictions_loader=pl, targets_loader=tl,
        times=unagg_times(P), out_path=os.path.join(out_dir, name, 's.zarr'),
        device='cpu', mesh=mesh, dim_to_axis=dim_to_axis, **kw).run()
    first = rank == 0
    store = (unagg.ZarrStatsStore(
        unagg_times(P), os.path.join(out_dir, f'sink_{name}', 's.zarr'), **kw)
             if first else None)
    state = _pipe(
        P, _rmse_bias(P),
        P['aggregation'].Aggregator(reduce_dims=['latitude', 'longitude']),
        pred, tgt, unagg_times(P), mesh=mesh, dim_to_axis=dim_to_axis,
        chunk_stats_sink=store.write_chunk if first else lambda *a: None
    ).run()
    if first:
      store.finalize()
    P['distributed'].barrier()
  return as_numpy(state.metric_values(_rmse_bias(P)))


# -- spawns: each test file's ranks start a few times, not once per case -------


def case_world2(rank, world, work_dir):
  return {'partition': case_partition(rank, world),
          'resume': case_resume(rank, world, work_dir)}


def case_world4(rank, world):
  return {'partition': case_partition(rank, world),
          'ragged': case_ragged_states(rank, world),
          'groups': case_groups(rank, world)}


# -- on the card ----------------------------------------------------------------


def cuda_case_inputs():
  """An ensemble on a grid whose longitudes 2 ranks split."""
  return source_arrays(n_valid=8, n_lead=2, seed=4, ens=10, n_lat=9,
                       n_lon=32)


def cuda_case_values(P, mesh=None, dim_to_axis=None):
  """The ensemble CRPS family and RMSE of ``cuda_case_inputs`` through the
  pipeline on the card; (values, fused launches)."""
  from weatherbenchx_tpu_torch.ops import crps_pairwise
  pred, tgt, inits, leads = cuda_case_inputs()
  metrics = {'crps': P['probabilistic'].CRPSEnsemble(),
             'rmse': P['wrappers'].WrappedMetric(
                 P['deterministic'].RMSE(),
                 [P['wrappers'].EnsembleMean('predictions')])}
  agg = P['aggregation'].Aggregator(
      reduce_dims=['init_time', 'latitude', 'longitude'],
      weigh_by=[P['weighting'].GridAreaWeighting()])
  pl, tl = _loaders(P, pred, tgt)
  crps_pairwise.reset_launch_counts()
  state = P['pipeline'].EvaluationPipeline(
      metrics=metrics, aggregator=agg, predictions_loader=pl,
      targets_loader=tl, device='cuda', mesh=mesh, dim_to_axis=dim_to_axis,
      times=P['time_chunks'].TimeChunks(inits, leads,
                                        init_time_chunk_size=2)).run()
  return (as_numpy(state.metric_values(metrics)),
          crps_pairwise.LAUNCHES['fused_ensemble_stats'])


def case_cuda_longitude(rank, world):
  """2 gloo ranks sharing the card, ``longitude`` sharded."""
  P = port()
  return cuda_case_values(P, _mesh((2,), ('space',)),
                          {'longitude': 'space'})


def case_one_rank_fails(rank, world):
  """Rank 1 raises while rank 0 waits for it at a barrier."""
  import torch.distributed as dist
  if rank == 1:
    raise ValueError('rank 1 gives up')
  dist.barrier()
