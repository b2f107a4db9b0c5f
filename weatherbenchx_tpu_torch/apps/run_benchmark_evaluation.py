"""WeatherBench benchmark evaluation CLI.

The port of ``weatherbenchx_tpu/apps/run_benchmark_evaluation.py``: the
same flags, registry lookup and metric sets, plus ``--device`` (default
``cuda``; without a GPU, or on a GPU without the native I/O libraries,
that raises: ``run_evaluation.resolve_device``).

* Deterministic forecasts: RMSE, MSE, bias, ACC and prediction activity
  against the latitude-sorted climatology, wind-vector RMSE for each u/v
  pair, and SEEPS for the precipitation variables.
* Ensembles (the probabilistic registry, or
  ``--prediction=probabilistic_climatology``): fair CRPS through the fused
  CUDA kernel, the unbiased spread/skill ratio, the unbiased
  ensemble-mean RMSE and the RMSE of the ensemble mean.
* The 17 ECMWF-style regions (with land parts when the target store holds
  a ``land_sea_mask``), area weights, masked aggregation; ``--temporal``
  keeps init_time.

Stores open lazily through ``io.open_dataset_auto``: ``.npz``, ``.wbx``,
zarr v2 and v3 (local, or an fsspec URL such as the registry's ``gs://``
paths) and netCDF; ``--output_format`` writes npz, zarr, wbx or nc.
``--unaggregated_zarr`` also streams the raw per-point statistics of the
same pass into ``<output>_stats.zarr`` (``--zarr_format``,
``--zarr_compressor``, ``--zarr_shards``). Not ported yet, and raising:
``--chunks_per_dispatch`` > 1 (ROADMAP A7). The JAX CLI's
``--compilation_cache_dir`` has no counterpart: nothing is compiled per
chunk shape.

The construction is split into functions (``build_loaders``,
``load_climatology``, ``build_metrics``, ``build_aggregator``) that
``main`` calls, so a caller can drive the CLI's own setup over in-memory
datasets: a config may name a store by ``path`` or hold it as ``ds``.

Example:
  python -m weatherbenchx_tpu_torch.apps.run_benchmark_evaluation \
      --prediction=hres --prediction_path=hres.npz --target_path=era5.npz \
      --climatology_path=clim.npz --resolution=64x32 --year=2020 \
      --variables=geopotential,2m_temperature --output_dir=./results
"""

import argparse
import json
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import aggregation, binning, weighting
from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch import time_chunks as time_chunks_lib
from weatherbenchx_tpu_torch.apps import configs as configs_lib
from weatherbenchx_tpu_torch.apps import run_evaluation
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.data import loaders
from weatherbenchx_tpu_torch.metrics import categorical, deterministic
from weatherbenchx_tpu_torch.metrics import probabilistic, wrappers
from weatherbenchx_tpu_torch.ops import crps_pairwise
from weatherbenchx_tpu_torch.parallel import pipeline as pipeline_lib
from weatherbenchx_tpu_torch.parallel import unaggregated

SPECIAL_PREDICTIONS = ('persistence', 'probabilistic_climatology',
                       'climatology')


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--prediction', required=True,
                 help='Model key in the config registry (e.g. hres, ens)')
  p.add_argument('--target', default='era5')
  p.add_argument('--resolution', default='64x32',
                 choices=list(configs_lib.RESOLUTIONS))
  p.add_argument('--year', type=int, default=2020)
  p.add_argument('--variables', default=None,
                 help='Comma-delimited variables (default: the registry '
                      "entry's standard variable list)")
  p.add_argument('--levels', default=None,
                 help='Comma-delimited pressure levels '
                      f'(default {configs_lib.DEFAULT_LEVELS})')
  p.add_argument('--time_frequency', type=int, default=None,
                 help='Init frequency in hours (default 12; 24 for excarta)')
  p.add_argument('--init_time_start', default=None,
                 help='Override init start (default: Jan 1 of --year)')
  p.add_argument('--init_time_stop', default=None,
                 help='Override init stop, exclusive (default: Jan 1 of '
                      'the following year)')
  p.add_argument('--lead_time_stop_days', type=int, default=10)
  p.add_argument('--lead_time_frequency', type=int, default=6)
  p.add_argument('--init_time_chunk_size', type=int, default=1)
  p.add_argument('--lead_time_chunk_size', type=int, default=12)
  p.add_argument('--temporal', action='store_true',
                 help='Do not reduce over init_time (per-init outputs)')
  p.add_argument('--output_dir', required=True)
  p.add_argument('--output_format', default='npz',
                 choices=['npz', 'zarr', 'wbx', 'nc'],
                 help='Metrics container')
  p.add_argument('--prediction_path', default=None,
                 help='Override the registry path (a local or fsspec '
                      '.npz, .wbx, .zarr or netCDF store)')
  p.add_argument('--target_path', default=None)
  p.add_argument('--climatology_path', default=None)
  p.add_argument('--checkpoint_every', type=int, default=0)
  p.add_argument('--chunks_per_dispatch', type=int, default=1,
                 help='Chunks per evaluation; only 1 is ported so far')
  p.add_argument('--load_retries', type=int, default=0,
                 help='Retries per chunk load on transient (I/O) failures')
  p.add_argument('--load_retry_backoff', type=float, default=1.0)
  p.add_argument('--skip_failed_chunks', action='store_true',
                 help='Skip (and report) chunks whose transient failures '
                      'survive all retries, instead of failing the run')
  p.add_argument('--zarr_format', type=int, default=2, choices=(2, 3),
                 help='Zarr store format for --unaggregated_zarr output')
  p.add_argument('--zarr_compressor', default=None,
                 choices=['zlib', 'zstd', 'blosc'],
                 help='Compression for --unaggregated_zarr cells')
  p.add_argument('--zarr_shards', default=None,
                 help='v3 sharding_indexed shard sizes per dim for '
                      '--unaggregated_zarr output, e.g. '
                      '"init_time=64,lead_time=16" (elements; rounded up '
                      'to a chunk multiple). Requires --zarr_format=3')
  p.add_argument('--unaggregated_zarr', action='store_true',
                 help='Also stream raw per-point statistics into a '
                      '<output>_stats.zarr store, from the same pass')
  p.add_argument('--device', default='cuda',
                 help="Device the chunks are evaluated on: 'cuda' (the "
                      "default; raises without a GPU) or 'cpu'")
  return p


def _check_ported(args) -> None:
  if args.chunks_per_dispatch > 1:
    raise NotImplementedError(
        'not ported to weatherbenchx_tpu_torch yet: --chunks_per_dispatch '
        '> 1 (ROADMAP A7)')


def resolve_configs(args) -> tuple[dict, dict, dict, bool]:
  """(prediction, target, climatology) configs and whether the prediction
  is an ensemble, from the registry and the path overrides."""
  pred_key = f'{args.prediction}_{args.resolution}_{args.year}'
  is_probabilistic = pred_key in configs_lib.probabilistic_prediction_configs
  clim_key = f'era5_{args.resolution}_{args.year}'
  if clim_key not in configs_lib.climatology_configs:
    clim_key = f'era5_{args.resolution}'
  if args.prediction in SPECIAL_PREDICTIONS:
    # Special kinds read the era5 target or climatology entries with
    # their own loaders.
    registry_cfg = (configs_lib.climatology_configs[clim_key]
                    if args.prediction == 'climatology'
                    else configs_lib.target_configs[f'era5_{args.resolution}'])
    pred_cfg = (dict(registry_cfg, path=args.prediction_path)
                if args.prediction_path else registry_cfg)
    is_probabilistic = args.prediction == 'probabilistic_climatology'
  elif args.prediction_path:
    # Override ONLY the path: the entry's per-model quirks (loader kwargs,
    # skipna, level defaults) survive a local-file override.
    registry_cfg = (
        configs_lib.probabilistic_prediction_configs[pred_key]
        if is_probabilistic
        else configs_lib.deterministic_prediction_configs.get(
            pred_key, {'data_loader_kwargs': {}}))
    pred_cfg = dict(registry_cfg, path=args.prediction_path)
  elif is_probabilistic:
    pred_cfg = configs_lib.probabilistic_prediction_configs[pred_key]
  elif pred_key in configs_lib.deterministic_prediction_configs:
    pred_cfg = configs_lib.deterministic_prediction_configs[pred_key]
  else:
    known = sorted(set(configs_lib.deterministic_prediction_configs)
                   | set(configs_lib.probabilistic_prediction_configs))
    same_model = [k for k in known if k.startswith(args.prediction + '_')]
    raise SystemExit(
        f"Unknown prediction config '{pred_key}'. "
        + (f'Configs for this model: {same_model}. ' if same_model
           else f'Known models: {sorted({k.rsplit("_", 2)[0] for k in known})}. ')
        + 'Use --prediction_path to point at a local file instead.')
  tgt_cfg = ({'path': args.target_path} if args.target_path
             else configs_lib.target_configs[
                 f'{args.target}_{args.resolution}'])
  clim_cfg = ({'path': args.climatology_path} if args.climatology_path
              else configs_lib.climatology_configs[clim_key])
  return pred_cfg, tgt_cfg, clim_cfg, is_probabilistic


def evaluation_times(args) -> tuple[time_chunks_lib.TimeChunks, int]:
  """The TimeChunks of the run and the init frequency in hours, with the
  registry's per-model default init ranges."""
  init_start, init_stop = args.init_time_start, args.init_time_stop
  if init_start is None and init_stop is None:
    init_start = f'{args.year}-01-01'
    if args.year == 2022 or args.prediction in ('fuxi', 'excarta'):
      init_stop = f'{args.year}-12-16'
      if args.prediction == 'aurora':
        init_start = f'{args.year}-01-01T12'
    elif args.year == 2020 and args.prediction == 'baguan':
      init_stop = f'{args.year}-12-30T12'
    else:
      init_stop = f'{args.year + 1}-01-01'
  time_frequency = args.time_frequency
  if time_frequency is None:
    time_frequency = 24 if args.prediction == 'excarta' else 12
  init_times = np.arange(
      init_start or f'{args.year}-01-01',
      init_stop or f'{args.year + 1}-01-01',
      np.timedelta64(time_frequency, 'h'), dtype='datetime64[ns]')
  lead_times = np.arange(
      0, 24 * args.lead_time_stop_days, args.lead_time_frequency,
      dtype='timedelta64[h]').astype('timedelta64[ns]')
  times = time_chunks_lib.TimeChunks(
      init_times, lead_times,
      init_time_chunk_size=args.init_time_chunk_size,
      lead_time_chunk_size=args.lead_time_chunk_size)
  return times, time_frequency


def _source(cfg: Mapping[str, Any]) -> dict:
  """The loader's store argument: ``ds`` when the config holds one."""
  return {'ds': cfg['ds']} if 'ds' in cfg else {'path': cfg['path']}


def open_store(cfg: Mapping[str, Any]) -> dict[str, DimArray]:
  return dict(cfg['ds']) if 'ds' in cfg else io_lib.open_dataset_auto(
      cfg['path'])


def build_loaders(prediction: str, pred_cfg: Mapping[str, Any],
                  tgt_cfg: Mapping[str, Any], variables: Sequence[str],
                  levels: Sequence[int]) -> tuple:
  """(predictions loader, targets loader) of a prediction kind."""
  sel_kwargs = {'level': list(levels)} if levels else None
  loader_kwargs = dict(pred_cfg.get('data_loader_kwargs', {}))
  if sel_kwargs:
    loader_kwargs.setdefault('sel_kwargs', sel_kwargs)
  if prediction == 'persistence':
    prediction_cls = loaders.PersistenceFromDataset
  elif prediction == 'climatology':
    prediction_cls = loaders.ClimatologyFromDataset
  elif prediction == 'probabilistic_climatology':
    prediction_cls = loaders.ProbabilisticClimatologyFromDataset
    # The website's fixed climatological-ensemble period.
    loader_kwargs.setdefault('start_year', 1990)
    loader_kwargs.setdefault('end_year', 2019)
  else:
    prediction_cls = loaders.PredictionsFromDataset
  prediction_loader = prediction_cls(
      **_source(pred_cfg), variables=variables, **loader_kwargs)
  # Targets always sort latitude ascending (setdefault: the era5 registry
  # entry already carries the same preprocessing_fn).
  tgt_kwargs = dict(tgt_cfg.get('data_loader_kwargs', {}))
  tgt_kwargs.setdefault('preprocessing_fn', configs_lib.sort_latitude)
  target_loader = loaders.TargetsFromDataset(
      **_source(tgt_cfg), variables=variables, sel_kwargs=sel_kwargs,
      **tgt_kwargs)
  return prediction_loader, target_loader


def load_climatology(clim_cfg: Mapping[str, Any], variables: Sequence[str],
                     levels: Sequence[int]) -> dict[str, DimArray]:
  """The climatology with latitude ascending, its evaluated variables cut
  to the evaluated levels (an unsubset level axis would silently widen the
  anomaly statistics to the climatology's full level set)."""
  climatology = configs_lib.sort_latitude(open_store(clim_cfg))
  if levels:
    climatology = {
        k: (v.sel(level=list(levels))
            if k in variables and 'level' in v.dims else v)
        for k, v in climatology.items()}
  return climatology


def build_metrics(variables: Sequence[str],
                  climatology: Optional[Mapping[str, DimArray]],
                  is_probabilistic: bool) -> dict:
  """The benchmark's metric set for an ensemble or a deterministic run."""
  if is_probabilistic:
    return {
        'crps': probabilistic.CRPSEnsemble(use_sort=True),
        'unbiased_spread_skill': probabilistic.UnbiasedSpreadSkillRatio(),
        'unbiased_mean_rmse': probabilistic.UnbiasedEnsembleMeanRMSE(),
        'mean_rmse': wrappers.WrappedMetric(
            deterministic.RMSE(),
            [wrappers.EnsembleMean(which='predictions')]),
    }
  all_metrics = {
      'rmse': deterministic.RMSE(),
      'mse': deterministic.MSE(),
      'bias': deterministic.Bias(),
      'acc': deterministic.ACC(climatology=climatology),
      'prediction_activity': deterministic.PredictionActivity(
          climatology=climatology),
  }
  u_names, v_names, vector_names = [], [], []
  for u, v, vector in (
      ('u_component_of_wind', 'v_component_of_wind', 'wind'),
      ('10m_u_component_of_wind', '10m_v_component_of_wind', '10m_wind')):
    if {u, v} <= set(variables):
      u_names.append(u)
      v_names.append(v)
      vector_names.append(vector)
  if u_names:
    all_metrics['vector_rmse'] = deterministic.WindVectorRMSE(
        u_names, v_names, vector_names)
  precip_variables = [
      v for v in variables if v in configs_lib.SEEPS_DRY_THRESHOLDS_MM]
  if precip_variables:
    all_metrics['seeps'] = categorical.SEEPS(
        variables=precip_variables, climatology=climatology,
        dry_threshold_mm=[configs_lib.SEEPS_DRY_THRESHOLDS_MM[v]
                          for v in precip_variables])
  return all_metrics


def build_aggregator(land_sea_mask: Optional[DimArray], temporal: bool,
                     aggregator_kwargs: Optional[Mapping] = None
                     ) -> aggregation.Aggregator:
  """The regions (with land parts given a land-sea mask), area weights
  and masked aggregation (SEEPS masks points by p1)."""
  return aggregation.Aggregator(
      reduce_dims=(['latitude', 'longitude'] if temporal
                   else ['init_time', 'latitude', 'longitude']),
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions(configs_lib.REGIONS,
                              land_sea_mask=land_sea_mask)],
      masked=True,
      **dict(aggregator_kwargs or {}))


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = build_parser().parse_args(argv)
  device = run_evaluation.resolve_device(args.device)
  _check_ported(args)

  pred_cfg, tgt_cfg, clim_cfg, is_probabilistic = resolve_configs(args)
  if args.variables:
    variables = [v for v in args.variables.split(',') if v]
  elif pred_cfg.get('variables'):
    variables = list(pred_cfg['variables'])
  else:
    raise SystemExit('--variables is required when the prediction config '
                     'declares no default variable list.')
  levels = ([int(l) for l in args.levels.split(',')] if args.levels
            else list(pred_cfg.get('levels', configs_lib.DEFAULT_LEVELS)))
  times, time_frequency = evaluation_times(args)
  prediction_loader, target_loader = build_loaders(
      args.prediction, pred_cfg, tgt_cfg, variables, levels)
  # The probabilistic set needs no climatology: none is opened for it.
  climatology = (None if is_probabilistic
                 else load_climatology(clim_cfg, variables, levels))
  all_metrics = build_metrics(variables, climatology, is_probabilistic)
  aggregator = build_aggregator(
      open_store(tgt_cfg).get('land_sea_mask'), args.temporal,
      pred_cfg.get('aggregator_kwargs'))

  filename = (f'{args.prediction}_vs_{args.target}_{args.resolution}_'
              f'{args.year}-init{time_frequency}h')
  if args.temporal:
    filename += '_temporal'
  out_path = os.path.join(args.output_dir, f'{filename}.{args.output_format}')
  os.makedirs(args.output_dir, exist_ok=True)
  print(f'Save path: {out_path}')
  stats_store = None
  if args.unaggregated_zarr:
    # Raw per-point statistics streamed into a Zarr store from the SAME
    # pass as the aggregated evaluation (the reference computes both in
    # one Beam graph, beam_pipeline.py:449-540,610-681).
    zarr_shards = None
    if args.zarr_shards:
      zarr_shards = {k: int(v) for k, v in
                     (kv.split('=', 1) for kv in args.zarr_shards.split(','))}
    stats_store = unaggregated.ZarrStatsStore(
        times, os.path.join(args.output_dir, filename + '_stats.zarr'),
        compressor=args.zarr_compressor, zarr_format=args.zarr_format,
        zarr_shards=zarr_shards)
  values = pipeline_lib.evaluate(
      all_metrics, aggregator, prediction_loader, target_loader, times,
      out_path=out_path, device=device,
      checkpoint_path=(out_path + '.ckpt' if args.checkpoint_every else None),
      checkpoint_every=args.checkpoint_every,
      chunk_stats_sink=stats_store.write_chunk if stats_store else None,
      retry=run_evaluation.retry_policy_from_args(args))
  if stats_store is not None:
    print(f'Wrote unaggregated statistics store: {stats_store.finalize()}')
  print(f'Wrote {len(values)} metric variables.')
  print(f'Kernel launches: {json.dumps(crps_pairwise.LAUNCHES)}')


if __name__ == '__main__':
  main()
