"""Generates the port's executed how-to notebooks under docs/torch/notebooks/.

The port of ``tools/make_notebooks.py``: one notebook per topic, the same
seven (quickstart, data_loaders, implement_metrics, metric_wrappers,
nan_handling, sparse_data, forecast_latency), each cell for cell the JAX
notebook's: the same prose, the same data from the same numpy seeds and
dtypes, the same printed quantities. The code cells import the port, put
every array that reaches a metric on ``DEVICE`` (the setup cell's, from
``--device``) and read values back to the host with ``.values``.

A builder returns plain ``(kind, source)`` pairs, so that the cells also
run without nbformat (:func:`run_cells`, which ``chip_smoke.py`` calls on
the card and the tests on the CPU); nbformat and nbclient are imported only
by :func:`main`, which executes each notebook in a kernel and writes it
with its outputs. :func:`committed_outputs` reads a written notebook's
printed text back with ``json``, and :func:`compare_printed` holds two
printed texts to each other number by number.

Usage:
  python -m weatherbenchx_tpu_torch.tools.make_notebooks [--device cpu]
      [--out docs/torch/notebooks] [--only NAME]

``--device cuda``, the default, raises without a GPU. The committed
notebooks are executed with ``--device cpu``. ``sparse_data`` needs pandas
and pyarrow (Parquet), which the port does not require on the GPU: it is
run on the CPU.
"""

import argparse
import contextlib
import io
import json
import math
import os
import re
from typing import Callable, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, 'docs', 'torch', 'notebooks')

Cells = list[tuple[str, str]]


def setup(device: str) -> str:
  """The setup cell: numpy, torch, the port's DimArray and the device."""
  return f'''\
import numpy as np
import torch
from weatherbenchx_tpu_torch.darray import Coord, DimArray

DEVICE = torch.device({device!r})  # every array a metric reads lives here
'''


def quickstart(device: str) -> Cells:
  return [
      ('md', '# Quickstart\n\nEvaluate a forecast against a truth dataset '
             'in a dozen lines: build `DimArray` data, pick metrics and an '
             '`Aggregator`, run the single-chunk ground-truth path, then '
             'the chunked pipeline (which must agree).'),
      ('code', setup(device)),
      ('code', '''\
from weatherbenchx_tpu_torch import aggregation, weighting
from weatherbenchx_tpu_torch.metrics import deterministic

rng = np.random.default_rng(0)
lats = np.linspace(-90, 90, 19)
lons = np.linspace(0, 360, 36, endpoint=False)
init = (np.datetime64('2020-01-01', 'ns')
        + np.arange(8) * np.timedelta64(12, 'h'))
lead = (np.arange(3) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
dims = ('init_time', 'lead_time', 'latitude', 'longitude')
coords = {'init_time': init, 'lead_time': lead,
          'latitude': lats, 'longitude': lons}
preds = {'2m_temperature': DimArray(torch.from_numpy(
    rng.standard_normal((8, 3, 19, 36)).astype(np.float32)).to(DEVICE),
    dims, coords)}
# Truth lives on valid_time (an analysis store); the targets loader
# gathers it at init + lead.
valid = np.unique((init[:, None] + lead[None, :]).ravel())
truth_store = {'2m_temperature': DimArray(torch.from_numpy(
    rng.standard_normal((len(valid), 19, 36)).astype(np.float32)).to(DEVICE),
    ('valid_time', 'latitude', 'longitude'),
    {'valid_time': valid, 'latitude': lats, 'longitude': lons})}

metrics = {'rmse': deterministic.RMSE(), 'bias': deterministic.Bias()}
aggregator = aggregation.Aggregator(
    reduce_dims=['init_time', 'latitude', 'longitude'],
    weigh_by=[weighting.GridAreaWeighting()])

from weatherbenchx_tpu_torch.data import loaders
targets = loaders.TargetsFromDataset(
    ds=truth_store, rename_dimensions=None).load_chunk(init, lead)
values = aggregation.compute_metric_values_for_single_chunk(
    metrics, aggregator, preds, targets)
for k, v in values.items():
    print(k, v.dims, np.round(np.asarray(v.values, np.float64), 4))'''),
      ('md', 'The chunked, restartable pipeline computes the same numbers '
             'chunk by chunk (one evaluation per chunk on `DEVICE`) and '
             'sums the monoid `AggregationState`:'),
      ('code', '''\
from weatherbenchx_tpu_torch import time_chunks
from weatherbenchx_tpu_torch.parallel import pipeline

pipe_values = pipeline.evaluate(
    metrics, aggregator,
    predictions_loader=loaders.PredictionsFromDataset(
        ds=preds, rename_dimensions=None),
    targets_loader=loaders.TargetsFromDataset(
        ds=truth_store, rename_dimensions=None),
    times=time_chunks.TimeChunks(init, lead, init_time_chunk_size=2,
                                 lead_time_chunk_size=3),
    device=DEVICE)
for k in values:
    direct = np.asarray(values[k].values, np.float64)
    piped = np.asarray(pipe_values[k].transpose(*values[k].dims).values,
                       np.float64)
    print(k, 'chunked == direct:', bool(np.allclose(piped, direct,
                                                    atol=1e-5)))'''),
  ]


def implement_metrics(device: str) -> Cells:
  return [
      ('md', '# Implementing your own metrics\n\nA `Statistic` computes '
             'per-point values for a chunk; a `Metric` is a set of named '
             'statistics plus a finalizer over their aggregated means '
             '(reference `metrics/base.py:23-173`). The `unique_name` must '
             'encode every parameter — deduplication and state '
             'serialization key on it.'),
      ('code', setup(device)),
      ('code', '''\
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch.metrics import base

class ThresholdedSquaredError(base.PerVariableStatistic):
    """SE only where the target exceeds a threshold (else 0)."""

    def __init__(self, threshold: float):
        self._threshold = threshold

    @property
    def unique_name(self):
        return f'ThresholdedSquaredError_{self._threshold}'

    def _compute_per_variable(self, predictions, targets):
        se = (predictions - targets) ** 2
        return se.where(targets > self._threshold, 0.0)

class ThresholdedRMSE(base.PerVariableMetric):
    def __init__(self, threshold: float):
        self._threshold = threshold

    @property
    def statistics(self):
        return {'TSE': ThresholdedSquaredError(self._threshold)}

    def _values_from_mean_statistics_per_variable(self, statistic_values):
        return statistic_values['TSE'] ** 0.5

rng = np.random.default_rng(1)
dims = ('init_time', 'latitude')
coords = {'init_time': (np.datetime64('2020-01-01', 'ns')
                        + np.arange(6) * np.timedelta64(1, 'D')),
          'latitude': np.linspace(-60, 60, 5)}
preds = {'t': DimArray(torch.from_numpy(
    rng.standard_normal((6, 5)).astype(np.float32)).to(DEVICE),
    dims, coords)}
tgts = {'t': DimArray(torch.from_numpy(
    rng.standard_normal((6, 5)).astype(np.float32)).to(DEVICE),
    dims, coords)}
agg = aggregation.Aggregator(reduce_dims=['init_time', 'latitude'])
out = aggregation.compute_metric_values_for_single_chunk(
    {'trmse': ThresholdedRMSE(0.0)}, agg, preds, tgts)
print({k: float(v.values) for k, v in out.items()})'''),
      ('md', 'Statistics are deduplicated across metrics by `unique_name`: '
             'two metrics sharing a statistic compute it once per chunk.'),
      ('code', '''\
stats = base.compute_unique_statistics_for_all_metrics(
    {'a': ThresholdedRMSE(0.0), 'b': ThresholdedRMSE(0.0),
     'c': ThresholdedRMSE(1.0)}, preds, tgts)
print(sorted(stats.keys()))  # two unique statistics, not three'''),
  ]


def metric_wrappers(device: str) -> Cells:
  return [
      ('md', '# Metric wrappers\n\nInput transforms compose: '
             '`WrappedMetric(metric, [t1, t2])` applies t2 then t1 to the '
             'inputs before the metric’s statistics run (reference '
             '`metrics/wrappers.py:892-936`). Each transform suffixes the '
             'statistic `unique_name` so different parameterizations never '
             'collide in the aggregation state.'),
      ('code', setup(device)),
      ('code', '''\
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch.metrics import categorical, deterministic
from weatherbenchx_tpu_torch.metrics import wrappers

rng = np.random.default_rng(2)
dims = ('number', 'init_time', 'latitude', 'longitude')
coords = {'number': np.arange(5),
          'init_time': (np.datetime64('2020-01-01', 'ns')
                        + np.arange(4) * np.timedelta64(1, 'D')),
          'latitude': np.linspace(-60, 60, 7),
          'longitude': np.linspace(0, 360, 8, endpoint=False)}
preds = {'t': DimArray(torch.from_numpy(
    rng.random((5, 4, 7, 8), dtype=np.float32)).to(DEVICE), dims, coords)}
tgts = {'t': DimArray(torch.from_numpy(
    rng.random((4, 7, 8), dtype=np.float32)).to(DEVICE),
    dims[1:], {d: coords[d] for d in dims[1:]})}
agg = aggregation.Aggregator(
    reduce_dims=['init_time', 'latitude', 'longitude'])

metrics = {
    # RMSE of the ensemble mean.
    'mean_rmse': wrappers.WrappedMetric(
        deterministic.RMSE(),
        [wrappers.EnsembleMean(which='predictions')]),
    # CSI after thresholding both sides into events.
    'csi': wrappers.WrappedMetric(
        categorical.CSI(),
        [wrappers.ContinuousToBinary(which='both', threshold_value=[0.5],
                                     threshold_dim='threshold')]),
    # MAE of ensemble quantiles.
    'q_mae': wrappers.WrappedMetric(
        deterministic.MAE(),
        [wrappers.EnsembleQuantiles(which='predictions',
                                    quantiles=[0.25, 0.75])]),
}
out = aggregation.compute_metric_values_for_single_chunk(
    metrics, agg, preds, tgts)
for k, v in sorted(out.items()):
    print(k, v.dims, np.round(np.asarray(v.values, np.float64).ravel(), 4))'''),
  ]


def nan_handling(device: str) -> Cells:
  return [
      ('md', '# NaN handling\n\nThe framework is deliberately NaN-loud '
             '(reference `data_loaders/base.py:33-41`): unexpected NaNs '
             'propagate into aggregated metrics. Expected missingness goes '
             'through a `mask` coordinate + `masked=True`, or `skipna`.'),
      ('code', setup(device)),
      ('code', '''\
from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch.data import base as data_base
from weatherbenchx_tpu_torch.metrics import deterministic

dims = ('init_time', 'latitude')
coords = {'init_time': (np.datetime64('2020-01-01', 'ns')
                        + np.arange(4) * np.timedelta64(1, 'D')),
          'latitude': np.linspace(-60, 60, 3)}
p = np.ones((4, 3), np.float32)
t = np.zeros((4, 3), np.float32)
t[1, 2] = np.nan  # one missing observation
preds = {'t': DimArray(torch.from_numpy(p).to(DEVICE), dims, coords)}
tgts = {'t': DimArray(torch.from_numpy(t).to(DEVICE), dims, coords)}
metrics = {'mse': deterministic.MSE()}

# 1. Default: NaN propagates loudly.
loud = aggregation.compute_metric_values_for_single_chunk(
    metrics, aggregation.Aggregator(reduce_dims=list(dims)), preds, tgts)
print('default:', float(loud['mse.t'].values))  # nan

# 2. skipna drops NaN points from numerator AND weights.
skipna = aggregation.compute_metric_values_for_single_chunk(
    metrics, aggregation.Aggregator(reduce_dims=list(dims), skipna=True),
    preds, tgts)
print('skipna :', float(skipna['mse.t'].values))

# 3. masked=True + a mask coord (add_nan_mask_to_data builds it).
masked_tgts = data_base.add_nan_mask_to_data(tgts)
masked = aggregation.compute_metric_values_for_single_chunk(
    metrics, aggregation.Aggregator(reduce_dims=list(dims), masked=True),
    preds, masked_tgts)
print('masked :', float(masked['mse.t'].values))'''),
      ('md', 'The `skipna` and `masked` results agree here because the mask '
             'was derived from the same NaNs; `masked` is the recommended '
             'path because it distinguishes *expected* missingness from '
             'bugs — a NaN outside the mask still propagates.'),
  ]


def data_loaders(device: str) -> Cells:
  return [
      ('md', '# Data loaders\n\nLoaders produce canonical '
             '`(init_time, lead_time, ...)` chunks from stored datasets: '
             'dim renaming from ECMWF conventions, valid-time selection '
             'for targets, persistence and climatology baselines '
             '(reference `data_loaders/xarray_loaders.py`).'),
      ('code', setup(device)),
      ('code', '''\
from weatherbenchx_tpu_torch.data import loaders

rng = np.random.default_rng(3)
n_valid = 12
valid = (np.datetime64('2020-01-01', 'ns')
         + np.arange(n_valid) * np.timedelta64(6, 'h'))
lead = (np.arange(2) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
lats = np.linspace(-90, 90, 5)
lons = np.linspace(0, 360, 6, endpoint=False)

# An ECMWF-named forecast store: time/prediction_timedelta.
pred_store = {'2m_temperature': DimArray(torch.from_numpy(
    rng.standard_normal((10, 2, 5, 6)).astype(np.float32)).to(DEVICE),
    ('time', 'prediction_timedelta', 'latitude', 'longitude'),
    {'time': valid[:10], 'prediction_timedelta': lead,
     'latitude': lats, 'longitude': lons})}
# An analysis store over valid_time.
tgt_store = {'2m_temperature': DimArray(torch.from_numpy(
    rng.standard_normal((n_valid, 5, 6)).astype(np.float32)).to(DEVICE),
    ('valid_time', 'latitude', 'longitude'),
    {'valid_time': valid, 'latitude': lats, 'longitude': lons})}

preds_loader = loaders.PredictionsFromDataset(ds=pred_store)  # renames
tgts_loader = loaders.TargetsFromDataset(ds=tgt_store,
                                         rename_dimensions=None)
init = valid[:4]
chunk_p = preds_loader.load_chunk(init, lead)
chunk_t = tgts_loader.load_chunk(init, lead)
print('predictions dims:', chunk_p['2m_temperature'].dims)
print('targets dims    :', chunk_t['2m_temperature'].dims)
# Targets were gathered at valid_time = init + lead:
vt = chunk_t['2m_temperature'].coords['valid_time']
print('valid_time[0]:', np.asarray(vt.values)[0])'''),
      ('md', 'Persistence repeats the analysis at init time along leads — '
             'a standard baseline:'),
      ('code', '''\
persist = loaders.PersistenceFromDataset(
    ds=tgt_store, rename_dimensions=None).load_chunk(init, lead)
a = np.asarray(persist['2m_temperature'].values)
print('lead 0 equals lead 1:', bool((a[:, 0] == a[:, 1]).all()))'''),
  ]


def sparse_data(device: str) -> Cells:
  return [
      ('md', '# Sparse (station) observations\n\nStation observations '
             'come from hive-partitioned Parquet; the grid forecast is '
             'gathered onto stations (with elevation adjustments), and the '
             'ragged per-chunk station sets are padded to buckets so the '
             'evaluator builds a bounded number of aggregation layouts.\n\n'
             'The Parquet side needs pandas and pyarrow. A machine without '
             'them (such as the GPU machine this port is measured on) '
             'cannot run this notebook: it runs on the CPU only there.'),
      ('code', setup(device)),
      ('code', '''\
import pandas as pd, tempfile, os as _os
from weatherbenchx_tpu_torch import aggregation, binning, interpolations
from weatherbenchx_tpu_torch.data import loaders, sparse_parquet
from weatherbenchx_tpu_torch.metrics import deterministic

tmp = tempfile.mkdtemp()
times = np.arange('2020-01-01T00', '2020-01-03T00',
                  np.timedelta64(6, 'h'), dtype='datetime64[ns]')
rows = []
rng = np.random.default_rng(4)
for t in times:
    for s in range(6):
        rows.append({'timeNominal': pd.Timestamp(t),
                     'stationName': f'ST{s}',
                     'latitude': -60.0 + 20.0 * s,
                     'longitude': 15.0 + 50.0 * s,
                     'elevation': 120.0 * s,
                     'temperature': 270.0 + rng.standard_normal(),
                     'temperatureDD': 'S'})
df = pd.DataFrame(rows)
fn = _os.path.join(tmp, 'obs', 'year=2020', 'month=1', '2020-01.parquet')
_os.makedirs(_os.path.dirname(fn), exist_ok=True)
df.to_parquet(fn)

targets_loader = sparse_parquet.METARFromParquet(
    path=_os.path.join(tmp, 'obs'), variables=['2m_temperature'],
    time_dim='timeNominal', add_nan_mask=True,
    pad_index_multiple=64)  # pad-to-bucket: bounded layout shapes
init = np.array(['2020-01-01T00', '2020-01-01T12'], dtype='datetime64[ns]')
lead = np.array([6, 12], dtype='timedelta64[h]').astype('timedelta64[ns]')
chunk = targets_loader.load_chunk(init, lead)
chunk = {k: v.copy(data=v.data.to(DEVICE)) for k, v in chunk.items()}
da = chunk['2m_temperature']
print('index length (padded):', da.sizes['index'])
print('real rows:', int(np.asarray(da.coords['mask'].values).sum()))'''),
      ('md', 'Grid → station: the prediction loader interpolates onto the '
             'target chunk’s station coordinates (lapse-rate temperature '
             'adjustment for elevation differences), and station-set '
             'binning aggregates per network:'),
      ('code', '''\
lats = np.linspace(-90, 90, 19)
lons = np.linspace(0, 360, 36, endpoint=False)
grid_elev = DimArray(torch.zeros((19, 36), device=DEVICE),
                     ('latitude', 'longitude'),
                     {'latitude': lats, 'longitude': lons})
pred_ds = {'2m_temperature': DimArray(torch.from_numpy(
    270 + np.random.default_rng(5).standard_normal(
        (2, 2, 19, 36)).astype(np.float32)).to(DEVICE),
    ('init_time', 'lead_time', 'latitude', 'longitude'),
    {'init_time': init, 'lead_time': lead,
     'latitude': lats, 'longitude': lons})}
predictions_loader = loaders.PredictionsFromDataset(
    ds=pred_ds, rename_dimensions=None,
    interpolation=interpolations.GridToSparseWithAltitudeAdjustment(
        'linear', grid_elevation=grid_elev, wrap_longitude=True))
agg = aggregation.Aggregator(
    reduce_dims=['index'], masked=True,
    bin_by=[binning.BySets({'low': ['ST0', 'ST1', 'ST2']},
                           coord_name='stationName', bin_dim_name='network',
                           add_set_complements=True, add_global_bin=True)])
p_chunk = predictions_loader.load_chunk(init, lead, reference=chunk)
out = aggregation.compute_metric_values_for_single_chunk(
    {'rmse': deterministic.RMSE()}, agg, p_chunk, chunk)
v = out['rmse.2m_temperature']
for name, val in zip(v.coord_values('network'),
                     np.asarray(v.values, np.float64)):
    print(f'{name:10s} rmse={val:.3f}')'''),
  ]


def forecast_latency(device: str) -> Cells:
  return [
      ('md', '# Simulating forecast latency\n\nOperational forecasts are '
             'not available at their nominal init time. '
             '`DatasetConstantLatencyWrapper` remaps a requested '
             '(init, lead) to the freshest *available* init given a '
             'constant latency, adjusting leads accordingly (reference '
             '`data_loaders/latency_wrappers.py:26-231`).'),
      ('code', setup(device)),
      ('code', '''\
from weatherbenchx_tpu_torch.data import latency_wrappers, loaders

rng = np.random.default_rng(6)
init = (np.datetime64('2020-01-01', 'ns')
        + np.arange(8) * np.timedelta64(12, 'h'))
lead = (np.arange(8) * np.timedelta64(6, 'h')).astype('timedelta64[ns]')
store = {'t': DimArray(torch.from_numpy(
    rng.standard_normal((8, 8, 3)).astype(np.float32)).to(DEVICE),
    ('init_time', 'lead_time', 'latitude'),
    {'init_time': init, 'lead_time': lead,
     'latitude': np.linspace(-60, 60, 3)})}

wrapper = latency_wrappers.DatasetConstantLatencyWrapper(
    loaders.PredictionsFromDataset(ds=store, rename_dimensions=None),
    latency=np.timedelta64(7, 'h'))
# At 2020-01-02T00 with 7h latency, the freshest available init is
# 2020-01-01T12 (the 00z run is 7h old at 07z; 12z arrives 19z):
req = np.datetime64('2020-01-02T00', 'ns')
print('available init:', wrapper.get_available_init_time(req))
chunk = wrapper.load_chunk(np.array([req]),
                           lead[:2])
print('chunk dims:', chunk['t'].dims, dict(chunk['t'].sizes))'''),
  ]


NOTEBOOKS: dict[str, Callable[[str], Cells]] = {
    'quickstart': quickstart,
    'data_loaders': data_loaders,
    'implement_metrics': implement_metrics,
    'metric_wrappers': metric_wrappers,
    'nan_handling': nan_handling,
    'sparse_data': sparse_data,
    'forecast_latency': forecast_latency,
}
# Topics that read Parquet: pandas and pyarrow, which the port does not
# require on the GPU.
NEEDS_PARQUET = ('sparse_data',)


def run_cells(cells: Cells) -> list[str]:
  """Runs the code cells in order in one fresh namespace, as a kernel
  would; returns what each printed."""
  namespace = {'__name__': '__main__'}
  printed = []
  for kind, source in cells:
    if kind != 'code':
      continue
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
      exec(compile(source, '<cell>', 'exec'), namespace)
    printed.append(buf.getvalue())
  return printed


def committed_outputs(path: str) -> list[str]:
  """Each code cell's printed text in a written notebook (plain json)."""
  with open(path) as f:
    nb = json.load(f)
  out = []
  for cell in nb['cells']:
    if cell['cell_type'] != 'code':
      continue
    text = []
    for o in cell.get('outputs', []):
      if o.get('output_type') == 'error':
        raise AssertionError(f'{path}: a cell raised {o.get("ename")}')
      if o.get('output_type') == 'stream' and o.get('name') == 'stdout':
        t = o['text']
        text.append(''.join(t) if isinstance(t, list) else t)
    out.append(''.join(text))
  return out


# Datetimes stay whole tokens; numbers are compared as numbers; everything
# else (names, dims, booleans, punctuation) as text without whitespace,
# which numpy's column padding moves.
_DATETIME = r'\d{4}-\d{2}-\d{2}T[\d:.]+'
_NUMBER = r'[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|\bnan\b|\binf\b'
_TOKEN = re.compile(f'({_DATETIME})|({_NUMBER})')


def printed_tokens(text: str) -> list[tuple[str, str]]:
  """('number' | 'text', token) pairs of a printed text."""
  out, pos = [], 0
  for m in _TOKEN.finditer(text):
    rest = re.sub(r'\s+', '', text[pos:m.start()])
    if rest:
      out.append(('text', rest))
    out.append(('text', m.group(1)) if m.group(1)
               else ('number', m.group(2)))
    pos = m.end()
  rest = re.sub(r'\s+', '', text[pos:])
  if rest:
    out.append(('text', rest))
  return out


def _decimals(token: str) -> int:
  mantissa = re.split('[eE]', token)[0]
  return len(mantissa.split('.')[1]) if '.' in mantissa else 0


def numbers_close(got: str, want: str, rtol: float = 1e-5) -> bool:
  """Two printed numbers agree within ``rtol`` relative, or within one
  unit in the last digit that either printed."""
  a, b = float(got), float(want)
  if math.isnan(a) or math.isnan(b):
    return math.isnan(a) and math.isnan(b)
  if math.isinf(a) or math.isinf(b):
    return a == b
  unit = 10.0 ** -max(_decimals(got), _decimals(want))
  if 'e' in got.lower() or 'e' in want.lower():
    unit = 0.0  # a unit of an exponent's mantissa is not 10**-decimals
  return abs(a - b) <= max(rtol * abs(b), unit * (1 + 1e-9))


def compare_printed(got: str, want: str, rtol: float = 1e-5
                    ) -> Optional[str]:
  """None if two printed texts agree (the same text tokens, every number
  within :func:`numbers_close`), else what differs."""
  tg, tw = printed_tokens(got), printed_tokens(want)
  if len(tg) != len(tw):
    return f'{len(tg)} tokens, want {len(tw)}: {got!r} vs {want!r}'
  for (kg, g), (kw, w) in zip(tg, tw):
    if kg != kw or (kg == 'text' and g != w) or (
        kg == 'number' and not numbers_close(g, w, rtol)):
      return f'{g!r} where {w!r}: {got!r} vs {want!r}'
  return None


def notebook(cells: Cells):
  """An nbformat notebook of the cells, not executed."""
  import nbformat
  nb = nbformat.v4.new_notebook()
  nb.metadata['kernelspec'] = {
      'name': 'python3', 'display_name': 'Python 3', 'language': 'python'}
  for kind, src in cells:
    nb.cells.append(nbformat.v4.new_markdown_cell(src) if kind == 'md'
                    else nbformat.v4.new_code_cell(src))
  return nb


def main(argv: Optional[Sequence[str]] = None) -> list[str]:
  """Executes and writes the notebooks; returns the paths written."""
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the default; raises without a GPU) or 'cpu'")
  p.add_argument('--out', default=OUT)
  p.add_argument('--only', default=None)
  args = p.parse_args(argv)
  from weatherbenchx_tpu_torch.apps import run_evaluation
  device = str(run_evaluation.resolve_device(args.device))
  import nbformat
  from nbclient import NotebookClient
  os.makedirs(args.out, exist_ok=True)
  written = []
  for name, build in NOTEBOOKS.items():
    if args.only and name != args.only:
      continue
    nb = notebook(build(device))
    NotebookClient(nb, timeout=600, kernel_name='python3',
                   resources={'metadata': {'path': REPO}}).execute()
    path = os.path.join(args.out, f'{name}.ipynb')
    nbformat.write(nb, path)
    n_out = sum(1 for c in nb.cells if c.cell_type == 'code' and c.outputs)
    print(f'{path}: {len(nb.cells)} cells, {n_out} executed with output')
    written.append(path)
  return written


if __name__ == '__main__':
  main()
