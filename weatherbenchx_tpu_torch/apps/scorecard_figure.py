"""Publication scorecard figure (matplotlib, static PNG/PDF).

Equivalent of the reference's website-scorecard notebook
(``public_benchmark/WB_X_Website_Scorecard.ipynb``), which renders the
WeatherBench headline figure from the combined results store: one row per
model, one panel per (variable, level, metric), each panel a single-row
heatmap of the % difference vs a reference model across lead times —
binned blue/red diverging colors ("Better ← % difference → Worse") with
the model's absolute scores overlaid per cell.

Input is the combined scorecard written by ``apps/combine_results.py``
(per-variable arrays with ``(model, metric, ...)`` dims). The interactive
counterpart is ``apps/scorecard_html.py``; this module is for papers /
the website's static headline image.

The port of ``weatherbenchx_tpu/apps/scorecard_figure.py``. matplotlib is
imported inside the functions that draw only; a machine without it (the
GPU machine this port is run on has none) imports the module and computes
``compute_relative`` and the panels' values, but cannot draw.
"""

import argparse
from typing import Mapping, Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.darray import DimArray

# Notebook's binned diverging scale: 6 blues (better), light-gray
# ±1% "no change" band, 6 reds (worse).
COLORBAR_LEVELS = [-50, -25, -15, -10, -5, -2, -1, 1, 2, 5, 10, 15, 25, 50]

# Display variables whose "vs Analysis" scores are replaced by the model's
# "vs ERA5" scores (analysis targets carry no precipitation).
PRECIP_VARIABLES = ('6h Precipitation', '24h Precipitation')


def _cmap_and_norm():
  import matplotlib
  blues = matplotlib.colormaps['Blues_r'](np.linspace(0.15, 0.8, 6))
  reds = matplotlib.colormaps['Reds'](np.linspace(0.25, 0.9, 6))
  colors = list(blues) + [(0.93, 0.93, 0.93, 1.0)] + list(reds)
  cmap = matplotlib.colors.ListedColormap(colors)
  cmap.set_under(colors[0])
  cmap.set_over(colors[-1])
  cmap.set_bad('white')
  norm = matplotlib.colors.BoundaryNorm(COLORBAR_LEVELS, cmap.N)
  return cmap, norm


def replace_analysis_precip_with_era(
    results: Mapping[str, DimArray]) -> dict[str, DimArray]:
  """Substitutes 'X vs Analysis' precip scores with 'X vs ERA5' ones.

  Mirrors the notebook's ``replace_analysis_with_era_precip``: analysis
  targets have no precipitation, so precip rows for operational models
  come from the same model verified against ERA5.
  """
  out = dict(results)
  for var in PRECIP_VARIABLES:
    if var not in out:
      continue
    da = out[var]
    models = [str(m) for m in da.coord_values('model')]
    vals = np.array(np.asarray(da.values), copy=True)
    axis = da.dims.index('model')
    for i, model in enumerate(models):
      if model.endswith('vs Analysis'):
        counterpart = model.replace('vs Analysis', 'vs ERA5')
        if counterpart in models:
          src = models.index(counterpart)
          sl = [slice(None)] * vals.ndim
          sl[axis] = i
          src_sl = list(sl)
          src_sl[axis] = src
          vals[tuple(sl)] = vals[tuple(src_sl)]
    out[var] = da.copy(data=vals)
  return out


def compute_relative(results: Mapping[str, DimArray],
                     reference_model: str) -> dict[str, DimArray]:
  """% difference vs the reference model: ``100 * (x - ref) / ref``."""
  out = {}
  for var, da in results.items():
    models = [str(m) for m in da.coord_values('model')]
    if reference_model not in models:
      raise ValueError(
          f'reference model {reference_model!r} not in scorecard '
          f'(models: {models})')
    vals = np.asarray(da.values, dtype=np.float64)
    axis = da.dims.index('model')
    ref = np.take(vals, models.index(reference_model), axis=axis)
    ref = np.expand_dims(ref, axis)
    with np.errstate(divide='ignore', invalid='ignore'):
      out[var] = da.copy(data=(vals - ref) / ref * 100.0)
  return out


def _lead_days(da: DimArray) -> np.ndarray:
  lead = np.asarray(da.coord_values('lead_time'))
  if lead.dtype.kind == 'm':
    return lead.astype('timedelta64[h]').astype(int) / 24.0
  return np.asarray(lead, dtype=float)


def _panel_values(da: DimArray, model: str, metric: str,
                  level, lead_days: np.ndarray) -> np.ndarray:
  sel = {'model': model, 'metric': metric}
  if level is not None and 'level' in da.dims:
    sel['level'] = level
  p = da.sel(**sel)
  if 'region' in p.dims:
    p = p.sel(region='Global' if 'Global' in set(
        map(str, p.coord_values('region'))) else
        p.coord_values('region')[0])
  days = _lead_days(p)
  idx = [int(np.argmin(np.abs(days - d))) for d in lead_days]
  vals = np.asarray(p.values, dtype=np.float64)
  lead_axis = p.dims.index('lead_time')
  vals = np.take(vals, idx, axis=lead_axis)
  # Any leftover singleton dims collapse; panels are 1-D over lead.
  return vals.reshape(-1, len(lead_days))[0]


def _fmt_abs(v: float, var: str, metric: str) -> str:
  if var == 'Specific Humidity':
    v *= 1000
  if var == '24h Precipitation' and metric == 'CRPS':
    v *= 1000
  s = f'{v:.3g}'
  return s[:4].rstrip('.') if v <= 10 else s[:3].rstrip('.')


def plot_scorecard(
    results: Mapping[str, DimArray],
    panels: Sequence[tuple],
    reference_model: str,
    models: Optional[Sequence[str]] = None,
    lead_days: Sequence[float] = (1, 3, 5, 7, 10),
    titles: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
    era5_precip_for_analysis: bool = True,
):
  """Renders the scorecard figure.

  Args:
    results: combined scorecard ({variable: (model, metric, ...) array}).
    panels: sequence of (variable, level-or-None, metric) column specs,
      e.g. ``[('Geopotential', 500, 'RMSE'), ('2m Temperature', None,
      'RMSE')]``.
    reference_model: display name the % differences are measured against.
    models: row order (default: every model in the first panel's variable).
    lead_days: cell columns (nearest available lead is used).
    titles: per-panel column titles (default "<var> <level>").
    out_path: if set, the figure is saved here (PNG/PDF by extension).
    era5_precip_for_analysis: apply ``replace_analysis_precip_with_era``.

  Returns:
    The matplotlib Figure.
  """
  import matplotlib
  import matplotlib.pyplot as plt

  if era5_precip_for_analysis:
    results = replace_analysis_precip_with_era(results)
  relative = compute_relative(results, reference_model)

  first = results[panels[0][0]]
  models = list(models or map(str, first.coord_values('model')))
  lead_days = np.asarray(lead_days, dtype=float)
  nrows, ncols = len(models), len(panels)
  cmap, norm = _cmap_and_norm()

  panel_w, panel_h = 2.0, 0.4
  fig_w = 2.0 + ncols * (panel_w + 0.12)
  fig_h = 1.6 + nrows * (panel_h + 0.05)
  fig, axes = plt.subplots(
      nrows, ncols, figsize=(fig_w, fig_h), squeeze=False,
      gridspec_kw={'left': 2.0 / fig_w, 'right': 0.99,
                   'top': 1 - 0.5 / fig_h, 'bottom': 1.0 / fig_h,
                   'hspace': 0.15, 'wspace': 0.08})
  img = None
  for row, model in enumerate(models):
    for col, (var, level, metric) in enumerate(panels):
      ax = axes[row][col]
      try:
        rel = _panel_values(relative[var], model, metric, level, lead_days)
        absolute = _panel_values(results[var], model, metric, level,
                                 lead_days)
      except (KeyError, ValueError):
        ax.set_axis_off()
        continue
      if np.all(np.isnan(rel)) and model != reference_model:
        ax.set_axis_off()
        continue
      img = ax.imshow(rel[None, :], aspect='auto', cmap=cmap, norm=norm)
      ax.set_xticks([])
      ax.set_yticks([])
      for x in np.arange(0.5, len(lead_days) - 0.5):
        ax.axvline(x, color='0.9', lw=1)
      for i, v in enumerate(absolute):
        if np.isfinite(v):
          ax.text(i, 0, _fmt_abs(float(v), var, metric),
                  ha='center', va='center', fontsize=8)
      if col == 0:
        ax.set_ylabel(model.split(' vs')[0], rotation='horizontal',
                      ha='right', va='center', fontsize=9.5)
      if row == 0:
        title = (titles[col] if titles else
                 f'{var}{f" {level}" if level is not None else ""}')
        ax.set_title(f'{title}\n({metric})', fontsize=9)
      if row == nrows - 1:
        ax.set_xticks(range(len(lead_days)))
        ax.set_xticklabels([f'{d:g}' for d in lead_days], fontsize=8)
        ax.set_xlabel('Lead time [days]', fontsize=8)

  if img is not None:
    cax = fig.add_axes((0.35, 0.25 / fig_h, 0.45, 0.12 / fig_h))
    cb = fig.colorbar(img, cax=cax, orientation='horizontal')
    cb.ax.set_xticks(COLORBAR_LEVELS)
    cb.ax.tick_params(labelsize=6)
    ref_short = reference_model.split(' vs')[0]
    cb.ax.set_xlabel(
        r'Better $\longleftarrow$ % difference vs '
        f'{ref_short}'
        r' $\longrightarrow$ Worse', fontsize=8)
  if out_path:
    fig.savefig(out_path, dpi=200)
  return fig


def _parse_panel(spec: str) -> tuple:
  """'Geopotential:500:RMSE' / '2m Temperature::RMSE' → (var, level, metric)."""
  parts = spec.split(':')
  if len(parts) != 3:
    raise ValueError(f'panel spec must be var:level:metric, got {spec!r}')
  var, level, metric = parts
  return var, (int(level) if level else None), metric


def main(argv: Optional[Sequence[str]] = None) -> None:
  import matplotlib
  matplotlib.use('Agg')
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--scorecard', required=True,
                 help='Combined scorecard store (combine_results output)')
  p.add_argument('--output', required=True, help='Figure path (.png/.pdf)')
  p.add_argument('--reference_model', default='IFS HRES vs Analysis')
  p.add_argument('--panels', default=(
      'Geopotential:500:RMSE,Temperature:850:RMSE,2m Temperature::RMSE'),
      help='Comma-separated var:level:metric column specs')
  p.add_argument('--models', default=None,
                 help='Comma-separated row order (default: all)')
  p.add_argument('--lead_days', default='1,3,5,7,10')
  args = p.parse_args(argv)

  results = io_lib.load_dataset(args.scorecard)
  panels = [_parse_panel(s) for s in args.panels.split(',') if s]
  fig = plot_scorecard(
      results, panels, args.reference_model,
      models=args.models.split(',') if args.models else None,
      lead_days=[float(d) for d in args.lead_days.split(',')],
      out_path=args.output)
  import matplotlib.pyplot as plt
  plt.close(fig)
  print(f'Wrote {args.output}')


if __name__ == '__main__':
  main()
