"""Self-contained interactive HTML scorecard viewer.

The reference ships Plotly Dash web apps for interactive scorecards
(``public_benchmark/apps/dash_app.py:42-430``, deployed on App Engine).
This dependency-free equivalent renders the combined scorecard
(``combine_results`` output) into a single HTML file with the same
interactions, no server required:

- variable / metric / level / region / year / resolution selectors
  (level disabled for surface variables, year/resolution shown only when
  the scorecard carries those dims, mirroring ``dash_app.py:55-236``);
- an SVG line chart of score vs lead time (ticks every 24 h), one line
  per model with stable colors, a click-to-toggle legend with
  default-visible model subsets and a markers toggle
  (``dash_app.py:355-393, 217-236``), gaps connected across NaNs;
- a relative-to-baseline mode: % improvement ``-100*(x-b)/b``, the ACC
  special case ``100*(x-b)/(1-b)``, lead 0 dropped, exactly as
  ``dash_app.py:341-350``; Spread/Skill also drops lead 0
  (``dash_app.py:351-352``);
- SEEPS guards: alert for non-precipitation variables and for relative
  mode vs an Analysis baseline (``dash_app.py:314-320``);
- y-axis labels with physical units (``UNITS``, reference
  ``combine_results.py:173-193``);
- the color-scaled model x lead-time table below the chart.

The port of ``weatherbenchx_tpu/apps/scorecard_html.py``: the same page,
character for character, from the same scorecard.

Example:
  python -m weatherbenchx_tpu_torch.apps.scorecard_html \
      --scorecard=scorecard.npz --output=scorecard.html
"""

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from weatherbenchx_tpu_torch import io as io_lib
from weatherbenchx_tpu_torch.apps import combine_results as combine_lib
from weatherbenchx_tpu_torch.apps import scorecard_logic

UNITS = {
    'Geopotential': 'm²/s²', 'geopotential': 'm²/s²',
    'Temperature': 'K', 'temperature': 'K',
    'Specific Humidity': 'g/kg', 'specific_humidity': 'g/kg',
    'U Component of Wind': 'm/s', 'u_component_of_wind': 'm/s',
    'V Component of Wind': 'm/s', 'v_component_of_wind': 'm/s',
    '10m U Component of Wind': 'm/s', '10m_u_component_of_wind': 'm/s',
    '10m V Component of Wind': 'm/s', '10m_v_component_of_wind': 'm/s',
    'Sea Level Pressure': 'Pa', 'mean_sea_level_pressure': 'Pa',
    '2m Temperature': 'K', '2m_temperature': 'K',
    '6h Precipitation': 'mm', 'total_precipitation_6hr': 'mm',
    '24h Precipitation': 'mm', 'total_precipitation_24hr': 'mm',
    'Wind Speed': 'm/s', 'wind_speed': 'm/s',
    '10m Wind Speed': 'm/s', '10m_wind_speed': 'm/s',
    'Wind Vector': 'm/s', 'wind_vector': 'm/s',
    '10m Wind Vector': 'm/s', '10m_wind_vector': 'm/s',
}

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>WeatherBench-X TPU scorecard</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }}
 h1 {{ font-size: 1.4rem; }}
 label {{ margin-right: 1rem; font-size: 0.9rem; }}
 select {{ padding: 0.25rem; font-size: 0.95rem; }}
 table {{ border-collapse: collapse; margin-bottom: 2rem; }}
 th, td {{ border: 1px solid #ccc; padding: 0.35rem 0.7rem;
           text-align: right; font-variant-numeric: tabular-nums; }}
 th {{ background: #f2f2f2; text-align: center; }}
 caption {{ font-weight: 600; text-align: left; padding: 0.4rem 0; }}
 #legend span {{ cursor: pointer; margin-right: 1rem; user-select: none;
                 font-size: 0.9rem; }}
 #legend span.off {{ opacity: 0.3; }}
 #alert {{ color: #8a1f11; background: #fbe3e4; padding: 0.5rem 1rem;
           border-radius: 4px; display: none; margin: 0.6rem 0; }}
 #selftest {{ font-size: 0.8rem; padding: 0.25rem 0.6rem; border-radius: 4px;
              display: inline-block; margin-bottom: 0.4rem; }}
 #selftest[data-status="pass"] {{ color: #264409; background: #e6efc2; }}
 #selftest[data-status="fail"] {{ color: #8a1f11; background: #fbe3e4; }}
 svg text {{ font-size: 11px; fill: #444; }}
</style></head>
<body>
<h1>WeatherBench-X TPU scorecard</h1>
<div id="selftest"></div>
<div>
 <label>Variable <select id="variable"></select></label>
 <label>Metric <select id="metric"></select></label>
 <label>Level <select id="level"></select></label>
 <label>Region <select id="region"></select></label>
 <label id="yearlbl">Year <select id="year"></select></label>
 <label id="reslbl">Resolution <select id="resolution"></select></label>
</div>
<div style="margin-top:0.4rem">
 <label><input type="radio" name="rel" value="abs" checked> Absolute</label>
 <label><input type="radio" name="rel" value="rel"> Relative to
  <select id="baseline"></select></label>
 <label><input type="checkbox" id="markers" checked> Markers</label>
</div>
<div id="alert"></div>
<div id="legend"></div>
<svg id="chart" width="900" height="420"></svg>
<div id="tables"></div>
<script>
const DATA = {data_json};
// Golden interaction fixtures, computed by the unit-tested Python mirror
// (apps/scorecard_logic.py) and re-executed against the JS below on load.
const SELFTEST = {selftest_json};
{logic_js}
{selftest_runner_js}
const PALETTE = ['#1f77b4','#ff7f0e','#2ca02c','#d62728','#9467bd',
                 '#8c564b','#e377c2','#7f7f7f','#bcbd22','#17becf',
                 '#aec7e8','#ffbb78','#98df8a','#ff9896','#c5b0d5'];
// Default-visible subsets (reference apps/config.py:55-70, applied at
// dash_app.py:361-372): a curated list per category — deterministic,
// precipitation, probabilistic. Models outside the list start
// legend-hidden; clicking toggles. When none of the curated names match
// (scorecard built without --display_names), fall back to the first
// DEFAULT_VISIBLE models.
const DEFAULTS_BY_CAT = {defaults_by_cat_json};
const DEFAULT_VISIBLE = {default_visible};
function categoryFor() {{
  return sl_categoryFor($('metric').value, $('variable').value);
}}
const hiddenByCat = {{}};  // per-category hidden sets; toggles persist
function hiddenSet() {{
  const cat = categoryFor();
  if (!(cat in hiddenByCat))
    hiddenByCat[cat] = new Set(sl_defaultHidden(
        DATA.models, cat, DEFAULTS_BY_CAT, DEFAULT_VISIBLE));
  return hiddenByCat[cat];
}}
const $ = id => document.getElementById(id);
function fill(sel, opts) {{
  const prev = sel.value; sel.innerHTML = '';
  for (const o of opts) sel.add(new Option(o, o));
  if (opts.includes(prev)) sel.value = prev;
}}
fill($('variable'), DATA.variables);
fill($('metric'), DATA.metrics);
fill($('region'), DATA.regions);
fill($('baseline'), DATA.models);
fill($('year'), DATA.years);
fill($('resolution'), DATA.resolutions);
if (DATA.years.length < 2) $('yearlbl').style.display = 'none';
if (DATA.resolutions.length < 2) $('reslbl').style.display = 'none';
function relMode() {{
  return document.querySelector('input[name=rel]:checked').value === 'rel';
}}
function currentEntry() {{
  const v = $('variable').value, m = $('metric').value;
  const byMetric = DATA.values[v]?.[m];
  if (!byMetric) return null;
  const levels = Object.keys(byMetric);
  fill($('level'), levels);
  $('level').disabled = levels.length === 1 && levels[0] === 'all';
  const yr = `${{$('year').value}}|${{$('resolution').value}}`;
  return sl_lookupEntry(DATA.values, v, m, $('level').value,
                        $('region').value, yr);
}}
function seepsGuard() {{
  return sl_seepsGuard($('metric').value, $('variable').value,
                       relMode(), $('baseline').value);
}}
function applyRelative(rows, metric) {{
  const b = DATA.models.indexOf($('baseline').value);
  return sl_applyRelative(rows, metric, b, DATA.lead_hours);
}}
function maskLeadZero(rows) {{
  return sl_maskLeadZero(rows, DATA.lead_hours);
}}
function drawChart(rows, ylabel) {{
  const svg = $('chart'), W = 900, H = 420;
  const ml = 70, mr = 20, mt = 15, mb = 45;
  const xs = DATA.lead_hours;
  const withMarkers = $('markers').checked;
  const hidden = hiddenSet();
  const shown = rows.map((r, i) => hidden.has(DATA.models[i]) ? null : r);
  const flat = shown.flat().filter(x => x != null && isFinite(x));
  if (!flat.length) {{ svg.innerHTML =
      '<text x="400" y="200">No finite data for this selection.</text>';
      return; }}
  let lo = Math.min(...flat), hi = Math.max(...flat);
  if (lo === hi) {{ lo -= 1; hi += 1; }}
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const X = h => ml + (W - ml - mr) * (x1 > x0 ? (h - x0) / (x1 - x0) : 0.5);
  const Y = v => H - mb - (H - mt - mb) * (v - lo) / (hi - lo);
  let out = '';
  for (let t = 0; t <= 5; t++) {{          // y grid + labels
    const v = lo + (hi - lo) * t / 5, y = Y(v);
    out += `<line x1="${{ml}}" y1="${{y}}" x2="${{W - mr}}" y2="${{y}}"
            stroke="#eee"/><text x="${{ml - 6}}" y="${{y + 4}}"
            text-anchor="end">${{v.toPrecision(3)}}</text>`;
  }}
  // x ticks: every 24h once the axis spans > 48h (dash_app.py:418).
  const tickStep = (x1 - x0) > 48 ? 24 : null;
  const ticks = tickStep
      ? Array.from({{length: Math.floor(x1 / tickStep) + 1}},
                   (_, i) => i * tickStep).filter(h => h >= x0)
      : xs;
  for (const h of ticks) out += `<text x="${{X(h)}}" y="${{H - mb + 16}}"
      text-anchor="middle">${{h}}h</text>`;
  out += `<text x="${{ml - 52}}" y="${{(mt + H - mb) / 2}}"
      transform="rotate(-90 ${{ml - 52}} ${{(mt + H - mb) / 2}})"
      text-anchor="middle">${{ylabel}}</text>`;
  shown.forEach((row, i) => {{
    if (!row) return;
    const pts = xs.map((h, j) => [h, row[j]])
        .filter(p => p[1] != null && isFinite(p[1]));  // connectgaps
    if (!pts.length) return;
    const c = PALETTE[i % PALETTE.length];
    out += '<polyline fill="none" stroke="' + c + '" stroke-width="2" '
        + 'points="' + pts.map(p => `${{X(p[0])}},${{Y(p[1])}}`).join(' ')
        + '"/>';
    if (withMarkers)
      for (const p of pts) out += `<circle cx="${{X(p[0])}}" cy="${{Y(p[1])}}"
          r="2.5" fill="${{c}}"><title>${{DATA.models[i]}} @ ${{p[0]}}h:
          ${{p[1].toPrecision(5)}}</title></circle>`;
  }});
  svg.innerHTML = out;
}}
function drawLegend() {{
  const hidden = hiddenSet();
  $('legend').innerHTML = DATA.models.map((m, i) =>
    `<span data-m="${{m}}" class="${{hidden.has(m) ? 'off' : ''}}"
     style="color:${{PALETTE[i % PALETTE.length]}}">&#9632; ${{m}}</span>`
  ).join('');
  for (const el of $('legend').children)
    el.onclick = () => {{
      const m = el.dataset.m;
      hidden.has(m) ? hidden.delete(m) : hidden.add(m);
      render();
    }};
}}
function color(v, lo, hi) {{
  if (v == null || !isFinite(v)) return '#eee';
  const t = hi > lo ? (v - lo) / (hi - lo) : 0.5;
  const g = Math.round(235 - 110 * t), r = Math.round(125 + 110 * t);
  return `rgb(${{r}},${{g}},125)`;
}}
function drawTable(rows, title) {{
  const vals = rows.flat().filter(x => x != null && isFinite(x));
  const lo = Math.min(...vals), hi = Math.max(...vals);
  let out = `<table><caption>${{title}}</caption>`;
  out += '<tr><th>model</th>' + DATA.lead_times.map(
      l => `<th>${{l}}</th>`).join('') + '</tr>';
  rows.forEach((row, i) => {{
    out += `<tr><th>${{DATA.models[i]}}</th>` + row.map(v =>
      `<td style="background:${{color(v, lo, hi)}}">` +
      (v != null && isFinite(v) ? v.toPrecision(4) : '&mdash;')
      + '</td>').join('') + '</tr>';
  }});
  $('tables').innerHTML = out + '</table>';
}}
function render() {{
  $('baseline').disabled = !relMode();
  const alertBox = $('alert');
  const guard = seepsGuard();
  drawLegend();
  if (guard) {{
    alertBox.textContent = guard;
    alertBox.style.display = 'block';
    $('chart').innerHTML = '';
    $('tables').innerHTML = '';
    return;
  }}
  alertBox.style.display = 'none';
  let rows = currentEntry();
  if (!rows) {{
    $('chart').innerHTML = '';
    $('tables').innerHTML = '<p>No data for this selection.</p>';
    return;
  }}
  const metric = $('metric').value;
  const unit = DATA.units[$('variable').value];
  let ylabel = unit ? `${{metric}} [${{unit}}]` : metric;
  if (metric === 'ACC') ylabel = 'ACC';
  if (relMode()) {{
    rows = applyRelative(rows, metric);
    ylabel = `% improvement vs ${{$('baseline').value}}`;
  }} else if (metric.includes('Spread/Skill')) {{
    rows = maskLeadZero(rows);  // dash_app.py:351-352
  }}
  const title = [$('variable').value, metric, $('level').value,
                 $('region').value].filter(s => s !== 'all').join(' &mdash; ');
  drawChart(rows, ylabel);
  drawTable(rows, title);
}}
for (const id of ['variable', 'metric', 'level', 'region', 'year',
                  'resolution', 'baseline'])
  $(id).onchange = render;
$('markers').onchange = render;
for (const r of document.querySelectorAll('input[name=rel]'))
  r.onchange = render;
// Execute the golden interaction fixtures against the embedded logic and
// surface the verdict (apps/scorecard_logic.py keeps fixture expectations
// in lock-step with the unit-tested Python mirror).
(() => {{
  const failures = sl_runSelfTests(SELFTEST);
  const el = $('selftest');
  if (failures.length) {{
    el.dataset.status = 'fail';
    el.textContent = `interaction-math self-test: ${{failures.length}} of ` +
        `${{SELFTEST.length}} cases FAILED — ` + failures.slice(0, 3).join('; ');
  }} else {{
    el.dataset.status = 'pass';
    el.textContent = `interaction-math self-test: ${{SELFTEST.length}}/` +
        `${{SELFTEST.length}} cases pass`;
  }}
}})();
render();
</script>
</body></html>
"""


def render_scorecard_html(scorecard_path: str) -> str:
  """Renders the combined scorecard npz into a standalone HTML page.

  The input follows the ``combine_results`` schema: one DimArray per
  variable with dims ``(model, metric[, resolution][, year][, level]
  [, lead_time][, region])``.
  """
  sc = io_lib.load_dataset(scorecard_path)
  variables = sorted(str(v) for v in sc.keys())
  first = sc[variables[0]]
  models = [str(m) for m in first.coord_values('model')]
  metrics = sorted({str(m) for v in variables
                    for m in sc[v].coord_values('metric')})

  def _regions_of(da):
    return ([str(r) for r in da.coord_values('region')]
            if 'region' in da.dims else [])

  # Union across variables, first-seen order: per-variable region sets can
  # differ (e.g. precipitation evaluated on a headline subset), and taking
  # only the first variable's list crashed the render on any region it
  # happened to lack.
  regions: list = []
  for v in variables:
    for r in _regions_of(sc[v]):
      if r not in regions:
        regions.append(r)
  if not regions:
    regions = ['all']
  years = ([str(y) for y in first.coord_values('year')]
           if 'year' in first.dims else ['all'])
  resolutions = ([str(r) for r in first.coord_values('resolution')]
                 if 'resolution' in first.dims else ['all'])
  # Lead axis = the UNION across variables, each variable scattered onto
  # it by label: combine_result_files aligns each variable to its own
  # lead_time extent, so e.g. a 24h-only precipitation variable must plot
  # at 24h on the shared axis, not at whatever hour shares its column
  # index in the first variable.
  def _var_lead_hours(da):
    if 'lead_time' not in da.dims:
      return None
    lv = da.coord_values('lead_time')
    if lv.dtype.kind == 'm':
      return lv.astype('timedelta64[h]').astype(np.int64).tolist()
    return [int(l) for l in lv]

  per_var_leads = {v: _var_lead_hours(sc[v]) for v in variables}
  union_leads = sorted({h for hs in per_var_leads.values() if hs
                        for h in hs})
  if union_leads:
    lead_hours = union_leads
    lead_labels = [f'{h}h' for h in lead_hours]
  else:
    lead_hours = [0]
    lead_labels = ['value']

  values: dict = {}
  for variable in variables:
    da = sc[variable]
    hs = per_var_leads[variable]
    # This variable's column index on the shared lead axis.
    var_cols = [lead_hours.index(h) for h in hs] if hs else [0]
    level_values = (list(da.coord_values('level'))
                    if 'level' in da.dims else [None])
    values[variable] = {}
    for metric in [str(m) for m in da.coord_values('metric')]:
      by_level: dict = {}
      msel = da.sel(metric=metric)
      for level_value in level_values:
        level = 'all' if level_value is None else str(level_value)
        lsel = (msel.sel(level=level_value)
                if level_value is not None else msel)
        by_region: dict = {}
        var_regions = set(_regions_of(da))
        for region in regions:
          if var_regions and region not in var_regions:
            continue  # this variable lacks the region: page shows no-data
          r0 = lsel.sel(region=region) if 'region' in lsel.dims else lsel
          by_yr: dict = {}
          for year in years:
            for resolution in resolutions:
              r = r0
              if 'year' in r.dims:
                r = r.sel(year=year)
              if 'resolution' in r.dims:
                r = r.sel(resolution=resolution)
              order = ['model'] + (
                  ['lead_time'] if 'lead_time' in r.dims else [])
              r = r.transpose(*order) if r.dims != tuple(order) else r
              arr = np.asarray(r.values, dtype=np.float64)
              if arr.ndim == 1:
                arr = arr[:, None]
              key = ('all' if years == ['all'] and resolutions == ['all']
                     else f'{year}|{resolution}')
              rows = []
              for row in arr:
                full = [None] * len(lead_hours)
                for c, x in zip(var_cols, row):
                  full[c] = None if not np.isfinite(x) else float(x)
                rows.append(full)
              by_yr[key] = rows
          by_region[region] = by_yr
        by_level[level] = by_region
      values[variable][metric] = by_level

  data = {
      'variables': variables,
      'models': models,
      'metrics': metrics,
      'regions': regions,
      'years': years,
      'resolutions': resolutions,
      'lead_times': lead_labels,
      'lead_hours': lead_hours,
      'units': {v: UNITS.get(v) for v in variables},
      'values': values,
  }
  return _PAGE.format(
      data_json=json.dumps(data),
      selftest_json=json.dumps(scorecard_logic.golden_fixtures(data)),
      logic_js=scorecard_logic.LOGIC_JS,
      selftest_runner_js=scorecard_logic.SELFTEST_RUNNER_JS,
      defaults_by_cat_json=json.dumps(scorecard_logic.DEFAULTS_BY_CAT),
      default_visible=scorecard_logic.DEFAULT_VISIBLE)


def main(argv: Optional[Sequence[str]] = None) -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--scorecard', required=True,
                 help='Combined scorecard .npz (from combine_results)')
  p.add_argument('--output', required=True, help='Output .html file')
  args = p.parse_args(argv)
  page = render_scorecard_html(args.scorecard)
  with open(args.output, 'w') as f:
    f.write(page)
  print(f'Wrote {args.output} ({len(page)} bytes)')


if __name__ == '__main__':
  main()
