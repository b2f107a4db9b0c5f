"""Scorecard selection/relative math: ONE Python source, JS generated.

The interactive scorecard page (:mod:`scorecard_html`) embeds
:data:`LOGIC_JS` and routes every interaction through it. That JS is not
hand-written: it is transpiled from the Python functions below by
:mod:`pyjs` at import time, so the unit-tested Python IS the shipped
logic — mirror drift is structurally impossible: CI executes the single
source, and every rendered page additionally re-runs Python-computed
golden fixtures against the generated JS on load, surfacing a pass/fail
banner in ``#selftest``. A copy of the JAX package's
``apps/scorecard_logic.py`` over the port's ``pyjs``: ``LOGIC_JS`` is the
same string.

Semantics mirror the reference Dash app
(``public_benchmark/apps/dash_app.py:272-436``): the relative mode's
``-100*(x-b)/b`` with the ACC special case ``100*(x-b)/(1-b)`` and lead-0
drop (``:341-350``), Spread/Skill lead-0 masking (``:351-352``), the SEEPS
guards (``:314-320``), and the curated default-visible model subsets
(``apps/config.py:55-70`` applied at ``dash_app.py:361-372``).

The functions are written in the pyjs-transpilable subset: no dict/list
truthiness (compare against ``None``), ``d_get`` for null-safe lookups,
``for i in range(len(...))`` loops.
"""

from weatherbenchx_tpu_torch.apps import pyjs

SL_PROB_METRICS = ['CRPS', 'Mean RMSE', 'Spread/Skill',
                   'Unbiased Mean RMSE', 'Unbiased Spread/Skill']
PROB_METRICS = frozenset(SL_PROB_METRICS)

DEFAULTS_BY_CAT = {
    'det': ['IFS HRES vs Analysis', 'IFS ENS (mean) vs Analysis',
            'GraphCast vs ERA5', 'NeuralGCM 0.7 vs ERA5'],
    'precip': ['IFS HRES vs ERA5', 'IFS ENS (mean) vs ERA5',
               'GraphCast vs ERA5'],
    'prob': ['IFS ENS vs Analysis', 'GenCast vs ERA5',
             'NeuralGCM ENS vs ERA5'],
}
DEFAULT_VISIBLE = 8


def d_get(d, k):
  """Null-safe dict lookup; the JS twin is pyjs.D_GET_JS."""
  if d is None:
    return None
  return d.get(k)


def category_for(metric, variable):
  if metric in SL_PROB_METRICS:
    return 'prob'
  if 'precip' in variable.lower():
    return 'precip'
  return 'det'


def seeps_guard(metric, variable, rel_mode, baseline):
  if metric != 'SEEPS':
    return None
  if 'precip' not in variable.lower():
    return 'SEEPS is only defined for precipitation variables.'
  if rel_mode and 'Analysis' in baseline:
    return 'SEEPS cannot be compared against an Analysis baseline.'
  return None


def apply_relative(rows, metric, base_index, lead_hours):
  base = rows[base_index]
  out = []
  for i in range(len(rows)):
    row = rows[i]
    row_out = []
    for j in range(len(row)):
      x = row[j]
      if lead_hours[j] == 0 or x is None or base[j] is None:
        row_out.append(None)  # no relative at t=0 (dash_app.py:341-350)
      elif metric == 'ACC':
        if base[j] == 1:
          row_out.append(None)  # guard 0/0 at a perfect baseline
        else:
          row_out.append(100 * (x - base[j]) / (1 - base[j]))
      elif base[j] == 0:
        row_out.append(None)
      else:
        row_out.append(-100 * (x - base[j]) / base[j])
    out.append(row_out)
  return out


def mask_lead_zero(rows, lead_hours):
  out = []
  for i in range(len(rows)):
    row = rows[i]
    row_out = []
    for j in range(len(row)):
      if lead_hours[j] == 0:
        row_out.append(None)  # Spread/Skill drops lead 0 (dash_app.py:351-352)
      else:
        row_out.append(row[j])
    out.append(row_out)
  return out


def lookup_entry(values, variable, metric, level, region, year_res):
  by_metric = d_get(d_get(values, variable), metric)
  if by_metric is None:
    return None
  by_region = d_get(d_get(by_metric, level), region)
  if by_region is None:
    return None
  entry = d_get(by_region, year_res)
  if entry is None:
    entry = d_get(by_region, 'all')
  return entry


def default_hidden(models, category, defaults_by_cat, default_visible):
  defaults = d_get(defaults_by_cat, category)
  any_match = False
  for i in range(len(models)):
    if models[i] in defaults:
      any_match = True
  if not any_match:
    return models[default_visible:]
  out = []
  for i in range(len(models)):
    if models[i] not in defaults:
      out.append(models[i])
  return out


LOGIC_FUNCTIONS = (category_for, seeps_guard, apply_relative,
                   mask_lead_zero, lookup_entry, default_hidden)

LOGIC_JS = pyjs.transpile(LOGIC_FUNCTIONS,
                          consts={'SL_PROB_METRICS': SL_PROB_METRICS})


# Fixture-arg placeholder for the page's full DATA.values mapping; the
# self-test runner substitutes the live object at run time.
VALUES_SENTINEL = '__DATA_VALUES__'


def golden_fixtures(data: dict) -> list:
  """Interaction fixtures over real page DATA, evaluated with the Python
  source of truth. The page runs each case against the generated JS on
  load (see SELFTEST_RUNNER_JS).

  Covers: entry lookup (incl. a missing selection), relative mode for a
  plain metric and the ACC special case, lead-0 masking, both SEEPS
  guards + passing cases, category routing, and default-hidden sets.
  """
  fixtures = []

  def add(fn, args, expected, name):
    fixtures.append({'fn': fn, 'args': args, 'expected': expected,
                     'name': name})

  values = data['values']
  lead_hours = data['lead_hours']
  models = data['models']
  variables = data['variables']
  metrics = data['metrics']

  # Entry lookups: walk real selections until 8 cases, plus one miss.
  n_lookups = 0
  for variable in variables:
    for metric in metrics:
      by_metric = values.get(variable, {}).get(metric)
      if not by_metric:
        continue
      for level, by_region in by_metric.items():
        for region, by_yr in by_region.items():
          year_res = next(iter(by_yr))
          got = lookup_entry(values, variable, metric, level, region,
                             year_res)
          # Sentinel instead of inlining the full values mapping: the JS
          # runner (and the Python mirror test) resolve it to DATA.values
          # at run time — 9 inlined copies multiplied page size ~10x for
          # large scorecards (ADVICE r4).
          add('lookupEntry', [VALUES_SENTINEL, variable, metric, level,
                              region, year_res], got,
              f'lookup {variable}/{metric}/{level}/{region}/{year_res}')
          n_lookups += 1
          if n_lookups >= 8:
            break
        if n_lookups >= 8:
          break
      if n_lookups >= 8:
        break
    if n_lookups >= 8:
      break
  add('lookupEntry', [VALUES_SENTINEL, '__no_such_variable__', metrics[0],
                      'all', 'all', 'all'], None, 'lookup miss')

  # Relative mode on the first populated entry, plain + ACC path.
  def first_rows():
    for variable in variables:
      for metric in metrics:
        by_metric = values.get(variable, {}).get(metric)
        if not by_metric:
          continue
        for by_region in by_metric.values():
          for by_yr in by_region.values():
            for rows in by_yr.values():
              if rows and any(x is not None for r in rows for x in r):
                return rows
    return None

  rows = first_rows()
  if rows is not None:
    base_index = min(1, len(rows) - 1)
    for metric_name in ('RMSE', 'ACC'):
      add('applyRelative', [rows, metric_name, base_index, lead_hours],
          apply_relative(rows, metric_name, base_index, lead_hours),
          f'relative {metric_name}')
    add('maskLeadZero', [rows, lead_hours],
        mask_lead_zero(rows, lead_hours), 'mask lead zero')

  # SEEPS guards (dash_app.py:314-320) + pass-through cases.
  for args in (['SEEPS', '2m Temperature', False, models[0]],
               ['SEEPS', '24h Precipitation', True, 'IFS HRES vs Analysis'],
               ['SEEPS', '24h Precipitation', False, models[0]],
               ['RMSE', '2m Temperature', True, models[0]]):
    add('seepsGuard', args, seeps_guard(*args), f'seeps guard {args}')

  # Category routing + default-hidden sets for each category.
  for metric_name, variable_name in (('RMSE', '2m Temperature'),
                                     ('RMSE', '24h Precipitation'),
                                     ('CRPS', '2m Temperature')):
    cat = category_for(metric_name, variable_name)
    add('categoryFor', [metric_name, variable_name], cat,
        f'category {metric_name}/{variable_name}')
    add('defaultHidden', [models, cat, DEFAULTS_BY_CAT, DEFAULT_VISIBLE],
        default_hidden(models, cat, DEFAULTS_BY_CAT, DEFAULT_VISIBLE),
        f'default hidden {cat}')

  return fixtures


SELFTEST_RUNNER_JS = r"""
function sl_deepNear(a, b) {
  if (a === null || a === undefined) return b === null || b === undefined;
  if (typeof a === 'number' && typeof b === 'number') {
    if (Number.isNaN(a) && Number.isNaN(b)) return true;
    return Math.abs(a - b) <= 1e-9 * Math.max(1, Math.abs(a), Math.abs(b));
  }
  if (Array.isArray(a) && Array.isArray(b))
    return a.length === b.length && a.every((x, i) => sl_deepNear(x, b[i]));
  return a === b;
}
function sl_runSelfTests(fixtures) {
  const failures = [];
  for (const f of fixtures) {
    let got;
    const args = f.args.map(
        (a) => a === '__DATA_VALUES__' ? DATA.values : a);
    try { got = window['sl_' + f.fn](...args); }
    catch (e) { failures.push(`${f.name}: threw ${e}`); continue; }
    if (!sl_deepNear(got, f.expected))
      failures.push(`${f.name}: got ${JSON.stringify(got)} != ` +
                    `${JSON.stringify(f.expected)}`);
  }
  return failures;
}
"""
