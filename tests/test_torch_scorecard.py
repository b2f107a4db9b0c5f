"""The scorecard apps of the port against the JAX package's, on the CPU.

Per-model result files written by the JAX package's ``io`` (seeded numpy
values) are combined by both packages' ``combine_results``: the files they
write are the same bytes. Both packages' ``scorecard_html`` render the
same page, character for character, from the same scorecard; the port's
``LOGIC_JS`` is the JAX package's string and runs its page's self-test
through the port's ``jsmini``. ``scorecard_figure``'s relative values and
panels equal the JAX package's, and it draws a PNG (matplotlib, inside its
functions only). The cases are those of the JAX package's
``tests/test_apps.py`` (``TestCombineResults``, ``TestHeterogeneousCombine``,
``TestCrossComboAlignment``, ``TestCombineCrossModelAlignment``,
``TestScorecardWorkflow``, ``TestScorecardLeadAlignment``,
``TestScorecardFigure``), ``tests/test_jsmini.py``,
``tests/test_scorecard_logic.py`` and ``tests/test_observability_scorecard.py``.
"""

import json
import os
import re

import numpy as np
import pytest

from weatherbenchx_tpu import io as j_io
from weatherbenchx_tpu.apps import combine_results as j_combine
from weatherbenchx_tpu.apps import jsmini as j_jsmini
from weatherbenchx_tpu.apps import pyjs as j_pyjs
from weatherbenchx_tpu.apps import scorecard_figure as j_figure
from weatherbenchx_tpu.apps import scorecard_html as j_html
from weatherbenchx_tpu.apps import scorecard_logic as j_logic
from weatherbenchx_tpu.darray import DimArray as JDimArray
from weatherbenchx_tpu_torch import io
from weatherbenchx_tpu_torch.apps import combine_results
from weatherbenchx_tpu_torch.apps import jsmini
from weatherbenchx_tpu_torch.apps import pyjs
from weatherbenchx_tpu_torch.apps import scorecard_figure
from weatherbenchx_tpu_torch.apps import scorecard_html
from weatherbenchx_tpu_torch.apps import scorecard_logic


def _leads(hours):
  return np.array(hours, 'timedelta64[h]').astype('timedelta64[ns]')


def _read(path):
  with open(path, 'rb') as f:
    return f.read()


# -- result files (written by the JAX package's io) ------------------------------


def _basic(d):
  regions = np.array(['global', 'tropics'])
  for model, val in [('hres', 1.0), ('graphcast', 2.0)]:
    j_io.save_dataset(os.path.join(d, f'{model}_vs_era5_64x32.npz'), {
        'rmse.2m_temperature': JDimArray(np.full(2, val), ('region',),
                                         {'region': regions}),
        'bias.2m_temperature': JDimArray(np.full(2, val / 10), ('region',),
                                         {'region': regions})})


def _workflow(d):
  regions = np.array(['global', 'tropics', 'tropics_land'])
  leads = (np.arange(0, 73, 24) * np.timedelta64(1, 'h')).astype(
      'timedelta64[ns]')
  rng = np.random.default_rng(0)
  for model in ['hres_vs_era5', 'pangu_vs_era5']:
    for year in [2018, 2020]:
      j_io.save_dataset(os.path.join(d, f'{model}_64x32_{year}-init12h.npz'), {
          'rmse.geopotential': JDimArray(
              rng.random((len(leads), len(regions))).astype(np.float32),
              ('lead_time', 'region'), {'lead_time': leads, 'region': regions}),
          'vector_rmse.wind': JDimArray(
              rng.random((len(leads), len(regions))).astype(np.float32),
              ('lead_time', 'region'),
              {'lead_time': leads, 'region': regions})})


def _cross_combo(d):
  for fn, hours, levels, val in (
      ('hres_vs_era5_64x32_2020.npz', [0, 6, 12], [500, 850], 1.0),
      ('hres_vs_era5_64x32_2022.npz', [0, 6], [500, 700], 2.0)):
    leads = _leads(hours)
    j_io.save_dataset(os.path.join(d, fn), {'rmse.z': JDimArray(
        np.full((len(leads), len(levels)), val), ('lead_time', 'level'),
        {'lead_time': leads, 'level': np.array(levels)})})


def _figure_results(d):
  lead = np.array([1, 3, 5, 7, 10], dtype='timedelta64[D]').astype(
      'timedelta64[ns]')
  levels, regions = np.array([500, 850]), np.array(['global'])
  rng = np.random.default_rng(0)
  base = 100 + 50 * rng.random((5, 2, 1))
  for model, scale in [('hres_vs_hres_t0', 1.0), ('pangu_vs_era5', 1.2),
                       ('pangu_hres_init_vs_hres_t0', 0.9)]:
    j_io.save_dataset(os.path.join(d, f'{model}_64x32_2020.npz'), {
        'rmse.geopotential': JDimArray(
            scale * base, ('lead_time', 'level', 'region'),
            {'lead_time': lead, 'level': levels, 'region': regions}),
        'rmse.total_precipitation_24hr': JDimArray(
            np.full((5, 1), np.nan) if model.endswith('hres_t0')
            else scale * rng.random((5, 1)), ('lead_time', 'region'),
            {'lead_time': lead, 'region': regions})})


RESULTS = {'basic': _basic, 'workflow': _workflow, 'cross_combo': _cross_combo,
           'figure': _figure_results}


def _combine_both(tmp_path, case, display_names):
  src = tmp_path / 'results'
  src.mkdir()
  RESULTS[case](str(src))
  flags = ['--display_names'] if display_names else []
  want, got = str(tmp_path / 'jax.npz'), str(tmp_path / 'port.npz')
  j_combine.main(['--results_dir', str(src), '--output_path', want] + flags)
  combine_results.main(['--results_dir', str(src), '--output_path', got]
                       + flags)
  return got, want


@pytest.mark.parametrize('display_names', [False, True])
@pytest.mark.parametrize('case', list(RESULTS))
def test_combine_results_writes_the_jax_packages_bytes(tmp_path, case,
                                                       display_names):
  got, want = _combine_both(tmp_path, case, display_names)
  assert _read(got) == _read(want)


def test_combine_basic_values(tmp_path):
  """TestCombineResults: two models, two metrics, one variable."""
  got, _ = _combine_both(tmp_path, 'basic', False)
  da = io.load_dataset(got)['2m_temperature']
  assert set(da.dims) == {'model', 'metric', 'region'}
  np.testing.assert_array_equal(da.coord_values('model'),
                                ['graphcast', 'hres'])
  np.testing.assert_array_equal(sorted(da.coord_values('metric')),
                                ['Bias', 'RMSE'])
  np.testing.assert_allclose(da.sel(model='hres', metric='RMSE').values,
                             [1.0, 1.0])


def test_multi_year_stacking_and_display_names(tmp_path):
  """TestScorecardWorkflow: years and resolutions stack, names display."""
  got, _ = _combine_both(tmp_path, 'workflow', True)
  sc = io.load_dataset(got)
  assert 'Wind Vector' in sc and 'Geopotential' in sc
  da = sc['Geopotential']
  assert set(da.dims) == {'model', 'metric', 'year', 'resolution',
                          'lead_time', 'region'}
  np.testing.assert_array_equal(da.coord_values('year'), ['2018', '2020'])
  np.testing.assert_array_equal(da.coord_values('model'),
                                ['IFS HRES vs ERA5', 'Pangu-Weather vs ERA5'])
  np.testing.assert_array_equal(da.coord_values('region'),
                                ['Global', 'Tropics', 'Tropics (Land)'])
  src = io.load_dataset(
      str(tmp_path / 'results' / 'hres_vs_era5_64x32_2018-init12h.npz'))
  sel = da.sel(model='IFS HRES vs ERA5', metric='RMSE', year='2018',
               resolution='64x32')
  np.testing.assert_allclose(
      sel.transpose('lead_time', 'region').values.astype(np.float64),
      src['rmse.geopotential'].values.astype(np.float64), atol=1e-7)


def test_heterogeneous_metric_sets_and_ranks(tmp_path):
  """TestHeterogeneousCombine: NaN holes, the same bytes as the JAX
  package's once written."""
  leads, regions = _leads([0, 6]), np.array(['global'])
  det = {'rmse.z': JDimArray(np.ones((2, 3, 1)),
                             ('lead_time', 'level', 'region'),
                             {'lead_time': leads,
                              'level': np.array([500, 700, 850]),
                              'region': regions}),
         'rmse.t2m': JDimArray(np.ones((2, 1)), ('lead_time', 'region'),
                               {'lead_time': leads, 'region': regions})}
  prob = {'crps.t2m': JDimArray(np.full((2, 1), 0.5), ('lead_time', 'region'),
                                {'lead_time': leads, 'region': regions})}
  files = {'hres': str(tmp_path / 'hres_vs_x.npz'),
           'ens': str(tmp_path / 'ens_vs_x.npz')}
  j_io.save_dataset(files['hres'], det)
  j_io.save_dataset(files['ens'], prob)
  out = combine_results.combine_model_results(files)
  z = out['z']
  assert z.dims == ('model', 'metric', 'lead_time', 'level', 'region')
  assert np.isnan(z.sel(model='ens').values).all()
  t2m = out['t2m']
  np.testing.assert_allclose(t2m.sel(model='ens', metric='CRPS').values, 0.5)
  assert np.isnan(t2m.sel(model='hres', metric='CRPS').values).all()
  np.testing.assert_allclose(t2m.sel(model='hres', metric='RMSE').values, 1.0)
  io.save_dataset(str(tmp_path / 'port.npz'), out)
  j_io.save_dataset(str(tmp_path / 'jax.npz'),
                    j_combine.combine_model_results(files))
  assert _read(tmp_path / 'port.npz') == _read(tmp_path / 'jax.npz')


def test_year_stack_outer_joins_labeled_dims(tmp_path):
  """TestCrossComboAlignment: lead and level label unions with NaN holes."""
  src = tmp_path / 'results'
  src.mkdir()
  _cross_combo(str(src))
  files = {fn: str(src / fn) for fn in os.listdir(src)}
  z = combine_results.combine_result_files(files)['z']
  assert z.sizes['year'] == 2 and z.sizes['lead_time'] == 3
  np.testing.assert_array_equal(z.coord_values('level'), [500, 700, 850])
  v2020 = z.sel(year='2020', model='hres', metric='RMSE')
  v2022 = z.sel(year='2022', model='hres', metric='RMSE')
  assert np.isnan(v2020.sel(level=700).values).all()
  assert np.isnan(v2022.sel(level=850).values).all()
  assert np.isnan(v2022.sel(lead_time=_leads(12)).values).all()
  np.testing.assert_allclose(v2020.sel(level=500).values.ravel(), [1.0] * 3)
  np.testing.assert_allclose(v2022.sel(level=700).values.ravel()[:2],
                             [2.0, 2.0])


def test_duplicate_result_files_warn(tmp_path, capsys):
  for fn, val in (('hres_vs_era5_64x32_2020.npz', 1.0),
                  ('hres_vs_era5_64x32_2020-temporal.npz', 9.0)):
    j_io.save_dataset(str(tmp_path / fn), {'rmse.z': JDimArray(
        np.full((1, 1), val), ('lead_time', 'level'),
        {'lead_time': _leads([0]), 'level': np.array([500])})})
  files = {fn: str(tmp_path / fn) for fn in sorted(os.listdir(tmp_path))}
  combine_results.combine_result_files(files)
  out = capsys.readouterr().out
  j_combine.combine_result_files(files)
  assert capsys.readouterr().out == out
  assert 'WARNING: multiple result files' in out
  assert 'hres_vs_era5_64x32_2020-temporal.npz' in out


def test_models_with_different_lead_extents_outer_join(tmp_path):
  """TestCombineCrossModelAlignment."""
  def result(hours, value):
    leads = _leads(hours)
    return {'rmse.2m_temperature': JDimArray(
        np.full(len(leads), value, np.float32), ('lead_time',),
        {'lead_time': leads})}
  files = {'hres': str(tmp_path / 'a.npz'), 'fuxi': str(tmp_path / 'b.npz')}
  j_io.save_dataset(files['hres'], result([0, 12, 24], 1.0))
  j_io.save_dataset(files['fuxi'], result([0, 12, 24, 36, 48], 2.0))
  out = combine_results.combine_model_results(files)
  da = out['2m_temperature']
  assert da.sizes['lead_time'] == 5
  hres = da.sel(model='hres', metric='RMSE').values
  np.testing.assert_array_equal(hres[:3], [1.0, 1.0, 1.0])
  assert np.isnan(hres[3:]).all()
  np.testing.assert_array_equal(da.sel(model='fuxi', metric='RMSE').values,
                                [2.0] * 5)
  io.save_dataset(str(tmp_path / 'port.npz'), out)
  j_io.save_dataset(str(tmp_path / 'jax.npz'),
                    j_combine.combine_model_results(files))
  assert _read(tmp_path / 'port.npz') == _read(tmp_path / 'jax.npz')


# -- scorecard_html ----------------------------------------------------------------


def _sc(path, ds):
  j_io.save_dataset(path, ds)
  return path


def _rich(d):
  leads = _leads([0, 6, 24])
  regions = np.array(['global', 'tropics'])
  models = np.array(['IFS HRES vs Analysis', 'GraphCast vs ERA5', 'c'])
  rng = np.random.default_rng(0)

  def da(names):
    m = np.array(names)
    return JDimArray(
        rng.random((len(models), len(m), len(leads), len(regions))) + 0.5,
        ('model', 'metric', 'lead_time', 'region'),
        {'model': models, 'metric': m, 'lead_time': leads, 'region': regions})
  return _sc(os.path.join(d, 'sc.npz'), {
      '2m Temperature': da(['RMSE', 'ACC', 'CRPS']),
      '24h Precipitation': da(['RMSE', 'SEEPS'])})


def _render(d):
  return _sc(os.path.join(d, 'sc.npz'), {'t2m': JDimArray(
      np.arange(8.0).reshape(2, 1, 2, 2),
      ('model', 'metric', 'lead_time', 'region'),
      {'model': np.array(['a', 'b']), 'metric': np.array(['RMSE']),
       'lead_time': _leads([0, 6]), 'region': np.array(['global', 'tropics'])})})


def _nan(d):
  return _sc(os.path.join(d, 'sc.npz'), {'v': JDimArray(
      np.array([[np.nan]]), ('model', 'metric'),
      {'model': np.array(['a']), 'metric': np.array(['RMSE'])})})


def _levels(d):
  return _sc(os.path.join(d, 'sc.npz'), {'z': JDimArray(
      np.arange(12.0).reshape(1, 1, 3, 2, 2),
      ('model', 'metric', 'level', 'lead_time', 'region'),
      {'model': np.array(['a']), 'metric': np.array(['RMSE']),
       'level': np.array([500, 700, 850]), 'lead_time': _leads([0, 6]),
       'region': np.array(['global', 'tropics'])})})


def _mixed_regions(d):
  def mk(regions, vals):
    return JDimArray(
        np.asarray(vals, np.float64).reshape(1, 1, 1, len(regions)),
        ('model', 'metric', 'lead_time', 'region'),
        {'model': np.array(['a']), 'metric': np.array(['RMSE']),
         'lead_time': _leads([6]), 'region': np.array(regions)})
  return _sc(os.path.join(d, 'sc.npz'), {
      't2m': mk(['global', 'tropics'], [1.0, 2.0]),
      'precip': mk(['global', 'tropics_land'], [3.0, 4.0])})


def _lead_union(d):
  def var(hours, value):
    return JDimArray(np.full((1, 1, len(hours)), value, np.float32),
                     ('model', 'metric', 'lead_time'),
                     {'model': np.array(['hres']), 'metric': np.array(['RMSE']),
                      'lead_time': _leads(hours)})
  return _sc(os.path.join(d, 'sc.npz'), {
      '2m_temperature': var([0, 12, 24], 1.0),
      'total_precipitation_24hr': var([24], 3.0)})


def _combined_workflow(d):
  src = os.path.join(d, 'results')
  os.makedirs(src)
  _workflow(src)
  out = os.path.join(d, 'sc.npz')
  j_combine.main(['--results_dir', src, '--output_path', out,
                  '--display_names'])
  return out


SCORECARDS = {'rich': _rich, 'render': _render, 'nan': _nan,
              'levels': _levels, 'mixed_regions': _mixed_regions,
              'lead_union': _lead_union, 'workflow': _combined_workflow}


def _data(page):
  return json.loads(re.search(r'const DATA = (\{.*?\});\n', page,
                              re.S).group(1))


@pytest.mark.parametrize('case', list(SCORECARDS))
def test_scorecard_html_renders_the_jax_packages_page(tmp_path, case):
  path = SCORECARDS[case](str(tmp_path))
  page = scorecard_html.render_scorecard_html(path)
  assert page == j_html.render_scorecard_html(path)
  out = str(tmp_path / 'page.html')
  scorecard_html.main(['--scorecard', path, '--output', out])
  with open(out) as f:
    assert f.read() == page


def test_scorecard_html_payloads(tmp_path):
  """The JAX package's page assertions, on the port's pages."""
  page = scorecard_html.render_scorecard_html(_render(str(tmp_path)))
  data = _data(page)
  assert data['models'] == ['a', 'b']
  assert data['values']['t2m']['RMSE']['all']['tropics']['all'] == [
      [1.0, 3.0], [5.0, 7.0]]
  for sub, fn, check in (
      ('nan', _nan, lambda d: d['values']['v']['RMSE']['all']['all']['all']
       == [[None]]),
      ('levels', _levels, lambda d: list(d['values']['z']['RMSE']) == [
          '500', '700', '850'] and d['values']['z']['RMSE']['700'][
              'tropics']['all'] == [[5.0, 7.0]]),
      ('mixed', _mixed_regions, lambda d: d['regions'] == [
          'global', 'tropics_land', 'tropics'] and d['values']['precip'][
              'RMSE']['all']['tropics_land']['all'] == [[4.0]]),
      ('leads', _lead_union, lambda d: d['lead_hours'] == [0, 12, 24]
       and d['values']['total_precipitation_24hr']['RMSE']['all']['all'][
           'all'][0] == [None, None, 3.0])):
    os.makedirs(tmp_path / sub)
    assert check(_data(scorecard_html.render_scorecard_html(
        fn(str(tmp_path / sub))))), sub
  page = scorecard_html.render_scorecard_html(
      _combined_workflow(str(tmp_path / 'wf')))
  data = _data(page)
  assert data['years'] == ['2018', '2020'] and data['resolutions'] == ['64x32']
  rows = data['values']['Geopotential']['RMSE']['all']['Global']['2018|64x32']
  assert len(rows) == 2 and len(rows[0]) == 4
  for needle in ('applyRelative', 'maskLeadZero', 'seepsGuard',
                 'id="markers"', 'id="year"', 'id="resolution"', 'units',
                 'sl_runSelfTests(SELFTEST)', 'id="selftest"',
                 "dataset.status = 'pass'", 'const DEFAULTS_BY_CAT = '):
    assert needle in page, needle


# -- scorecard_logic, pyjs, jsmini ---------------------------------------------------


def test_logic_js_is_the_jax_packages_string():
  assert scorecard_logic.LOGIC_JS == j_logic.LOGIC_JS
  assert scorecard_logic.SELFTEST_RUNNER_JS == j_logic.SELFTEST_RUNNER_JS
  assert scorecard_logic.DEFAULTS_BY_CAT == j_logic.DEFAULTS_BY_CAT
  assert pyjs.transpile(
      scorecard_logic.LOGIC_FUNCTIONS,
      consts={'SL_PROB_METRICS': scorecard_logic.SL_PROB_METRICS}
  ) == scorecard_logic.LOGIC_JS
  js = scorecard_logic.LOGIC_JS
  assert 'variable.toLowerCase().includes("precip")' in js
  assert '(100 * (x - base[j])) / (1 - base[j])' in js
  assert '((-100) * (x - base[j])) / base[j]' in js


def test_golden_fixtures_equal_the_jax_packages(tmp_path):
  data = _data(scorecard_html.render_scorecard_html(_rich(str(tmp_path))))
  fixtures = scorecard_logic.golden_fixtures(data)
  assert fixtures == j_logic.golden_fixtures(data)
  assert len(fixtures) >= 15


def test_logic_functions_equal_the_jax_packages():
  """The Python mirrors on a sweep and a seeded fuzz of inputs."""
  rng = np.random.default_rng(7)
  for m in ['RMSE', 'ACC', 'SEEPS', 'CRPS', 'Spread/Skill', 'Bias']:
    for v in ['2m Temperature', '24h Precipitation', 'Geopotential']:
      assert scorecard_logic.category_for(m, v) == j_logic.category_for(m, v)
      for rel in (False, True):
        for b in ['IFS HRES vs Analysis', 'IFS HRES vs ERA5']:
          assert (scorecard_logic.seeps_guard(m, v, rel, b)
                  == j_logic.seeps_guard(m, v, rel, b))
  for _ in range(25):
    n_model, n_lead = int(rng.integers(1, 5)), int(rng.integers(2, 6))
    lead_hours = [0] + sorted(rng.choice(120, n_lead - 1,
                                         replace=False).tolist())
    rows = [[None if rng.random() < 0.2 else
             float(np.round(rng.uniform(-2, 2), 3)) for _ in lead_hours]
            for _ in range(n_model)]
    base = int(rng.integers(0, n_model))
    for metric in ('RMSE', 'ACC'):
      assert (scorecard_logic.apply_relative(rows, metric, base, lead_hours)
              == j_logic.apply_relative(rows, metric, base, lead_hours))
    assert (scorecard_logic.mask_lead_zero(rows, lead_hours)
            == j_logic.mask_lead_zero(rows, lead_hours))
  pool = [f'model{i}' for i in range(12)] + list(
      scorecard_logic.DEFAULTS_BY_CAT['det'])
  for _ in range(10):
    models = [str(m) for m in rng.choice(pool, int(rng.integers(1, 10)),
                                         replace=False)]
    for cat in ('det', 'precip', 'prob'):
      assert scorecard_logic.default_hidden(
          models, cat, scorecard_logic.DEFAULTS_BY_CAT,
          scorecard_logic.DEFAULT_VISIBLE) == j_logic.default_hidden(
              models, cat, j_logic.DEFAULTS_BY_CAT, j_logic.DEFAULT_VISIBLE)


def test_transpiler_refuses_what_the_jax_packages_refuses():
  def bad(rows):
    new = []
    new.append(rows)
    return new

  def uses_while(x):
    while x > 0:
      x = x - 1
    return x

  def uses_comprehension(xs):
    return [x + 1 for x in xs]

  def uses_kwargs(a, b=2):
    return a + b

  for fn in (bad, uses_while, uses_comprehension, uses_kwargs):
    with pytest.raises(pyjs.TranspileError):
      pyjs.transpile([fn])
    with pytest.raises(j_pyjs.TranspileError):
      j_pyjs.transpile([fn])


JS_EXPRESSIONS = [
    ('1 / 0', {}), ('-1 / 0', {}), ('7 / 2', {}), ('-7 % 3', {}),
    ('7 % -3', {}), ('"a" + 1', {}), ('"a" + 1.5', {}), ('`x${1.0}y`', {}),
    ('1 === 1.0', {}), ('"1" === 1', {}), ('null === null', {}),
    ('!0', {}), ('!""', {}), ('!"0"', {}), ('0 || "b"', {}),
    ('xs.slice(1)', {'xs': [1, 2, 3]}), ('xs.slice(-5, 2)', {'xs': [1, 2, 3]}),
    ('xs.includes(2)', {'xs': [1, 2, 3]}), ('xs[7]', {'xs': [1]}),
    ('d["k"]', {'d': {}}), ('"AbC".toLowerCase()', {}),
]


@pytest.mark.parametrize('expr,consts', JS_EXPRESSIONS)
def test_jsmini_takes_the_jax_packages_js_semantics(expr, consts):
  """The interpreter's JS semantics (division, %, ToString, strict
  equality, truthiness, slicing, undefined) against the JAX package's."""
  def ev(mod):
    decls = '\n'.join(f'const {k} = {json.dumps(v)};'
                      for k, v in consts.items())
    return mod.Interpreter().run(
        f'{decls}\nfunction t() {{ return {expr}; }}').call('t')
  got, want = ev(jsmini), ev(j_jsmini)
  assert jsmini.to_string(got) == j_jsmini.to_string(want)
  assert type(got).__name__ == type(want).__name__


def _page_parts(page):
  ms = re.search(r'const SELFTEST = (\[.*?\]);\n', page, re.S)
  return (_data(page), json.loads(ms.group(1)),
          page[ms.end():page.index('function sl_deepNear')])


def test_run_selftests_passes_on_the_generated_page(tmp_path):
  page = scorecard_html.render_scorecard_html(_rich(str(tmp_path)))
  data, fixtures, logic_js = _page_parts(page)
  assert logic_js.strip().startswith(scorecard_logic.LOGIC_JS.strip()[:40])
  assert jsmini.run_selftests(logic_js, fixtures, data['values']) == []
  broken = logic_js.replace('((-100) * (x - base[j]))', '(100 * (x - base[j]))')
  assert broken != logic_js
  failures = jsmini.run_selftests(broken, fixtures, data['values'])
  assert any('relative RMSE' in f for f in failures)
  interp = jsmini.Interpreter().run(logic_js)
  for fn in ('d_get', 'sl_categoryFor', 'sl_seepsGuard', 'sl_applyRelative',
             'sl_maskLeadZero', 'sl_lookupEntry', 'sl_defaultHidden'):
    assert callable(interp.globals.get(fn)), fn


def test_generated_js_executes_as_its_python_source():
  """The codegen differential of the JAX package's tests: random inputs
  through the port's Python source and its generated JS text."""
  interp = jsmini.Interpreter().run(scorecard_logic.LOGIC_JS)
  rng = np.random.default_rng(11)

  def both(fn, js_name, *args):
    got = interp.call(js_name, *args)
    assert jsmini.deep_near(got, jsmini._from_python(fn(*args))), js_name

  for m in ['RMSE', 'ACC', 'SEEPS', 'CRPS']:
    for v in ['2m Temperature', '24h Precipitation']:
      both(scorecard_logic.category_for, 'sl_categoryFor', m, v)
      both(scorecard_logic.seeps_guard, 'sl_seepsGuard', m, v, True,
           'IFS HRES vs Analysis')
  for _ in range(10):
    lead_hours = [0, 6, 24, 48]
    rows = [[None if rng.random() < 0.2 else float(rng.uniform(-2, 2))
             for _ in lead_hours] for _ in range(3)]
    both(scorecard_logic.apply_relative, 'sl_applyRelative', rows, 'ACC', 1,
         lead_hours)
    both(scorecard_logic.mask_lead_zero, 'sl_maskLeadZero', rows, lead_hours)
  values = {'T': {'RMSE': {'all': {'global': {'all': [[2.0]]}}}}}
  both(scorecard_logic.lookup_entry, 'sl_lookupEntry', values, 'T', 'RMSE',
       'all', 'global', '2021|64x32')


# -- scorecard_figure ----------------------------------------------------------------


def _figure_store(tmp_path):
  got, want = _combine_both(tmp_path, 'figure', True)
  return got, io.load_dataset(got), j_io.load_dataset(want)


def test_figure_relative_and_panels_equal_the_jax_packages(tmp_path):
  _, store, j_store = _figure_store(tmp_path)
  rel = scorecard_figure.compute_relative(store, 'IFS HRES vs Analysis')
  j_rel = j_figure.compute_relative(j_store, 'IFS HRES vs Analysis')
  assert sorted(rel) == sorted(j_rel)
  for var in rel:
    np.testing.assert_array_equal(rel[var].values,
                                  np.asarray(j_rel[var].values))
  np.testing.assert_allclose(
      rel['Geopotential'].sel(model='IFS HRES vs Analysis').values, 0.0,
      atol=1e-9)
  np.testing.assert_allclose(
      rel['Geopotential'].sel(model='Pangu-Weather vs ERA5',
                              metric='RMSE').values, 20.0, atol=1e-6)
  days = np.array([1.0, 3.0, 5.0, 7.0, 10.0])
  for model in ('IFS HRES vs Analysis', 'Pangu-Weather vs ERA5'):
    for level in (500, 850):
      np.testing.assert_array_equal(
          scorecard_figure._panel_values(rel['Geopotential'], model, 'RMSE',
                                         level, days),
          j_figure._panel_values(j_rel['Geopotential'], model, 'RMSE',
                                 level, days))
  subst = scorecard_figure.replace_analysis_precip_with_era(store)
  j_subst = j_figure.replace_analysis_precip_with_era(j_store)
  np.testing.assert_array_equal(subst['24h Precipitation'].values,
                                np.asarray(j_subst['24h Precipitation'].values))
  assert np.isnan(subst['24h Precipitation'].sel(
      model='IFS HRES vs Analysis').values).all()


def test_figure_writes_a_png(tmp_path):
  import matplotlib
  matplotlib.use('Agg')
  path, _, _ = _figure_store(tmp_path)
  out = str(tmp_path / 'scorecard.png')
  scorecard_figure.main([
      '--scorecard', path, '--output', out,
      '--reference_model', 'IFS HRES vs Analysis',
      '--panels', 'Geopotential:500:RMSE,Geopotential:850:RMSE'])
  assert _read(out)[:8] == b'\x89PNG\r\n\x1a\n'
  assert os.path.getsize(out) > 20_000
