"""The parity fuzz's layer families against the JAX package, on the CPU.

The layers that the four metric families never draw: the host binnings
(``time_bins``: every time unit of both packages, sets, int seconds, edge
bins and string and integer sets, stacked with regions), the station path
(``sparse``: interpolation to 0-40 stations through the loaders, NaN
masks, padding, networks), batched dispatch over chunks whose signatures
change mid-stream (``dispatch``: the port at 1-8 chunks a dispatch against
the JAX package's pipeline one chunk at a time), the inference methods on
AR(1) states (``inference``: the port on the JAX package's own state,
carried across by ``convert.state_from_reference``, at rtol 1e-9) and the
ensemble statistics past 64 members (``large_members``: the port against
the JAX package and against a float64 reference of the same draw). Each
seed is
drawn once (``parity_fuzz.draw``) and built in both packages from the
same plain-data spec.
"""

import dataclasses
import datetime
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import weatherbenchx_tpu
import weatherbenchx_tpu_torch
from weatherbenchx_tpu import darray as j_darray
from weatherbenchx_tpu_torch import convert
from weatherbenchx_tpu_torch import darray as t_darray
from weatherbenchx_tpu_torch import parity_fuzz

torch.set_num_threads(1)

SEEDS = {'time_bins': 24, 'sparse': 16, 'dispatch': 8, 'inference': 8,
         'large_members': 12}


def jax_array(f: parity_fuzz.Field):
  return j_darray.DimArray(f.values, f.dims, dict(f.coords))


def run_jax(spec, states=None) -> dict:
  return parity_fuzz.run_in(spec, weatherbenchx_tpu, jax_array,
                            states=states)


# The binnings whose masks lie over both latitude and longitude.
AREA_MASKS = ('binning.ByCoordBins', 'binning.Regions')


def nan_spreads_through_a_mask_stack(spec) -> bool:
  """A NaN statistic, skipna off, every dim reduced and two masks over
  latitude and longitude (elevation bins and regions): the port's einsum,
  as numpy's (and so upstream's xr.dot), makes every bin NaN that sums
  over the NaN point, as one mask does in both packages; the JAX package's
  XLA einsum over such a stack leaves the bins without the point finite."""
  (case,) = spec.cases
  if not isinstance(case, parity_fuzz.Case):
    return False
  kw = case.aggregator.kwargs
  fields = [f for side in (case.predictions, case.targets)
            for f in side.values()]
  nan = any(np.isnan(f.values).any() for f in fields)
  reduced = all(set(f.dims) <= set(kw['reduce_dims']) for f in fields)
  masks = sum(c.path in AREA_MASKS for c in kw.get('bin_by', []))
  return nan and not kw.get('skipna') and reduced and masks > 1


real_dot = t_darray.dot


def numpy_dot(*arrays, dim):
  """``darray.dot`` by numpy's einsum in float64: the same dims, coords
  and dtype."""
  out = real_dot(*arrays, dim=dim)
  letters = {}
  for a in arrays:
    for d in a.dims:
      letters.setdefault(d, chr(ord('a') + len(letters)))
  spec = ','.join(''.join(letters[d] for d in a.dims) for a in arrays)
  spec += '->' + ''.join(letters[d] for d in out.dims)
  data = np.einsum(spec, *[np.asarray(a.values, np.float64)
                           for a in arrays])
  return out.copy(data=torch.as_tensor(data).to(out.data.dtype))


def assert_contraction_matches_numpy(spec, got: dict) -> None:
  """``got`` equal to the port's values with its aggregation contraction
  done by numpy's einsum of the same operands, NaN where NaN."""
  with mock.patch.object(t_darray, 'dot', numpy_dot):
    want = parity_fuzz.run(spec, 'cpu')
  parity_fuzz.compare_results(want, got)


def assert_nan_spread(want: dict, got: dict) -> None:
  """``got`` NaN wherever ``want`` is, and equal to it where both are
  finite; keys, dims and coords as ``compare_results`` holds them."""
  finite = {}
  for k, w in want.items():
    wv = np.asarray(parity_fuzz._host(w.data), np.float64)
    gv = np.asarray(parity_fuzz._host(got[k].transpose(*w.dims).data),
                    np.float64)
    assert np.isnan(gv[np.isnan(wv)]).all(), k
    keep = np.isfinite(gv)
    finite[k] = (w.copy(data=np.where(keep, wv, np.nan)),
                 got[k].transpose(*w.dims).copy(data=np.where(keep, gv,
                                                              np.nan)))
  parity_fuzz.compare_results({k: w for k, (w, _) in finite.items()},
                              {k: g for k, (_, g) in finite.items()})


def tolerance_share(want: dict, got: dict) -> float:
  """The largest |got - want| / (atol + rtol |want|) where both are
  finite: above 1 outside the tolerance."""
  share = 0.0
  for k, w in want.items():
    wv = np.asarray(parity_fuzz._host(w.data), np.float64)
    gv = np.asarray(parity_fuzz._host(got[k].transpose(*w.dims).data),
                    np.float64)
    both = np.isfinite(wv) & np.isfinite(gv)
    limit = parity_fuzz.ATOL + parity_fuzz.RTOL * np.abs(wv[both])
    share = max(share, float(np.max(np.abs(gv[both] - wv[both]) / limit,
                                    initial=0.0)))
  return share


def check_family(family: str, seed: int) -> dict:
  """Holds the seed's draw in the port to the JAX package; for
  ``large_members`` returns the tolerance shares (``tolerance_share``) of
  the port and the JAX package against float64 and of each other."""
  spec = parity_fuzz.draw(family, seed)
  if family == 'inference':
    (case,) = spec.cases
    j_states = parity_fuzz.inference_states(case, weatherbenchx_tpu,
                                            jax_array)
    want = run_jax(spec, j_states)
    carried = tuple(None if s is None else convert.state_from_reference(s)
                    for s in j_states)
    got = parity_fuzz.run_in(spec, weatherbenchx_tpu_torch,
                             parity_fuzz.on_device('cpu'), states=carried)
    tol = (parity_fuzz.INFERENCE_ATOL, parity_fuzz.INFERENCE_RTOL)
    parity_fuzz.compare_results(want, got, *tol)
    # The port's own states (its statistics and aggregation in float64),
    # which ``run`` and the card's sweep evaluate.
    own = parity_fuzz.inference_states(case, weatherbenchx_tpu_torch,
                                       parity_fuzz.on_device('cpu'))
    for mine, theirs in zip(own, carried):
      if theirs is not None:
        parity_fuzz.compare_results(theirs.to_dataset(), mine.to_dataset(),
                                    *tol)
    return {}
  got = parity_fuzz.run(spec, 'cpu')
  # The JAX package's pipeline one chunk a dispatch.
  want = run_jax(parity_fuzz.per_chunk(spec))
  if nan_spreads_through_a_mask_stack(spec):
    assert_contraction_matches_numpy(spec, got)
    assert_nan_spread(want, got)
    return {}
  if family != 'large_members':
    parity_fuzz.compare_results(want, got)
    return {}
  # The float64 run of the same draw is a second witness. The JAX
  # package's own share of the tolerance from it, where above 1, is the
  # "Precision" difference of ROADMAP.md §C, not a port fault.
  reference = parity_fuzz.float64_reference(spec)
  shares = {'port_float64': tolerance_share(reference, got),
            'jax_float64': tolerance_share(reference, want),
            'port_jax': tolerance_share(want, got)}
  parity_fuzz.compare_results(reference, got)
  try:
    parity_fuzz.compare_results(want, got)
  except AssertionError as e:
    raise AssertionError(
        f'{e}; the JAX package against float64: '
        f'{shares["jax_float64"]:.3g} of the tolerance') from e
  return shares


@pytest.mark.parametrize('family,seed', [
    (family, seed) for family, n in SEEDS.items() for seed in range(n)])
def test_layer_family_matches_jax(family, seed):
  check_family(family, seed)


def test_an_empty_station_block_is_refused_by_both_packages():
  """The layout the sparse family draws no empty station block for: a
  reference of (init, lead, station) with no stations, interpolated over
  latitude and longitude. The JAX package expands it by the dims it
  already has and fails in the statistics; the port refuses it at the
  interpolation, with the same error type."""
  spec = parity_fuzz.draw('sparse', 0)
  (case,) = spec.cases
  assert spec.kind.startswith('block/')
  empty = {v: parity_fuzz.Field(
      f.values[..., :0], f.dims,
      {k: ((c[0], c[1][:0]) if isinstance(c, tuple) else
           c[:0] if k == 'index' else c) for k, c in f.coords.items()})
           for v, f in case.targets.items()}
  plain = dict(add_nan_mask=False, pad_index_multiple=None)
  spec = dataclasses.replace(spec, cases=(dataclasses.replace(
      case, targets=empty, targets_loader_kwargs=plain,
      predictions_loader=dataclasses.replace(
          case.predictions_loader,
          kwargs={**case.predictions_loader.kwargs, **plain}),
      aggregator=parity_fuzz.Call(
          'aggregation.Aggregator', dict(reduce_dims=['index']))),))
  with pytest.raises(ValueError, match='Failed to compute statistic'):
    run_jax(spec)
  with pytest.raises(ValueError, match='empty reference chunk'):
    parity_fuzz.run(spec, 'cpu')


# The 14 units the port's _extract_time_unit once refused with a
# ValueError, where the JAX package bins them; these CPU seeds bin by them.
REFUSED_UNITS = {'microsecond', 'nanosecond', 'days_in_month', 'daysinmonth',
            'is_leap_year', 'is_month_start', 'is_month_end',
            'is_quarter_start', 'is_quarter_end', 'is_year_start',
            'is_year_end', 'date', 'time', 'timetz'}
REFUSED_UNIT_SEEDS = (5, 11, 16, 23)


@pytest.mark.parametrize('seed', REFUSED_UNIT_SEEDS)
def test_time_bins_seeds_bin_by_the_units_the_port_refused(seed):
  (case,) = parity_fuzz.draw('time_bins', seed).cases
  units = {c.kwargs['unit'] for c in case.aggregator.kwargs['bin_by']
           if c.path in ('binning.ByTimeUnit', 'binning.ByTimeUnitSets')}
  assert units & REFUSED_UNITS
  assert set(parity_fuzz.DATETIME_UNITS) >= REFUSED_UNITS


@pytest.mark.parametrize('family', parity_fuzz.LAYER_FAMILIES)
def test_layer_draw_is_deterministic_and_plain_data(family):
  """The same seed draws the same spec; a spec holds numpy arrays, plain
  Python and dates and times only, so it pickles, and its copy runs to
  the same values."""
  spec = parity_fuzz.draw(family, 3)
  assert pickle.dumps(spec) == pickle.dumps(parity_fuzz.draw(family, 3))
  assert pickle.dumps(spec) != pickle.dumps(parity_fuzz.draw(family, 4))

  def leaves(obj):
    if dataclasses.is_dataclass(obj):
      for v in vars(obj).values():
        yield from leaves(v)
    elif isinstance(obj, dict):
      for k, v in obj.items():
        yield k
        yield from leaves(v)
    elif isinstance(obj, (list, tuple)):
      for v in obj:
        yield from leaves(v)
    else:
      yield obj
  plain = (np.ndarray, np.generic, str, int, float, bool, type(None),
           datetime.date, datetime.time)
  assert all(isinstance(x, plain) for x in leaves(spec))
  copy = pickle.loads(pickle.dumps(spec))
  parity_fuzz.compare_results(parity_fuzz.run(spec, 'cpu'),
                              parity_fuzz.run(copy, 'cpu'), atol=0, rtol=0)


@pytest.mark.parametrize('seed', [102, 155])
def test_nan_spreads_to_every_bin_of_a_mask_stack(seed):
  """time_bins seeds with a NaN point, skipna off and elevation bins
  stacked with regions: every bin is NaN in the port, as in numpy's
  einsum of the same operands; the JAX package leaves the bins without
  the point finite."""
  spec = parity_fuzz.draw('time_bins', seed)
  assert nan_spreads_through_a_mask_stack(spec)
  got = parity_fuzz.run(spec, 'cpu')
  want = run_jax(spec)
  for k in want:
    assert np.isnan(got[k].values).all(), k
    assert np.isfinite(np.asarray(want[k].values)).any(), k
  assert_nan_spread(want, got)
  assert_contraction_matches_numpy(spec, got)
  (case,) = spec.cases
  agg = parity_fuzz.build(case.aggregator, weatherbenchx_tpu_torch,
                          parity_fuzz.on_device('cpu'))
  stat = parity_fuzz.on_device('cpu')(case.predictions['2m_temperature'])
  operands = [np.asarray(op.values, np.float64)
              for op in agg.aggregation_operands(stat)]
  x = stat.values.astype(np.float64)
  # stat (init, lead, lat, lon) against the masks (bin, lat, lon).
  assert np.isnan(np.einsum('ijkl,akl,bkl->ab', x, *operands)).all()


def sweep(counts: dict) -> tuple:
  """``check_family`` over seeds 0..n-1 of each family: the failures as
  (family, seed, error), and the largest of each ``large_members``
  tolerance share."""
  failures = []
  shares: dict = {}
  for family, n in counts.items():
    for seed in range(n):
      try:
        for k, v in check_family(family, seed).items():
          shares[k] = max(shares.get(k, 0.0), v)
      except Exception as e:  # noqa: BLE001 -- every seed is reported
        failures.append((family, seed, f'{type(e).__name__}: {e}'[:400]))
  return failures, shares


if __name__ == '__main__':
  # The layers' families at chip_smoke.py's phase-17 counts against the
  # JAX package (the CPU test runs SEEDS), from the repository root:
  #   JAX_PLATFORMS=cpu PYTHONPATH=. python \
  #     tests/test_torch_parity_fuzz_layers.py
  import os
  import sys
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import conftest  # noqa: F401 -- the JAX package's CPU settings
  found, largest = sweep({'time_bins': 200, 'sparse': 100, 'dispatch': 20,
                          'inference': 50, 'large_members': 40})
  for f in found:
    print(f)
  print(f'{len(found)} failures in 410 seeds; large_members, the largest '
        f'share of the tolerance: {largest}')
  sys.exit(1 if found else 0)
