"""CF/xarray storage-convention helpers shared by the io backends.

The port of ``weatherbenchx_tpu/cf.py``.

The zarr (``zarr_io.py``) and netCDF (``netcdf_io.py``) backends implement
the same two conventions — one array per coordinate name (mismatches
raise) on write, and the xarray ``coordinates``-attribute / dim-name rule
for telling coordinates from data variables on read (reference stores
follow both via xarray). Keeping the logic here means a fix lands in both
backends at once.
"""

from typing import Any, Hashable, Mapping, Sequence

import numpy as np


def coord_arrays_equal(a: np.ndarray, b: np.ndarray) -> bool:
  """Array equality where NaN == NaN and NaT == NaT.

  ``np.array_equal(equal_nan=True)`` only covers float kinds; datetime64/
  timedelta64 arrays holding NaT compare unequal to themselves, which
  would spuriously reject a shared time coordinate with missing entries.
  NaT is the min-int64 sentinel, so comparing the integer view is exact.
  """
  a, b = np.asarray(a), np.asarray(b)
  if a.shape != b.shape or a.dtype != b.dtype:
    return False
  if a.dtype.kind in 'fc':
    return bool(np.array_equal(a, b, equal_nan=True))
  if a.dtype.kind in 'Mm':
    return bool(np.array_equal(a.view('i8'), b.view('i8')))
  return bool(np.array_equal(a, b))


def check_shared_coord(
    written: dict,
    cname: Hashable,
    dims: Sequence[str],
    values: np.ndarray,
    container: str,
) -> bool:
  """Registers a coordinate for writing, validating cross-variable reuse.

  Returns True when the coordinate is new (caller writes it), False when
  an identical one was already written. Raises when two variables carry
  coordinates of the same name with different dims or values — both zarr
  and netCDF store one array per name.
  """
  values = np.asarray(values)
  if cname in written:
    prev_dims, prev_vals = written[cname]
    if prev_dims != tuple(dims) or not coord_arrays_equal(prev_vals, values):
      raise ValueError(
          f'coordinate {cname!r} differs between variables; {container} '
          'stores one array per name')
    return False
  written[cname] = (tuple(dims), values)
  return True


def infer_coord_names(
    arrays: Mapping[str, tuple[Any, Sequence[str], Mapping]],
) -> set[str]:
  """Which stored arrays are coordinates (xarray conventions).

  ``arrays`` maps name → (payload, dims, attrs). An array is a coordinate
  when it is named after one of its own dims, or referenced by any
  variable's CF ``coordinates`` attribute.
  """
  referenced: set[str] = set()
  for _, (_, _, attrs) in arrays.items():
    referenced.update(str(attrs.get('coordinates', '')).split())
  return {n for n, (_, dims, _) in arrays.items()
          if n in tuple(dims)} | (referenced & set(arrays))


def subset_coords(coords_all: Mapping, dims: Sequence[str]) -> dict:
  """The coordinates attachable to a variable: dims ⊆ the variable's."""
  return {cn: c for cn, c in coords_all.items()
          if set(c.dims) <= set(dims)}
