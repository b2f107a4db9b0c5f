"""Utilities for statistical inference implementations.

The port of ``weatherbenchx_tpu/inference/utils.py`` (reference
``weatherbenchX/statistical_inference/utils.py:25-138``).
"""

from typing import Any, Callable, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import Coord, DimArray


def get_and_check_experimental_unit_coord(
    aggregated_statistics: aggregation.AggregationState,
    name: str,
    check_is_dim: bool = True,
) -> Coord:
  """The experimental-unit coordinate, checked consistent across stats."""
  coord: Coord | None = None
  for stat_name, stat_vars in (
      aggregated_statistics.sum_weighted_statistics.items()):
    for var_name, var in stat_vars.items():
      var_coord = var.coords.get(name)
      if var_coord is None:
        if check_is_dim and name in var.dims:
          # A dimension without explicit coordinate values: use a default
          # positional coordinate.
          var_coord = Coord((name,), np.arange(var.sizes[name]))
        else:
          raise ValueError(
              f'No experimental unit coordinate {name} found for '
              f'{stat_name=} {var_name=}.')
      if len(var_coord.dims) != 1:
        raise ValueError(
            f'Experimental unit coordinate {name} has multiple dimensions.')
      if check_is_dim and var_coord.dims[0] != name:
        raise ValueError(f'Coordinate {name} is not a dimension coordinate.')
      values = var.coord_values(name) if name in var.coords else np.asarray(
          var_coord.values)
      if coord is None:
        coord = Coord(var_coord.dims, values)
      elif values.size != np.asarray(coord.values).size:
        raise ValueError(
            f'Inconsistent sizes for coordinate {name}: {values.size} and '
            f'{np.asarray(coord.values).size}.')
      elif not np.all(values == np.asarray(coord.values)):
        raise ValueError(f'Inconsistent coordinate values for {name}.')
  if coord is None:
    raise ValueError('No statistics found.')
  return coord


def logarithmic_round(x, resolution=30):
  """Rounds in log10 domain with `resolution` values per decade."""
  return 10 ** ((np.log10(x) * resolution).round() / resolution)


def as_float64(state: aggregation.AggregationState
               ) -> aggregation.AggregationState:
  """The state in float64 on its own device(s): inference computes in
  float64, as the JAX package does under x64 and the reference's numpy
  does."""
  return state.map(lambda x: x if x.dtype == torch.float64
                   else x.astype(torch.float64))


DataArrayTree = Any


def apply_to_slices(
    func: Callable[..., DataArrayTree],
    *args: DataArrayTree,
    dim: str | Sequence[str],
) -> DataArrayTree:
  """Applies ``func`` to every unit slice along ``dim``s, reassembling.

  Slices keep the sliced dims with size 1 (so outputs can be concatenated
  back); mirrors reference ``utils.py:79-138``. One ``func`` call per
  slice, in a Python loop.
  """
  dims = (dim,) if isinstance(dim, str) else tuple(dim)
  sizes: dict[str, int] = {}

  def check_sizes(arg: DimArray):
    for d in dims:
      if d not in arg.dims:
        continue
      if d not in sizes:
        sizes[d] = arg.sizes[d]
      if sizes[d] != arg.sizes[d]:
        raise ValueError(
            f'Different sizes {sizes[d]}, {arg.sizes[d]} for dim={d!r}.')
      if d not in arg.coords:
        arg = arg.assign_coords(**{d: Coord((d,), np.arange(arg.sizes[d]))})
    return arg

  args = tree.map_structure(check_sizes, args)
  for d in dims:
    if d not in sizes:
      raise ValueError(f'Dimension {d!r} not found in any arguments.')

  grid_shape = [sizes[d] for d in dims]
  results = []
  for indexes in np.ndindex(*grid_shape):
    def slice_arg(arg, indexes=indexes):
      return arg.isel({
          d: slice(i, i + 1) for d, i in zip(dims, indexes) if d in arg.dims})
    results.append(func(*tree.map_structure(slice_arg, args)))

  def combine(*slices):
    # Reassemble the n-d grid of slices by nested concatenation,
    # reducing the trailing slice axis first.
    arr = np.empty(grid_shape, dtype=object)
    for k, indexes in enumerate(np.ndindex(*grid_shape)):
      arr[indexes] = slices[k]
    for axis in reversed(range(len(dims))):
      d = dims[axis]
      new_shape = tuple(grid_shape[:axis])
      new_arr = np.empty(new_shape, dtype=object)
      for idx in np.ndindex(*new_shape):
        parts = [arr[idx + (i,)] for i in range(grid_shape[axis])]
        new_arr[idx] = (darray.concat(parts, d)
                        if d in parts[0].dims else parts[0])
      arr = new_arr
    return arr[()]

  return tree.map_structure(lambda *s: combine(*s), *results)
