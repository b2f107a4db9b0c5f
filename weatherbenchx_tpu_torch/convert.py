"""Conversions between the JAX package's objects, numpy and the port.

Duck-typed: a reference ``DimArray`` is anything with ``.data``, ``.dims``
and ``.coords[name].dims/.values``; a reference ``AggregationState`` has
``.sum_weighted_statistics`` and ``.sum_weights``. Arrays are read through
``np.asarray``, so this module never imports jax, and a state computed by
the JAX package can be summed with one computed here.

The numpy form of a state is ``{key: {'dims', 'data', 'coords'}}`` with the
``'#'`` keys of ``AggregationState.to_dataset``.
"""

from typing import Any

import numpy as np
import torch

from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.aggregation import AggregationState
from weatherbenchx_tpu_torch.darray import Coord, DimArray


def _tensor(values: Any, device) -> torch.Tensor:
  """A tensor holding its own copy (arrays read out of JAX are read-only)."""
  arr = np.asarray(values)
  if arr.dtype.name == 'bfloat16':  # ml_dtypes' bfloat16: no torch mapping
    return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
  return torch.from_numpy(np.array(arr, order='C')).to(device)


def dimarray_from_reference(obj: Any, device=None) -> DimArray:
  """A port DimArray with ``obj``'s data on ``device``; coords stay numpy,
  whatever their type: string bin labels, datetime64 and timedelta64 times,
  a climatology's ``quantile`` levels."""
  coords = {str(name): Coord(tuple(c.dims), np.asarray(c.values))
            for name, c in obj.coords.items()}
  return DimArray(_tensor(obj.data, device), tuple(obj.dims), coords)


def dataset_from_reference(dataset: Any, device=None) -> dict:
  """A port dataset ``{name: DimArray}`` from one of the JAX package, e.g.
  a climatology (with its ``quantile`` dim, where it has one)."""
  return {name: dimarray_from_reference(da, device)
          for name, da in dataset.items()}


def state_from_reference(state: Any, device=None) -> AggregationState:
  """A port AggregationState from one computed by the JAX package."""
  if state.sum_weighted_statistics is None:
    return AggregationState.zero()
  conv = lambda da: dimarray_from_reference(da, device)  # noqa: E731
  return AggregationState(
      tree.map_structure(conv, dict(state.sum_weighted_statistics)),
      tree.map_structure(conv, dict(state.sum_weights)))


def _numpy(values: Any) -> np.ndarray:
  if isinstance(values, torch.Tensor):
    values = values.detach().cpu()
    if values.dtype == torch.bfloat16:
      values = values.float()
    return values.numpy()
  return np.asarray(values)


def state_to_numpy(state: AggregationState) -> dict[str, dict]:
  """Host numpy form of a state, keyed like ``AggregationState.to_dataset``."""
  return {
      key: {'dims': da.dims, 'data': _numpy(da.data),
            'coords': {name: (c.dims, _numpy(c.values))
                       for name, c in da.coords.items()}}
      for key, da in state.to_dataset().items()}


def state_from_numpy(arrays: dict[str, dict], device=None
                     ) -> AggregationState:
  """Inverse of ``state_to_numpy``, with the data on ``device``."""
  return AggregationState.from_dataset({
      key: DimArray(_tensor(v['data'], device), tuple(v['dims']),
                    {name: Coord(tuple(dims), values)
                     for name, (dims, values) in v['coords'].items()})
      for key, v in arrays.items()})
