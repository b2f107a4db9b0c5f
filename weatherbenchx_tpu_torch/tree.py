"""Nested-structure mapping utilities for trees of DimArrays.

A copy of ``weatherbenchx_tpu.tree`` (host-only code): dicts are internal
nodes, everything else is a leaf, and dict entries mapped to None are
dropped.
"""

from typing import Any, Callable


def map_structure(func: Callable[..., Any], *structures: Any) -> Any:
  """Maps ``func`` over parallel nested dict/list/tuple structures.

  The first structure determines the tree shape; parallel dicts must have
  identical keys. For dict nodes, keys whose mapped value is None are
  dropped.
  """
  if not callable(func):
    raise TypeError(f'func must be callable, got: {func}')
  if not structures:
    raise ValueError('Must provide at least one structure')

  first = structures[0]
  if isinstance(first, dict):
    for s in structures[1:]:
      if not isinstance(s, dict) or s.keys() != first.keys():
        raise ValueError(
            'map_structure requires parallel dict structures with '
            f'identical keys; got {sorted(first.keys())} vs '
            f'{sorted(s.keys()) if isinstance(s, dict) else type(s).__name__}')
    result = {}
    for k in first.keys():
      v = map_structure(func, *[s[k] for s in structures])
      if v is not None:
        result[k] = v
    return result
  if isinstance(first, (list, tuple)):
    for s in structures[1:]:
      if not isinstance(s, (list, tuple)) or len(s) != len(first):
        raise ValueError(
            'map_structure requires parallel sequences of equal length; '
            f'got {len(first)} vs '
            f'{len(s) if isinstance(s, (list, tuple)) else type(s).__name__}')
    return type(first)(map_structure(func, *s) for s in zip(*structures))
  return func(*structures)


def flatten_with_paths(structure: Any, prefix: tuple = ()) -> dict:
  """Flattens nested dicts to a mapping from key-path tuples to leaves."""
  if isinstance(structure, dict):
    out = {}
    for k, v in structure.items():
      out.update(flatten_with_paths(v, prefix + (k,)))
    return out
  return {prefix: structure}


def unflatten_from_paths(flat: dict) -> Any:
  """Inverse of flatten_with_paths for dict-of-dict structures."""
  root: dict = {}
  for path, leaf in flat.items():
    node = root
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = leaf
  return root
