"""Base data loader.

The port of ``weatherbenchx_tpu/data/base.py:23-192``. Loaders return
chunks as ``dict[var, DimArray]`` with canonical dims
(init_time/lead_time/valid_time/latitude/longitude[/number]) on the HOST:
CPU tensors and numpy coords. The pipeline moves them to its device. The
load pipeline per chunk: source load → process_chunk_fn → compute →
optional NaN mask coord. For a store opened lazily the compute step is the
per-chunk windowed read: only the chunk's selection comes off disk.

Interpolation against a reference chunk, padding of the sparse ``index``
dim and values-as-coords belong to the sparse path, which is not ported
yet: asking for them raises NotImplementedError.
"""

import abc
from typing import Callable, Collection, Hashable, Mapping, Optional, Union

import numpy as np

from weatherbenchx_tpu_torch.darray import Coord, DimArray


def add_nan_mask_to_data(
    data: Mapping[Hashable, DimArray],
    variable_subset: Collection[str] | None = None,
) -> dict[Hashable, DimArray]:
  """Adds a boolean host 'mask' coord to each variable, False at NaNs.

  Preferred over skipna so unexpected NaNs still propagate loudly.
  """
  out = dict(data)
  for var in out:
    if variable_subset is None or var in variable_subset:
      da = out[var]
      out[var] = da.assign_coords(
          mask=Coord(da.dims, ~np.isnan(da.values)))
  return out


class DataLoader(abc.ABC):
  """Base class for data loaders.

  Loaders return prediction/target chunks that broadcast against each
  other. ``reference`` (the other chunk of the pair) is accepted for the
  JAX package's signature; only interpolation, not ported yet, reads it.
  """

  def __init__(
      self,
      interpolation=None,
      compute: bool = True,
      add_nan_mask: bool = False,
      process_chunk_fn: Optional[Callable[
          [Mapping[Hashable, DimArray]], Mapping[Hashable, DimArray]]] = None,
      add_values_to_coords: bool = False,
      pad_index_multiple: Optional[int] = None,
  ):
    unported = {'interpolation': interpolation is not None,
                'add_values_to_coords': add_values_to_coords,
                'pad_index_multiple': pad_index_multiple is not None}
    if any(unported.values()):
      raise NotImplementedError(
          f'{[k for k, v in unported.items() if v]}: the sparse path of the '
          'loaders is not ported to weatherbenchx_tpu_torch yet')
    self._compute = compute
    self._add_nan_mask = add_nan_mask
    self._process_chunk_fn = process_chunk_fn

  @abc.abstractmethod
  def _load_chunk_from_source(
      self,
      init_times: np.ndarray,
      lead_times: Optional[Union[np.ndarray, slice]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Loader-specific source read."""

  def load_chunk(
      self,
      init_times: np.ndarray,
      lead_times: Optional[Union[np.ndarray, slice]] = None,
      reference: Optional[Mapping[Hashable, DimArray]] = None,
  ) -> Mapping[Hashable, DimArray]:
    """Shared chunk-loading pipeline."""
    del reference  # read by interpolation only
    chunk = self._load_chunk_from_source(init_times, lead_times)
    if self._process_chunk_fn is not None:
      chunk = self._process_chunk_fn(chunk)
    if self._compute:
      # Lazy views are read here, the chunk's window alone (the reference's
      # per-chunk .compute(), data_loaders/base.py:146-153), into CPU
      # tensors; contiguous, so the device copy is one block per variable.
      chunk = {k: da.copy(data=da.data.contiguous())
               for k, da in chunk.items()}
    if self._add_nan_mask:
      chunk = add_nan_mask_to_data(chunk)
    return chunk
