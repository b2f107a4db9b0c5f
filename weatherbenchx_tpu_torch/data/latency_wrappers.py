"""Operational-latency simulation wrappers.

The port of ``weatherbenchx_tpu/data/latency_wrappers.py``, over the
port's loaders (host chunks: CPU tensors, numpy coords).

Reference semantics: ``weatherbenchX/data_loaders/latency_wrappers.py``.
Requested (init, lead) pairs are remapped to the most recent *available*
nominal init time given a constant latency; per-init results are
concatenated (along init_time for gridded data, index for sparse).
"""

import logging
from typing import Hashable, Mapping, Optional, Union

import numpy as np

from weatherbenchx_tpu_torch import darray
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import Coord, DimArray
from weatherbenchx_tpu_torch.data import base
from weatherbenchx_tpu_torch.data import loaders as dataset_loaders

logger = logging.getLogger(__name__)


class ConstantLatencyWrapper(base.DataLoader):
  """Adjusts init/lead times for a constant operational latency.

  The most recent nominal init with issue time (nominal init + latency)
  <= requested init is used; lead times are shifted by the offset and the
  requested init/lead coords are restored on the result
  (reference ``latency_wrappers.py:26-186``).
  """

  def __init__(
      self,
      data_loader: base.DataLoader,
      latency: np.timedelta64,
      nominal_init_times: np.ndarray,
      concat_dim: str = 'init_time',
  ):
    self.data_loader = data_loader
    self.latency = latency
    self.nominal_init_times = np.asarray(nominal_init_times)
    self._concat_dim = concat_dim
    # The wrapper calls the wrapped loader's _load_chunk_from_source
    # directly and replays the shared load_chunk pipeline itself, so EVERY
    # pipeline option must be forwarded — dropping pad_index_multiple, for
    # example, would silently lose the sparse padding that keeps a run's
    # chunks at a few layouts. The reference wrapper forwards only
    # interpolation/compute/nan-mask (``latency_wrappers.py:60-75``);
    # add_values_to_coords and the padding are load-bearing here.
    super().__init__(
        interpolation=data_loader._interpolation,
        compute=data_loader._compute,
        add_nan_mask=data_loader._add_nan_mask,
        process_chunk_fn=data_loader._process_chunk_fn,
        add_values_to_coords=data_loader._add_values_to_coords,
        pad_index_multiple=data_loader._pad_index_multiple,
    )

  def get_available_init_time(
      self, init_time: np.datetime64) -> np.datetime64 | None:
    """Most recent nominal init whose issue time <= requested init."""
    issue_time = self.nominal_init_times + self.latency
    diff = (issue_time - init_time).astype('timedelta64[s]').astype(float)
    diff = np.where(diff <= 0, diff, np.nan)
    if np.all(np.isnan(diff)):
      return None
    return self.nominal_init_times[int(np.nanargmax(diff))]

  def _load_chunk_from_source(self, init_times, lead_times=None):
    if isinstance(self.data_loader, dataset_loaders.DatasetBackedLoader):
      self.data_loader.maybe_prepare_dataset()
    if lead_times is None:
      raise ValueError('Latency adjustment is only valid with lead times.')

    chunks = []
    for init_time in init_times:
      available = self.get_available_init_time(init_time)
      if available is None:
        raise ValueError(
            f'No available init time found for init time {init_time}.')
      lead_time_offset = init_time - available
      adjusted_lead_times = lead_times + lead_time_offset
      logger.info(
          'LatencyWrapper: init %s -> available %s, adjusted leads %s',
          init_time, available,
          adjusted_lead_times.astype('timedelta64[m]'))
      raw = self.data_loader._load_chunk_from_source(
          np.array([available]), adjusted_lead_times)

      def adjust(x: DimArray, offset=lead_time_offset) -> DimArray:
        init_c = x.coords['init_time']
        lead_c = x.coords['lead_time']
        return x.assign_coords(
            init_time=Coord(init_c.dims,
                            np.asarray(init_c.values) + offset),
            lead_time=Coord(lead_c.dims,
                            np.asarray(lead_c.values) - offset))

      chunks.append(tree.map_structure(adjust, dict(raw)))

    return tree.map_structure(
        lambda *x: darray.concat(list(x), self._concat_dim), *chunks)


class DatasetConstantLatencyWrapper(ConstantLatencyWrapper):
  """Latency wrapper reading nominal init times from the loader's dataset.

  The analogue of the reference's XarrayConstantLatencyWrapper
  (``latency_wrappers.py:188-231``).
  """

  def __init__(
      self,
      data_loader: dataset_loaders.DatasetBackedLoader,
      latency: np.timedelta64,
      init_time_dim: str = 'init_time',
      concat_dim: str = 'init_time',
  ):
    self._init_time_dim = init_time_dim
    self._nominal_init_times_set = False
    super().__init__(data_loader, latency,
                     nominal_init_times=np.array([], dtype='datetime64[ns]'),
                     concat_dim=concat_dim)

  def maybe_set_nominal_init_times(self):
    if self._nominal_init_times_set:
      return
    assert isinstance(self.data_loader, dataset_loaders.DatasetBackedLoader)
    self.data_loader.maybe_prepare_dataset()
    first = next(iter(self.data_loader._ds.values()))
    self.nominal_init_times = np.asarray(
        first.coords[self._init_time_dim].values)
    self._nominal_init_times_set = True

  def _load_chunk_from_source(self, init_times, lead_times=None):
    self.maybe_set_nominal_init_times()
    return super()._load_chunk_from_source(init_times, lead_times)

  def get_available_init_time(self, init_time):
    self.maybe_set_nominal_init_times()
    return super().get_available_init_time(init_time)


class MultipleConstantLatencyWrapper(base.DataLoader):
  """Picks the freshest of several latency-wrapped loaders per init time.

  Ties broken by the largest latency (larger lookahead);
  reference ``latency_wrappers.py:233-336``.
  """

  def __init__(self, data_loaders: list, concat_dim: str = 'init_time'):
    super().__init__()
    self._data_loaders = list(data_loaders)
    self._concat_dim = concat_dim

  def _load_chunk_from_source(self, init_times, lead_times=None):
    raise NotImplementedError(
        'This should only be called for the individual data loaders.')

  def _get_data_loader(self, init_time):
    inf_time = np.timedelta64(int(1e6), 'D')
    entries = []
    for data_loader in self._data_loaders:
      available = data_loader.get_available_init_time(init_time)
      if available is None:
        entries.append((inf_time, inf_time))
      else:
        entries.append((init_time - available, -data_loader.latency))
    entries = np.array(entries, dtype=[
        ('lead_time_offset', 'timedelta64[s]'),
        ('neg_latency', 'timedelta64[s]')])
    idx = np.argsort(entries, order=('lead_time_offset', 'neg_latency'))
    if entries[idx[0]][0] == inf_time:
      raise ValueError(
          f'No available init time found for init time {init_time}.')
    chosen = self._data_loaders[idx[0]]
    logger.info('Init time: %s, data loader latency: %s min',
                init_time, chosen.latency.astype('timedelta64[m]'))
    return chosen

  def load_chunk(self, init_times, lead_times=None, reference=None):
    chunks = [
        self._get_data_loader(init_time).load_chunk(
            np.array([init_time]), lead_times, reference)
        for init_time in init_times
    ]
    return tree.map_structure(
        lambda *x: darray.concat(list(x), self._concat_dim), *chunks)
