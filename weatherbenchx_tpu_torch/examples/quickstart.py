"""Quickstart: score one forecast chunk in memory.

The port of ``examples/quickstart.py``, the single-chunk path
(``aggregation.compute_metric_values_for_single_chunk``): build named-axis
arrays on the device, pick metrics, aggregate with area weighting and
region bins, read off metric values.

Run: python -m weatherbenchx_tpu_torch.examples.quickstart [--device cpu]
(no data files needed; ``--device cuda``, the default, raises without a
GPU)
"""

from typing import Optional, Sequence

import numpy as np
import torch

from weatherbenchx_tpu_torch import aggregation, binning, weighting
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.examples import parse_device
from weatherbenchx_tpu_torch.metrics import deterministic


def main(argv: Optional[Sequence[str]] = None) -> dict[str, DimArray]:
  device = parse_device(argv, __doc__)
  rng = np.random.default_rng(0)
  lats = np.linspace(-90, 90, 19)
  lons = np.linspace(0, 360, 36, endpoint=False)
  lead = np.array([6, 12, 24], 'timedelta64[h]').astype('timedelta64[ns]')
  dims = ('lead_time', 'latitude', 'longitude')
  coords = {'lead_time': lead, 'latitude': lats, 'longitude': lons}

  def field():
    return torch.from_numpy(
        280 + rng.standard_normal((3, 19, 36)).astype(np.float32)).to(device)

  predictions = {'2m_temperature': DimArray(field(), dims, coords)}
  targets = {'2m_temperature': DimArray(field(), dims, coords)}

  metrics = {
      'rmse': deterministic.RMSE(),
      'bias': deterministic.Bias(),
      'mae': deterministic.MAE(),
  }
  aggregator = aggregation.Aggregator(
      reduce_dims=['latitude', 'longitude'],
      weigh_by=[weighting.GridAreaWeighting()],
      bin_by=[binning.Regions({'global': ((-90, 90), (0, 360)),
                               'tropics': ((-20, 20), (0, 360))})])

  values = aggregation.compute_metric_values_for_single_chunk(
      metrics, aggregator, predictions, targets)

  for name, da in values.items():
    print(f'{name}: dims={da.dims}')
    print(np.asarray(da.values).round(3))
  return values


if __name__ == '__main__':
  main()
