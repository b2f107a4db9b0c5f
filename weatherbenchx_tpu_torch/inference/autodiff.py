"""Delta method by linearizing the metric finalizers with ``torch.func``.

The port of ``weatherbenchx_tpu/inference/autodiff.py`` (reference
``weatherbenchX/statistical_inference/autodiff.py:33-233``):
``values_from_mean_statistics ∘ weight-normalize`` is linearized at the
mean statistics with ``torch.func.linearize``, and the tangent map is
vmapped over the experimental-unit axis with ``torch.func.vmap``, on the
state's device, in float64. Every finalizer this drives must therefore
trace: no ``.item()``, no numpy round trips of its tensors, no Python
branch on a tensor's value, no in-place write to an input.
"""

import warnings
from typing import Hashable, Mapping

import torch

from weatherbenchx_tpu_torch import aggregation
from weatherbenchx_tpu_torch import tree
from weatherbenchx_tpu_torch.darray import DimArray
from weatherbenchx_tpu_torch.inference import utils
from weatherbenchx_tpu_torch.metrics import base as metrics_base

MetricValues = Mapping[str, Mapping[Hashable, DimArray]]


def per_unit_values_linearized_around_mean_statistics(
    metrics: Mapping[str, metrics_base.Metric],
    aggregation_state: aggregation.AggregationState,
    experimental_unit_dim: str,
) -> tuple[MetricValues, MetricValues]:
  """Linearized per-unit metric values (multivariate delta method).

  Returns (value, per_unit_tangents): the metric at the mean statistics,
  and zero-mean per-unit tangents of the linearized finalizer, both on the
  state's device in float64. See the reference docstring
  (``autodiff.py:38-126``) for the full statistical story; weight
  normalization is part of the differentiated function.
  """
  unit_coord = utils.get_and_check_experimental_unit_coord(
      aggregation_state, experimental_unit_dim)

  def to_unit_last(x: DimArray) -> DimArray:
    order = [d for d in x.dims if d != experimental_unit_dim]
    order.append(experimental_unit_dim)
    return x.transpose(*order).astype(torch.float64)

  per_unit = aggregation_state.map(to_unit_last)
  mean_state = per_unit.map(lambda x: x.mean(experimental_unit_dim))
  ws_template = mean_state.sum_weighted_statistics
  w_template = mean_state.sum_weights

  def data_of(structure):
    return tree.map_structure(lambda d: d.data, structure)

  result_template: dict = {}

  def metric_fn(ws_data, w_data):
    ws = tree.map_structure(
        lambda d, t: DimArray(d, t.dims, t.coords), ws_data, ws_template)
    w = tree.map_structure(
        lambda d, t: DimArray(d, t.dims, t.coords), w_data, w_template)
    state = aggregation.AggregationState(ws, w)
    result = metrics_base.compute_metrics_from_statistics(
        metrics, state.mean_statistics())
    result_template.clear()
    result_template.update(result)
    return data_of(result)

  with warnings.catch_warnings():
    # torch.func.linearize constant-folds its traced graph and warns about
    # the folded constants it inserts: harmless, and once per call.
    warnings.filterwarnings('ignore', message='Attempted to insert a get_attr')
    values_data, linearized = torch.func.linearize(
        metric_fn, data_of(ws_template), data_of(w_template))
  linearized = torch.func.vmap(linearized, in_dims=-1, out_dims=-1)

  value = tree.map_structure(
      lambda d, t: DimArray(d, t.dims, t.coords),
      values_data, dict(result_template))

  tangents_in = aggregation.AggregationState.map_multi(
      lambda x, y: x - y, per_unit, mean_state)
  tangents_out_data = linearized(
      data_of(tangents_in.sum_weighted_statistics),
      data_of(tangents_in.sum_weights))

  def rebuild_tangent(d, t: DimArray) -> DimArray:
    coords = dict(t.coords)
    coords[experimental_unit_dim] = unit_coord
    return DimArray(d, t.dims + (experimental_unit_dim,), coords)

  per_unit_tangents = tree.map_structure(
      rebuild_tangent, tangents_out_data, dict(result_template))
  return value, per_unit_tangents

