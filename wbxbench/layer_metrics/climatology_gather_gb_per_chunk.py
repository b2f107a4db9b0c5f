"""GB the climatology gathers write a compute pass (one pass a chunk of one
scoring): the port's counters in ``observability.default_metrics``, the
bytes gathered on the device (``climatology_gather_bytes``) and on the
host (``climatology_host_gather_bytes``) over ``ChunkEvaluator``'s compute
passes (``eval_passes``), over the whole run. None where the port keeps no
such counters or made no pass."""


def read(ctx):
  del ctx
  from weatherbenchx_tpu_torch import observability
  counters = observability.default_metrics.counters
  passes = counters.get('eval_passes', 0)
  if not passes:
    return None
  gathered = (counters.get('climatology_gather_bytes', 0)
              + counters.get('climatology_host_gather_bytes', 0))
  return gathered / 1e9 / passes
