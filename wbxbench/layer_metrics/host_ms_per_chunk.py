"""Host milliseconds a chunk spends in prepare_pair + eval_accum (every
scoring), the harness's own span over the untraced window: the enqueue,
not the device's work. Mean over the window's chunks."""


def read(ctx):
  if not ctx.host_chunk_s:
    return None
  return 1e3 * sum(ctx.host_chunk_s) / len(ctx.host_chunk_s)
