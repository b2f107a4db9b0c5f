"""CUDA kernels a chunk in the traced stretch (torch.profiler)."""


def read(ctx):
  if not ctx.kernels or not ctx.chunks:
    return None
  return len(ctx.kernels) / ctx.chunks
