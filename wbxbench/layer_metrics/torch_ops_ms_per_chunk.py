"""Device milliseconds a chunk of every kernel launched outside the port's
``wbx.<kernel>`` ranges: the statistics built on the kernels' outputs, the
masking and the contraction (torch ops), in the traced stretch."""


def read(ctx):
  if not ctx.kernels or not ctx.chunks:
    return None
  return 1e3 * sum(k.dur for k in ctx.kernels if not k.range) * 1e-6 / (
      ctx.chunks)
