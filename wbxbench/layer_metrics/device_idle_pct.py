"""Share of the traced stretch in which no device operation runs."""


def read(ctx):
  if ctx.window_s <= 0 or ctx.busy_s <= 0:
    return None
  return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
