"""The fused_ensemble_stats kernel's share of its bytes bound in the traced
stretch: counts/fused_ensemble_stats.py over the card's HBM rate, against the
device time of the kernels launched inside its wbx.fused_ensemble_stats
calls."""

from wbxbench import trace


def read(ctx):
  return trace.roofline_pct(ctx, 'fused_ensemble_stats')
