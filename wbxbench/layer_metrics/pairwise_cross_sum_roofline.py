"""The pairwise_cross_sum kernel's share of its bytes bound in the traced
stretch: counts/pairwise_cross_sum.py over the card's HBM rate, against the
device time of the kernels launched inside its wbx.pairwise_cross_sum calls."""

from wbxbench import trace


def read(ctx):
  return trace.roofline_pct(ctx, 'pairwise_cross_sum')
