"""Bytes of one call of the fused ensemble-statistics kernel.

x (M, N) and the target y (N) read once; spread, skill, mean and squared
deviations (4 N) written once: what any method needs, whatever the
kernel reads again.
"""


def bytes_moved(members: int, points: int, itemsize: int = 4) -> int:
  return itemsize * (members * points + points + 4 * points)
