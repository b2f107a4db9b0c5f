"""Bytes of one call of the cross kernel: x (Mx, N) and y (My, N) read
once, the sum (N) written once. ``members`` is (Mx, My)."""


def bytes_moved(members: tuple, points: int, itemsize: int = 4) -> int:
  mx, my = members
  return itemsize * ((mx + my) * points + points)
