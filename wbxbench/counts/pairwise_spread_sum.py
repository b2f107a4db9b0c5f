"""Bytes of one call of the spread-only kernel: x (M, N) read once, the
spread (N) written once."""


def bytes_moved(members: int, points: int, itemsize: int = 4) -> int:
  return itemsize * (members * points + points)
