"""The card's published peaks, for roofline shares.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): HBM3 at 3.35 TB/s, at the
full power limit of 700 W. A run reports the card's name and power limit
beside every share (``nvidia-smi``).
"""

HBM_BYTES_PER_S = 3.35e12
