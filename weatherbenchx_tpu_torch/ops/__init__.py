"""Array operations of the PyTorch port: the hand-written CUDA kernels with
their plain versions (``crps_pairwise``), and the neighborhood convolution
in torch ops (``conv``)."""
