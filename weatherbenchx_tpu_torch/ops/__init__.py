"""Hand-written CUDA kernels of the PyTorch port, with their plain versions."""
