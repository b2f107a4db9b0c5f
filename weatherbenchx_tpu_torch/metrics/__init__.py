"""Statistics and metrics of the PyTorch port."""
