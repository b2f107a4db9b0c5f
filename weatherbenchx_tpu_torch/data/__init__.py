"""Data loaders of the PyTorch port: chunks on the host, as CPU tensors."""
