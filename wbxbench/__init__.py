"""The benchmark of the PyTorch/CUDA port, ``weatherbenchx_tpu_torch``.

One command runs one cell once (``python3 -m wbxbench.run --help``). The
cells, configurations and metrics are named in ``BENCHMARK.json`` at the
root of the checkout; everything that belongs to one of them sits in a
file of its own under this folder, found by that name (``spec.py``).
"""
