"""weatherbenchx_tpu_torch: the PyTorch/CUDA port of weatherbenchx_tpu.

Mirrors the JAX package's module paths and public names (``darray``,
``aggregation``, ``metrics.probabilistic``, ``parallel.evaluator``, ...)
over ``torch.Tensor`` data. The Pallas kernels of the JAX package are
hand-written CUDA kernels here (``ops/csrc``), built with nvcc at first use.
This package never imports jax.

The aggregation contraction (``darray.dot``) is a float32 einsum; TF32
there is the GPU analogue of the single-pass bf16 MXU products that put
half of the JAX package's TPU fuzz configurations outside 1e-5. So full
float32 precision is set here, at import, and checked.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')
if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    or torch.get_float32_matmul_precision() != 'highest'):
  raise RuntimeError('could not disable TF32 for float32 contractions')

from weatherbenchx_tpu_torch import darray  # noqa: E402
from weatherbenchx_tpu_torch import tree  # noqa: E402
from weatherbenchx_tpu_torch.darray import Coord, DimArray  # noqa: E402

__version__ = '0.1.0'
