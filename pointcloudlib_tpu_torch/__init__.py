"""pointcloudlib_tpu_torch — the PyTorch + CUDA port of pointcloudlib_tpu.

The JAX package beside it stays the reference; this package imports
``torch``, numpy and the standard library only, never ``jax`` nor
anything under ``pointcloudlib_tpu``. Layouts at public functions follow
the JAX package: channel-last ``[B, N, C]`` float32 clouds and ``int32``
index arrays.

Every kernel the JAX package wrote in Pallas for the TPU is a kernel
written by hand for Hopper here (``csrc/``, built with ``nvcc`` at first
use). A kernel wrapper launches its kernel for a CUDA tensor or raises;
only a CPU tensor takes the plain PyTorch version.

Numerics: TF32 is switched off for matmuls and cuDNN. The ball-query
distance math and the products that emulate bf16 operands with f32
accumulation need true f32 (a TF32 product rounds the bf16 operands'
exact products and can flip ball-query membership at the radius).
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
