"""openairinterface5g_tpu_torch — the PyTorch / CUDA port of openairinterface5g_tpu.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name, place and public layouts, so a reader can hold one
against the other.  Plain tensor code is PyTorch; the Pallas kernels of the
JAX package become hand-written CUDA C++ kernels for Hopper (``csrc/``),
built at first use by ``ops/_cuda.py``.

This package imports no JAX and nothing of the JAX package: it keeps its
own copies of the jax-free modules it needs (``config``, ``transport``,
``data/tables``).
"""
import torch

# The CRC is a {0,1} matrix product in float32 (coding/crc.py) and must stay
# exact; TF32 would round the operands of float32 matmuls and convolutions
# on the card.  Both switches are set here, once, for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
