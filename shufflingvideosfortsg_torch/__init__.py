"""PyTorch and CUDA port of the temporal sentence grounding framework.

The port of ``shufflingvideosfortsg_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100, module for module under the same names. It imports torch,
numpy and yaml, never jax or the JAX package. The TPU kernels on the ported
paths are CUDA C++ kernels under ``csrc/`` (built at first use by
``_kernels.py``); each wrapper takes its plain PyTorch version for CPU
tensors and launches its kernel, or raises, for CUDA tensors.

Ported so far: GMD evaluation (``python -m shufflingvideosfortsg_torch.test``).
"""

__version__ = "0.1.0"
