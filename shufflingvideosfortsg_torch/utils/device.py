"""The device a run or a service uses."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device must exist: the port never falls
    back to the CPU unless asked for it."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name}: no CUDA device is available '
                           '(pass --device cpu to run on the CPU)')
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {name!r}')
    return device


def exact_bf16_products() -> None:
    """Have cuBLAS sum every bf16 product in f32 and round once, as the
    JAX package's products do: its default
    (``allow_bf16_reduced_precision_reduction``) may add the split-K
    partial sums of a bf16 product in bf16. A process-wide setting, which
    the drivers, the grounder and the measurement tools make on a card."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
