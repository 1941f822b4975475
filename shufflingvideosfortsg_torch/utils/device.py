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
