"""Dense layers and LayerNorm at a compute dtype.

Counterparts of ``shufflingvideosfortsg_tpu/models/components.py``
``TDense`` (``:57-68``) and ``LayerNorm`` (``:74-85``). The parameters stay
f32, as Flax keeps them, and are cast at use. In f32 these are
``nn.Linear``'s and ``nn.LayerNorm``'s own forwards. In bf16 ``dense``
keeps JAX's rounding points: the product of bf16 x and bf16 W sums in f32
and is rounded to bf16, and only then is the bf16 bias added, with a
second rounding (``torch.addmm`` and ``F.linear`` would add the bias before
their one rounding). The products are ``torch.matmul``: the JAX package
leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``dtype`` (weight [out, in] as
    ``nn.Linear`` holds it; bias may be None): x is cast to ``dtype``
    first, as ``TDense`` casts it."""
    x = x.to(dtype)
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = torch.matmul(x, weight.t().to(dtype))
    return y if bias is None else y + bias.to(dtype)


def linear(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """:func:`dense` over an ``nn.Linear``'s weight and bias."""
    return dense(x, layer.weight, layer.bias, dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``LayerNorm``: x taken in f32 with the f32 scale and bias,
    the result rounded once to ``dtype``."""
    return norm(x.float()).to(dtype)
