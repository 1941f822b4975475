"""Positional encodings and multi-head attention for the self-attention
span predictor.

Counterpart of ``shufflingvideosfortsg_tpu/ops/attention.py:47-86``. JAX's
choices are kept: the logits are scaled by sqrt(``scale_dim``), the model
width, not the width of a head; masked logits are filled with -1e10; the
logits and the softmax are f32 whatever the inputs' dtype, and the
attention weights are cast to q's dtype before they mix v. Each product
takes its inputs in f32, as ``preferred_element_type=f32`` sums them (a
product of two bf16 values is exact in f32), and the mix is rounded once
to q's dtype. The products are ``torch.matmul``: JAX leaves them to XLA,
outside any Pallas kernel. ``F.scaled_dot_product_attention`` would round
at other points and is not used.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32


def positional_encodings_like(x: torch.Tensor) -> torch.Tensor:
    """Sin/cos encodings [T, D] of x [B, T, D] in x's dtype, made on x's
    device (no host copy): channel c of position t is sin(t / 10000^(c/D))
    for even c and cos(t / 10000^((c-1)/D)) for odd c."""
    T, D = x.shape[1], x.shape[2]
    pos = torch.arange(T, dtype=F32, device=x.device)[:, None]
    chan = torch.arange(D, dtype=F32, device=x.device)[None, :]
    even = (torch.arange(D, device=x.device) % 2 == 0)[None, :]
    angle_even = pos / torch.pow(10000.0, chan / D)
    angle_odd = pos / torch.pow(10000.0, (chan - 1.0) / D)
    enc = torch.where(even, torch.sin(angle_even), torch.cos(angle_odd))
    return enc.to(x.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_heads: int, scale_dim: int, causal: bool = False,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head scaled dot-product attention over [B, T, D] inputs
    (already projected): heads of D / ``n_heads`` channels, logits over
    sqrt(``scale_dim``), an optional causal mask and key mask [B, Tk]
    (nonzero keeps), out [B, Tq, D] in q's dtype."""
    B, Tq, D = q.shape
    Dh = D // n_heads

    def heads(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, x.shape[1], n_heads, Dh).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    logits = torch.matmul(qh.to(F32), kh.to(F32).transpose(-1, -2))
    logits = logits / math.sqrt(float(scale_dim))
    if causal:
        Tk = k.shape[1]
        tri = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri, -1e10)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :].bool(), -1e10)
    A = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(A.to(F32), vh.to(F32)).to(q.dtype)
    return out.transpose(1, 2).reshape(B, Tq, D)
