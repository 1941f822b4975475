"""Transformer encoder and decoder blocks.

Counterpart of ``shufflingvideosfortsg_tpu/models/transformer.py``
(the reference's ``networks/transformer.py``): a pre-norm residual
wrapper, the ReLU feed-forward, the encoder and decoder layers over
``components.MultiHead`` and the stand-alone cross-attention layer. No
config key builds them, in JAX or here. Each takes JAX's ``dtype`` (f32
or bf16): the dense layers and LayerNorm through ``ops/dense.py``, the
attention through ``ops/attention.py``, the residual sums on tensors of
that dtype. Dropout, in training only, draws from the ``generator`` a
forward is given (``ops/rnn.py::dropout``), one mask a residual branch in
JAX's order. Submodule names are JAX's, so ``utils/interop.
dense_tree_to_torch`` carries a JAX tree across.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.dense import layer_norm, linear
from ..ops.rnn import dropout
from .components import MultiHead

F32 = torch.float32


def _norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


class ResidualBlock(nn.Module):
    """``x + dropout(layer(norm(x), *args))`` (``:20-32``); ``layer`` is
    any module, called on the normed input and ``args``."""

    def __init__(self, layer: nn.Module, dim: int, dropout: float,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.layer = layer
        self.norm = _norm(dim)

    def forward(self, x: torch.Tensor, *args,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.layer(layer_norm(self.norm, x, self.dtype), *args)
        return x + dropout(y, self.dropout, self.training, generator)


class FeedForward(nn.Module):
    """``linear2(relu(linear1(x)))``, d_model -> d_hidden -> d_model."""

    def __init__(self, d_model: int, d_hidden: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(d_model, d_hidden)
        self.linear2 = nn.Linear(d_hidden, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.linear2,
                      torch.relu(linear(self.linear1, x, self.dtype)),
                      self.dtype)


class EncoderLayer(nn.Module):
    """Self-attention and feed-forward, each a pre-norm residual branch.
    The attention's query, key and value each take a LayerNorm of their
    own (``norm1``, ``norm1_kv``, ``norm1_kv2``), as JAX has them."""

    def __init__(self, d_model: int, d_hidden: int, n_heads: int,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.selfattn = MultiHead(d_model, n_heads, dropout, dtype=dtype)
        self.norm1 = _norm(d_model)
        self.norm1_kv = _norm(d_model)
        self.norm1_kv2 = _norm(d_model)
        self.ff = FeedForward(d_model, d_hidden, dtype)
        self.norm2 = _norm(d_model)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, p, on = self.dtype, self.dropout, self.training
        a = self.selfattn(layer_norm(self.norm1, x, dt),
                          layer_norm(self.norm1_kv, x, dt),
                          layer_norm(self.norm1_kv2, x, dt))
        x = x + dropout(a, p, on, generator)
        return x + dropout(self.ff(layer_norm(self.norm2, x, dt)), p, on,
                           generator)


class DecoderLayer(nn.Module):
    """Self-attention (``causal`` by default), cross-attention over
    ``encoding`` [B, Te, d_encoding] and feed-forward, each a pre-norm
    residual branch (``norm1``, ``norm2``, ``norm3``)."""

    def __init__(self, d_model: int, d_hidden: int, n_heads: int,
                 dropout: float, causal: bool = True,
                 dtype: torch.dtype = F32,
                 d_encoding: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.selfattn = MultiHead(d_model, n_heads, dropout, dtype=dtype,
                                  causal=causal)
        self.norm1 = _norm(d_model)
        self.crossattn = MultiHead(d_model, n_heads, dropout, dtype=dtype,
                                   kv_dim=d_encoding)
        self.norm2 = _norm(d_model)
        self.ff = FeedForward(d_model, d_hidden, dtype)
        self.norm3 = _norm(d_model)

    def forward(self, x: torch.Tensor, encoding: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, p, on = self.dtype, self.dropout, self.training
        xn = layer_norm(self.norm1, x, dt)
        x = x + dropout(self.selfattn(xn, xn, xn), p, on, generator)
        x = x + dropout(self.crossattn(layer_norm(self.norm2, x, dt),
                                       encoding, encoding), p, on, generator)
        return x + dropout(self.ff(layer_norm(self.norm3, x, dt)), p, on,
                           generator)


class MHAttLayer(nn.Module):
    """Stand-alone cross-attention (``:75-120``): q [B, Tq, d_model]
    attends over kv [B, Tk, d_kv], then the feed-forward, each a pre-norm
    residual branch (``norm1`` on q only, ``norm2``)."""

    def __init__(self, d_model: int, d_hidden: int, n_heads: int,
                 dropout: float, dtype: torch.dtype = F32,
                 d_kv: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.attn = MultiHead(d_model, n_heads, dropout, dtype=dtype,
                              kv_dim=d_kv)
        self.norm1 = _norm(d_model)
        self.ff = FeedForward(d_model, d_hidden, dtype)
        self.norm2 = _norm(d_model)

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, p, on = self.dtype, self.dropout, self.training
        x = q + dropout(self.attn(layer_norm(self.norm1, q, dt), kv, kv), p,
                        on, generator)
        return x + dropout(self.ff(layer_norm(self.norm2, x, dt)), p, on,
                           generator)
