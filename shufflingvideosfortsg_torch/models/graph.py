"""Sentence graph modeling over (subject, relation, object) triplets.

Counterpart of ``shufflingvideosfortsg_tpu/models/graph.py`` (the
reference's ``components/SentenceGraphModeling.py``): word encodings
gathered at triplet indices, relations embedded by a tri-linear message
step (hadamard product or concatenation), the object heads' embeddings
before the relations'. No config key builds it, in JAX or here. The
dense layers run through ``ops/dense.py`` at JAX's ``dtype``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops.dense import linear

F32 = torch.float32


def word_feat_from_idx(sent_feat: torch.Tensor, inds: torch.Tensor
                       ) -> List[torch.Tensor]:
    """Word features [B, N, D] gathered at each index column of inds
    [B, M, K]: K tensors [B, M, D] (JAX's ``take_along_axis``)."""
    D = sent_feat.shape[-1]
    return [torch.gather(sent_feat, 1, inds[:, :, i:i + 1].long().expand(
        -1, -1, D)) for i in range(inds.shape[-1])]


class TriLinear(nn.Module):
    """``r + relu(we(r * o * s))`` with ``connect_type`` 'hadamard
    product', else ``r + relu(we([r, o, s]))``, where r, o, s are ``wr``,
    ``wo``, ``ws`` of the relation, object and subject features."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 connect_type: str = 'hadamard product',
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.hadamard = connect_type == 'hadamard product'
        self.wr = nn.Linear(input_dim, hidden_dim)
        self.wo = nn.Linear(input_dim, hidden_dim)
        self.ws = nn.Linear(input_dim, hidden_dim)
        self.we = nn.Linear(hidden_dim if self.hadamard else 3 * hidden_dim,
                            input_dim)

    def forward(self, rl_feat: torch.Tensor, ob_feat: torch.Tensor,
                sub_feat: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        r = linear(self.wr, rl_feat, dt)
        o = linear(self.wo, ob_feat, dt)
        s = linear(self.ws, sub_feat, dt)
        joint = r * o * s if self.hadamard else torch.cat([r, o, s], dim=-1)
        return r + torch.relu(linear(self.we, joint, dt))


class GraphModelingTriplet(nn.Module):
    """The object heads' features (``obs`` [B, M_o, K], the head word in
    column 0, as the reference's identity span embedding) and the
    triplets' message-passing embeddings (``rls`` [B, M_r, 3]: relation,
    object, subject word), concatenated over M: [B, M_o + M_r, D]."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 rl_connect: str = 'hadamard product',
                 dtype: torch.dtype = F32):
        super().__init__()
        self.message_passing = TriLinear(input_dim, hidden_dim, rl_connect,
                                         dtype)

    def forward(self, word_encoding: torch.Tensor, obs: torch.Tensor,
                rls: torch.Tensor) -> torch.Tensor:
        object_embed = word_feat_from_idx(word_encoding, obs)[0]
        rl_feat, ob_feat, sub_feat = word_feat_from_idx(word_encoding, rls)
        triplet_embed = self.message_passing(rl_feat, ob_feat, sub_feat)
        return torch.cat([object_embed, triplet_embed], dim=1)
