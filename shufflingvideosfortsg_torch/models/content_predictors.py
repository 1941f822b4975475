"""The content-predictor span heads.

Counterpart of ``shufflingvideosfortsg_tpu/models/content_predictors.py``
(the reference's ``SpanPredictor.py:274-438``): heads that give a
per-frame content distribution beside the start and end ones, and the
start-conditioned end predictor, with its teacher-forced ``forward`` and
its ``inference`` from the predicted start. No config key builds them,
in JAX or here. Every BiLSTM is ``ops/rnn.BiLSTM`` under the reference's
``<name>.lstm.*`` keys: K1 without gradients, K3 and K4 with them, on a
card. The dense layers run through ``ops/dense.py`` at JAX's ``dtype``;
each distribution is a softmax over t of f32 logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.dense import linear
from .components import _mlp_head, _rnn_cell

F32 = torch.float32
_HEADS = ('start', 'end', 'content')


def _softmax_t(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=1)


class _ThreeMLPHeads(nn.Module):
    """``{start,end,content}_mlp_{1,2}``: a tanh-MLP head a distribution."""

    def _add_heads(self, in_dim: int, hidden_dim: int) -> None:
        for head in _HEADS:
            setattr(self, f'{head}_mlp_1', nn.Linear(in_dim, hidden_dim))
            setattr(self, f'{head}_mlp_2', nn.Linear(hidden_dim, 1))

    def _heads(self, feat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(_softmax_t(_mlp_head(getattr(self, f'{h}_mlp_1'),
                                          getattr(self, f'{h}_mlp_2'), feat,
                                          self.dtype)) for h in _HEADS)


class MLPContentPredictor(_ThreeMLPHeads):
    """Three tanh-MLP heads over the features (``:28-43``): start, end and
    content probabilities [B, T] f32."""

    def __init__(self, in_dim: int, hidden_dim: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self._add_heads(in_dim, hidden_dim)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self._heads(feat)


class TiedLSTMContentPredictor(_ThreeMLPHeads):
    """One BiLSTM (``cross_lstm``) shared by the three MLP heads
    (``:46-65``)."""

    def __init__(self, in_dim: int, lstm_hidden_dim: int, mlp_hidden_dim: int,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.cross_lstm = _rnn_cell(in_dim, lstm_hidden_dim, 1, dropout, dtype)
        self._add_heads(2 * lstm_hidden_dim, mlp_hidden_dim)

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        return self._heads(self.cross_lstm['lstm'](feat, generator)[0])


class ConditionalLSTMContentPredictor(nn.Module):
    """``start_lstm`` over the features; ``end_lstm`` and ``content_lstm``
    over its output; one linear layer each (``start_fc``, ``end_fc``,
    ``content_fc``) (``:68-93``)."""

    def __init__(self, in_dim: int, lstm_hidden_dim: int, dropout: float,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        H2 = 2 * lstm_hidden_dim
        self.start_lstm = _rnn_cell(in_dim, lstm_hidden_dim, 1, dropout, dtype)
        self.end_lstm = _rnn_cell(H2, lstm_hidden_dim, 1, dropout, dtype)
        self.content_lstm = _rnn_cell(H2, lstm_hidden_dim, 1, dropout, dtype)
        self.start_fc = nn.Linear(H2, 1)
        self.end_fc = nn.Linear(H2, 1)
        self.content_fc = nn.Linear(H2, 1)

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, ...]:
        start_feat = self.start_lstm['lstm'](feat, generator)[0]
        end_feat = self.end_lstm['lstm'](start_feat, generator)[0]
        content_feat = self.content_lstm['lstm'](start_feat, generator)[0]
        return tuple(_softmax_t(linear(fc, f, self.dtype)[..., 0])
                     for fc, f in ((self.start_fc, start_feat),
                                   (self.end_fc, end_feat),
                                   (self.content_fc, content_feat)))


class StartConditionedPredictor(nn.Module):
    """End prediction conditioned on a start position (``:96-138``): the
    start frame's features tiled over t and concatenated to the features,
    through a 2-layer ``end_lstm`` and the end MLP. :meth:`forward` takes
    the start from the caller (teacher forcing, in training);
    :meth:`inference` takes the argmax of the start probabilities and
    runs without dropout, as JAX's does."""

    def __init__(self, in_dim: int, hidden_dim: int, lstm_hidden_dim: int,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.start_mlp_1 = nn.Linear(in_dim, hidden_dim)
        self.start_mlp_2 = nn.Linear(hidden_dim, 1)
        self.end_lstm = _rnn_cell(2 * in_dim, lstm_hidden_dim, 2, dropout,
                                  dtype)
        self.end_mlp_1 = nn.Linear(2 * lstm_hidden_dim, hidden_dim)
        self.end_mlp_2 = nn.Linear(hidden_dim, 1)

    def _start_prob(self, video_feat: torch.Tensor) -> torch.Tensor:
        return _softmax_t(_mlp_head(self.start_mlp_1, self.start_mlp_2,
                                    video_feat, self.dtype))

    def _end_prob(self, video_feat: torch.Tensor, start_idx: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        B, T, D = video_feat.shape
        cond = torch.gather(video_feat, 1, start_idx.long()[:, None, None]
                            .expand(B, 1, D)).expand(B, T, D)
        end_feat = self.end_lstm['lstm'](torch.cat([video_feat, cond], -1),
                                         generator)[0]
        return _softmax_t(_mlp_head(self.end_mlp_1, self.end_mlp_2, end_feat,
                                    self.dtype))

    def forward(self, video_feat: torch.Tensor,
                start_timestamp: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._start_prob(video_feat),
                self._end_prob(video_feat, start_timestamp, generator))

    def inference(self, video_feat: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        start_prob = self._start_prob(video_feat)
        lstm = self.end_lstm['lstm']
        training = lstm.training
        lstm.train(False)  # JAX's deterministic=True
        try:
            end_prob = self._end_prob(video_feat,
                                      torch.argmax(start_prob, dim=1), None)
        finally:
            lstm.train(training)
        return start_prob, end_prob
