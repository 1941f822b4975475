"""Model components of GMD.

Counterpart of ``shufflingvideosfortsg_tpu/models/components.py``
(``:35-351`` and ``:561-630``): only the classes GMD runs, with
submodules named so that ``state_dict()`` keys equal the reference torch
keys (``rnn_cell.lstm.*``, ``attention.{W_s,W_a,w}``, ``predict.predict.{0,2}``,
``foreback_context.0`` ...). ``TDense`` is ``nn.Linear`` with torch's
default init; LayerNorm is ``nn.LayerNorm`` (eps 1e-5). The other span
predictors, video encoders, CSMM temporal models and CMI modes arrive with
the variants slice and raise here. Dropout masks come from the
``generator`` a forward is given (``ops/rnn.py::dropout``).

Every module takes the compute ``dtype`` of the JAX modules (f32, or bf16
at ``precision: bf16``); the parameters stay f32. The dense layers and
LayerNorm run through ``ops/dense.py`` (JAX's ``TDense`` and
``LayerNorm``), the element-wise operations on tensors of that dtype,
each result rounded, as XLA rounds them with excess precision off; the
span heads' softmax takes f32 logits (``:328-336``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.dense import layer_norm, linear
from ..ops.losses import mask_logits
from ..ops.rnn import BiLSTM, dropout
from ..ops.scdm_fused import (scdm_attention_fused,
                              scdm_attention_fused_trainable)


F32 = torch.float32


def _rnn_cell(input_size: int, hidden: int, layers: int, dropout: float,
              dtype: torch.dtype) -> nn.ModuleDict:
    """The reference's ``rnn_cell`` holder: keys ``rnn_cell.lstm.*``."""
    return nn.ModuleDict({'lstm': BiLSTM(input_size, hidden, layers, dropout,
                                         dtype)})


class SentenceRNNEncoder(nn.Module):
    """Linear word embed + BiLSTM over all N word slots (``sent_mask`` is
    ignored, as in the reference); the sentence embedding is the last
    layer's final forward and backward states, concatenated."""

    def __init__(self, word_dim: int, hidden_dim: int, n_layers: int,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.textual_dim = 2 * hidden_dim
        self.word_embed = nn.Linear(word_dim, word_dim)
        self.rnn_cell = _rnn_cell(word_dim, hidden_dim, n_layers, dropout,
                                  dtype)

    def forward(self, query_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        word_encoding, hn, _ = self.rnn_cell['lstm'](
            linear(self.word_embed, query_feat, self.dtype), generator)
        return word_encoding, torch.cat([hn[-2], hn[-1]], dim=-1)


class SCDMAttention(nn.Module):
    """Additive word attention giving per-frame text context [B, T, Ds],
    through the K2 kernel (``ops/scdm_fused.py``), or K5 (K2 with a
    backward) when gradients are on."""

    def __init__(self, video_dim: int, sent_dim: int, hidden_dim: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.W_s = nn.Linear(sent_dim, hidden_dim, bias=False)
        self.W_a = nn.Linear(video_dim, hidden_dim)
        self.w = nn.Linear(hidden_dim, 1, bias=False)

    def project_video(self, video_feat: torch.Tensor) -> torch.Tensor:
        """``W_a`` of the video features, in the compute dtype."""
        return linear(self.W_a, video_feat, self.dtype)

    def forward(self, video_feat: torch.Tensor, sent_feat: torch.Tensor,
                video_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``video_proj`` is :meth:`project_video` of ``video_feat`` when
        the caller has it (serving projects one video once and expands it
        over the queries); otherwise it is computed here. ``sent_feat``
        (the word encodings) is already in the compute dtype."""
        sent_feat = sent_feat.contiguous()
        fn = (scdm_attention_fused_trainable if torch.is_grad_enabled()
              else scdm_attention_fused)
        if video_proj is None:
            video_proj = self.project_video(video_feat)
        return fn(video_proj.contiguous(),
                  linear(self.W_s, sent_feat, self.dtype).contiguous(),
                  self.w.weight[0].to(self.dtype), sent_feat)


_GATES = {'sigmoid': torch.sigmoid, 'relu': torch.relu, 'tanh': torch.tanh}


class RNNRecalibrationLayer(nn.Module):
    """One QAVE block: BiLSTM -> SCDM context -> channel gate. Split into
    ``run_rnn``/``apply_gate`` because the query-independent recurrence
    can run once per video for many queries (the serving slice)."""

    def __init__(self, input_dim: int, hidden_dim: int, n_layers: int,
                 sent_dim: int, ca_activ: str, dropout: float,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.ca_activ = ca_activ
        self.rnn_cell = _rnn_cell(input_dim, hidden_dim, n_layers, dropout,
                                  dtype)
        self.attention = SCDMAttention(2 * hidden_dim, sent_dim,
                                       2 * hidden_dim, dtype)
        self.sent_linear = nn.Linear(sent_dim, 2 * hidden_dim)

    def run_rnn(self, video_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.rnn_cell['lstm'](video_feat, generator)[0]

    def apply_gate(self, rnn_output: torch.Tensor, word_feat: torch.Tensor,
                   video_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
        channel_attn = linear(self.sent_linear,
                              self.attention(rnn_output, word_feat,
                                             video_proj), self.dtype)
        gate = _GATES.get(self.ca_activ)
        if gate is not None:
            channel_attn = gate(channel_attn)
        # an int8 bank's rows arrive f32: their product with the gate is
        # f32, as JAX promotes it, and the next block casts it
        return rnn_output * channel_attn

    def forward(self, video_feat: torch.Tensor, word_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.apply_gate(self.run_rnn(video_feat, generator), word_feat)


class QueryAwareEncoder(nn.Module):
    """QAVE: a stack of recalibration blocks and a final LayerNorm."""

    def __init__(self, input_dim: int, hidden_dim: int, n_layers: int,
                 nblocks: int, sent_dim: int, dropout: float,
                 ca_activ: str = 'sigmoid', dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.visual_dim = 2 * hidden_dim
        self.blocks = nn.ModuleList(
            RNNRecalibrationLayer(input_dim if i == 0 else 2 * hidden_dim,
                                  hidden_dim, n_layers, sent_dim, ca_activ,
                                  dropout, dtype)
            for i in range(nblocks))
        self.norm = nn.LayerNorm(2 * hidden_dim, eps=1e-5)

    def forward(self, video_feat: torch.Tensor, word_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        residual = video_feat
        for block in self.blocks:
            residual = block(residual, word_feat, generator)
        return layer_norm(self.norm, residual, self.dtype)

    def block0_rnn(self, video_feat: torch.Tensor) -> torch.Tensor:
        """The query-independent block-0 recurrence of resident [V, T, D]
        video(s): computed once a video, reused by every query batch."""
        return self.blocks[0].run_rnn(video_feat)

    def finish_from_rnn0(self, rnn0: torch.Tensor, word_feat: torch.Tensor,
                         video_proj: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """The query-dependent rest, given each query's block-0
        recurrence rnn0 [Q, T, 2H] (gathered from a bank, or one video's
        expanded over Q) and, optionally, its SCDM projection
        ``W_a(rnn0)``: block 0's gate, the later blocks, the norm."""
        residual = self.blocks[0].apply_gate(rnn0, word_feat, video_proj)
        for block in self.blocks[1:]:
            residual = block(residual, word_feat)
        return layer_norm(self.norm, residual, self.dtype)

    def shared_video_from_rnn0(self, rnn0: torch.Tensor,
                               word_feat: torch.Tensor) -> torch.Tensor:
        """:meth:`finish_from_rnn0` for one video's rnn0 [1, T, 2H] against
        Q queries: block 0's SCDM projection of the video runs once, and
        the recurrence and projection are expanded over Q, not copied;
        block 0's gate writes the [Q, T, 2H] product once."""
        Q = word_feat.shape[0]
        video_proj = self.blocks[0].attention.project_video(rnn0)
        return self.finish_from_rnn0(rnn0.expand(Q, -1, -1), word_feat,
                                     video_proj.expand(Q, -1, -1))


def _check_cmi(name: str) -> None:
    if name.lower() not in ('videosentconcat', 'vs', 'b'):
        raise NotImplementedError(f'cross-modal interaction {name!r} is not '
                                  'ported yet (only "vs")')


def cmi_dim(name: str, video_dim: int, sent_dim: int) -> int:
    _check_cmi(name)
    return video_dim + sent_dim


def cmi_apply(name: str, video_feat: torch.Tensor, word_feat: torch.Tensor,
              sent_feat: torch.Tensor) -> torch.Tensor:
    """'vs': the sentence embedding tiled over time, after the video."""
    _check_cmi(name)
    B, T, _ = video_feat.shape
    tiled = sent_feat[:, None, :].expand(B, T, sent_feat.shape[-1])
    return torch.cat([video_feat, tiled], dim=-1)


def _finalize(start_logits: torch.Tensor, end_logits: torch.Tensor,
              v_mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if v_mask is not None:
        start_logits = mask_logits(start_logits, v_mask)
        end_logits = mask_logits(end_logits, v_mask)
    return (torch.softmax(start_logits.float(), dim=1),
            torch.softmax(end_logits.float(), dim=1))


class MLPPredictor(nn.Module):
    """Two tanh-MLP heads over the fused features (the default predictor)."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.start_mlp_1 = nn.Linear(in_dim, hidden_dim)
        self.start_mlp_2 = nn.Linear(hidden_dim, 1)
        self.end_mlp_1 = nn.Linear(in_dim, hidden_dim)
        self.end_mlp_2 = nn.Linear(hidden_dim, 1)

    def _head(self, first: nn.Linear, second: nn.Linear,
              feat: torch.Tensor) -> torch.Tensor:
        hidden = torch.tanh(linear(first, feat, self.dtype))
        return linear(second, hidden, self.dtype)[..., 0]

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _finalize(self._head(self.start_mlp_1, self.start_mlp_2, feat),
                         self._head(self.end_mlp_1, self.end_mlp_2, feat),
                         v_mask)


class SpanPredictorBoundary(nn.Module):
    """Name-dispatching holder (keys ``span_predictor.predictor.*``)."""

    def __init__(self, predictor_name: str, in_dim: int, mlp_hidden_dim: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        if predictor_name not in ('mlp', 'a'):
            raise NotImplementedError(f'span predictor {predictor_name!r} is '
                                      'not ported yet (only "mlp")')
        self.predictor = MLPPredictor(in_dim, mlp_hidden_dim, dtype)

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.predictor(feat, v_mask)


_ACTIVATIONS = {'tanh': nn.Tanh, 'sigmoid': nn.Sigmoid}


class VideoTextSemanticMatch(nn.Module):
    """CSMM: video ‖ tiled sentence -> 2-layer MLP -> per-frame match
    logit (the raw ``predict_2`` output, no sigmoid)."""

    def __init__(self, video_dim: int, sent_dim: int, temporal_name: str,
                 predict_hidden: int, predict_activation: str,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        if temporal_name.lower() != 'none':
            raise NotImplementedError(f'CSMM temporal {temporal_name!r} is '
                                      'not ported yet (only "none")')
        act = _ACTIVATIONS.get(predict_activation.lower(), nn.ReLU)
        self.predict = nn.ModuleDict({'predict': nn.Sequential(
            nn.Linear(video_dim + sent_dim, predict_hidden), act(),
            nn.Linear(predict_hidden, 1))})

    def forward(self, video_feat: torch.Tensor, query_feat: torch.Tensor,
                video_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, _ = video_feat.shape
        q = (query_feat[:, None, :] if query_feat.dim() == 2 else query_feat)
        cross_feat = torch.cat(
            [video_feat, q.expand(B, T, query_feat.shape[-1])], dim=-1)
        first, act, second = self.predict['predict']
        hidden = act(linear(first, cross_feat, self.dtype))
        return linear(second, hidden, self.dtype)[..., 0], cross_feat


class MomentPoolingTOD(nn.Module):
    """Temporal-order discriminator (TemporalOrderDiscriminator.py:15-45):
    masked mean-pools of the target, fore and back regions, one
    ``foreback_context`` layer shared by fore and back, dropout, then a
    2-way original-vs-pseudo classifier. ``dropout`` is the reference's
    hard-coded 0.5 unless a config's ``disc_dropout`` says otherwise."""

    def __init__(self, visual_dim: int, dropout: float = 0.5,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.foreback_context = nn.Sequential(
            nn.Linear(2 * visual_dim, visual_dim))
        self.fc_classifier_domain_video = nn.Sequential(
            nn.Linear(3 * visual_dim, 2))

    @staticmethod
    def average_mask(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.to(feat.dtype)
        return ((feat * m[..., None]).sum(dim=1)
                / (m.sum(dim=1, keepdim=True) + 1e-6))

    def forward(self, feat: torch.Tensor, target_mask: torch.Tensor,
                fore_mask: torch.Tensor, back_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        target = self.average_mask(feat, target_mask)
        fore = self.average_mask(feat, fore_mask)
        back = self.average_mask(feat, back_mask)
        foreback = self.foreback_context[0]
        fore_feat = torch.relu(linear(foreback, torch.cat([fore, target], -1),
                                      self.dtype))
        back_feat = torch.relu(linear(foreback, torch.cat([target, back], -1),
                                      self.dtype))
        concat = torch.cat([target, fore_feat, back_feat], dim=-1)
        concat = dropout(concat, self.dropout, self.training, generator)
        return linear(self.fc_classifier_domain_video[0], concat, self.dtype)
