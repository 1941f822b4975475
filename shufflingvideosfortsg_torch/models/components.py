"""Model components of GMD and the QAVE baseline.

Counterpart of ``shufflingvideosfortsg_tpu/models/components.py``
(``:35-630``): every class and option a config key selects, with
submodules named so that ``state_dict()`` keys equal the reference torch
keys (``rnn_cell.lstm.*``, ``attention.{W_s,W_a,w}``, ``predict.predict.{0,2}``,
``foreback_context.0``, ``cross_lstm.lstm.*``, ``start_lstm.lstm.*``,
``csmm.temporal.lstm.lstm.*`` ...). The reference defines no keys for
the RNN video encoder, the conv and the self-attention predictors; theirs
follow the JAX tree (``utils/interop.py``). ``TDense`` is ``nn.Linear``
with torch's default init; LayerNorm is ``nn.LayerNorm`` (eps 1e-5).
Dropout masks come from the ``generator`` a forward is given
(``ops/rnn.py::dropout``).

Every module takes the compute ``dtype`` of the JAX modules (f32, or bf16
at ``precision: bf16``); the parameters stay f32. The dense layers and
LayerNorm run through ``ops/dense.py`` (JAX's ``TDense`` and
``LayerNorm``), the element-wise operations on tensors of that dtype,
each result rounded, as XLA rounds them with excess precision off; the
span heads' softmax takes f32 logits (``:328-336``). Every BiLSTM,
the span predictors' included (JAX runs those through ``lax.scan``, the
same function), is ``ops/rnn.BiLSTM``: K1 without gradients, K3 and K4
with them, on a card. The modules no config key reaches are beside this
one: ``transformer.py``, ``graph.py`` and ``content_predictors.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention, positional_encodings_like
from ..ops.dense import dense, layer_norm, linear
from ..ops.losses import mask_logits
from ..ops.rnn import BiLSTM, dropout
from ..ops.scdm_fused import (scdm_attention_fused,
                              scdm_attention_fused_trainable)


F32 = torch.float32


def _rnn_cell(input_size: int, hidden: int, layers: int, dropout: float,
              dtype: torch.dtype) -> nn.ModuleDict:
    """A BiLSTM under the reference's ``<holder>.lstm.*`` keys (``rnn_cell``,
    ``cross_lstm``, ``start_lstm`` ...)."""
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


class VideoRNNEncoder(nn.Module):
    """The query-independent video encoder (``:118-137``): a BiLSTM and a
    LayerNorm, keys ``rnn_cell.lstm.*`` and ``norm``. ``word_feat`` is
    accepted and unused, so the encoder is called as QAVE is."""

    def __init__(self, input_dim: int, hidden_dim: int, n_layers: int,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.visual_dim = 2 * hidden_dim
        self.rnn_cell = _rnn_cell(input_dim, hidden_dim, n_layers, dropout,
                                  dtype)
        self.norm = nn.LayerNorm(2 * hidden_dim, eps=1e-5)

    def forward(self, video_feat: torch.Tensor,
                word_feat: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        encoding = self.rnn_cell['lstm'](video_feat, generator)[0]
        return layer_norm(self.norm, encoding, self.dtype)


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
                generator: Optional[torch.Generator] = None,
                draws: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        return self.rnn_cell['lstm'](video_feat, generator, draws)[0]

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
                generator: Optional[torch.Generator] = None,
                draws: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """``draws``: the dropout masks' uniform draws, made before the
        call (``BiLSTM.dropout_draws``), in place of ``generator``."""
        return self.apply_gate(self.run_rnn(video_feat, generator, draws),
                               word_feat)


class QueryAwareEncoder(nn.Module):
    """QAVE: a stack of recalibration blocks and a final LayerNorm.

    ``remat`` (``:211-239``, JAX's ``nn.remat`` of each block) runs each
    block under ``torch.utils.checkpoint`` (``use_reentrant=False``) when
    gradients are on: the backward recomputes the block (its K3 and K5
    forward launches again) instead of keeping its activations. The
    block's dropout masks are drawn before the checkpointed call, in the
    order of a run without remat, and handed in, so the recompute applies
    the same masks and ``generator`` advances as it would without remat:
    the loss, the gradients and the weights are those of ``remat=False``,
    bit for bit. No RNG state is saved or restored
    (``preserve_rng_state=False``: the block draws nothing itself), so
    the step may be captured in a CUDA graph with its generator
    registered."""

    def __init__(self, input_dim: int, hidden_dim: int, n_layers: int,
                 nblocks: int, sent_dim: int, dropout: float,
                 ca_activ: str = 'sigmoid', dtype: torch.dtype = F32,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
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
            if self.remat and torch.is_grad_enabled():
                draws = block.rnn_cell['lstm'].dropout_draws(
                    residual.shape[0], residual.shape[1], residual.device,
                    generator)
                residual = checkpoint(block, residual, word_feat, None, draws,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
            else:
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


QAVE_NAMES = ('query_aware_encoder', 'qae', 'qave')


def video_encoder(name: str, input_dim: int, hidden: int, layers: int,
                  nblocks: int, sent_dim: int, dropout: float,
                  dtype: torch.dtype, remat: bool) -> nn.Module:
    """QAVE for its names (any case), else the RNN video encoder, as JAX's
    ``setup`` picks (``models/gmd.py:64-83``, ``baseline.py:32-47``);
    ``remat`` applies to QAVE's blocks only."""
    if name.lower() in QAVE_NAMES:
        return QueryAwareEncoder(input_dim, hidden, layers, nblocks, sent_dim,
                                 dropout, dtype=dtype, remat=remat)
    return VideoRNNEncoder(input_dim, hidden, layers, dropout, dtype)


_CMI = {'onlyvideo': 'a', 'a': 'a', 'videosentconcat': 'vs', 'vs': 'vs',
        'b': 'vs', 'tall': 'tall', 'mm': 'tall', 'c': 'tall'}


def _cmi(name: str) -> str:
    try:
        return _CMI[name.lower()]
    except KeyError:
        raise ValueError(f'unknown CMI: {name}') from None


def cmi_dim(name: str, video_dim: int, sent_dim: int) -> int:
    """The width of :func:`cmi_apply`'s features (``:294-304``)."""
    mode = _cmi(name)
    if mode == 'a':
        return video_dim
    if mode == 'vs':
        return video_dim + sent_dim
    if video_dim != sent_dim:
        raise ValueError(f"CMI {name!r} needs equal video and sentence "
                         f"widths, got {video_dim} and {sent_dim}")
    return video_dim * 4


def cmi_apply(name: str, video_feat: torch.Tensor, word_feat: torch.Tensor,
              sent_feat: torch.Tensor) -> torch.Tensor:
    """The cross-modal features (``:307-325``): 'a' the video alone; 'vs'
    the sentence embedding tiled over time, after the video; 'tall' the
    video, the tiled sentence, their product and their sum."""
    mode = _cmi(name)
    if mode == 'a':
        return video_feat
    B, T, _ = video_feat.shape
    tiled = sent_feat[:, None, :].expand(B, T, sent_feat.shape[-1])
    if mode == 'vs':
        return torch.cat([video_feat, tiled], dim=-1)
    return torch.cat([video_feat, tiled, video_feat * tiled,
                      video_feat + tiled], dim=-1)


def _finalize(start_logits: torch.Tensor, end_logits: torch.Tensor,
              v_mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if v_mask is not None:
        start_logits = mask_logits(start_logits, v_mask)
        end_logits = mask_logits(end_logits, v_mask)
    return (torch.softmax(start_logits.float(), dim=1),
            torch.softmax(end_logits.float(), dim=1))


def _mlp_head(first: nn.Linear, second: nn.Linear, feat: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``second(tanh(first(feat)))[..., 0]``: one boundary's logits."""
    hidden = torch.tanh(linear(first, feat, dtype))
    return linear(second, hidden, dtype)[..., 0]


class _MLPHeads(nn.Module):
    """The start and end tanh-MLP heads (``start_mlp_{1,2}``,
    ``end_mlp_{1,2}``) of the MLP and the LSTM predictors, registered
    after the predictor's BiLSTMs, as the reference orders its keys."""

    def _add_heads(self, in_dim: int, hidden_dim: int) -> None:
        self.start_mlp_1 = nn.Linear(in_dim, hidden_dim)
        self.start_mlp_2 = nn.Linear(hidden_dim, 1)
        self.end_mlp_1 = nn.Linear(in_dim, hidden_dim)
        self.end_mlp_2 = nn.Linear(hidden_dim, 1)

    def heads(self, start_feat: torch.Tensor, end_feat: torch.Tensor,
              v_mask: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _finalize(
            _mlp_head(self.start_mlp_1, self.start_mlp_2, start_feat,
                      self.dtype),
            _mlp_head(self.end_mlp_1, self.end_mlp_2, end_feat, self.dtype),
            v_mask)


class MLPPredictor(_MLPHeads):
    """Two tanh-MLP heads over the fused features (the default predictor)."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self._add_heads(in_dim, hidden_dim)

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.heads(feat, feat, v_mask)


class TiedLSTMPredictor(_MLPHeads):
    """One BiLSTM (``cross_lstm``) over the features, then the MLP heads
    (``:400-415``); ``cat`` (``CatTiedLSTMPredictor``, ``:418-434``)
    gives the heads the BiLSTM's output and the features, concatenated."""

    def __init__(self, in_dim: int, lstm_hidden: int, mlp_hidden: int,
                 dropout: float, dtype: torch.dtype = F32, cat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.cat = cat
        self.cross_lstm = _rnn_cell(in_dim, lstm_hidden, 1, dropout, dtype)
        self._add_heads(2 * lstm_hidden + (in_dim if cat else 0), mlp_hidden)

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.cross_lstm['lstm'](feat)[0]
        if self.cat:
            h = torch.cat([h, feat], dim=-1)
        return self.heads(h, h, v_mask)


class ConditionalLSTMPredictor(nn.Module):
    """``start_lstm`` over the features, ``end_lstm`` over its output, one
    linear layer each (``start_fc``, ``end_fc``) (``:437-453``)."""

    def __init__(self, in_dim: int, lstm_hidden: int, dropout: float,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.start_lstm = _rnn_cell(in_dim, lstm_hidden, 1, dropout, dtype)
        self.end_lstm = _rnn_cell(2 * lstm_hidden, lstm_hidden, 1, dropout,
                                  dtype)
        self.start_fc = nn.Linear(2 * lstm_hidden, 1)
        self.end_fc = nn.Linear(2 * lstm_hidden, 1)

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        start_feat = self.start_lstm['lstm'](feat)[0]
        end_feat = self.end_lstm['lstm'](start_feat)[0]
        return _finalize(linear(self.start_fc, start_feat, self.dtype)[..., 0],
                         linear(self.end_fc, end_feat, self.dtype)[..., 0],
                         v_mask)


class CatConditionalLSTMPredictor(_MLPHeads):
    """As :class:`ConditionalLSTMPredictor`, with MLP heads over each
    BiLSTM's output concatenated with the features (``:456-477``)."""

    def __init__(self, in_dim: int, lstm_hidden: int, mlp_hidden: int,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.start_lstm = _rnn_cell(in_dim, lstm_hidden, 1, dropout, dtype)
        self.end_lstm = _rnn_cell(2 * lstm_hidden, lstm_hidden, 1, dropout,
                                  dtype)
        self._add_heads(2 * lstm_hidden + in_dim, mlp_hidden)

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        start_feat = self.start_lstm['lstm'](feat)[0]
        end_feat = self.end_lstm['lstm'](start_feat)[0]
        return self.heads(torch.cat([start_feat, feat], dim=-1),
                          torch.cat([end_feat, feat], dim=-1), v_mask)


def _conv_same(conv: nn.Conv1d, feat: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``nn.Conv`` with SAME padding over [B, T, C] (stride 1, odd
    kernel K): the K zero-padded shifts of the input side by side, one
    [B*T, K*C] @ [K*C, out] product with the bias, through
    :func:`~shufflingvideosfortsg_torch.ops.dense.dense` (JAX's rounding
    points in bf16; in f32 a full-f32 product, where cuDNN's convolution
    would take TF32 by default)."""
    K = conv.kernel_size[0]
    T = feat.shape[1]
    padded = nn.functional.pad(feat.to(dtype), (0, 0, K // 2, K // 2))
    shifts = torch.cat([padded[:, j:j + T] for j in range(K)], dim=-1)
    weight = conv.weight.permute(0, 2, 1).reshape(conv.out_channels, -1)
    return dense(shifts, weight, conv.bias, dtype)


class ConvPredictor(nn.Module):
    """A temporal convolution a boundary (kernel 3, SAME padding,
    ``mlp_hidden_dim`` channels), tanh and a linear layer (``:374-397``).
    The convolutions keep ``nn.Conv1d``'s weight [out, in, K]; flax's
    kernel is [K, in, out]."""

    def __init__(self, in_dim: int, hidden_dim: int, kernel_size: int = 3,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.start_conv = nn.Conv1d(in_dim, hidden_dim, kernel_size)
        self.end_conv = nn.Conv1d(in_dim, hidden_dim, kernel_size)
        self.start_fc = nn.Linear(hidden_dim, 1)
        self.end_fc = nn.Linear(hidden_dim, 1)

    def _head(self, conv: nn.Conv1d, fc: nn.Linear,
              feat: torch.Tensor) -> torch.Tensor:
        hidden = torch.tanh(_conv_same(conv, feat, self.dtype))
        return linear(fc, hidden, self.dtype)[..., 0]

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _finalize(self._head(self.start_conv, self.start_fc, feat),
                         self._head(self.end_conv, self.end_fc, feat), v_mask)


class MultiHead(nn.Module):
    """Multi-head attention (``:464-480``): bias-free ``wq``, ``wk``,
    ``wv`` and ``wo`` onto the query's width D, logits scaled by sqrt(D)
    (``ops/attention.py``), ``causal`` masking as JAX's. ``kv_dim`` is
    the keys' and values' width where it is not D (the cross-attention of
    ``models/transformer.py``). ``dropout`` is accepted and unused, as in
    JAX."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = F32, causal: bool = False,
                 kv_dim: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.n_heads = n_heads
        self.causal = causal
        kv_dim = kv_dim or dim
        for name, d_in in (('wq', dim), ('wk', kv_dim), ('wv', kv_dim),
                           ('wo', dim)):
            setattr(self, name, nn.Linear(d_in, dim, bias=False))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        D = query.shape[-1]
        q = linear(self.wq, query, self.dtype)
        k = linear(self.wk, key, self.dtype)
        v = linear(self.wv, value, self.dtype)
        out = multi_head_attention(q, k, v, self.n_heads, scale_dim=D,
                                   causal=self.causal)
        return linear(self.wo, out, self.dtype)


class SelfAttentionPredictor(nn.Module):
    """A self-attention a boundary over the features and a linear layer
    (``:498-520``). The mask is ignored, as in JAX and the reference
    (``:500-502``)."""

    def __init__(self, in_dim: int, n_heads: int, position_encoding: bool,
                 dropout: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.position_encoding = position_encoding
        self.start_selfattn = MultiHead(in_dim, n_heads, dropout, dtype=dtype)
        self.end_selfattn = MultiHead(in_dim, n_heads, dropout, dtype=dtype)
        self.start_fc = nn.Linear(in_dim, 1)
        self.end_fc = nn.Linear(in_dim, 1)

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.position_encoding:
            feat = feat + positional_encodings_like(feat)[None]
        start_feat = self.start_selfattn(feat, feat, feat)
        end_feat = self.end_selfattn(feat, feat, feat)
        return _finalize(linear(self.start_fc, start_feat, self.dtype)[..., 0],
                         linear(self.end_fc, end_feat, self.dtype)[..., 0],
                         None)


class SpanPredictorBoundary(nn.Module):
    """Name-dispatching holder (``:523-549``; keys
    ``span_predictor.predictor.*``), with JAX's names and aliases;
    ``lstm_hidden_dim`` (``span_hidden_dim``) is the LSTM predictors' H.
    The self-attention has 4 heads and no position encoding, as JAX's
    models build it (no config key sets either)."""

    def __init__(self, predictor_name: str, in_dim: int, mlp_hidden_dim: int,
                 lstm_hidden_dim: int = 128, dropout: float = 0.0,
                 dtype: torch.dtype = F32):
        super().__init__()
        name = predictor_name
        if name in ('mlp', 'a'):
            p = MLPPredictor(in_dim, mlp_hidden_dim, dtype)
        elif name in ('tied_lstm', 'b', 'cat_tied_lstm', 'b2'):
            p = TiedLSTMPredictor(in_dim, lstm_hidden_dim, mlp_hidden_dim,
                                  dropout, dtype,
                                  cat=name in ('cat_tied_lstm', 'b2'))
        elif name in ('condi_lstm', 'c'):
            p = ConditionalLSTMPredictor(in_dim, lstm_hidden_dim, dropout,
                                         dtype)
        elif name in ('cat_condi_lstm', 'c2'):
            p = CatConditionalLSTMPredictor(in_dim, lstm_hidden_dim,
                                            mlp_hidden_dim, dropout, dtype)
        elif name in ('conv', 'e'):
            p = ConvPredictor(in_dim, mlp_hidden_dim, dtype=dtype)
        elif name in ('self_attn', 'd'):
            p = SelfAttentionPredictor(in_dim, 4, False, dropout, dtype)
        else:
            raise ValueError(f'unknown predictor: {name}')
        self.predictor = p

    def forward(self, feat: torch.Tensor,
                v_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.predictor(feat, v_mask)


_ACTIVATIONS = {'tanh': nn.Tanh, 'sigmoid': nn.Sigmoid}


class VideoTextSemanticMatch(nn.Module):
    """CSMM (``:561-599``): video ‖ tiled sentence, with ``temporal_name``
    'lstm' a ``temporal_layers``-deep BiLSTM(``temporal_hidden``) over
    it (keys ``temporal.lstm.lstm.*``), -> 2-layer MLP -> per-frame match
    logit (the raw ``predict_2`` output, no sigmoid). Returns (logits,
    the MLP's input)."""

    def __init__(self, video_dim: int, sent_dim: int, temporal_name: str,
                 predict_hidden: int, predict_activation: str,
                 dtype: torch.dtype = F32, temporal_hidden: int = 256,
                 temporal_layers: int = 2, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        in_dim = video_dim + sent_dim
        if temporal_name.lower() == 'lstm':
            self.temporal = nn.ModuleDict({'lstm': _rnn_cell(
                in_dim, temporal_hidden, temporal_layers, dropout, dtype)})
            in_dim = 2 * temporal_hidden
        else:
            self.temporal = None
        act = _ACTIVATIONS.get(predict_activation.lower(), nn.ReLU)
        self.predict = nn.ModuleDict({'predict': nn.Sequential(
            nn.Linear(in_dim, predict_hidden), act(),
            nn.Linear(predict_hidden, 1))})

    def forward(self, video_feat: torch.Tensor, query_feat: torch.Tensor,
                video_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, _ = video_feat.shape
        q = (query_feat[:, None, :] if query_feat.dim() == 2 else query_feat)
        temporal_feat = torch.cat(
            [video_feat, q.expand(B, T, query_feat.shape[-1])], dim=-1)
        if self.temporal is not None:
            temporal_feat = self.temporal['lstm']['lstm'](temporal_feat,
                                                          generator)[0]
        first, act, second = self.predict['predict']
        hidden = act(linear(first, temporal_feat, self.dtype))
        return linear(second, hidden, self.dtype)[..., 0], temporal_feat


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
