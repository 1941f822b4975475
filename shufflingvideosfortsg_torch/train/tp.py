"""Tensor-parallel GMD training: the width-scaling path.

Counterpart of ``shufflingvideosfortsg_tpu/train/tp.py``
(``qave_tensor_parallel`` ``:43-69``, ``make_tp_forward`` ``:72-107``,
``make_gmd_tp_train_step`` ``:110-119``). Every QAVE block's BiLSTM runs
the hidden-sharded recurrence of ``parallel/tensor_parallel.py`` over
the mesh's model axis; the SCDM gate and the LayerNorm run through the
port's QAVE block (K2 and K5 on a card), replicated over the model axis,
and so do the sentence encoder, CSMM, the TOD and the span heads. The
forward plugs into ``make_gmd_train_step``'s ``forward`` seam and keeps
its loss.

Gradients: the replicated parts compute the same gradients on the n
model ranks, and the backward's collectives keep them alike, so they are
reduced over the data column only (the train state's ``mesh``), never
summed n times. Each rank's gradient of a video recurrence's weights
holds its gate shard's rows; ``reduce_grads`` sums them over the model
axis into the full gradient before the data mean. The state stays
replicated, in the ordinary layout, so checkpoints, the valid pass and
the test drivers are untouched.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.components import QueryAwareEncoder
from ..ops.dense import layer_norm
from ..parallel.mesh import DataMesh, MeshAxis
from ..parallel.tensor_parallel import MODEL_AXIS, bilstm_hidden_sharded
from .state import TrainState
from .steps import make_gmd_train_step


def qave_tensor_parallel(encoder: QueryAwareEncoder,
                         video_feat: torch.Tensor, word_feat: torch.Tensor,
                         axis: MeshAxis,
                         generator: Optional[torch.Generator] = None,
                         dropout: float = 0.0) -> torch.Tensor:
    """QAVE's forward with every block's BiLSTM hidden-sharded over
    ``axis``; block by block as ``QueryAwareEncoder.forward``, drawing its
    dropout masks in the same order."""
    residual = video_feat
    for block in encoder.blocks:
        rnn_out = bilstm_hidden_sharded(block.rnn_cell['lstm'], residual,
                                        axis, generator, dropout)
        residual = block.apply_gate(rnn_out, word_feat)
    return layer_norm(encoder.norm, residual, encoder.dtype)


def _video_rnn_params(model):
    return [p for block in model.video_encoder.blocks
            for p in block.rnn_cell['lstm'].parameters()]


def make_tp_forward(model, axis: MeshAxis, train_dropout: bool = True):
    """A GMD pair forward with the video encoder tensor-parallel over
    ``axis``: ``forward(batch, pseudo, generator)`` -> GMD's output dict,
    ``make_gmd_train_step``'s ``forward`` contract."""
    encoder = model.video_encoder
    if not isinstance(encoder, QueryAwareEncoder):
        raise ValueError('tensor parallelism shards the QAVE video '
                         f'encoder\'s blocks, not {type(encoder).__name__}')
    H = encoder.blocks[0].rnn_cell['lstm'].hidden_size
    if H % axis.size:
        raise ValueError(f'video_rnn_hiddendim={H} must divide the '
                         f'{axis.size}-way {axis.name!r} mesh axis')
    p = encoder.blocks[0].rnn_cell['lstm'].dropout if train_dropout else 0.0

    def forward(batch, pseudo, generator):
        word_feat, sent_embed = model.encode_query(batch['sent_feat'],
                                                   generator)
        both_video = torch.cat([batch['video_feat'], pseudo['video_feat']])
        both_words = torch.cat([word_feat, word_feat])
        both_frame = qave_tensor_parallel(encoder, both_video, both_words,
                                          axis, generator, p)
        return model.forward_from_frames(
            word_feat, sent_embed, both_frame, batch['video_mask'],
            pseudo['video_mask'], batch['temporal_labels'],
            batch['fore_masks'], batch['back_masks'],
            pseudo['temporal_labels'], pseudo['fore_masks'],
            pseudo['back_masks'], generator)

    return forward


def make_gmd_tp_train_step(model, state: TrainState, params: Dict[str, Any],
                           mesh: DataMesh, lg_frame2sec: bool = False,
                           assembler=None, train_dropout: bool = True):
    """The 4-term GMD train step (``make_gmd_train_step``) with the video
    encoder tensor-parallel over ``mesh.inner``, its model axis."""
    axis = mesh.inner
    if axis is None or axis.name != MODEL_AXIS:
        raise ValueError(f'a tensor-parallel step needs a {MODEL_AXIS!r} '
                         'mesh axis (parallel/tensor_parallel.create_tp_mesh)')
    forward = make_tp_forward(model, axis, train_dropout)
    rnn = _video_rnn_params(model)
    return make_gmd_train_step(model, state, params, lg_frame2sec, assembler,
                               forward=forward,
                               reduce_grads=lambda: axis.sum_grads(rnn))
