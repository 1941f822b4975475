"""The QAVE baseline: sentence encoder, video encoder (QAVE, or the RNN
encoder), the cross-modal features and the span predictor, trained on
the grounding loss alone (no CSMM gate, no discriminator).

Counterpart of ``shufflingvideosfortsg_tpu/models/baseline.py:16-64``
(reference: grounding/model/Baseline.py). Submodules carry the reference
torch names, so ``state_dict()`` keys equal those that
``utils/torch_interop.convert_to_reference_state_dict(kind='baseline')``
writes and a reference ``.ckp`` loads strictly. Dropout follows
``self.training``, with masks from the generator a forward is given.
``dtype`` is the compute dtype, as GMD's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .components import (SentenceRNNEncoder, SpanPredictorBoundary,
                         cmi_apply, cmi_dim, video_encoder)


class Baseline(nn.Module):
    def __init__(self, video_feature_dim: int = 1024, word_dim: int = 300,
                 sent_hidden: int = 256, sent_layers: int = 2,
                 video_encoder_name: str = 'query_aware_encoder',
                 video_hidden: int = 256, video_layers: int = 2,
                 nblocks: int = 2, cross_name: str = 'vs',
                 predictor_name: str = 'mlp', mlp_hidden_dim: int = 256,
                 span_hidden_dim: int = 128, video_if_mask: bool = False,
                 dropout: float = 0.5, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross_name = cross_name
        self.video_if_mask = video_if_mask
        sent_dim = 2 * sent_hidden
        self.dtype = dtype
        self.sentence_encoder = SentenceRNNEncoder(word_dim, sent_hidden,
                                                   sent_layers, dropout, dtype)
        self.video_encoder = video_encoder(
            video_encoder_name, video_feature_dim, video_hidden, video_layers,
            nblocks, sent_dim, dropout, dtype, remat)
        self.span_predictor = SpanPredictorBoundary(
            predictor_name, cmi_dim(cross_name, 2 * video_hidden, sent_dim),
            mlp_hidden_dim, span_hidden_dim, dropout, dtype=dtype)

    def forward(self, video_feat: torch.Tensor, query_feat: torch.Tensor,
                video_mask: Optional[torch.Tensor] = None,
                query_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """{start_prob, end_prob} [B, T] f32. ``query_mask`` is accepted
        and unused, as in the reference."""
        word_feat, sent_embed = self.sentence_encoder(query_feat, generator)
        frame_feat = self.video_encoder(video_feat, word_feat, generator)
        cross_feat = cmi_apply(self.cross_name, frame_feat, word_feat,
                               sent_embed)
        start_prob, end_prob = self.span_predictor(
            cross_feat, v_mask=video_mask if self.video_if_mask else None)
        return {'start_prob': start_prob, 'end_prob': end_prob}

    # the reference's eval_forward is forward for the baseline
    eval_forward = forward
