"""GMD: the shuffling-framework grounding model, evaluation path.

Counterpart of ``shufflingvideosfortsg_tpu/models/gmd.py`` (``:25-83``
construction, ``:179-195`` ``eval_forward``). Submodules carry the
reference torch names, so ``state_dict()`` keys equal the keys that
``utils/torch_interop.convert_to_reference_state_dict`` writes and a
reference ``.ckp`` loads strictly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .components import (MomentPoolingTOD, QueryAwareEncoder,
                         SentenceRNNEncoder, SpanPredictorBoundary,
                         VideoTextSemanticMatch, cmi_apply, cmi_dim)


class GMD(nn.Module):
    def __init__(self, video_feature_dim: int = 1024, word_dim: int = 300,
                 sent_hidden: int = 256, sent_layers: int = 2,
                 video_encoder_name: str = 'query_aware_encoder',
                 video_hidden: int = 256, video_layers: int = 2,
                 nblocks: int = 2, cross_name: str = 'vs',
                 predictor_name: str = 'mlp', mlp_hidden_dim: int = 256,
                 video_if_mask: bool = False,
                 m_temp: str = 'none', m_pred_hidden: int = 1024,
                 m_pred_activ: str = 'relu', dropout: float = 0.5):
        super().__init__()
        if video_encoder_name.lower() not in ('query_aware_encoder', 'qae',
                                              'qave'):
            raise NotImplementedError(f'video encoder {video_encoder_name!r} '
                                      'is not ported yet (only QAVE)')
        self.cross_name = cross_name
        self.video_if_mask = video_if_mask
        sent_dim = 2 * sent_hidden
        visual_dim = 2 * video_hidden
        self.sentence_encoder = SentenceRNNEncoder(word_dim, sent_hidden,
                                                   sent_layers, dropout)
        self.video_encoder = QueryAwareEncoder(
            video_feature_dim, video_hidden, video_layers, nblocks, sent_dim,
            dropout)
        self.span_predictor = SpanPredictorBoundary(
            predictor_name, cmi_dim(cross_name, visual_dim, sent_dim),
            mlp_hidden_dim)
        self.csmm = VideoTextSemanticMatch(visual_dim, sent_dim, m_temp,
                                           m_pred_hidden, m_pred_activ)
        self.tod = MomentPoolingTOD(visual_dim)

    def eval_forward(self, video_feat: torch.Tensor, query_feat: torch.Tensor,
                     video_mask: Optional[torch.Tensor] = None,
                     sent_mask: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
        """Single-video inference: {start_prob, end_prob} [B, T] f32 and
        the CSMM ``match_prob`` [B, T]. The match output is the raw
        ``predict_2`` logit and gates the fused features as it is, as the
        reference does. ``sent_mask`` is accepted and unused, as there."""
        word_feat, sent_embed = self.sentence_encoder(query_feat)
        frame_feat = self.video_encoder(video_feat, word_feat)
        cross_feat = cmi_apply(self.cross_name, frame_feat, word_feat,
                               sent_embed)
        match_prob, _ = self.csmm(frame_feat, sent_embed, video_mask)
        start_prob, end_prob = self.span_predictor(
            match_prob[:, :, None] * cross_feat,
            v_mask=video_mask if self.video_if_mask else None)
        return {'start_prob': start_prob, 'end_prob': end_prob,
                'match_prob': match_prob}
