"""GMD: the shuffling-framework grounding model.

Counterpart of ``shufflingvideosfortsg_tpu/models/gmd.py`` (``:25-83``
construction, ``:85-177`` the pair forward, ``:179-195`` ``eval_forward``,
``:197-294`` serving over a cached block-0 recurrence, or with the RNN
video encoder over the video itself).
The raw and pseudo videos run through the shared video encoder and CSMM
as one [2B] batch. Dropout follows ``self.training``, with masks from the
generator a forward is given. Submodules carry the
reference torch names, so ``state_dict()`` keys equal the keys that
``utils/torch_interop.convert_to_reference_state_dict`` writes and a
reference ``.ckp`` loads strictly. ``dtype`` is the compute dtype of
every submodule (bf16 at ``precision: bf16``); the weights stay f32 and
the start/end probabilities are f32 at either.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .components import (MomentPoolingTOD, QueryAwareEncoder,
                         SentenceRNNEncoder, SpanPredictorBoundary,
                         VideoTextSemanticMatch, cmi_apply, cmi_dim,
                         video_encoder)

class GMD(nn.Module):
    def __init__(self, video_feature_dim: int = 1024, word_dim: int = 300,
                 sent_hidden: int = 256, sent_layers: int = 2,
                 video_encoder_name: str = 'query_aware_encoder',
                 video_hidden: int = 256, video_layers: int = 2,
                 nblocks: int = 2, cross_name: str = 'vs',
                 predictor_name: str = 'mlp', mlp_hidden_dim: int = 256,
                 span_hidden_dim: int = 128, video_if_mask: bool = False,
                 m_temp: str = 'none', m_temp_hidden: int = 256,
                 m_temp_layers: int = 2, m_pred_hidden: int = 1024,
                 m_pred_activ: str = 'relu', dropout: float = 0.5,
                 disc_dropout: float = 0.5, pseudo_ground: bool = False,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross_name = cross_name
        self.video_if_mask = video_if_mask
        # beyond the reference: also ground the pseudo stream through the
        # shared span predictor, for the loss_pseudo_ground_lambda term
        self.pseudo_ground = pseudo_ground
        sent_dim = 2 * sent_hidden
        visual_dim = 2 * video_hidden
        self.dtype = dtype
        self.sentence_encoder = SentenceRNNEncoder(word_dim, sent_hidden,
                                                   sent_layers, dropout, dtype)
        self.video_encoder = video_encoder(
            video_encoder_name, video_feature_dim, video_hidden, video_layers,
            nblocks, sent_dim, dropout, dtype, remat)
        self.span_predictor = SpanPredictorBoundary(
            predictor_name, cmi_dim(cross_name, visual_dim, sent_dim),
            mlp_hidden_dim, span_hidden_dim, dropout, dtype=dtype)
        self.csmm = VideoTextSemanticMatch(
            visual_dim, sent_dim, m_temp, m_pred_hidden, m_pred_activ, dtype,
            m_temp_hidden, m_temp_layers, dropout)
        self.tod = MomentPoolingTOD(visual_dim, disc_dropout, dtype)

    def forward(self, query_feat: torch.Tensor, query_mask: torch.Tensor,
                ori_video_feat: torch.Tensor, ori_video_mask: torch.Tensor,
                pseudo_video_feat: torch.Tensor,
                pseudo_video_mask: torch.Tensor,
                ori_temporal_mask: torch.Tensor, ori_fore_mask: torch.Tensor,
                ori_back_mask: torch.Tensor,
                pseudo_temporal_mask: torch.Tensor,
                pseudo_fore_mask: torch.Tensor,
                pseudo_back_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The training pair forward (SpanGroundMatchDisc.py:60-100).
        ``query_mask`` is accepted and unused, as in the reference."""
        word_feat, sent_embed = self.encode_query(query_feat, generator)
        both_video = torch.cat([ori_video_feat, pseudo_video_feat], dim=0)
        both_words = torch.cat([word_feat, word_feat], dim=0)
        both_frame_feat = self.video_encoder(both_video, both_words, generator)
        return self.forward_from_frames(
            word_feat, sent_embed, both_frame_feat, ori_video_mask,
            pseudo_video_mask, ori_temporal_mask, ori_fore_mask,
            ori_back_mask, pseudo_temporal_mask, pseudo_fore_mask,
            pseudo_back_mask, generator)

    def encode_query(self, query_feat: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
        """The sentence-encoder half of the pair forward: (word features
        [B, N, 2Hs], sentence embedding [B, 2Hs])."""
        return self.sentence_encoder(query_feat, generator)

    def forward_from_frames(self, word_feat: torch.Tensor,
                            sent_embed: torch.Tensor,
                            both_frame_feat: torch.Tensor,
                            ori_video_mask: torch.Tensor,
                            pseudo_video_mask: torch.Tensor,
                            ori_temporal_mask: torch.Tensor,
                            ori_fore_mask: torch.Tensor,
                            ori_back_mask: torch.Tensor,
                            pseudo_temporal_mask: torch.Tensor,
                            pseudo_fore_mask: torch.Tensor,
                            pseudo_back_mask: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
        """Everything after the shared video encoder: CSMM on both
        streams, match-gated span prediction on the raw one, the TOD on
        both. ``both_frame_feat`` is the [2B, T, 2H] raw‖pseudo encoder
        output."""
        B = word_feat.shape[0]
        ori_frame_feat = both_frame_feat[:B]
        pseudo_frame_feat = both_frame_feat[B:]
        ori_cross_feat = cmi_apply(self.cross_name, ori_frame_feat,
                                   word_feat, sent_embed)
        both_match_prob, _ = self.csmm(
            both_frame_feat, torch.cat([sent_embed, sent_embed], dim=0),
            torch.cat([ori_video_mask, pseudo_video_mask], dim=0), generator)
        ori_match_prob = both_match_prob[:B]
        pseudo_match_prob = both_match_prob[B:]
        start_prob, end_prob = self.span_predictor(
            ori_match_prob[:, :, None] * ori_cross_feat,
            v_mask=ori_video_mask if self.video_if_mask else None)
        both_disc = self.tod(
            both_frame_feat,
            torch.cat([ori_temporal_mask, pseudo_temporal_mask], dim=0),
            torch.cat([ori_fore_mask, pseudo_fore_mask], dim=0),
            torch.cat([ori_back_mask, pseudo_back_mask], dim=0), generator)
        out = {'start_prob': start_prob, 'end_prob': end_prob,
               'ori_match_prob': ori_match_prob,
               'pseudo_match_prob': pseudo_match_prob,
               'ori_disc_prob': both_disc[:B],
               'pseudo_disc_prob': both_disc[B:]}
        if self.pseudo_ground:
            pseudo_cross_feat = cmi_apply(self.cross_name, pseudo_frame_feat,
                                          word_feat, sent_embed)
            out['pseudo_start_prob'], out['pseudo_end_prob'] = \
                self.span_predictor(
                    pseudo_match_prob[:, :, None] * pseudo_cross_feat,
                    v_mask=pseudo_video_mask if self.video_if_mask else None)
        return out

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
        return self._ground(frame_feat, word_feat, sent_embed, video_mask)

    def _ground(self, frame_feat: torch.Tensor, word_feat: torch.Tensor,
                sent_embed: torch.Tensor,
                video_mask: Optional[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Everything after the video encoder at inference: the cross
        features, the CSMM gate and the span heads."""
        cross_feat = cmi_apply(self.cross_name, frame_feat, word_feat,
                               sent_embed)
        match_prob, _ = self.csmm(frame_feat, sent_embed, video_mask)
        start_prob, end_prob = self.span_predictor(
            match_prob[:, :, None] * cross_feat,
            v_mask=video_mask if self.video_if_mask else None)
        return {'start_prob': start_prob, 'end_prob': end_prob,
                'match_prob': match_prob}

    # -- serving (JAX ``models/gmd.py:197-294``) ----------------------------
    def _cached(self) -> bool:
        """Whether the video encoder has a query-independent block 0 to
        cache (QAVE); the RNN encoder is run whole on each query's video."""
        return isinstance(self.video_encoder, QueryAwareEncoder)

    def precompute_video(self, video_feat: torch.Tensor) -> torch.Tensor:
        """The query-independent part of resident [V, T, D] video(s): QAVE's
        block-0 recurrence [V, T, 2H], or the features themselves where the
        encoder has no such part. V=1 for one video, any V for a bank."""
        if self._cached():
            return self.video_encoder.block0_rnn(video_feat)
        return video_feat

    def serve_cached_multi(self, rnn0_bank: torch.Tensor,
                           query_feat: torch.Tensor,
                           video_ids: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        """Query i against bank video ``video_ids[i]`` of a bank of
        :meth:`precompute_video` rows [V, T, ...]."""
        return self.serve_gathered(rnn0_bank[video_ids], query_feat)

    def serve_gathered(self, rnn0_q: torch.Tensor, query_feat: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        """:meth:`serve_cached_multi` with the rows already gathered (the
        int8 bank gathers and dequantises them first)."""
        word_feat, sent_embed = self.sentence_encoder(query_feat)
        if self._cached():
            frame_feat = self.video_encoder.finish_from_rnn0(rnn0_q,
                                                             word_feat)
        else:
            frame_feat = self.video_encoder(rnn0_q, word_feat)
        return self._ground(frame_feat, word_feat, sent_embed, None)

    def serve_cached(self, rnn0: torch.Tensor, query_feat: torch.Tensor,
                     video_mask: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
        """Q queries against one video whose :meth:`precompute_video` row
        [1, T, ...] is ``rnn0``."""
        Q = query_feat.shape[0]
        word_feat, sent_embed = self.sentence_encoder(query_feat)
        if self._cached():
            frame_feat = self.video_encoder.shared_video_from_rnn0(rnn0,
                                                                   word_feat)
        else:
            frame_feat = self.video_encoder(rnn0.expand(Q, -1, -1),
                                            word_feat)
        vmask = None
        if video_mask is not None:
            vmask = video_mask.expand(Q, video_mask.shape[-1])
        return self._ground(frame_feat, word_feat, sent_embed, vmask)

    def serve_multi_query(self, video_feat: torch.Tensor,
                          query_feat: torch.Tensor,
                          video_mask: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
        """Q sentences [Q, N, 300] against one video [1, T, D]: QAVE's
        block-0 recurrence runs once for the video, the rest over Q."""
        return self.serve_cached(self.precompute_video(video_feat),
                                 query_feat, video_mask)
