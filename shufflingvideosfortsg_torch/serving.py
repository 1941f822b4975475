"""Multi-query grounding service: many sentences against resident videos.

Counterpart of ``shufflingvideosfortsg_tpu/serving.py``. A video's first
QAVE block recurrence does not depend on the query, so it is computed once
a video (``GMD.precompute_video``) and kept on the device; each batch of
queries then runs the sentence encoder, block 0's gate, the later blocks
and the heads. Three residencies:

- one video (:meth:`MultiQueryGrounder.set_video`), Q queries against it;
- a bank of videos (:meth:`~MultiQueryGrounder.set_videos`), query i
  against bank row ``video_ids[i]``;
- a whole feature pack (:meth:`~MultiQueryGrounder.set_corpus`), streamed
  through block 0 in chunks into one preallocated tensor, raw (in the
  model's dtype) or int8 with per-(video, frame) f32 scales; queries name
  videos by id.

At ``precision: bf16`` the model runs in bf16 (``models/build.py``): the
cached recurrences are bf16, so the raw tier holds half the f32 bytes,
and the int8 tier quantises them in f32 (JAX ``serving.py:258-269``).
Shipped f16 features and embedded token ids widen to f32 on the device
and the model casts them, as JAX's serve functions do.

Queries ship as sentence features (f32, or f16 with ``serve_query_dtype:
f16``, widened on the device) or as token ids against a resident GloVe
matrix (:meth:`~MultiQueryGrounder.set_vocab`). Each call cuts the queries
into batches of ``query_batch`` (the last padded by repeating its last
row, the padding trimmed), dispatches every batch from pinned host memory
without waiting, and fetches the results after the loop.

A batch runs through module functions of the model and the resident
state (:func:`precompute`, :func:`serve_features`, :func:`serve_tokens`,
:func:`serve_bank`, :func:`serve_bank_tokens`), which ``utils/aot.py``
exports as they are; the batches are ``utils/batches.in_batches``.

On a card the recurrences are K1 (``csrc/lstm_scan.cu``) and the word
attention K2 (``csrc/scdm.cu``); on the CPU their plain versions. One card:
the JAX package's mesh options (``set_corpus(shard=True)``,
``set_video_sharded``) raise.

Usage::

    g = MultiQueryGrounder(params, state_dict)          # device='cuda'
    spans, scores = g.ground(video_TxD, sent_feats_QxNx300)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .models.build import build_model
from .ops.span import span_decode, span_topk_nms
from .utils.batches import check_rows, in_batches, put
from .utils.device import exact_bf16_products, resolve_device

Bank = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
_UNSHARDED = ('one card holds the port: the sharded bank and the '
              'sequence-parallel block 0 come with the parallel surfaces '
              '(ROADMAP.md §1, the parallel surfaces)')


def _bank_rows(bank: Bank, video_ids: torch.Tensor) -> torch.Tensor:
    """Each query's rows [Q, T, 2H] of a resident block-0 bank, in its
    dtype. The int8 bank, (values [V, T, 2H] int8, scales [V, T] f32),
    gathers both and dequantises only the gathered rows, to f32."""
    if isinstance(bank, tuple):
        q, s = bank
        return (q.index_select(0, video_ids).float()
                * s.index_select(0, video_ids)[..., None])
    return bank.index_select(0, video_ids)


def _quantize(rnn0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (video, frame) over the 2H features, taken in
    f32: scale = amax / 127 (1/127 for an all-zero frame), values round
    half to even as ``jnp.round``; the error is at most amax / 254 an
    element."""
    rnn0 = rnn0.float()
    amax = rnn0.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(rnn0 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# -- one batch on the device: the functions that utils/aot.py exports ---------
# Each takes the model and the resident state as arguments, so that the
# live grounder and its exported programs run the same code.

@torch.no_grad()
def precompute(model, videos: torch.Tensor) -> torch.Tensor:
    """The query-independent part of videos [V, T, D] (QAVE's block 0)."""
    return model.precompute_video(videos.float())


def embed(emb: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids [Q, N] as their rows of the vocabulary [V_words, 300]."""
    return emb.index_select(0, token_ids.reshape(-1).long()).view(
        *token_ids.shape, -1)


@torch.no_grad()
def serve_features(model, rnn0: torch.Tensor, queries: torch.Tensor):
    """(spans, scores) of queries [Q, N, 300] against one video's
    ``rnn0`` [1, T, 2H]."""
    out = model.serve_cached(rnn0, queries.float())
    return span_decode(out['start_prob'], out['end_prob'])


def serve_tokens(model, rnn0: torch.Tensor, emb: torch.Tensor,
                 token_ids: torch.Tensor):
    return serve_features(model, rnn0, embed(emb, token_ids))


@torch.no_grad()
def serve_bank(model, bank: Bank, queries: torch.Tensor,
               video_ids: torch.Tensor):
    """(spans, scores) of query i against bank row ``video_ids[i]``."""
    out = model.serve_gathered(_bank_rows(bank, video_ids.long()),
                               queries.float())
    return span_decode(out['start_prob'], out['end_prob'])


def serve_bank_tokens(model, bank: Bank, emb: torch.Tensor,
                      token_ids: torch.Tensor, video_ids: torch.Tensor):
    return serve_bank(model, bank, embed(emb, token_ids), video_ids)


def bank_nbytes(bank: Optional[Bank]) -> int:
    """Device bytes a resident bank holds (values and scales)."""
    if bank is None:
        return 0
    parts = bank if isinstance(bank, tuple) else (bank,)
    return sum(t.numel() * t.element_size() for t in parts)


class MultiQueryGrounder:
    """Grounds query batches against resident block-0 recurrences.

    ``params`` is the flat config (``config.load_config``), ``state_dict``
    the GMD weights in the port's (the reference ``.ckp``) format;
    ``device`` defaults to ``cuda`` and a missing card raises."""

    def __init__(self, params: Dict, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device] = 'cuda',
                 query_batch: int = 256):
        self.params = params
        self.device = resolve_device(str(device))
        if self.device.type == 'cuda' and self.device.index is None:
            # a thread of its own (the gateway's) sets this card
            self.device = torch.device('cuda', torch.cuda.current_device())
        if self.device.type == 'cuda':
            exact_bf16_products()
        model = build_model(params, 'gmd', device='cpu')
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.query_batch = int(query_batch)
        # serve_query_dtype f16 halves the sentence features' bytes over
        # the host link; they widen to f32 on the device, so the model
        # sees the features rounded once to f16 and nothing else changes
        ship = str(params.get('serve_query_dtype', 'f32')).lower()
        self._ship_np = np.float16 if ship in ('f16', 'float16') \
            else np.float32
        self._resident_rnn0: Optional[torch.Tensor] = None
        self._resident_bank: Optional[Bank] = None
        self._resident_emb: Optional[torch.Tensor] = None
        self._vid_to_row: Dict[str, int] = {}

    # -- host to device ----------------------------------------------------
    def _put(self, a: np.ndarray, dtype) -> torch.Tensor:
        return put(a, dtype, self.device)

    def _check_tokens(self, token_ids: np.ndarray) -> np.ndarray:
        if self._resident_emb is None:
            raise RuntimeError('no vocabulary set: call set_vocab first')
        return check_rows(token_ids, self._resident_emb.shape[0], 'token ids')

    def _resident_video(self) -> torch.Tensor:
        if self._resident_rnn0 is None:
            raise RuntimeError('no video set: call set_video first')
        return self._resident_rnn0

    def _bank(self) -> Bank:
        if self._resident_bank is None:
            raise RuntimeError('no video bank set: call set_videos or '
                               'set_corpus first')
        return self._resident_bank

    def _bank_size(self) -> int:
        bank = self._bank()
        return (bank[0] if isinstance(bank, tuple) else bank).shape[0]

    # -- one batch on the device (the gateway calls these too) -------------
    def _serve(self, queries: torch.Tensor):
        return serve_features(self.model, self._resident_video(), queries)

    def _serve_tokens(self, token_ids: torch.Tensor):
        return serve_tokens(self.model, self._resident_video(),
                            self._resident_emb, token_ids)

    def _serve_multi(self, queries: torch.Tensor, video_ids: torch.Tensor):
        return serve_bank(self.model, self._bank(), queries, video_ids)

    def _serve_multi_tokens(self, token_ids: torch.Tensor,
                            video_ids: torch.Tensor):
        return serve_bank_tokens(self.model, self._bank(), self._resident_emb,
                                 token_ids, video_ids)

    def _precompute(self, videos: torch.Tensor) -> torch.Tensor:
        return precompute(self.model, videos)

    def _batches(self, serve, arrays: Sequence[Tuple[np.ndarray, type]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return in_batches(serve, arrays, self.query_batch, self.device)

    # -- residency ---------------------------------------------------------
    def set_vocab(self, embeddings: np.ndarray) -> None:
        """Pin the GloVe matrix [V_words, 300] so queries can ship as token
        ids: a batch of 512 then ships 30 KB of int32, not 9 MB of f32."""
        self._resident_emb = self._put(embeddings, np.float32)

    def set_video(self, video_feats: np.ndarray) -> None:
        """Pin a [T, D] video: its block-0 recurrence runs once here."""
        self._resident_rnn0 = self._precompute(
            self._put(np.asarray(video_feats)[None], np.float32))

    def set_video_sharded(self, video_feats: np.ndarray) -> None:
        raise NotImplementedError('set_video_sharded: ' + _UNSHARDED)

    def set_videos(self, video_feats: np.ndarray) -> None:
        """Pin a bank of [V, T, D] videos: one block-0 pass over all."""
        self._resident_bank = self._precompute(
            self._put(video_feats, np.float32))

    @torch.no_grad()
    def set_corpus(self, pack, chunk_videos: int = 64, shard: bool = False,
                   dtype: str = 'raw') -> None:
        """Pin a whole feature pack (``data/featpack.PackedFeatureSource``)
        for serving: its videos go through block 0 ``chunk_videos`` at a
        time (uploaded in the pack's stored dtype, widened on the device)
        and only the [V, T, 2H] recurrences stay, written in place into
        one tensor allocated up front, in the model's dtype (bf16 at
        ``precision: bf16``: half the f32 bytes). ``dtype='int8'`` keeps
        int8 values and per-(video, frame) f32 scales instead, a quarter
        of the f32 bytes plus the scales, within amax/254 of the model's
        recurrences an element. Videos are
        then named by id in :meth:`ground_vids`."""
        if shard:
            raise NotImplementedError('set_corpus(shard=True): ' + _UNSHARDED)
        tier = str(dtype).lower()
        if tier not in ('raw', 'int8'):
            raise ValueError(f'set_corpus dtype {dtype!r}: raw or int8')
        V, step = pack.num_videos, max(1, int(chunk_videos))
        self._resident_bank = None  # free the previous bank first
        bank = None
        for at in range(0, V, step):
            rows = np.arange(at, min(at + step, V))
            rnn0 = self._precompute(self._put(pack.gather_raw(rows),
                                              pack.raw_dtype))
            if bank is None:
                shape = (V,) + tuple(rnn0.shape[1:])
                bank = (torch.empty(shape, dtype=torch.int8,
                                    device=self.device),
                        torch.empty(shape[:-1], device=self.device)) \
                    if tier == 'int8' else \
                    torch.empty(shape, dtype=rnn0.dtype, device=self.device)
            if tier == 'int8':
                q, s = _quantize(rnn0)
                bank[0][at:at + len(rows)].copy_(q)
                bank[1][at:at + len(rows)].copy_(s)
            else:
                bank[at:at + len(rows)].copy_(rnn0)
        self._resident_bank = bank
        self._vid_to_row = dict(pack.vid_to_row)

    # -- grounding ---------------------------------------------------------
    def ground(self, video_feats: Optional[np.ndarray],
               sent_feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Spans [Q, 2] int32 and scores [Q] of sentence features
        [Q, N, 300] against ``video_feats`` [T, D] (pinned first) or, with
        None, the resident video."""
        if video_feats is not None:
            self.set_video(video_feats)
        self._resident_video()
        return self._batches(self._serve, [(sent_feats, self._ship_np)])

    def ground_tokens_video(self, token_ids: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`ground` of token-id queries [Q, N] (pad id 0), embedded
        on the device against the :meth:`set_vocab` matrix."""
        self._resident_video()
        token_ids = self._check_tokens(token_ids)
        return self._batches(self._serve_tokens, [(token_ids, np.int32)])

    def ground_topk(self, sent_feats: np.ndarray, k: int = 5,
                    nms_iou: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k NMS proposals against the resident video: spans [Q, k, 2]
        int32, scores [Q, k] f32 by score; an exhausted pool repeats its
        last span with score -inf. Proposal 1 is :meth:`ground`'s span."""
        rnn0 = self._resident_video()

        @torch.no_grad()
        def serve(queries):
            out = self.model.serve_cached(rnn0, queries.float())
            return span_topk_nms(out['start_prob'], out['end_prob'], k,
                                 iou_threshold=nms_iou)
        return self._batches(serve, [(sent_feats, self._ship_np)])

    def ground_bank(self, sent_feats: np.ndarray, video_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Query i (features) against resident bank row ``video_ids[i]``."""
        ids = check_rows(video_ids, self._bank_size(), 'video ids')
        return self._batches(self._serve_multi,
                             [(sent_feats, self._ship_np), (ids, np.int32)])

    def ground_vids(self, sent_feats: np.ndarray, vids: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Query i against corpus video ``vids[i]`` (ids of the pack given
        to :meth:`set_corpus`)."""
        rows = np.asarray([self._vid_to_row[v] for v in vids], np.int32)
        return self.ground_bank(sent_feats, rows)

    def ground_tokens(self, token_ids: np.ndarray, video_ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Token-id query i [N] against resident bank row
        ``video_ids[i]``."""
        ids = check_rows(video_ids, self._bank_size(), 'video ids')
        token_ids = self._check_tokens(token_ids)
        return self._batches(self._serve_multi_tokens,
                             [(token_ids, np.int32), (ids, np.int32)])
