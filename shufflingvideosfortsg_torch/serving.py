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
exports as they are; the batches are ``utils/batches.in_shards``.

On a card the recurrences are K1 (``csrc/lstm_scan.cu``) and the word
attention K2 (``csrc/scdm.cu``); on the CPU their plain versions.

Several shards (JAX's mesh, ``serving.py:44-52``): ``mesh_shape`` [n]
lays the grounder over n devices, ``cuda:0..n-1`` on a card (n CPU
shards on the CPU), or ``devices=`` names them (two shards may share one
card). Unset, or one shard, it is the one ``device``. One process drives
the shards, as JAX's single controller drives its mesh:

- each shard holds a replica of the model, the vocabulary and the
  resident ``rnn0`` or replicated bank (shards on one device share them);
- every ``ground*`` call cuts each padded batch of ``query_batch`` into n
  equal parts, one a shard (JAX's ``batch_sharding``; ``query_batch`` a
  multiple of n), dispatches every part before it fetches any and returns
  the results in query order;
- :meth:`~MultiQueryGrounder.set_video_sharded` runs block 0's
  recurrence time-sharded over the shards (``parallel/seq_parallel.py``)
  and replicates the f32 ``rnn0``;
- ``set_corpus(shard=True)`` splits the bank's video axis over the
  shards, V zero-padded to a multiple of n, shard k holding rows
  ``[k V_pad/n, (k+1) V_pad/n)`` (:class:`ShardedBank`); each query is
  routed to the shard that holds its video, so a query's 18 KB of
  features cross, not its video's rows.

Usage::

    g = MultiQueryGrounder(params, state_dict)          # device='cuda'
    spans, scores = g.ground(video_TxD, sent_feats_QxNx300)
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .models.build import build_model
from .ops.span import span_decode, span_topk_nms
from .utils.batches import (check_rows, dispatch_shards, in_shards,
                            on_device, put)
from .utils.device import exact_bf16_products, resolve_device

Bank = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


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


class ShardedBank:
    """A bank whose video axis is split over the shards: ``parts[k]`` (a
    tensor, or int8 values and scales), on shard k, holds rows
    ``[k rows, (k+1) rows)`` of the bank zero-padded to ``len(parts) *
    rows`` videos; ``num_videos`` are real."""

    def __init__(self, parts: List[Bank], rows: int, num_videos: int):
        self.parts, self.rows, self.num_videos = parts, rows, num_videos

    @property
    def shape(self) -> Tuple[int, ...]:
        """The padded bank's shape (of the int8 values)."""
        first = self.parts[0]
        first = first[0] if isinstance(first, tuple) else first
        return (self.rows * len(self.parts),) + tuple(first.shape[1:])


def bank_nbytes(bank) -> int:
    """Device bytes a resident bank holds (values and scales; a sharded
    bank's parts together)."""
    if bank is None:
        return 0
    if isinstance(bank, ShardedBank):
        return sum(bank_nbytes(p) for p in bank.parts)
    parts = bank if isinstance(bank, tuple) else (bank,)
    return sum(t.numel() * t.element_size() for t in parts)


def _to(bank: Optional[Bank], device: torch.device) -> Optional[Bank]:
    """A resident tensor (or int8 pair) on ``device``: itself where it
    lies there already."""
    if bank is None:
        return None
    if isinstance(bank, tuple):
        return tuple(t.to(device) for t in bank)
    return bank.to(device)


def shard_devices(mesh_shape, device: torch.device,
                  devices: Optional[Sequence] = None) -> List[torch.device]:
    """The grounder's shards: ``devices`` where given (their count the
    product of ``mesh_shape`` where that is set too); else one shard, the
    ``device``, for an unset or one-device ``mesh_shape``; else n of them,
    ``cuda:0..n-1`` on a card (fewer visible cards, or a ``device`` that
    names another first card, raise), n times the CPU on the CPU. A card
    with no index is the current one."""
    n = math.prod(int(s) for s in mesh_shape) if mesh_shape else None
    if devices is not None:
        devs = [_indexed(resolve_device(str(d))) for d in devices]
        if not devs or (n is not None and n != len(devs)):
            raise ValueError(f'mesh_shape {mesh_shape} against {len(devs)} '
                             'devices')
        return devs
    if not n or n == 1:
        return [_indexed(device)]
    if device.type == 'cpu':
        return [device] * n
    if device.index not in (None, 0):
        raise ValueError(f'mesh_shape {list(mesh_shape)} lays the grounder '
                         f'over cuda:0..{n - 1}, not from {device} (devices= '
                         'names other cards)')
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f'mesh_shape {list(mesh_shape)} lays the grounder '
                         f'over {n} cards, {have} are visible (devices= '
                         'may put several shards on one card)')
    return [torch.device('cuda', i) for i in range(n)]


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: a card with none is the current one."""
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


class _Replica:
    """One shard: its device, its model, and its resident video, bank (its
    part of a sharded one) and vocabulary."""

    def __init__(self, device: torch.device, model):
        self.device, self.model = device, model
        self.rnn0: Optional[torch.Tensor] = None
        self.bank: Optional[Bank] = None
        self.emb: Optional[torch.Tensor] = None


class MultiQueryGrounder:
    """Grounds query batches against resident block-0 recurrences.

    ``params`` is the flat config (``config.load_config``), ``state_dict``
    the GMD weights in the port's (the reference ``.ckp``) format;
    ``device`` defaults to ``cuda`` and a missing card raises.
    ``params['mesh_shape']`` or ``devices`` lay it over several shards
    (:func:`shard_devices`); ``query_batch`` must then be a multiple of
    their number."""

    def __init__(self, params: Dict, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device] = 'cuda',
                 query_batch: int = 256,
                 devices: Optional[Sequence] = None):
        self.params = params
        # a card with no index is the current one (a thread of its own,
        # the gateway's, sets it)
        shards = shard_devices(params.get('mesh_shape'),
                               resolve_device(str(device)), devices)
        self.device = shards[0]
        self.query_batch = int(query_batch)
        if self.query_batch % len(shards):
            raise ValueError(f'query_batch {self.query_batch} must be a '
                             f'multiple of the {len(shards)} shards: each '
                             'batch is cut into one equal part a shard')
        if self.device.type == 'cuda':
            exact_bf16_products()
        model = build_model(params, 'gmd', device='cpu')
        model.load_state_dict(state_dict, strict=True)
        models = {d: copy.deepcopy(model).to(d).eval()
                  for d in dict.fromkeys(shards) if d != self.device}
        self.model = model.to(self.device).eval()
        models[self.device] = self.model
        self.replicas = [_Replica(d, models[d]) for d in shards]
        # serve_query_dtype f16 halves the sentence features' bytes over
        # the host link; they widen to f32 on the device, so the model
        # sees the features rounded once to f16 and nothing else changes
        ship = str(params.get('serve_query_dtype', 'f32')).lower()
        self._ship_np = np.float16 if ship in ('f16', 'float16') \
            else np.float32
        self._sharded: Optional[ShardedBank] = None  # set_corpus(shard=True)
        self._vid_to_row: Dict[str, int] = {}

    # -- resident state, on every shard ------------------------------------
    # each replica holds its shard's state; the grounder reads and sets it
    # through these properties alone
    def _replicate(self, name: str, value) -> None:
        """``value`` as every replica's ``name``, on its device (shards on
        one device share it)."""
        copies: Dict[torch.device, object] = {}
        for r in self.replicas:
            if r.device not in copies:
                copies[r.device] = _to(value, r.device)
            setattr(r, name, copies[r.device])

    @property
    def _resident_rnn0(self) -> Optional[torch.Tensor]:
        return self.replicas[0].rnn0

    @_resident_rnn0.setter
    def _resident_rnn0(self, value) -> None:
        self._replicate('rnn0', value)

    @property
    def _resident_emb(self) -> Optional[torch.Tensor]:
        return self.replicas[0].emb

    @_resident_emb.setter
    def _resident_emb(self, value) -> None:
        self._replicate('emb', value)

    @property
    def _resident_bank(self):
        """The resident bank: a tensor (or int8 pair), replicated on every
        shard, or a :class:`ShardedBank` after ``set_corpus(shard=True)``."""
        if self._sharded is not None:
            return self._sharded
        return self.replicas[0].bank

    @_resident_bank.setter
    def _resident_bank(self, value) -> None:
        """A replicated bank, or a :class:`ShardedBank`, whose part k goes
        to shard k."""
        self._sharded = value if isinstance(value, ShardedBank) else None
        if self._sharded is None:
            self._replicate('bank', value)
        else:
            for r, part in zip(self.replicas, value.parts):
                r.bank = part

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

    def _bank(self):
        bank = self._resident_bank
        if bank is None:
            raise RuntimeError('no video bank set: call set_videos or '
                               'set_corpus first')
        return bank

    def _bank_size(self) -> int:
        """The videos a query may name (a sharded bank's real ones)."""
        bank = self._bank()
        if isinstance(bank, ShardedBank):
            return bank.num_videos
        return (bank[0] if isinstance(bank, tuple) else bank).shape[0]

    # -- one batch on the device (the gateway's worker too) ----------------
    # each on shard ``r`` with its resident state
    def _serve(self, r: _Replica, queries: torch.Tensor):
        return serve_features(r.model, r.rnn0, queries)

    def _serve_tokens(self, r: _Replica, token_ids: torch.Tensor):
        return serve_tokens(r.model, r.rnn0, r.emb, token_ids)

    def _serve_multi(self, r: _Replica, queries: torch.Tensor,
                     video_ids: torch.Tensor):
        return serve_bank(r.model, r.bank, queries, video_ids)

    def _serve_multi_tokens(self, r: _Replica, token_ids: torch.Tensor,
                            video_ids: torch.Tensor):
        return serve_bank_tokens(r.model, r.bank, r.emb, token_ids,
                                 video_ids)

    def _precompute(self, videos: torch.Tensor) -> torch.Tensor:
        return precompute(self.model, videos)

    def _serves(self, serve) -> List:
        """``serve`` (one of the methods above) bound to each shard."""
        return [functools.partial(serve, r) for r in self.replicas]

    def _batches(self, serve, arrays: Sequence[Tuple[np.ndarray, type]],
                 route: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return in_shards(self._serves(serve), arrays, self.query_batch,
                         [r.device for r in self.replicas], route=route)

    def _routed(self, ids: np.ndarray):
        """Bank rows ``ids`` as (each row's index on its shard, the shard
        of each row): against a sharded bank each query goes to the shard
        that holds its row; against a replicated one (None) to any."""
        if self._sharded is None:
            return ids, None
        rows = self._sharded.rows
        return ids % rows, ids // rows

    def _bank_batches(self, serve, arrays: Sequence[Tuple[np.ndarray, type]],
                      ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`_batches` of ``arrays`` and bank rows ``ids``."""
        local, route = self._routed(ids)
        return self._batches(serve, list(arrays) + [(local, np.int32)],
                             route)

    def _dispatch_tokens(self, tokens: np.ndarray,
                         vids: Optional[np.ndarray] = None):
        """One padded batch of token-id queries over the shards, against
        the resident video (``vids`` None) or the bank's rows ``vids``,
        without waiting: [(rows, (spans, scores) on the rows' shard)]
        (``utils/batches.dispatch_shards``; the gateway's worker)."""
        devices = [r.device for r in self.replicas]
        if vids is None:
            return dispatch_shards(self._serves(self._serve_tokens),
                                   [(tokens, np.int32)], devices)
        local, route = self._routed(vids)
        return dispatch_shards(self._serves(self._serve_multi_tokens),
                               [(tokens, np.int32), (local, np.int32)],
                               devices, route=route)

    # -- residency ---------------------------------------------------------
    def set_vocab(self, embeddings: np.ndarray) -> None:
        """Pin the GloVe matrix [V_words, 300] so queries can ship as token
        ids: a batch of 512 then ships 30 KB of int32, not 9 MB of f32."""
        self._resident_emb = self._put(embeddings, np.float32)

    def set_video(self, video_feats: np.ndarray) -> None:
        """Pin a [T, D] video: its block-0 recurrence runs once here."""
        self._resident_rnn0 = self._precompute(
            self._put(np.asarray(video_feats)[None], np.float32))

    @torch.no_grad()
    def set_video_sharded(self, video_feats: np.ndarray) -> None:
        """Pin a very long [T, D] video through the sequence-parallel block
        0 (``parallel/seq_parallel.bilstm_time_sharded``): the raw features,
        the projections and the recurrence's output live T/n on each shard
        while the two directions pipeline across them, so the video's
        length is bounded by the shards' memory together. T must be a
        multiple of the shards. The [1, T, 2H] ``rnn0`` is gathered,
        widened to f32 (as JAX's, ``serving.py:194``, also at bf16) and
        replicated, so every ``ground*`` afterwards is :meth:`set_video`'s
        path."""
        from .parallel.seq_parallel import Shards, bilstm_time_sharded
        if not self.model._cached():
            raise ValueError(
                'set_video_sharded runs QAVE\'s block-0 recurrence: video_'
                f'encoder {self.params.get("video_encoder")!r} has none '
                '(set_video runs the whole encoder on each query\'s video)')
        shards = Shards([r.device for r in self.replicas])
        video = torch.from_numpy(np.ascontiguousarray(video_feats,
                                                      np.float32))
        lstm = self.model.video_encoder.blocks[0].rnn_cell['lstm']
        out = bilstm_time_sharded(lstm, video[:, None, :], shards,
                                  dtype=self.model.dtype)
        rnn0 = torch.cat([c.to(self.device) for c in out])
        self._resident_rnn0 = rnn0.transpose(0, 1).float().contiguous()

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
        recurrences an element. Videos are then named by id in
        :meth:`ground_vids`.

        ``shard=True`` over several shards splits the bank's video axis
        over them instead of replicating it (JAX ``serving.py:206-289``):
        V zero-padded to a multiple of n (int8 padding with zero values
        and zero scales), shard k computing and holding videos
        ``[k V_pad/n, (k+1) V_pad/n)``. Over one shard it is the
        replicated bank."""
        tier = str(dtype).lower()
        if tier not in ('raw', 'int8'):
            raise ValueError(f'set_corpus dtype {dtype!r}: raw or int8')
        V, step = pack.num_videos, max(1, int(chunk_videos))
        self._resident_bank = None  # free the previous bank first
        n = len(self.replicas)
        if shard and n > 1:
            rows = -(-V // n)
            spans = [(k * rows, min((k + 1) * rows, V)) for k in range(n)]
        else:
            rows, spans = V, [(0, V)]
        parts: List[Optional[Bank]] = [None] * len(spans)
        for k, (lo, hi) in enumerate(spans):
            r = self.replicas[k]
            with on_device(r.device):
                for at in range(lo, hi, step):
                    idx = np.arange(at, min(at + step, hi))
                    rnn0 = precompute(r.model, put(pack.gather_raw(idx),
                                                   pack.raw_dtype, r.device))
                    if parts[0] is None:  # the first chunk fixes the shapes
                        parts = [self._empty_bank(rows, rnn0, tier,
                                                  self.replicas[j].device,
                                                  zeros=len(spans) > 1)
                                 for j in range(len(spans))]
                    part, at_k = parts[k], at - lo
                    if tier == 'int8':
                        q, s = _quantize(rnn0)
                        part[0][at_k:at_k + len(idx)].copy_(q)
                        part[1][at_k:at_k + len(idx)].copy_(s)
                    else:
                        part[at_k:at_k + len(idx)].copy_(rnn0)
        self._resident_bank = (ShardedBank(parts, rows, V) if len(spans) > 1
                               else parts[0])
        self._vid_to_row = dict(pack.vid_to_row)

    @staticmethod
    def _empty_bank(rows: int, rnn0: torch.Tensor, tier: str,
                    device: torch.device, zeros: bool) -> Bank:
        """A bank of ``rows`` videos shaped as ``rnn0``'s rows, in the
        tier's dtypes, on ``device``; ``zeros`` for a shard's part, whose
        padding stays zero."""
        new = torch.zeros if zeros else torch.empty
        shape = (rows,) + tuple(rnn0.shape[1:])
        if tier == 'int8':
            return (new(shape, dtype=torch.int8, device=device),
                    new(shape[:-1], device=device))
        return new(shape, dtype=rnn0.dtype, device=device)

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
        self._resident_video()

        @torch.no_grad()
        def serve(r, queries):
            out = r.model.serve_cached(r.rnn0, queries.float())
            return span_topk_nms(out['start_prob'], out['end_prob'], k,
                                 iou_threshold=nms_iou)
        return self._batches(serve, [(sent_feats, self._ship_np)])

    def ground_bank(self, sent_feats: np.ndarray, video_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Query i (features) against resident bank row ``video_ids[i]``."""
        ids = check_rows(video_ids, self._bank_size(), 'video ids')
        return self._bank_batches(self._serve_multi,
                                  [(sent_feats, self._ship_np)], ids)

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
        return self._bank_batches(self._serve_multi_tokens,
                                  [(token_ids, np.int32)], ids)
