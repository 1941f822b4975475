"""Span decoding and IoU.

Counterpart of ``shufflingvideosfortsg_tpu/ops/span.py:25-224``.
:func:`span_decode` picks the best (start, end) with end >= start in O(T)
per sample through a suffix maximum of ``end_prob``; ties go to the first
occurrence, as in the reference's matrix decode, which
:func:`span_decode_matrix` keeps as a cross-check. :func:`span_topk` and
:func:`span_topk_nms` give the k best spans (R@k evaluation, multi-proposal
serving) in JAX's order: score descending, equal scores by the smaller
flattened ``start * T + end``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

DELTA = 1e-4


def _suffix_max_and_first_argmax(x: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: M[i] = max_{j>=i} x[j]; A[i] = smallest j>=i attaining M[i].

    ``torch.cummax``'s indices promise no tie rule, so only its values are
    used; the index comes from a cummin over a hit mask: i attains its own
    suffix max iff x[i] == M[i], and the first such j >= i is the
    first-occurrence argmax of the suffix.
    """
    T = x.shape[1]
    M = torch.cummax(x.flip(1), dim=1).values.flip(1)
    pos = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(x >= M, pos, torch.full_like(pos, T))
    A = torch.cummin(idx.flip(1), dim=1).values.flip(1)
    return M, A


def span_decode(start_prob: torch.Tensor, end_prob: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best span maximising start_prob[s] + end_prob[e], e >= s.

    Returns (pred [B, 2] int64, score [B] f32). A row whose sums are all
    <= 0 reports end index 0 for starts i > 0 (the reference's zero-filled
    lower triangle; it matters only for such degenerate rows).
    """
    start_prob = start_prob.float()
    end_prob = end_prob.float()
    T = start_prob.shape[1]
    M, A = _suffix_max_and_first_argmax(end_prob)
    row_max = start_prob + M
    i_idx = torch.arange(T, device=start_prob.device)[None, :]
    row_idx = torch.where((row_max <= 0) & (i_idx > 0),
                          torch.zeros_like(A), A)
    best_start = torch.argmax(row_max, dim=1)  # first occurrence
    score = torch.gather(row_max, 1, best_start[:, None])[:, 0]
    best_end = torch.gather(row_idx, 1, best_start[:, None])[:, 0]
    return torch.stack([best_start, best_end], dim=-1), score


def span_decode_matrix(start_prob: torch.Tensor, end_prob: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic cross-check: materialises the triu start_i + end_j matrix."""
    start_prob = start_prob.float()
    end_prob = end_prob.float()
    T = start_prob.shape[1]
    mat = start_prob[:, :, None] + end_prob[:, None, :]
    tri = torch.triu(torch.ones(T, T, dtype=torch.bool,
                                device=start_prob.device))
    mat = torch.where(tri[None], mat, torch.zeros_like(mat))
    row_max = mat.max(dim=2).values
    row_idx = torch.argmax(mat, dim=2)
    best_start = torch.argmax(row_max, dim=1)
    score = torch.gather(row_max, 1, best_start[:, None])[:, 0]
    best_end = torch.gather(row_idx, 1, best_start[:, None])[:, 0]
    return torch.stack([best_start, best_end], dim=-1), score


def _order_key(scores: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """An int64 key a cell that orders cells as ``jax.lax.top_k`` over the
    flattened matrix does: by score descending, then by the smaller flat
    index. ``torch.topk`` promises no order among equal values, so the
    score's f32 bits (made monotone as a signed integer, -0.0 as +0.0)
    take the high 32 bits and the flat index, reversed, the low 32: every
    key of a row differs, and the largest keys are JAX's first cells."""
    bits = (scores + 0.0).view(torch.int32)
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).long()
    return mono * (1 << 32) + (0xFFFFFFFF - flat)


def _top(scores: torch.Tensor, flat: torch.Tensor, k: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k first cells of each row of (scores, flat) in JAX's order."""
    idx = torch.topk(_order_key(scores, flat), k, dim=1).indices
    return scores.gather(1, idx), flat.gather(1, idx)


def span_topk(start_prob: torch.Tensor, end_prob: torch.Tensor, k: int,
              row_block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (start, end) spans with end >= start by start + end.

    Runs over blocks of ``row_block`` start rows, so memory is
    O(B * row_block * T), not O(B * T^2); each block's best k merge into a
    carry (the carry's cells come first among equal scores, as its flat
    indices are smaller). Cells with end < start score -inf, so for k
    above the number of valid spans the tail is (-inf, [0, 0]).

    Returns (spans [B, k, 2] int32, scores [B, k] f32), ordered by score
    descending, equal scores by the smaller flattened start*T+end.
    """
    start_prob = start_prob.float()
    end_prob = end_prob.float()
    B, T = start_prob.shape
    k = int(k)
    dev = start_prob.device
    row_block = max(1, min(int(row_block), T))
    n_blocks = -(-T // row_block)
    start_pad = torch.full((B, n_blocks * row_block), -math.inf,
                           device=dev)
    start_pad[:, :T] = start_prob
    j_idx = torch.arange(T, device=dev)
    c_scores = torch.full((B, k), -math.inf, device=dev)
    c_flat = torch.zeros((B, k), dtype=torch.long, device=dev)
    for i0 in range(n_blocks):
        i_idx = i0 * row_block + torch.arange(row_block, device=dev)
        rows = start_pad[:, i0 * row_block:(i0 + 1) * row_block]
        blk = rows[:, :, None] + end_prob[:, None, :]      # [B, Rb, T]
        valid = j_idx[None, :] >= i_idx[:, None]            # [Rb, T]
        blk = blk.masked_fill(~valid[None], -math.inf).reshape(B, -1)
        flat_local = (i_idx[:, None] * T + j_idx[None, :]).reshape(1, -1)
        kk = min(k, row_block * T)
        b_scores, b_flat = _top(blk, flat_local.expand(B, -1), kk)
        if kk < k:
            b_scores = torch.cat([b_scores, torch.full(
                (B, k - kk), -math.inf, device=dev)], dim=1)
            b_flat = torch.cat([b_flat, torch.zeros(
                (B, k - kk), dtype=torch.long, device=dev)], dim=1)
        c_scores, c_flat = _top(torch.cat([c_scores, b_scores], dim=1),
                                torch.cat([c_flat, b_flat], dim=1), k)
    flat = torch.where(torch.isfinite(c_scores), c_flat,
                       torch.zeros_like(c_flat))
    spans = torch.stack([flat // T, flat % T], dim=-1).int()
    return spans, c_scores


def span_topk_nms(start_prob: torch.Tensor, end_prob: torch.Tensor, k: int,
                  iou_threshold: float = 0.5, pool: int = 0,
                  row_block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k spans after greedy non-maximum suppression over the ``pool``
    (default 8*k) best spans: take the best candidate left, drop those
    with temporal IoU above ``iou_threshold`` against it, k times. Where
    the pool runs out, the tail repeats the last kept span with score
    -inf. Returns (spans [B, k, 2] int32, scores [B, k] f32)."""
    pool = int(pool) if pool else 8 * int(k)
    cand, cand_scores = span_topk(start_prob, end_prob, pool, row_block)
    return _greedy_nms(cand, cand_scores, int(k), float(iou_threshold))


def _greedy_nms(cand: torch.Tensor, cand_scores: torch.Tensor, k: int,
                iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over [B, P, 2] candidates sorted by score descending."""
    B, P, _ = cand.shape
    s = cand[..., 0].float()
    e = cand[..., 1].float()
    pos = torch.arange(P, device=cand.device)[None, :]
    alive = torch.isfinite(cand_scores)
    spans, scores = [], []
    for _ in range(k):
        score_alive = torch.where(alive, cand_scores,
                                  torch.full_like(cand_scores, -math.inf))
        best = torch.argmax(score_alive, dim=1)[:, None]  # first occurrence
        bs, be = s.gather(1, best), e.gather(1, best)
        inter = (torch.minimum(e, be) - torch.maximum(s, bs)).clamp(min=0.0)
        union = (e - s) + (be - bs) - inter
        alive = alive & (inter / (union + DELTA) <= iou_threshold)
        # the selected candidate is always consumed: a zero-length span
        # [t, t] has self-IoU 0 and would be selected again and again
        alive = alive & (pos != best)
        spans.append(torch.cat([bs, be], dim=1).int())
        scores.append(score_alive.gather(1, best)[:, 0])
    spans = torch.stack(spans, dim=1)    # [B, k, 2]
    scores = torch.stack(scores, dim=1)
    # an exhausted pool repeats the last kept span (score -inf)
    ok = torch.isfinite(scores).int()
    last_ok = (torch.cumsum(ok, dim=1) - 1).clamp(min=0)
    spans = spans.gather(1, last_ok[..., None].expand(-1, -1, 2).long())
    return spans, scores


def iou_per_sample(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Temporal IoU of [B, 2] (s, e) segments, shape [B]: non-negative
    intersection, union + 1e-4, no union clamp."""
    pred = pred.float()
    gt = gt.float()
    inter = torch.minimum(pred[:, 1], gt[:, 1]) - torch.maximum(pred[:, 0], gt[:, 0])
    inter = inter.clamp(min=0.0)
    union = torch.maximum(pred[:, 1], gt[:, 1]) - torch.minimum(pred[:, 0], gt[:, 0])
    return inter / (union + DELTA)
