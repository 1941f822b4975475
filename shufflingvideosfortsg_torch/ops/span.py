"""Span decoding and IoU.

Counterpart of ``shufflingvideosfortsg_tpu/ops/span.py:25-82,210-224``.
:func:`span_decode` picks the best (start, end) with end >= start in O(T)
per sample through a suffix maximum of ``end_prob``; ties go to the first
occurrence, as in the reference's matrix decode, which
:func:`span_decode_matrix` keeps as a cross-check.
"""

from __future__ import annotations

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


def iou_per_sample(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Temporal IoU of [B, 2] (s, e) segments, shape [B]: non-negative
    intersection, union + 1e-4, no union clamp."""
    pred = pred.float()
    gt = gt.float()
    inter = torch.minimum(pred[:, 1], gt[:, 1]) - torch.maximum(pred[:, 0], gt[:, 0])
    inter = inter.clamp(min=0.0)
    union = torch.maximum(pred[:, 1], gt[:, 1]) - torch.minimum(pred[:, 0], gt[:, 0])
    return inter / (union + DELTA)
