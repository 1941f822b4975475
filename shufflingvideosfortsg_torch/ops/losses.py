"""Losses on the evaluation path.

Counterpart of ``shufflingvideosfortsg_tpu/ops/losses.py:17-47``
(``mask_logits``, ``span_ground_nll``); the training losses arrive with the
training slice.
"""

from __future__ import annotations

import torch


def mask_logits(inputs: torch.Tensor, mask: torch.Tensor,
                mask_value: float = -1e30) -> torch.Tensor:
    """inputs*mask + mask_value*(1-mask); a [..., T] mask broadcasts over
    a trailing feature dim when the inputs have one more dim."""
    mask = mask.to(inputs.dtype)
    if mask.dim() == inputs.dim() - 1:
        mask = mask[..., None]
    return inputs * mask + mask_value * (1.0 - mask)


def span_ground_nll(start_prob: torch.Tensor, end_prob: torch.Tensor,
                    framestps: torch.Tensor) -> torch.Tensor:
    """Per-sample -log p_start[s] - log p_end[e], shape [B]."""
    idx = framestps.long()
    ps = torch.gather(start_prob, 1, idx[:, :1])[:, 0]
    pe = torch.gather(end_prob, 1, idx[:, 1:2])[:, 0]
    return -torch.log(ps) - torch.log(pe)
