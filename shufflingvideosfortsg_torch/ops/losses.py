"""The loss library.

Counterpart of ``shufflingvideosfortsg_tpu/ops/losses.py``: the reference
loss semantics (grounding/loss.py) as batched gathers and masked
reductions, with its numerical details kept (DELTA = 1e-4, the un-shifted
exp of ``masked_softmax``, the span-aligned KL).
"""

from __future__ import annotations

import torch

DELTA = 1e-4


def mask_logits(inputs: torch.Tensor, mask: torch.Tensor,
                mask_value: float = -1e30) -> torch.Tensor:
    """inputs*mask + mask_value*(1-mask); a [..., T] mask broadcasts over
    a trailing feature dim when the inputs have one more dim."""
    mask = mask.to(inputs.dtype)
    if mask.dim() == inputs.dim() - 1:
        mask = mask[..., None]
    return inputs * mask + mask_value * (1.0 - mask)


def masked_softmax(vec: torch.Tensor, mask: torch.Tensor, dim: int = 1,
                   epsilon: float = 1e-4) -> torch.Tensor:
    """exp(vec)*mask / (sum + eps), with the reference's un-shifted exp
    (attention.py:123-127), in f32."""
    masked_exps = torch.exp(vec.float()) * mask.float()
    return masked_exps / (masked_exps.sum(dim=dim, keepdim=True) + epsilon)


def span_ground_nll(start_prob: torch.Tensor, end_prob: torch.Tensor,
                    framestps: torch.Tensor) -> torch.Tensor:
    """Per-sample -log p_start[s] - log p_end[e], shape [B]."""
    idx = framestps.long()
    ps = torch.gather(start_prob, 1, idx[:, :1])[:, 0]
    pe = torch.gather(end_prob, 1, idx[:, 1:2])[:, 0]
    return -torch.log(ps) - torch.log(pe)


def span_ground_loss(start_prob: torch.Tensor, end_prob: torch.Tensor,
                     framestps: torch.Tensor) -> torch.Tensor:
    """Batch mean of :func:`span_ground_nll` (loss.py:22-28)."""
    return span_ground_nll(start_prob, end_prob, framestps).mean()


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked binary cross-entropy with logits, summed over the mask and
    divided by (mask sum + 1e-4) (loss.py:30-36), in the stable
    max(x, 0) - x*z + log1p(exp(-|x|)) form."""
    x = logits.float()
    z = labels.float()
    per_loc = x.clamp(min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    m = mask.float()
    return (per_loc * m).sum() / (m.sum() + DELTA)


def matching_kl_divergence(prob1: torch.Tensor, prob2: torch.Tensor,
                           framestps1: torch.Tensor, framestps2: torch.Tensor,
                           epsilon: float = 1e-4) -> torch.Tensor:
    """Span-aligned KL between two masked-softmax distributions
    (loss.py:42-51): prob1[s1 + k] against prob2[s2 + k] for k <= e1 - s1,
    as clipped gathers with a validity mask; batch mean."""
    B, T = prob1.shape
    k = torch.arange(T, device=prob1.device)[None, :]
    s1 = framestps1[:, :1].long()
    e1 = framestps1[:, 1:2].long()
    s2 = framestps2[:, :1].long()
    valid = (k <= (e1 - s1)).float()
    p1 = torch.gather(prob1, 1, (s1 + k).clamp(0, T - 1))
    p2 = torch.gather(prob2, 1, (s2 + k).clamp(0, T - 1))
    kl = p1 * torch.log((p1 + epsilon) / (p2 + epsilon))
    return (kl * valid).sum(dim=1).mean()


def temporal_order_discrimination_loss(original_logits: torch.Tensor,
                                       pseudo_logits: torch.Tensor
                                       ) -> torch.Tensor:
    """Mean cross-entropy over [original; pseudo] with labels 0 and 1
    (loss.py:6-20); logits [B, 2]."""
    logp_ori = torch.log_softmax(original_logits.float(), dim=-1)
    logp_pse = torch.log_softmax(pseudo_logits.float(), dim=-1)
    loss = -(logp_ori[:, 0].sum() + logp_pse[:, 1].sum())
    return loss / (original_logits.shape[0] + pseudo_logits.shape[0])
