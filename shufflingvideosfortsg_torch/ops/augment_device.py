"""Pseudo-video generation on the device (the shuffling framework's hot path).

Counterpart of ``shufflingvideosfortsg_tpu/ops/augment_device.py:22-118``:
the reference's per-sample ``gt_moment_translate`` (np.delete/np.insert in
the data loader, data_augment.py:135-156) as one [B, T] gather of the
padded [B, T, D] features, plus the four masks of the translated span;
and the segment-permutation shuffle (data_augment.py:158-166), which no
driver calls, as in JAX.

The draws are explicit: the caller passes ``u`` [B], uniform on [0, 1),
from its own generator, so a test can feed the numbers
``jax.random.uniform`` drew and get the same insertion offsets as the JAX
function; :func:`segment_shuffle` takes the permutations themselves, and
:func:`segment_shuffle_batch` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def gt_translate_indices(s: Tensor, e: Tensor, n: Tensor, cropin: Tensor,
                         T: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Gather map of gt_moment_translate, batched.

    s, e: GT spans (inclusive), n: nfeats, cropin: new starts, all [B] int.
    Returns (idx [B, T], new_s [B], new_e [B]). Where the transform is a
    no-op (span length <= 1 or >= nfeats, the reference's guard,
    data_augment.py:137-139) the identity map and the original span come
    back. Output position t reads from:
      t < cropin:        t        if t < s else t + L    (the wo-GT prefix)
      cropin <= t <= ne: s + (t - cropin)                (the moved moment)
      t > ne:            t - L    if t - L < s else t    (the wo-GT suffix)
    """
    s, e, n, cropin = (x.long()[:, None] for x in (s, e, n, cropin))
    L = e - s + 1
    ts = torch.arange(T, device=s.device)[None, :]
    new_s = cropin
    new_e = cropin + L - 1
    before = torch.where(ts < s, ts, ts + L)
    inside = s + (ts - cropin)
    after = torch.where(ts - L < s, ts - L, ts)
    idx = torch.where(ts < new_s, before,
                      torch.where(ts <= new_e, inside, after))
    idx = idx.clamp(0, T - 1)
    noop = (L <= 1) | (L >= n)
    idx = torch.where(noop, ts.expand_as(idx), idx)
    new_s = torch.where(noop, s, new_s)[:, 0]
    new_e = torch.where(noop, e, new_e)[:, 0]
    return idx, new_s, new_e


def device_masks(framestps_s: Tensor, framestps_e: Tensor, nfeats: Tensor,
                 T: int) -> Dict[str, Tensor]:
    """The four reference masks [B, T] int32, inclusive ends (as
    ``data/masks.py``)."""
    ts = torch.arange(T, device=nfeats.device)[None, :]
    s = framestps_s.long()[:, None]
    e = framestps_e.long()[:, None]
    n = nfeats.long()[:, None]

    def incl(lo, hi):
        hi = hi.clamp(max=T - 1)
        lo = lo.clamp(min=0)
        return ((ts >= lo) & (ts <= hi)).to(torch.int32)

    return {
        'video_mask': incl(torch.zeros_like(n), n),
        'temporal_labels': incl(s, e),
        'fore_masks': incl(torch.zeros_like(s), s),
        'back_masks': incl(e, n),
    }


def gt_translate_batch(u: Tensor, video_feat: Tensor, framestps: Tensor,
                       nfeats: Tensor
                       ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Batched gt_moment_translate.

    u: [B] uniform on [0, 1); video_feat: [B, T, D] zero-padded;
    framestps: [B, 2] int; nfeats: [B]. The insertion offset is
    ``min(floor(u * (hi + 1)), hi)`` with ``hi = max(nfeats - L, 0)``,
    uniform on [0, nfeats - L] inclusive like the reference's randint
    (data_augment.py:150). Returns (pseudo_feat [B, T, D], pseudo_framestps
    [B, 2] int32, the pseudo masks)."""
    T = video_feat.shape[1]
    s = framestps[:, 0].long()
    e = framestps[:, 1].long()
    n = nfeats.long()
    hi = (n - (e - s + 1)).clamp(min=0)
    cropin = torch.minimum((u.float() * (hi + 1).float()).long(), hi)
    idx, new_s, new_e = gt_translate_indices(s, e, n, cropin, T)
    pseudo = torch.gather(video_feat, 1,
                          idx[:, :, None].expand(-1, -1, video_feat.shape[2]))
    masks = device_masks(new_s, new_e, n, T)
    return pseudo, torch.stack([new_s, new_e], dim=-1).to(torch.int32), masks


def segment_shuffle(video_feat: Tensor, perms: Tensor, seg_len: int
                    ) -> Tensor:
    """The segment shuffle at given permutations: [B, T, D] cut into
    T // seg_len segments of ``seg_len`` clips, sample b's segment i
    taken from segment ``perms[b, i]`` ([B, T // seg_len] int); a tail of
    T % seg_len clips stays in place."""
    B, T, D = video_feat.shape
    n_seg = T // seg_len
    body = video_feat[:, :n_seg * seg_len].reshape(B, n_seg, seg_len, D)
    index = perms.long()[:, :, None, None].expand(-1, -1, seg_len, D)
    out = torch.gather(body, 1, index).reshape(B, n_seg * seg_len, D)
    return torch.cat([out, video_feat[:, n_seg * seg_len:]], dim=1)


def segment_shuffle_batch(generator: torch.Generator, video_feat: Tensor,
                          seg_len: int) -> Tensor:
    """On-device segment-permutation shuffle (JAX ``:104-118``): an
    independent uniform permutation of the T // seg_len segments a
    sample, drawn from ``generator`` (one [B, T // seg_len] uniform draw,
    ranked), applied by :func:`segment_shuffle`."""
    B, T, _ = video_feat.shape
    u = torch.rand(B, T // seg_len, generator=generator,
                   device=video_feat.device)
    return segment_shuffle(video_feat, u.argsort(dim=1), seg_len)
