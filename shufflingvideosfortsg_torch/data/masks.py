"""Mask construction, replicating reference semantics exactly.

The port's own copy of ``shufflingvideosfortsg_tpu/data/masks.py``.

``sequence_mask(max_len, (st, et))`` sets positions st..et *inclusive* to 1
(clipped into range) — reference: grounding/dataset/charades.py:12-18. Note
the inclusive end: the reference's video mask ``[0, nfeats]`` therefore
covers nfeats+1 positions and the sentence mask ``[0, sent_len]`` covers
sent_len+1; this off-by-one is part of the trained behavior and preserved.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def sequence_mask(max_len: int, temporal_boundary: Sequence[int],
                  dtype=np.int32) -> np.ndarray:
    st, et = temporal_boundary
    mask = np.zeros(max_len, dtype=dtype)
    st_ = max(0, int(st))
    et_ = min(int(et), max_len - 1)
    mask[st_:et_ + 1] = 1
    return mask


def sample_masks(max_len: int, framestamps: Sequence[int], nfeats: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The four per-sample masks (charades.py:164-169): video, temporal
    (GT span), foreground [0, s], background [e, nfeats]."""
    video_mask = sequence_mask(max_len, (0, nfeats))
    temporal_labels = sequence_mask(max_len, framestamps)
    fore_mask = sequence_mask(max_len, (0, framestamps[0]))
    back_mask = sequence_mask(max_len, (framestamps[1], nfeats))
    return video_mask, temporal_labels, fore_mask, back_mask
