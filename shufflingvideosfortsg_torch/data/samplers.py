"""Feature samplers: raw clip features -> fixed [1, SAMPLE_LEN, D] arrays.

The port's own copy of ``shufflingvideosfortsg_tpu/data/samplers.py``.

Vectorized NumPy equivalents of the reference's per-clip Python loops, with
identical outputs:

- pair_mean_pool:   charades i3d (charades.py:177-196) — adjacent-pair mean
  pool, truncate to SAMPLE_LEN
- one_to_one:       anet i3d (anet.py:193-208) — copy, truncate
- frame_to_second:  anet 'raw' (anet.py:173-191) — one source frame per
  output second
- frame_to_second_114: anet '114' (anet.py:210-230) — per-second mean pool
  (NOTE: returns nfeats = raw clip count, the reference's quirk)
- lg_fixed_length:  LGI-style strided resampling with positional span labels
  (charades.py:198-243 / anet.py:232-277)

All return (feats [1, L, D] float64, framestamps, nfeats) exactly like the
reference (float64 zeros + assignment — kept so collate's float() cast is
the single downcast point).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SamplerResult = Tuple[np.ndarray, Sequence[int], int]


def clip_framestamps(timestamps: Sequence[float], sample_len: int) -> List[int]:
    """int(sec) clipped to sample_len-1 (charades.py:178)."""
    return [int(x) if int(x) < sample_len else sample_len - 1
            for x in timestamps]


def pair_mean_pool(video_fts: np.ndarray, timestamps, video_duration,
                   sample_len: int) -> SamplerResult:
    framestamps = clip_framestamps(timestamps, sample_len)
    cn, dim = video_fts.shape
    n_out = min((cn + 1) // 2, sample_len)
    out = np.zeros((1, sample_len, dim))
    idx = np.arange(n_out) * 2
    second = np.minimum(idx + 1, cn - 1)
    out[0, :n_out] = (np.asarray(video_fts[idx]) + np.asarray(video_fts[second])) / 2.0
    return out, framestamps, n_out


def one_to_one(video_fts: np.ndarray, timestamps, video_duration,
               sample_len: int) -> SamplerResult:
    framestamps = clip_framestamps(timestamps, sample_len)
    cn, dim = video_fts.shape
    n = min(cn, sample_len)
    out = np.zeros((1, sample_len, dim))
    out[0, :n] = video_fts[:n]
    return out, framestamps, n


def frame_to_second(video_fts: np.ndarray, timestamps, duration,
                    sample_len: int) -> SamplerResult:
    framestamps = clip_framestamps(timestamps, sample_len)
    cn, dim = video_fts.shape
    out = np.zeros((1, sample_len, dim))
    rate = cn / duration
    secs = np.arange(sample_len)
    valid = secs < duration
    src = np.minimum(np.maximum(0, np.floor(secs[valid] * rate)).astype(int), cn - 1)
    out[0, secs[valid]] = np.asarray(video_fts[src])
    return out, framestamps, int(valid.sum())


def frame_to_second_114(video_fts: np.ndarray, timestamps, duration,
                        sample_len: int) -> SamplerResult:
    framestamps = clip_framestamps(timestamps, sample_len)
    cn, dim = video_fts.shape
    out = np.zeros((1, sample_len, dim))
    rate = cn / duration
    fts = np.asarray(video_fts)
    for i in range(sample_len):
        if i < duration:
            start = min(cn - 1, max(0, int(i * rate + 0.5)))
            end = int((i + 1) * rate + 0.5)
            if end > cn or end <= start:
                out[0, i] = fts[start]
            else:
                out[0, i] = fts[start:end].mean(0)
    # the reference returns the raw clip count as nfeats here (anet.py:230)
    return out, framestamps, cn


def triple_mean_pool(video_fts: np.ndarray, timestamps, video_duration,
                     sample_len: int) -> SamplerResult:
    """charades lgi3d sampler (charades.py:245-269): groups of 3 clips,
    partial trailing groups mean-pooled over what's available."""
    framestamps = clip_framestamps(timestamps, sample_len)
    cn, dim = video_fts.shape
    n_out = min((cn + 2) // 3, sample_len)
    out = np.zeros((1, sample_len, dim))
    starts = np.arange(n_out) * 3
    sums = np.add.reduceat(np.asarray(video_fts[:min(cn, n_out * 3)]), starts, axis=0)
    counts = np.minimum(starts + 3, cn) - starts
    out[0, :n_out] = sums / counts[:, None]
    return out, framestamps, n_out


def lg_fixed_length(video_fts: np.ndarray, timestamps, video_duration,
                    sample_len: int, is_train: bool,
                    rng: np.random.RandomState) -> SamplerResult:
    """LGI resampling: stride over clips, positional (index) span labels.

    Train draws a random phase like the reference's
    np.random.random_integers(0, -0.5+stride) (charades.py:214-219).
    """
    start_pos = min(max(timestamps[0] / video_duration, 0), 1)
    end_pos = min(max(timestamps[1] / video_duration, 0), 1)
    num_segment = sample_len
    nfeats = video_fts.shape[0]
    stride = 1.0 if nfeats <= sample_len else nfeats * 1.0 / num_segment
    if not is_train:
        spos = 0
    else:
        random_end = -0.5 + stride
        if random_end == np.floor(random_end):
            random_end -= 1.0
        # random_integers(0, x) == randint(0, floor(x)+1); guard tiny strides
        spos = rng.randint(0, max(int(np.floor(random_end)), 0) + 1)
    s = np.round(np.arange(spos, nfeats - 0.5, stride)).astype(int)
    start_pos = float(nfeats - 1.0) * start_pos
    end_pos = float(nfeats - 1.0) * end_pos
    if not (nfeats < sample_len and len(s) == nfeats) \
            and not (nfeats >= sample_len and len(s) == num_segment):
        s = s[:num_segment]
    assert (nfeats < sample_len and len(s) == nfeats) \
        or (nfeats >= sample_len and len(s) == num_segment)

    start_index, end_index = None, None
    for i in range(len(s) - 1):
        if s[i] <= end_pos < s[i + 1]:
            end_index = i
        if s[i] <= start_pos < s[i + 1]:
            start_index = i
    if start_index is None:
        start_index = 0
    if end_index is None:
        end_index = num_segment - 1

    cur = np.asarray(video_fts[s])
    nfeats = min(nfeats, num_segment)
    out = np.zeros((1, num_segment, cur.shape[1]))
    out[0, :nfeats] = cur[:nfeats]
    return out, (start_index, end_index), nfeats
