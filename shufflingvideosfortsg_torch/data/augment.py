"""Video augmentation library (host-side, NumPy).

The port's own copy of ``shufflingvideosfortsg_tpu/data/augment.py``.

Re-implements the five augmentation modes of the reference's
DataAugmentForTSG (grounding/dataset/data_augment.py) with identical
semantics on [1, T, D] feature arrays:

- gt_moment_crop:      delete a random sub-span of the GT moment, shift left
- protected_gt_moment_crop: crop avoiding 20% protected boundaries
- gt_moment_cropout:   overwrite an interior GT region with an outside region
- gt_moment_translate: remove the GT moment and reinsert it whole at a
                       random offset (THE mode used by the paper's framework)
- shuffle_temporal_order_by_short_segments{,_pad,2}: permute fixed-length
  segments

RNG discipline: the reference seeds numpy but then draws from the *global*
python ``random`` module (non-reproducible across workers). Here every
instance owns a seeded ``random.Random`` + ``RandomState``, so runs are
reproducible; draw distributions match the reference (``randint`` bounds
reproduced verbatim, including its asymmetric ``+1`` quirks).

The JAX package's on-device equivalent (ops/augment_device.py) expresses
gt_translate as an index gather; this module doubles as its oracle.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

AugResult = Tuple[List[int], int, np.ndarray]


class DataAugmentForTSG:
    def __init__(self, seed: int, aug_percentage: float, mode: str = 'all',
                 seg_len: int | None = None):
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.aug_percentage = aug_percentage
        self.protected_ratio = 0.2
        self.count = 0
        self.aug_mode = mode
        self.seg_len = seg_len
        if mode in ('all',):
            self.fn_candidate = [self.protected_gt_moment_crop, self.gt_moment_cropout]
        elif mode in ('gt_crop',):
            self.fn_candidate = [self.gt_moment_crop]
        elif mode in ('gt_cropout',):
            self.fn_candidate = [self.gt_moment_cropout]
        elif mode in ('prot_gt_crop',):
            self.fn_candidate = [self.protected_gt_moment_crop]
        elif mode in ('gt_translate',):
            self.fn_candidate = [self.gt_moment_translate]
        elif mode in ('shuffle_temporal',):
            self.fn_candidate = [self.shuffle_temporal_order_by_short_segments]
        else:
            self.fn_candidate = [self.gt_moment_crop, self.gt_moment_cropout]

    def aug_data(self, framestps, nfeats, video_feat,
                 min_crop_width_ratio=0.2, max_crop_width_ratio=0.5) -> AugResult:
        if self.np_rng.rand() > self.aug_percentage:
            self.count += 1
            return framestps, nfeats, video_feat
        fn_idx = self.rng.randint(0, len(self.fn_candidate) - 1) \
            if len(self.fn_candidate) > 1 else 0
        fn = self.fn_candidate[fn_idx]
        if self.aug_mode == 'shuffle_temporal':
            # the reference's dispatch passes crop *ratios* into seg_len here
            # (data_augment.py:28-36 -> :158-200), crashing with a float
            # reshape; require an explicit segment length instead.
            if self.seg_len is None:
                raise ValueError(
                    "aug_mode='shuffle_temporal' needs an explicit integer "
                    "seg_len (pass seg_len= to DataAugmentForTSG, or set "
                    "aug_seg_len in the config); the reference's aug_data "
                    "dispatch passes crop ratios here and crashes.")
            return fn(framestps, nfeats, video_feat, self.seg_len)
        return fn(framestps, nfeats, video_feat,
                  min_crop_width_ratio, max_crop_width_ratio)

    # -- crops ---------------------------------------------------------------

    def gt_moment_crop(self, framestps, nfeats, video_feat,
                       min_crop_width_ratio=0.2, max_crop_width_ratio=0.5,
                       crop_width=None, crop_start=None) -> AugResult:
        raw_start, raw_end = framestps
        L = raw_end - raw_start + 1
        if L <= 1:
            return framestps, nfeats, video_feat
        if crop_width is None or crop_width >= L:
            # reference draws randint(ceil(L*minr), ceil(L*maxr))
            lo = int(np.ceil(L * min_crop_width_ratio))
            hi = int(np.ceil(L * max_crop_width_ratio))
            crop_width = self.rng.randint(min(lo, hi), max(lo, hi))
        if crop_start is None or crop_start < raw_start or crop_start > raw_end:
            # the reference's upper bound is raw_end - crop_width + 1
            crop_start = self.rng.randint(raw_start, raw_end - crop_width + 1)
        crop_end = crop_start + crop_width - 1

        kept = np.delete(video_feat.copy(),
                         list(range(crop_start, crop_end + 1)), axis=1)
        out = np.zeros(video_feat.shape)
        out[0, :kept.shape[1], :] = kept[0]
        return ([raw_start, raw_end - crop_width], nfeats - crop_width, out)

    def protected_gt_moment_crop(self, framestps, nfeats, video_feat,
                                 min_crop_width_ratio=0.2,
                                 max_crop_width_ratio=0.5,
                                 crop_width=None, crop_start=None) -> AugResult:
        raw_start, raw_end = framestps
        L = raw_end - raw_start + 1
        if L <= 1:
            return framestps, nfeats, video_feat
        prot_start = raw_start + int(np.ceil(L * self.protected_ratio))
        prot_end = raw_end - int(np.ceil(L * self.protected_ratio))
        if crop_width is None or crop_width > L:
            span = prot_end - prot_start
            lo = int(np.ceil(span * min_crop_width_ratio))
            hi = int(np.ceil(span * max_crop_width_ratio))
            crop_width = self.rng.randint(min(lo, hi), max(lo, hi))
        if crop_start is None or crop_start < raw_start or crop_start > raw_end:
            crop_start = self.rng.randint(prot_start, prot_end - crop_width + 1)
        crop_end = crop_start + crop_width - 1
        kept = np.delete(video_feat.copy(),
                         list(range(crop_start, crop_end + 1)), axis=1)
        out = np.zeros(video_feat.shape)
        out[0, :kept.shape[1], :] = kept[0]
        return ([raw_start, raw_end - crop_width], nfeats - crop_width, out)

    def gt_moment_cropout(self, framestps, nfeats, video_feat,
                          min_crop_width_ratio=0.2,
                          max_crop_width_ratio=0.5) -> AugResult:
        raw_start, raw_end = framestps
        L = raw_end - raw_start + 1
        if L <= 1:
            return framestps, nfeats, video_feat
        pad = int(np.ceil(L * self.protected_ratio))
        prot_start_l, prot_start_r = raw_start - pad, raw_start + pad
        prot_end_l, prot_end_r = raw_end - pad, raw_end + pad

        span = prot_end_l - prot_start_r
        lo = int(np.ceil(span * min_crop_width_ratio))
        hi = int(np.ceil(span * max_crop_width_ratio))
        crop_width = self.rng.randint(min(lo, hi), max(lo, hi))
        if crop_width <= 0:
            return self.gt_moment_crop(framestps, nfeats, video_feat,
                                       min_crop_width_ratio, max_crop_width_ratio)
        cropout_start = self.rng.randint(prot_start_r, prot_end_l - crop_width + 1)

        candidates: List[int] = []
        if prot_start_l >= crop_width:
            candidates += list(range(int(prot_start_l)))
        if nfeats - 1 - prot_end_r >= crop_width:
            candidates += list(range(int(prot_end_r), nfeats - crop_width))
        if not candidates:
            return self.gt_moment_crop(framestps, nfeats, video_feat,
                                       min_crop_width_ratio, max_crop_width_ratio,
                                       crop_width, cropout_start)
        cropin_start = candidates[self.rng.randint(0, len(candidates) - 1)
                                  if len(candidates) > 1 else 0]
        out = video_feat.copy()
        out[0, cropout_start:cropout_start + crop_width, :] = \
            video_feat[0, cropin_start:cropin_start + crop_width]
        return framestps, nfeats, out

    # -- translate (the framework's mode) -------------------------------------

    def gt_moment_translate(self, framestps, nfeats, video_feat, *args) -> AugResult:
        raw_start, raw_end = framestps
        L = raw_end - raw_start + 1
        if L <= 1 or L >= nfeats:
            return framestps, nfeats, video_feat
        cropin_start = self.rng.randint(0, nfeats - L)
        return self.gt_moment_translate_at(framestps, nfeats, video_feat,
                                           cropin_start)

    @staticmethod
    def gt_moment_translate_at(framestps, nfeats, video_feat,
                               cropin_start: int) -> AugResult:
        """Deterministic core of gt_translate (separated so the device
        version can be tested against it at a fixed insertion offset)."""
        raw_start, raw_end = framestps
        L = raw_end - raw_start + 1
        if L <= 1 or L >= nfeats:
            return framestps, nfeats, video_feat
        wo_len = nfeats - L
        wo = np.zeros(video_feat.shape)
        wo[0, :raw_start, :] = video_feat[0, :raw_start]
        if raw_start < wo_len:
            wo[0, raw_start:wo_len, :] = video_feat[0, raw_end + 1:nfeats]
        inserted = np.insert(wo, [cropin_start] * L,
                             video_feat[0, raw_start:raw_end + 1], axis=1)
        out = np.zeros(video_feat.shape)
        out[0, :video_feat.shape[1]] = inserted[0, :video_feat.shape[1], :]
        return [cropin_start, cropin_start + L - 1], nfeats, out

    # -- segment shuffles ------------------------------------------------------

    @staticmethod
    def _check_seg_len(seg_len):
        if not (isinstance(seg_len, (int, np.integer)) and seg_len >= 1):
            raise ValueError(
                f'seg_len must be a positive integer, got {seg_len!r}')

    def shuffle_temporal_order_by_short_segments(self, framestps, nfeats,
                                                 video_feat, seg_len, *args
                                                 ) -> AugResult:
        self._check_seg_len(seg_len)
        _, T, D = video_feat.shape
        T_ = T // seg_len
        reshaped = np.reshape(video_feat[:, :T_ * seg_len], (T_, seg_len, D))
        perm = self.np_rng.permutation(T_)
        out = reshaped[perm].reshape((1, T_ * seg_len, D))
        if T_ * seg_len < T:  # reference assumes divisibility; keep tail
            out = np.concatenate([out, video_feat[:, T_ * seg_len:]], axis=1)
        return framestps, nfeats, out

    def pad_vfeat(self, video_feat, seg_len):
        _, T, D = video_feat.shape
        pad = T % seg_len
        if pad == 0:
            return video_feat
        out = np.zeros((1, T + seg_len - pad, D))
        out[:, :T] = video_feat
        return out

    def shuffle_temporal_order_by_short_segments_pad(self, framestps, nfeats,
                                                     video_feat, seg_len, *args
                                                     ) -> AugResult:
        self._check_seg_len(seg_len)
        _, raw_T, D = video_feat.shape
        padded = self.pad_vfeat(video_feat, seg_len)
        _, T, _ = padded.shape
        T_ = T // seg_len
        perm = self.np_rng.permutation(T_)
        out = np.reshape(padded, (T_, seg_len, D))[perm].reshape((1, T, D))
        return framestps, nfeats, out[:, :raw_T]

    def shuffle_temporal_order_by_short_segments2(self, framestps, nfeats,
                                                  video_feat, seg_len, *args
                                                  ) -> AugResult:
        self._check_seg_len(seg_len)
        _, raw_T, D = video_feat.shape
        trimmed = self.pad_vfeat(video_feat[:, :nfeats], seg_len)
        _, T, _ = trimmed.shape
        T_ = T // seg_len
        perm = self.np_rng.permutation(T_)
        shuffled = np.reshape(trimmed, (T_, seg_len, D))[perm].reshape((1, T, D))
        out = np.zeros((1, raw_T, D))
        n = min(raw_T, T)
        out[0, :n] = shuffled[0, :n]
        return framestps, T, out
