"""Annotation loading: JSON schemas -> flattened per-sentence sample lists.

The port's own copy of ``shufflingvideosfortsg_tpu/data/annotations.py``.

Charades schema (data/Charades-CD/*.json): per-vid dict with sentences[],
timestamps[][2] (seconds), framestamps, video_duration, decode_fps.
ANet schema (data/ANet-CD/*.json): sentences[], timestamps[][2], duration.

One training sample = one (sentence, video) pair; a video with k sentences
appears k times (charades.py:113-118). Sentence text preprocessing is
per-dataset (see data/vocab.py) and the *preprocessed* sentence string is
what reaches prediction JSONs, as in the reference.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .vocab import (Vocab, pad_indices, preprocess_sentence_anet,
                    preprocess_sentence_charades)

CHARADES_SPLITS = {
    'train': 'train', 'train_f': 'train', 'charades_train': 'train',
    'test': 'test', 'test_f': 'test', 'charades_test_iid': 'test',
    'test_ood': 'test_ood', 'charades_test_ood': 'test_ood',
}
ANET_SPLITS = {
    'train': 'train', 'train_f': 'train', 'anet_train': 'train',
    'val_2': 'val_2', 'val_2_f': 'val_2', 'val_1': 'val_1', 'val_1_f': 'val_1',
    'anet_test_iid': 'test_iid', 'anet_test_ood': 'test_ood', 'anet_val': 'val',
}


@dataclass
class SentenceSample:
    vid: str
    sentence: str          # preprocessed display/text form
    token_ids: np.ndarray  # [sent_len] int64, 0-padded
    sentence_len: int
    timestamps: Sequence[float]
    duration: float


def detect_split(annotation_file: str, dataset: str) -> str:
    prefix = os.path.splitext(os.path.split(annotation_file)[-1])[0]
    table = CHARADES_SPLITS if dataset == 'charades' else ANET_SPLITS
    default = 'val' if dataset == 'charades' else 'val_m'
    return table.get(prefix, default)


def load_sentence_samples(annotation_file: str, dataset: str, vocab: Vocab,
                          sent_len: int) -> List[SentenceSample]:
    """Flatten annotations into per-sentence samples with encoded tokens."""
    anno: Dict = json.load(open(annotation_file, 'r'))
    samples: List[SentenceSample] = []
    charades = dataset == 'charades'
    for vid, entry in anno.items():
        duration = entry['video_duration'] if charades else entry['duration']
        for sidx, raw_sentence in enumerate(entry['sentences']):
            if charades:
                sentence = preprocess_sentence_charades(raw_sentence)
            else:
                sentence = preprocess_sentence_anet(raw_sentence)
            idxs = vocab.encode(sentence.lower().split(' '))
            token_ids, n = pad_indices(idxs, sent_len)
            samples.append(SentenceSample(
                vid=vid,
                sentence=sentence,
                token_ids=token_ids,
                sentence_len=min(n, sent_len),
                timestamps=entry['timestamps'][sidx],
                duration=duration,
            ))
    return samples
