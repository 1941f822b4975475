"""Vocabulary and GloVe word-embedding artifacts.

The port's own copy of ``shufflingvideosfortsg_tpu/data/vocab.py``.

Loads the reference's npy artifacts (wordtoix / ixtoword dicts, [V, 300]
embedding matrix) and provides the per-dataset sentence preprocessing +
indexing rules (reference: charades.py:120-132, anet.py:92-112):

- charades: every punctuation char -> space; tokens = lower().split(' ');
  OOV words dropped (not UNK'd); pad with index 0 to sent_len
  (crash-on-overflow in the reference; here we truncate and note it).
- anet: lower().strip() first; ',' -> space, other punctuation deleted,
  whitespace collapsed; pad to sent_len or truncate.

The offline vocabulary-building functions stay in the JAX package's copy, which
``generate_glove_wordembed.py`` uses.
"""

from __future__ import annotations

import string
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class Vocab:
    def __init__(self, wordtoix: Dict[str, int], ixtoword: Dict[int, str],
                 embeddings: np.ndarray):
        self.wordtoix = wordtoix
        self.ixtoword = ixtoword
        self.embeddings = embeddings  # [V, 300] float32

    @classmethod
    def load(cls, wordtoix_path: str, ixtoword_path: str,
             word_fts_path: str) -> "Vocab":
        wordtoix = np.load(wordtoix_path, allow_pickle=True).tolist()
        ixtoword = np.load(ixtoword_path, allow_pickle=True).tolist()
        emb = np.asarray(np.load(word_fts_path), dtype=np.float32)
        return cls(wordtoix, ixtoword, emb)

    def encode(self, tokens: Iterable[str]) -> List[int]:
        """OOV words are dropped, matching the reference indexer."""
        return [self.wordtoix[w] for w in tokens if w in self.wordtoix]


def preprocess_sentence_charades(sentence: str) -> str:
    for c in string.punctuation:
        sentence = sentence.replace(c, ' ')
    return sentence


def tokenize_charades(sentence: str) -> List[str]:
    return sentence.lower().split(' ')


def preprocess_sentence_anet(sentence: str) -> str:
    s = sentence.lower().strip()
    for c in string.punctuation:
        s = s.replace(c, ' ') if c == ',' else s.replace(c, '')
    return ' '.join(s.replace('\n', '').split())


def tokenize_anet(sentence: str) -> List[str]:
    return sentence.lower().split(' ')


def pad_indices(idxs: Sequence[int], max_len: int) -> Tuple[np.ndarray, int]:
    """Pad with 0 (the '.' token) to max_len; truncate if longer.

    (The reference's charades path would raise on overflow — charades
    sentences never exceed 15 tokens; the anet path truncates. Truncation is
    used for both here.)"""
    arr = np.zeros(max_len, dtype=np.int64)
    n = min(len(idxs), max_len)
    arr[:n] = np.asarray(idxs[:n], dtype=np.int64)
    return arr, len(idxs)
