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
``generate_glove_wordembed.py`` uses. :func:`write_synthetic_vocab` writes
a vocabulary in the reference's format from a seed, for corpora that need
one where the GloVe artifacts are absent (``run_learning.py``).
"""

from __future__ import annotations

import os
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


GLOVE_DIM = 300


def write_synthetic_vocab(words_dir: str, n_words: int = 400,
                          seed: int = 0) -> Dict[str, str]:
    """A vocabulary in the reference's format made from ``seed``: index 0
    is ``'#START#'`` in ``wordtoix.npy`` and ``'.'`` in ``ixtoword.npy``
    (``build_word_vocab``'s aliasing), then ``n_words`` distinct lowercase
    words of 4-9 letters, purely alphabetic (``tools/make_signal_corpus.py``
    keeps only ``w.isalpha()`` words), and ``word_glove_fts_init.npy``, a
    [n_words + 1, 300] f32 matrix of normal entries with GloVe's spread
    (std 0.4). Writes the three files under ``words_dir`` and returns their
    paths by name (``wordtoix``, ``ixtoword``, ``word_glove_fts_init``)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(string.ascii_lowercase))
    words: List[str] = []
    seen = set()
    while len(words) < n_words:
        w = ''.join(rng.choice(letters, size=int(rng.integers(4, 10))))
        if w not in seen:
            seen.add(w)
            words.append(w)
    wordtoix = {'#START#': 0, **{w: i + 1 for i, w in enumerate(words)}}
    ixtoword = {0: '.', **{i + 1: w for i, w in enumerate(words)}}
    emb = (0.4 * rng.standard_normal((n_words + 1, GLOVE_DIM))
           ).astype(np.float32)
    os.makedirs(words_dir, exist_ok=True)
    paths = {name: os.path.join(words_dir, f'{name}.npy')
             for name in ('wordtoix', 'ixtoword', 'word_glove_fts_init')}
    np.save(paths['wordtoix'], np.array(wordtoix, dtype=object))
    np.save(paths['ixtoword'], np.array(ixtoword, dtype=object))
    np.save(paths['word_glove_fts_init'], emb)
    return paths


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
