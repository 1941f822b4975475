"""The serving tokenizer over the port's build of ``native/tokenizer.cpp``.

Counterpart of ``shufflingvideosfortsg_tpu/data/text_native.py``. A raw
sentence becomes token ids by the reference's per-dataset rules
(grounding/dataset/charades.py:120-132, anet.py:92-112) and the
OOV-dropping vocabulary lookup, in C++ with the GIL released. The
vocabulary (a pickled-dict npy artifact) is read once in Python and handed
to the native side as one blob. The library is built at first use
(``_native.tokenizer_library``); ``use_native=False`` runs the same rules
in Python (:mod:`.vocab`), which the tests hold the native path to.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import _native
from .vocab import preprocess_sentence_anet, preprocess_sentence_charades

MODES = {'charades': 0, 'anet': 1}
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


class NativeTokenizer:
    """Sentence -> token ids with the reference's per-dataset rules.

    ``encode`` returns ``(ids, n_matched)``: at most ``max_out`` in-vocab
    ids in sentence order, and the number found (more than ``len(ids)``
    means the sentence was cut, as ``vocab.pad_indices`` cuts). Each call
    writes into a buffer of its own and the native side keeps its scratch
    a thread, so client threads may share one instance."""

    def __init__(self, wordtoix: Dict[str, int], dataset: str = 'charades',
                 max_out: int = 64, use_native: bool = True):
        if dataset not in MODES:
            raise ValueError(f'dataset must be one of {sorted(MODES)}')
        self.dataset = dataset
        self.mode = MODES[dataset]
        self.max_out = int(max_out)
        self._wordtoix = wordtoix
        self._lib: Optional[ctypes.CDLL] = None
        self._h: Optional[ctypes.c_void_p] = None
        if use_native:
            self._lib = _native.tokenizer_library()
            h = ctypes.c_void_p()
            rc = self._lib.tok_create(ctypes.byref(h))
            if rc != 0:
                raise RuntimeError(f'tok_create failed: {rc}')
            self._h = h
            words = [w.encode('utf-8') for w in wordtoix]
            offsets = np.zeros(len(words) + 1, np.int64)
            np.cumsum([len(w) for w in words], out=offsets[1:])
            ids = np.asarray(list(wordtoix.values()), np.int32)
            rc = self._lib.tok_load_vocab(h, b''.join(words),
                                          offsets.ctypes.data_as(_I64P),
                                          ids.ctypes.data_as(_I32P),
                                          len(words))
            if rc != 0:
                raise RuntimeError(f'tok_load_vocab failed: {rc}')

    @property
    def native(self) -> bool:
        return self._h is not None

    def encode(self, text: str) -> Tuple[List[int], int]:
        if self._h is not None:
            out = np.empty(self.max_out, np.int32)
            n = self._lib.tok_encode(self._h, text.encode('utf-8'), self.mode,
                                     out.ctypes.data_as(_I32P), self.max_out)
            if n < 0:
                raise RuntimeError(f'tok_encode failed: {n}')
            return out[:min(n, self.max_out)].tolist(), int(n)
        # the Python path: the loader's own composition of the rules
        if self.mode == 0:
            pre = preprocess_sentence_charades(text)
        else:
            pre = preprocess_sentence_anet(text)
        idxs = [self._wordtoix[w] for w in pre.lower().split(' ')
                if w in self._wordtoix]
        return idxs[:self.max_out], len(idxs)

    def encode_batch(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Many sentences in one foreign call: ids [n, max_out] int32,
        zero-padded, and each sentence's count of in-vocab words."""
        n = len(texts)
        ids = np.zeros((n, self.max_out), np.int32)
        counts = np.zeros(n, np.int32)
        if n == 0:
            return ids, counts
        if self._h is not None:
            bs = [t.encode('utf-8') for t in texts]
            offsets = np.zeros(n + 1, np.int64)
            np.cumsum([len(b) for b in bs], out=offsets[1:])
            rc = self._lib.tok_encode_batch(
                self._h, b''.join(bs), offsets.ctypes.data_as(_I64P), n,
                self.mode, ids.ctypes.data_as(_I32P), self.max_out,
                counts.ctypes.data_as(_I32P))
            if rc != 0:
                raise RuntimeError(f'tok_encode_batch failed: {rc}')
            return ids, counts
        for i, t in enumerate(texts):
            row, c = self.encode(t)
            ids[i, :len(row)] = row
            counts[i] = c
        return ids, counts

    def close(self) -> None:
        if self._h is not None:
            self._lib.tok_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
