"""The one traffic generator: corpora, sentence-moment pairs, batches and
arrivals, from a configuration's corpus and a traffic mix's parameters.

What a run draws from ``--seed`` changes order and values, never sizes:
the corpus and its pairs are fixed by the configuration (read from an
annotation file, or drawn from published statistics with the
configuration's own ``corpus_seed``); a training epoch's order is the
port's sampler's (a ``RandomState`` shuffle of the pairs); a served
run's inter-arrival gaps, sentences and video rows are a fixed pool,
drawn with the mix's own ``pool_seed``, put in the run seed's order.
"""

from __future__ import annotations

import json
import math
import os
import string
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

INDEX_KEYS = ('pack_row', 'token_ids', 'sent_len', 'framestps', 'nfeats',
              'timestps', 'duration')


@dataclass
class Corpus:
    """The videos (their clip counts and durations) and the sentence-moment
    pairs over them (``pair_*``, one row a pair)."""
    nfeats: np.ndarray        # [V] int32, clips of each video (<= T)
    duration: np.ndarray      # [V] float32 seconds
    pair_row: np.ndarray      # [P] int64 video row of each pair
    token_ids: np.ndarray     # [P, N] int64, 0-padded
    sent_len: np.ndarray      # [P] int64, words (capped at N)
    n_words: np.ndarray       # [P] int64, words before the cap
    timestps: np.ndarray      # [P, 2] float32 seconds
    vocab_size: int

    @property
    def num_videos(self) -> int:
        return int(self.nfeats.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.pair_row.shape[0])

    def framestps(self, T: int) -> np.ndarray:
        """[P, 2] int32: int(seconds) clipped to T - 1, as the port's
        packed datasets take them (``clip_framestamps``)."""
        f = self.timestps.astype(np.int64)
        return np.minimum(f, T - 1).astype(np.int32)


def preprocess_anet(sentence: str) -> List[str]:
    """Lower case, commas to spaces, other punctuation dropped (the
    reference code's ActivityNet preprocessing)."""
    s = sentence.lower().strip()
    for c in string.punctuation:
        s = s.replace(c, ' ') if c == ',' else s.replace(c, '')
    return s.replace('\n', '').split()


def _pad(ids: List[int], N: int):
    out = np.zeros(N, np.int64)
    n = min(len(ids), N)
    out[:n] = ids[:n]
    return out, n


def corpus_from_file(path: str, T: int, N: int) -> Corpus:
    """An ActivityNet-schema annotation file ({vid: {duration,
    timestamps, sentences}}): a video's clips min(T, ceil(duration)) (i3d
    at about one a second); every sentence a pair; the vocabulary the
    file's distinct words in sorted order from id 1 (id 0 pads)."""
    with open(path) as f:
        anno = json.load(f)
    vids = list(anno)
    words: Dict[str, int] = {}
    sentences = []
    for v in vids:
        for s in anno[v]['sentences']:
            toks = preprocess_anet(s)
            sentences.append(toks)
            for t in toks:
                words.setdefault(t, 0)
    for i, w in enumerate(sorted(words)):
        words[w] = i + 1
    duration = np.array([float(anno[v]['duration']) for v in vids],
                        np.float32)
    nfeats = np.minimum(T, np.ceil(duration)).astype(np.int32)
    rows, stamps = [], []
    for r, v in enumerate(vids):
        for ts in anno[v]['timestamps']:
            rows.append(r)
            stamps.append(ts)
    tok = np.zeros((len(sentences), N), np.int64)
    slen = np.zeros(len(sentences), np.int64)
    nw = np.zeros(len(sentences), np.int64)
    for i, toks in enumerate(sentences):
        tok[i], slen[i] = _pad([words[t] for t in toks], N)
        nw[i] = len(toks)
    return Corpus(nfeats, duration, np.array(rows, np.int64), tok, slen, nw,
                  np.array(stamps, np.float32), len(words) + 1)


def corpus_from_stats(spec: Dict, T: int, N: int) -> Corpus:
    """A corpus drawn from published statistics with the configuration's
    ``corpus_seed``: ``videos`` videos of gamma durations (``duration_s``
    mean and ``duration_shape``), clips min(T, ceil(duration *
    ``clips_per_s``)); the first ``pair_videos`` of them carry ``pairs``
    pairs, dealt out round robin; moments of gamma length (``moment_s``
    mean, ``moment_shape``) placed uniformly inside their video;
    sentences of 1 + Poisson(``words_mean`` - 1) words of ids uniform on
    [1, ``vocab``)."""
    rng = np.random.RandomState(int(spec['corpus_seed']))
    V, P = int(spec['videos']), int(spec['pairs'])
    k = float(spec['duration_shape'])
    duration = rng.gamma(k, float(spec['duration_s']) / k, V)
    duration = np.maximum(duration, float(spec['min_duration_s'])
                          ).astype(np.float32)
    nfeats = np.minimum(T, np.ceil(duration * float(spec['clips_per_s']))
                        ).astype(np.int32)
    rows = np.arange(P, dtype=np.int64) % int(spec['pair_videos'])
    km = float(spec['moment_shape'])
    length = np.minimum(rng.gamma(km, float(spec['moment_s']) / km, P),
                        duration[rows])
    start = rng.uniform(0, 1, P) * (duration[rows] - length)
    stamps = np.stack([start, start + length], -1).astype(np.float32)
    nw = 1 + rng.poisson(float(spec['words_mean']) - 1, P)
    vocab = int(spec['vocab'])
    tok = np.zeros((P, N), np.int64)
    slen = np.minimum(nw, N).astype(np.int64)
    ids = rng.randint(1, vocab, (P, N))
    tok[np.arange(N)[None] < slen[:, None]] = ids[np.arange(N)[None]
                                                  < slen[:, None]]
    return Corpus(nfeats, duration, rows, tok, slen, nw.astype(np.int64),
                  stamps, vocab)


def build_corpus(config: Dict, root: str) -> Corpus:
    T, N = config['params']['video_len'], config['params']['sent_len']
    spec = config['corpus']
    if spec['kind'] == 'file':
        return corpus_from_file(os.path.join(root, spec['annotations']), T, N)
    return corpus_from_stats(spec, T, N)


def index_batch(corpus: Corpus, rows: np.ndarray, T: int) -> Dict:
    """The index-only batch of pairs ``rows`` (a device bank's input:
    ``data/device_bank.INDEX_KEYS``)."""
    v = corpus.pair_row[rows]
    return {'pack_row': v.astype(np.int64),
            'token_ids': corpus.token_ids[rows],
            'sent_len': corpus.sent_len[rows],
            'framestps': corpus.framestps(T)[rows],
            'nfeats': corpus.nfeats[v].astype(np.int32),
            'timestps': corpus.timestps[rows],
            'duration': corpus.duration[v].astype(np.float32)}


def epoch_order(num_pairs: int, seed: int, epoch: int) -> np.ndarray:
    """The sampler's shuffled order of epoch ``epoch``
    (``data/pipeline.BatchLoader``: RandomState(seed + epoch).shuffle)."""
    idx = np.arange(num_pairs)
    np.random.RandomState((seed + epoch) % 2 ** 32).shuffle(idx)
    return idx


def stripe_batches(order: np.ndarray, batch: int, rank: int = 0,
                   world: int = 1) -> List[np.ndarray]:
    """A process's batches of an epoch order: its stripe order[rank::world]
    (padded by wrapping to the longest stripe's length), in batches of
    ``batch``, the last padded with rows 0, 1, ... of the data set, as
    the loader pads."""
    per = -(-len(order) // world)
    mine = order[rank::world]
    if len(mine) < per:
        mine = np.concatenate([mine, mine[np.arange(per - len(mine))
                                          % len(mine)]])
    out = []
    for i in range(0, per, batch):
        chunk = mine[i:i + batch]
        if len(chunk) < batch:
            chunk = np.concatenate([chunk, np.arange(batch - len(chunk))
                                    % len(order)])
        out.append(chunk)
    return out


def seeded_permutation(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed % 2 ** 32).permutation(n)


def request_pool(corpus: Corpus, mix: Dict, seconds: float) -> Dict:
    """The fixed pool of a served run: for ``rate_qps`` over ``seconds``,
    the Poisson inter-arrival gaps, each request's pair (sentence) and
    video row (uniform over the corpus), drawn with ``pool_seed``."""
    rng = np.random.RandomState(int(mix['pool_seed']))
    rate = float(mix['rate_qps'])
    n = int(math.ceil(rate * seconds))
    return {'gaps': rng.exponential(1.0 / rate, n),
            'pair': rng.randint(0, corpus.num_pairs, n),
            'video_row': rng.randint(0, corpus.num_videos, n)}


def schedule(pool: Dict, seed: int) -> Dict:
    """The run seed's order of the pool: due times in seconds from the
    window's start."""
    n = len(pool['gaps'])
    due = np.cumsum(pool['gaps'][seeded_permutation(n, seed)])
    rows = seeded_permutation(n, seed + 1)
    return {'due': due, 'pair': pool['pair'][rows],
            'video_row': pool['video_row'][seeded_permutation(n, seed + 2)]}
