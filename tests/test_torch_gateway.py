"""The port's serving gateway (``gateway.py`` over its own build of
``native/gateway.cpp``) and serving tokenizer (``data/text_native.py``
over ``native/tokenizer.cpp``).

- The queue: a concurrent round trip, a part-full batch flushed at its
  deadline, backpressure and dead tickets, a shutdown that drains.
- The gateway in ``bank`` (pipeline depth 1 and 3) and ``video`` mode and
  on raw text, also from 8 client threads at once: every result equal to the grounder's own
  ``ground_tokens``/``ground_tokens_video`` on the same requests; a worker
  that raises hands its error to the clients.
- The tokenizer's native path against its Python path on unit cases and
  every sentence of ``data/ANet-CD/anet_train.json``, and one instance
  shared by 8 threads.

Every wait is bounded and every gateway is closed in ``finally``. On a
card (skipped here): the gateway over the kernels.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch import _native
from shufflingvideosfortsg_torch import gateway as gwmod
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.data.text_native import NativeTokenizer
from shufflingvideosfortsg_torch.data.vocab import (
    preprocess_sentence_anet, preprocess_sentence_charades)
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
from torch_one_thread import one_torch_thread  # noqa: F401

T, N, DV = 20, 6, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60  # the bound on every wait for a result or a thread


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)


# --- the queue ---------------------------------------------------------------

def _echo_worker(q, max_batch=16, first_wait_us=200_000, flush_us=1_000):
    """Answers each request with (sum of tokens, video row, nonzero
    tokens), so a client sees its own payload come back."""
    while True:
        try:
            tickets, tokens, vids = q.next_batch(max_batch, first_wait_us,
                                                 flush_us)
        except gwmod.GatewayClosed:
            return
        if len(tickets):
            q.complete(tickets, tokens.sum(axis=1).astype(np.float32),
                       vids.astype(np.float32),
                       (tokens != 0).sum(axis=1).astype(np.float32))


def test_library_is_the_ports_own_build():
    for lib, name in ((_native.gateway_library(), 'libgateway_'),
                      (_native.tokenizer_library(), 'libtokenizer_')):
        assert os.path.dirname(lib._name) == _native.BUILD_DIR
        assert os.path.basename(lib._name).startswith(name)
    assert '-pthread' in _native.GATEWAY_FLAGS
    assert not any('march' in f for f in _native.GATEWAY_FLAGS
                   + _native.TOKENIZER_FLAGS)


def test_queue_concurrent_round_trip():
    q = gwmod.NativeBatchQueue(capacity=256, max_tokens=8)
    worker = threading.Thread(target=_echo_worker, args=(q,), daemon=True)
    worker.start()
    errors = []

    def client(seed):
        rng = np.random.RandomState(seed)
        for _ in range(50):
            toks = rng.randint(1, 100, rng.randint(1, 9)).astype(np.int32)
            vid = int(rng.randint(0, 1000))
            out = q.wait(q.submit(toks, vid), timeout_us=WAIT_S * 10**6)
            if out != (float(toks.sum()), float(vid), float(len(toks))):
                errors.append((seed, toks, vid, out))
                return

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        _join(threads)
        assert not errors, errors[:3]
        stats = q.stats()
        assert stats['submitted'] == stats['completed'] == 300
        assert stats['batches'] < 300  # requests shared batches
    finally:
        q.shutdown()
        _join([worker])


def test_part_full_batch_flushes_at_its_deadline():
    q = gwmod.NativeBatchQueue(capacity=16, max_tokens=4)
    worker = threading.Thread(target=_echo_worker, args=(q, 64),
                              daemon=True)
    worker.start()
    try:
        t0 = time.perf_counter()
        out = q.wait(q.submit([7], 3), timeout_us=WAIT_S * 10**6)
        assert out is not None and out[0] == 7.0
        assert time.perf_counter() - t0 < 1.0
    finally:
        q.shutdown()
        _join([worker])


def test_backpressure_and_dead_tickets():
    q = gwmod.NativeBatchQueue(capacity=2, max_tokens=4)
    try:
        t1 = q.submit([1], 0)
        q.submit([2], 0)
        with pytest.raises(gwmod.QueueFull):
            q.submit([3], 0)
        tickets, _, _ = q.next_batch(1, 10_000, 0)
        assert list(tickets) == [t1]
        q.complete(tickets, np.zeros(1), np.zeros(1), np.zeros(1))
        assert q.wait(t1, 100_000) == (0.0, 0.0, 0.0)
        q.submit([3], 0)  # the slot is reused
        with pytest.raises(KeyError):
            q.wait(t1, 0)  # consumed
        with pytest.raises(KeyError):
            q.wait(10**12, 0)  # never issued
        with pytest.raises(ValueError):
            q.submit([1] * 5, 0)
    finally:
        q.shutdown()
    with pytest.raises(gwmod.GatewayClosed):
        q.submit([4], 0)


def test_shutdown_drains_queued_work():
    q = gwmod.NativeBatchQueue(capacity=16, max_tokens=4)
    tickets = [q.submit([i], 0) for i in range(1, 6)]
    q.shutdown()
    got, toks, _ = q.next_batch(16, 10_000, 0)
    assert len(got) == 5
    q.complete(got, toks.sum(axis=1).astype(np.float32), np.zeros(5),
               np.zeros(5))
    for i, t in enumerate(tickets):
        assert q.wait(t, 100_000)[0] == float(i + 1)
    with pytest.raises(gwmod.GatewayClosed):
        q.next_batch(16, 1_000, 0)


# --- the gateway -------------------------------------------------------------

def _grounder(device='cpu'):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=DV, sent_rnn_hiddendim=8,
                  sent_rnn_layers=1, video_rnn_hiddendim=8,
                  video_rnn_layers=1, mlp_hidden_dim=8, m_pred_hidden=16,
                  dropout=0.0, sent_len=N)
    torch.manual_seed(0)
    state = build_model(params, 'gmd', device='cpu').state_dict()
    g = MultiQueryGrounder(params, state, device=device, query_batch=8)
    rng = np.random.RandomState(7)
    g.set_videos(rng.randn(3, T, DV).astype(np.float32))
    g.set_vocab(rng.randn(50, 300).astype(np.float32))
    g.set_video(rng.randn(T, DV).astype(np.float32))
    return g


@pytest.fixture(scope='module')
def grounder():
    return _grounder()


def _serve_concurrently(gw, token_ids, vids, clients=4):
    """Every request submitted from ``clients`` threads; results by row."""
    results, lock = {}, threading.Lock()
    per = -(-len(token_ids) // clients)

    def client(lo):
        tickets = [(i, gw.submit(token_ids[i], int(vids[i])))
                   for i in range(lo, min(lo + per, len(token_ids)))]
        for i, t in tickets:
            out = gw.result(t, timeout_s=WAIT_S)
            with lock:
                results[i] = out

    threads = [threading.Thread(target=client, args=(lo,))
               for lo in range(0, len(token_ids), per)]
    for t in threads:
        t.start()
    _join(threads)
    return results


def _assert_equal_direct(results, direct):
    pred, score = direct
    assert sorted(results) == list(range(len(pred)))
    for i, (s, e, sc) in results.items():
        assert (s, e) == tuple(pred[i]), i
        assert sc == np.float32(score[i]), i  # the same batch computation


@pytest.mark.parametrize('depth', [1, 3])
def test_gateway_bank_mode_equals_ground_tokens(grounder, depth):
    rng = np.random.RandomState(11)
    token_ids = rng.randint(0, 50, (40, N)).astype(np.int32)
    vids = (np.arange(40) % 3).astype(np.int32)
    gw = gwmod.ServingGateway(grounder, mode='bank', flush_us=2_000,
                              max_tokens=N, pipeline_depth=depth)
    try:
        results = _serve_concurrently(gw, token_ids, vids)
        assert gw.stats()['completed'] == 40
    finally:
        gw.close()
    _assert_scores_close(results, grounder.ground_tokens(token_ids, vids))


def _assert_scores_close(results, direct):
    """Spans equal; scores within 1e-6 (a request's batch mates differ
    from the direct call's, and a row's f32 sums may follow its batch)."""
    pred, score = direct
    assert sorted(results) == list(range(len(pred)))
    for i, (s, e, sc) in results.items():
        assert (s, e) == tuple(pred[i]), i
        assert abs(sc - score[i]) <= 1e-6, i


def test_gateway_video_mode_equals_ground_tokens_video(grounder):
    rng = np.random.RandomState(13)
    token_ids = rng.randint(0, 50, (8, N)).astype(np.int32)
    gw = gwmod.ServingGateway(grounder, mode='video', max_tokens=N,
                              flush_us=200_000)
    try:
        tickets = [gw.submit(token_ids[i]) for i in range(8)]
        results = {i: gw.result(t, timeout_s=WAIT_S)
                   for i, t in enumerate(tickets)}
    finally:
        gw.close()
    # one full batch of the same 8 rows as the direct call: equal bits
    _assert_equal_direct(results, grounder.ground_tokens_video(token_ids))


def test_gateway_raw_text_equals_ground_tokens(grounder):
    wordtoix = {'person': 3, 'opens': 17, 'the': 5, 'door': 29,
                'closes': 41, 'a': 8, 'window': 12}
    tok = NativeTokenizer(wordtoix, 'charades', max_out=N)
    texts = ['A person opens the door.', 'the PERSON closes a window!',
             'door window door window door window', 'unknownword the door']
    padded = np.zeros((len(texts), N), np.int32)
    for i, s in enumerate(texts):
        ids, _ = tok.encode(s)
        padded[i, :len(ids)] = ids
    vids = np.array([0, 1, 2, 0], np.int32)
    pred, score = grounder.ground_tokens(padded, vids)
    gw = gwmod.ServingGateway(grounder, mode='bank', max_tokens=N,
                              tokenizer=tok)
    try:
        for i, s in enumerate(texts):
            st, en, sc = gw.ground_text(s, int(vids[i]), timeout_s=WAIT_S)
            assert (st, en) == tuple(pred[i]) and abs(sc - score[i]) <= 1e-6
        with pytest.raises(ValueError, match='no in-vocab'):
            gw.submit_text('zz9qq entirely oov !!!')
        with pytest.raises(IndexError, match='video_row'):
            gw.submit(padded[0], 3)
        with pytest.raises(IndexError, match='token ids'):
            gw.submit([50], 0)
    finally:
        gw.close()
        tok.close()


def test_gateway_raw_text_from_many_threads(grounder):
    """Clients on 8 threads share the gateway's one tokenizer: each
    request grounds its own sentence."""
    words = ['person', 'opens', 'the', 'door', 'closes', 'a', 'window']
    wordtoix = {w: i + 3 for i, w in enumerate(words)}
    tok = NativeTokenizer(wordtoix, 'charades', max_out=N)
    rng = np.random.RandomState(19)
    texts = [' '.join(rng.choice(words, rng.randint(1, N + 1)))
             for _ in range(48)]
    padded = np.zeros((len(texts), N), np.int32)
    for i, s in enumerate(texts):
        ids, _ = tok.encode(s)
        padded[i, :len(ids)] = ids
    vids = (np.arange(len(texts)) % 3).astype(np.int32)
    results, lock = {}, threading.Lock()
    gw = gwmod.ServingGateway(grounder, mode='bank', max_tokens=N,
                              tokenizer=tok, flush_us=2_000)
    try:
        def client(lo):
            tickets = [(i, gw.submit_text(texts[i], int(vids[i])))
                       for i in range(lo, len(texts), 8)]
            for i, t in tickets:
                out = gw.result(t, timeout_s=WAIT_S)
                with lock:
                    results[i] = out

        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(8)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        gw.close()
        tok.close()
    _assert_scores_close(results, grounder.ground_tokens(padded, vids))


def test_gateway_refuses_what_it_cannot_serve(grounder):
    with pytest.raises(ValueError, match='bank or video'):
        gwmod.ServingGateway(grounder, mode='nope')
    gw = gwmod.ServingGateway(grounder, mode='bank', max_tokens=N)
    try:
        with pytest.raises(ValueError, match='tokenizer'):
            gw.submit_text('a person opens the door')
    finally:
        gw.close()


def test_a_failing_worker_reaches_its_clients(grounder, monkeypatch):
    def broken(*args):
        raise FloatingPointError('injected')
    monkeypatch.setattr(grounder, '_serve_multi_tokens', broken)
    gw = gwmod.ServingGateway(grounder, mode='bank', max_tokens=N)
    try:
        t = gw.submit([1, 2, 3], 0)
        with pytest.raises(RuntimeError, match='worker died') as info:
            gw.result(t, timeout_s=WAIT_S)
        assert isinstance(info.value.__cause__, FloatingPointError)
        with pytest.raises(RuntimeError, match='worker died'):
            gw.submit([1], 0)
    finally:
        gw.close()


# --- the tokenizer -----------------------------------------------------------

CASES = ['A person opens the door.',
         'person  double--spaced,punct!ed (parenthetical) end',
         "it's a contraction-heavy, semi;colon: sentence",
         '  leading and trailing   ', '',
         'UPPERCASE SHOUTING WITH TABS\tAND\nNEWLINES',
         'word1.word2 glued,comma split', 'totally-unseen zz9qq words only',
         '!!! ... ,,, ???',
         'the the the the the the the the the the the the the the the the']


def _python_encode(text, wordtoix, dataset):
    pre = (preprocess_sentence_charades(text) if dataset == 'charades'
           else preprocess_sentence_anet(text))
    return [wordtoix[w] for w in pre.lower().split(' ') if w in wordtoix]


@pytest.fixture(scope='module')
def anet():
    """The sentences of the repo's ANet-CD train split and a vocabulary
    of every other word of them (the rest are out of vocabulary)."""
    with open(os.path.join(REPO, 'data', 'ANet-CD', 'anet_train.json')) as f:
        sentences = [s for rec in json.load(f).values()
                     for s in rec['sentences']]
    words = sorted({w for s in sentences
                    for w in preprocess_sentence_anet(s).split()})
    return sentences, {w: i for i, w in enumerate(words[::2])}


@pytest.mark.parametrize('dataset', ['charades', 'anet'])
def test_native_tokenizer_equals_its_python_path(anet, dataset):
    sentences, wordtoix = anet
    texts = CASES + sentences
    nat = NativeTokenizer(wordtoix, dataset, max_out=12)
    py = NativeTokenizer(wordtoix, dataset, max_out=12, use_native=False)
    try:
        assert nat.native and not py.native
        for text in texts:
            got = nat.encode(text)
            assert got == py.encode(text), text
            want = _python_encode(text, wordtoix, dataset)
            assert got == (want[:12], len(want)), text
        ids, counts = nat.encode_batch(texts)
        ids_py, counts_py = py.encode_batch(texts)
        np.testing.assert_array_equal(ids, ids_py)
        np.testing.assert_array_equal(counts, counts_py)
        assert len(texts) > 1000 and counts.max() > 12  # some overflow
    finally:
        nat.close()


def test_native_tokenizer_shared_by_threads(anet):
    """One instance encoding from 8 threads at once gives every thread
    the ids of its own sentences."""
    sentences, wordtoix = anet
    tok = NativeTokenizer(wordtoix, 'anet', max_out=12)
    want = [tok.encode(s) for s in sentences]
    bad, lock = [], threading.Lock()

    def worker(lo):
        for i in range(lo, len(sentences), 8):
            if tok.encode(sentences[i]) != want[i]:
                with lock:
                    bad.append(i)

    try:
        threads = [threading.Thread(target=worker, args=(lo,))
                   for lo in range(8)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        tok.close()
    assert not bad, bad[:10]


# --- on a card ---------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize('depth', [1, 2])
def test_gateway_on_the_card_equals_ground_tokens(depth):
    g = _grounder('cuda')
    rng = np.random.RandomState(17)
    token_ids = rng.randint(0, 50, (64, N)).astype(np.int32)
    vids = (np.arange(64) % 3).astype(np.int32)
    gw = gwmod.ServingGateway(g, mode='bank', max_tokens=N,
                              pipeline_depth=depth, flush_us=5_000)
    try:
        results = _serve_concurrently(gw, token_ids, vids, clients=16)
    finally:
        gw.close()
    _assert_scores_close(results, g.ground_tokens(token_ids, vids))
