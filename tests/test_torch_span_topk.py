"""The port's top-k span decode (``ops/span.py``: ``span_topk``,
``span_topk_nms``, ``_greedy_nms``) against the JAX package's on the same
probabilities: spans equal, scores within 1e-6, over several T and row
blocks, exact ties, k above the number of valid spans, a zero-length best
span and an exhausted pool."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shufflingvideosfortsg_tpu.ops import span as jax_span
from shufflingvideosfortsg_torch.ops import span as port_span
from torch_one_thread import one_torch_thread  # noqa: F401

SCORE_TOL = 1e-6


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _both(fn, start, end, *args, **kw):
    want = getattr(jax_span, fn)(jnp.asarray(start), jnp.asarray(end), *args,
                                 **kw)
    got = getattr(port_span, fn)(torch.from_numpy(start),
                                 torch.from_numpy(end), *args, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same(want, got):
    (w_spans, w_scores), (g_spans, g_scores) = want, got
    assert g_spans.dtype == np.int32 and g_scores.dtype == np.float32
    np.testing.assert_array_equal(g_spans, w_spans)
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize('T,block,k', [(8, 3, 5), (50, 64, 5), (128, 32, 40),
                                       (240, 64, 8), (37, 7, 1)])
def test_span_topk_matches_jax(T, block, k):
    rng = np.random.RandomState(T)
    start = _softmax(rng.randn(6, T) * 2)
    end = _softmax(rng.randn(6, T) * 2)
    _assert_same(*_both('span_topk', start, end, k, block))


@pytest.mark.parametrize('block', [1, 5, 12])
def test_span_topk_tie_order_matches_jax(block):
    """Integer probabilities make many exact ties: equal scores go to the
    smaller flattened start*T+end, whatever the row block."""
    rng = np.random.RandomState(7)
    start = rng.randint(0, 3, (3, 12)).astype(np.float32)
    end = rng.randint(0, 3, (3, 12)).astype(np.float32)
    want, got = _both('span_topk', start, end, 30, block)
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same(want, got)


def test_span_topk_k_above_the_valid_spans_matches_jax():
    """T=3 has 6 valid spans; k=10 leaves a tail of (-inf, [0, 0])."""
    start = _softmax(np.arange(3, dtype=np.float32)[None])
    end = _softmax(np.arange(3, dtype=np.float32)[None])
    want, got = _both('span_topk', start, end, 10, 2)
    _assert_same(want, got)
    assert np.isfinite(got[1][0, :6]).all()
    assert not np.isfinite(got[1][0, 6:]).any() and (got[0][0, 6:] == 0).all()


def test_span_topk_k1_is_span_decode():
    rng = np.random.RandomState(3)
    start = torch.from_numpy(_softmax(rng.randn(16, 64) * 3))
    end = torch.from_numpy(_softmax(rng.randn(16, 64) * 3))
    spans, scores = port_span.span_topk(start, end, 1)
    pred, score = port_span.span_decode(start, end)
    assert torch.equal(spans[:, 0].long(), pred)
    assert torch.allclose(scores[:, 0], score, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize('T,k,iou', [(64, 5, 0.5), (20, 3, 0.3),
                                     (128, 8, 0.7)])
def test_span_topk_nms_matches_jax(T, k, iou):
    rng = np.random.RandomState(k)
    start = _softmax(rng.randn(8, T) * 3)
    end = _softmax(rng.randn(8, T) * 3)
    want, got = _both('span_topk_nms', start, end, k, iou_threshold=iou)
    _assert_same(want, got)


def test_nms_zero_length_best_span_is_consumed_as_in_jax():
    """The best span [5, 5] has self-IoU 0; it is taken once, not again at
    every step."""
    start = np.full((1, 16), 1e-3, np.float32)
    end = np.full((1, 16), 1e-3, np.float32)
    start[0, 5] = end[0, 5] = 0.9
    start[0, 1] = end[0, 12] = 0.5
    want, got = _both('span_topk_nms', start, end, 4, iou_threshold=0.5)
    _assert_same(want, got)
    spans, scores = got
    assert (spans[0, 0] == [5, 5]).all()
    kept = [tuple(s) for s, sc in zip(spans[0], scores[0]) if np.isfinite(sc)]
    assert len(kept) >= 2 and len(set(kept)) == len(kept)


def test_nms_exhausted_pool_repeats_the_last_span_as_in_jax():
    start = np.full((1, 16), 1e-3, np.float32)
    end = np.full((1, 16), 1e-3, np.float32)
    start[0, 2] = end[0, 10] = 0.9
    want, got = _both('span_topk_nms', start, end, 4, iou_threshold=0.99,
                      pool=3)
    _assert_same(want, got)
    spans, scores = got
    last = np.max(np.where(np.isfinite(scores[0]))[0])
    assert last < 3
    for i in range(last + 1, 4):
        assert not np.isfinite(scores[0, i])
        assert (spans[0, i] == spans[0, last]).all()


def test_greedy_nms_matches_jax_on_ties():
    """Candidates with equal scores: argmax takes the first alive one."""
    cand = np.asarray([[[0, 4], [1, 5], [6, 9], [6, 6], [2, 3], [8, 9]]],
                      np.int32)
    scores = np.asarray([[0.9, 0.9, 0.9, 0.5, 0.5, -np.inf]], np.float32)
    want = jax_span._greedy_nms(jnp.asarray(cand), jnp.asarray(scores), 5,
                                0.3)
    got = port_span._greedy_nms(torch.from_numpy(cand),
                                torch.from_numpy(scores), 5, 0.3)
    _assert_same([np.asarray(w) for w in want], [g.numpy() for g in got])
