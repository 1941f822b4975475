"""The port's modules against the JAX package's, at shared weights and
small widths: the BiLSTM, the evaluation-path components, span decoding,
IoU and the losses. Inputs come from numpy; tolerances are f32's (1e-5),
spans exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shufflingvideosfortsg_tpu.models import components as jc
from shufflingvideosfortsg_tpu.ops import losses as jl
from shufflingvideosfortsg_tpu.ops import span as js
from shufflingvideosfortsg_tpu.ops.rnn import BiLSTM as JaxBiLSTM
from shufflingvideosfortsg_torch.models import components as tc
from shufflingvideosfortsg_torch.ops import losses as tl
from shufflingvideosfortsg_torch.ops import span as ts
from shufflingvideosfortsg_torch.ops.rnn import BiLSTM
from shufflingvideosfortsg_torch.utils.interop import (bilstm_to_torch,
                                                       layernorm_to_torch,
                                                       linear_to_torch)
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5


def _init(module, *inputs, seed=0):
    return jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs])['params'])


def _load(module, sd):
    module.load_state_dict({k: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_bilstm_matches_jax_with_final_states():
    rng = np.random.RandomState(0)
    B, T, D, H, L = 3, 9, 12, 8, 2
    x = rng.randn(B, T, D).astype(np.float32)
    ref = JaxBiLSTM(hidden_size=H, num_layers=L)
    p = _init(ref, x)
    want = ref.apply({'params': p}, jnp.asarray(x))
    sd = {}
    bilstm_to_torch(p, 'm', L, sd)
    port = _load(BiLSTM(D, H, L), {k[2:]: v for k, v in sd.items()})
    got = port(_t(x))
    for g, w in zip(got, want):  # outputs [B,T,2H], hn and cn [2L,B,H]
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_bilstm_parameters_are_nn_lstm_shaped():
    port = BiLSTM(10, 6, 2)
    ref = torch.nn.LSTM(10, 6, 2, bidirectional=True)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    bound = 1 / np.sqrt(6)
    assert all(p.abs().max() <= bound for p in port.parameters())


def test_sentence_encoder_matches_jax():
    rng = np.random.RandomState(1)
    B, N, W, H = 3, 7, 20, 8
    q = rng.randn(B, N, W).astype(np.float32)
    ref = jc.SentenceRNNEncoder(hidden_dim=H, n_layers=2, dropout=0.0)
    p = _init(ref, q)
    want = ref.apply({'params': p}, jnp.asarray(q))
    sd = {}
    linear_to_torch(p['word_embed'], 'word_embed', sd)
    bilstm_to_torch(p['rnn'], 'rnn_cell.lstm', 2, sd)
    port = _load(tc.SentenceRNNEncoder(W, H, 2, 0.0), sd)
    for g, w in zip(port(_t(q)), want):
        _close(g, w)


def test_query_aware_encoder_matches_jax():
    rng = np.random.RandomState(2)
    B, T, D, N, Ds, H = 3, 11, 12, 5, 10, 8
    v = rng.randn(B, T, D).astype(np.float32)
    words = rng.randn(B, N, Ds).astype(np.float32)
    ref = jc.QueryAwareEncoder(hidden_dim=H, n_layers=2, nblocks=2,
                               dropout=0.0)
    p = _init(ref, v, words)
    want = ref.apply({'params': p}, jnp.asarray(v), jnp.asarray(words))
    sd = {}
    for i in range(2):
        blk, pre = p[f'block{i}'], f'blocks.{i}'
        bilstm_to_torch(blk['rnn'], f'{pre}.rnn_cell.lstm', 2, sd)
        linear_to_torch(blk['attention']['W_s'], f'{pre}.attention.W_s', sd)
        linear_to_torch(blk['attention']['W_a'], f'{pre}.attention.W_a', sd)
        sd[f'{pre}.attention.w.weight'] = _t(blk['attention']['w'].T.copy())
        linear_to_torch(blk['sent_linear'], f'{pre}.sent_linear', sd)
    layernorm_to_torch(p['norm'], 'norm', sd)
    port = _load(tc.QueryAwareEncoder(D, H, 2, 2, Ds, 0.0), sd)
    _close(port(_t(v), _t(words)), want)


def test_semantic_match_matches_jax():
    rng = np.random.RandomState(3)
    B, T, V, S, hid = 3, 10, 16, 10, 24
    v = rng.randn(B, T, V).astype(np.float32)
    s = rng.randn(B, S).astype(np.float32)
    ref = jc.VideoTextSemanticMatch('none', 256, 2, hid, 'relu', 0.0)
    p = _init(ref, v, s)
    want_logit, want_feat = ref.apply({'params': p}, jnp.asarray(v),
                                      jnp.asarray(s))
    sd = {}
    linear_to_torch(p['predict_1'], 'predict.predict.0', sd)
    linear_to_torch(p['predict_2'], 'predict.predict.2', sd)
    port = _load(tc.VideoTextSemanticMatch(V, S, 'none', hid, 'relu'), sd)
    logit, feat = port(_t(v), _t(s))
    _close(logit, want_logit)  # the raw logit, no sigmoid
    _close(feat, want_feat)


@pytest.mark.parametrize('masked', [False, True])
def test_mlp_predictor_matches_jax(masked):
    rng = np.random.RandomState(4)
    B, T, F, hid = 3, 14, 26, 8
    feat = rng.randn(B, T, F).astype(np.float32)
    mask = (np.arange(T)[None] <= rng.randint(3, T, (B, 1))).astype(np.int32)
    ref = jc.MLPPredictor(hidden_dim=hid)
    p = _init(ref, feat)
    jmask = jnp.asarray(mask) if masked else None
    want = ref.apply({'params': p}, jnp.asarray(feat), jmask)
    sd = {}
    for n in ('start_mlp_1', 'start_mlp_2', 'end_mlp_1', 'end_mlp_2'):
        linear_to_torch(p[n], n, sd)
    port = _load(tc.MLPPredictor(F, hid), sd)
    got = port(_t(feat), _t(mask) if masked else None)
    for g, w in zip(got, want):
        _close(g, w)


def _span_cases():
    rng = np.random.RandomState(5)
    B, T = 16, 12
    cont = [rng.rand(B, T).astype(np.float32) for _ in range(2)]
    # coarse values: many equal sums, so first-occurrence ties decide
    ties = [(rng.randint(0, 3, (B, T)) / 2).astype(np.float32)
            for _ in range(2)]
    zeros = [np.zeros((3, T), np.float32)] * 2  # the zero-row quirk
    return {'continuous': cont, 'ties': ties, 'zero_rows': zeros}


@pytest.mark.parametrize('case', ['continuous', 'ties', 'zero_rows'])
def test_span_decode_matches_jax_exactly(case):
    start, end = _span_cases()[case]
    want_pred, want_score = js.span_decode(jnp.asarray(start), jnp.asarray(end))
    pred, score = ts.span_decode(_t(start), _t(end))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want_pred))
    _close(score, want_score)
    m_pred, m_score = ts.span_decode_matrix(_t(start), _t(end))
    np.testing.assert_array_equal(m_pred.numpy(), np.asarray(want_pred))
    _close(m_score, want_score)


def test_iou_and_nll_match_jax():
    rng = np.random.RandomState(6)
    B, T = 10, 9
    pred = rng.randint(0, T, (B, 2)).astype(np.float32)
    gt = np.sort(rng.uniform(0, T, (B, 2)), axis=1).astype(np.float32)
    _close(ts.iou_per_sample(_t(pred), _t(gt)),
           js.iou_per_sample(jnp.asarray(pred), jnp.asarray(gt)))
    probs = rng.dirichlet(np.ones(T), size=(2, B)).astype(np.float32)
    stamps = np.sort(rng.randint(0, T, (B, 2)), axis=1).astype(np.int32)
    _close(tl.span_ground_nll(_t(probs[0]), _t(probs[1]), _t(stamps)),
           jl.span_ground_nll(*map(jnp.asarray, (probs[0], probs[1], stamps))))


@pytest.mark.parametrize('shape', [(4, 7), (4, 7, 3)])
def test_mask_logits_matches_jax(shape):
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    mask = rng.randint(0, 2, shape[:2]).astype(np.int32)
    _close(tl.mask_logits(_t(x), _t(mask)),
           jl.mask_logits(jnp.asarray(x), jnp.asarray(mask)))
