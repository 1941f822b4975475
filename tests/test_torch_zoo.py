"""The modules no config key reaches, against the JAX package at shared
weights: ``ops/rnn.BiGRU``, ``models/transformer.py``, ``models/graph.py``
and ``models/content_predictors.py``, each JAX parameter tree carried
across by ``utils/interop.py`` and loaded strictly.

Inputs and weight perturbations come from numpy seeds (JAX's init, then
each leaf moved by 0.1 of a normal draw, so that LayerNorm's scale and
bias are not 1 and 0). Bounds, f32: the BiGRU as ``tests/test_rnn.py``
holds JAX's against ``nn.GRU`` (atol 2e-5, rtol 1e-4); the transformer
and graph outputs atol 1e-5, rtol 1e-4; the content predictors'
probabilities atol 1e-5, rtol 1e-4; the LSTM content predictors'
gradients ``tests/test_grad_parity.py``'s (atol 1e-6, rtol 2e-3), with
JAX's BiLSTM through ``lax.scan``, as those modules run it. At bf16
(``PERF.md`` §2), JAX compiled with excess precision off and its
f32-accumulated einsums of bf16 operands widened (``tests/jax_cpu.py``):
the recurrences 2e-3, the probabilities 1e-3, the dense, LayerNorm and
attention compositions of the transformer and graph within one bf16
rounding (2^-8) of each element's magnitude plus 2^-8 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shufflingvideosfortsg_tpu.ops.attention as jax_attention
import shufflingvideosfortsg_tpu.ops.rnn as jax_rnn
from shufflingvideosfortsg_tpu.models import content_predictors as JC
from shufflingvideosfortsg_tpu.models import graph as JG
from shufflingvideosfortsg_tpu.models import transformer as JT
from shufflingvideosfortsg_torch.models import content_predictors as PC
from shufflingvideosfortsg_torch.models import graph as PG
from shufflingvideosfortsg_torch.models import transformer as PT
from shufflingvideosfortsg_torch.ops import lstm_scan
from shufflingvideosfortsg_torch.ops.rnn import BiGRU
from shufflingvideosfortsg_torch.utils import interop
from jax_cpu import _no_excess, _WidenedEinsum
from torch_one_thread import one_torch_thread  # noqa: F401

ULP = 2.0 ** -8
GRU_ATOL, GRU_RTOL = 2e-5, 1e-4      # tests/test_rnn.py
FWD_ATOL, FWD_RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 2e-3    # tests/test_grad_parity.py
BF16_RECURRENCE = 2e-3
BF16_PROB = 1e-3
B, T, D, H = 3, 12, 16, 8            # batch, steps, width, LSTM/GRU width


@pytest.fixture
def widened(monkeypatch):
    """JAX at bf16 on the CPU: the recurrences' and the attention's
    f32-accumulated einsums of bf16 operands on f32 operands (exact
    products, the same f32 sums)."""
    monkeypatch.setattr(jax_rnn, 'jnp', _WidenedEinsum())
    monkeypatch.setattr(jax_attention, 'jnp', _WidenedEinsum())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _init(module, *args, seed=0):
    """JAX's init of ``module`` on ``args``, each leaf moved by 0.1 of a
    normal draw from ``seed``, as numpy."""
    params = module.init(jax.random.PRNGKey(seed), *args)['params']
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.1 * rng.randn(
        *a.shape)).astype(np.float32), params)


def _load(port, tree, to_torch):
    state = {}
    to_torch(tree, 'm', state)
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    return port.eval()


def _apply(module, params, *args, dtype=jnp.float32, method=None):
    """JAX's forward in f32, or at bf16 compiled with excess precision off."""
    def fn(p, *a):
        return module.apply({'params': p}, *a, method=method)
    if dtype == jnp.float32:
        return fn(params, *args)
    return _no_excess(fn, params, *args)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().detach().numpy(), _np(want),
                               atol=atol, rtol=rtol)


def _close_bf16(got, want):
    """Within one bf16 rounding of each element's magnitude plus one of the
    largest |value|: an f32 sum in another order moves a rounding by one
    ulp, and a LayerNorm or product after it moves its row by as much."""
    want = _np(want)
    got = got.float().detach().numpy()
    tol = ULP * (np.abs(want) + np.abs(want).max())
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# --- BiGRU -------------------------------------------------------------------

def _bigru(L, Dx, Hx, seed, jdtype=jnp.float32, tdtype=torch.float32):
    x = np.random.RandomState(seed).randn(B, T, Dx).astype(np.float32)
    jm = jax_rnn.BiGRU(hidden_size=Hx, num_layers=L, dtype=jdtype)
    tree = _init(jm, jnp.asarray(x), seed=seed)
    port = _load(BiGRU(Dx, Hx, L, dtype=tdtype), tree, interop.bigru_to_torch)
    return jm, tree, port, x


@pytest.mark.parametrize('L', [1, 2])
@pytest.mark.parametrize('Dx,Hx', [(16, 8), (30, 16)])
def test_bigru_matches_jax(L, Dx, Hx):
    jm, tree, port, x = _bigru(L, Dx, Hx, seed=L)
    want_out, want_hn = _apply(jm, tree, jnp.asarray(x))
    with torch.no_grad():
        got_out, got_hn = port(_t(x))
    assert got_out.shape == (B, T, 2 * Hx) and got_hn.shape == (2 * L, B, Hx)
    _close(got_out, want_out, GRU_ATOL, GRU_RTOL)
    _close(got_hn, want_hn, GRU_ATOL, GRU_RTOL)


@pytest.mark.parametrize('L', [1, 2])
def test_bigru_bf16_matches_jax(L, widened):
    jm, tree, port, x = _bigru(L, D, H, seed=10 + L, jdtype=jnp.bfloat16,
                               tdtype=torch.bfloat16)
    want_out, want_hn = _apply(jm, tree, jnp.asarray(x), dtype=jnp.bfloat16)
    with torch.no_grad():
        got_out, got_hn = port(_t(x))
    assert got_out.dtype == got_hn.dtype == torch.bfloat16
    _close(got_out, want_out, BF16_RECURRENCE, 0)
    _close(got_hn, want_hn, BF16_RECURRENCE, 0)


def test_bigru_is_nn_gru():
    """``nn.GRU``'s parameter names and shapes, and its function."""
    port = BiGRU(D, H, 2)
    ref = torch.nn.GRU(D, H, 2, batch_first=True, bidirectional=True)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    port.load_state_dict(ref.state_dict(), strict=True)
    x = torch.from_numpy(np.random.RandomState(5).randn(B, T, D)
                         .astype(np.float32))
    with torch.no_grad():
        got, want = port(x), ref(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRU_ATOL, rtol=GRU_RTOL)


def test_bigru_dropout_follows_its_generator():
    port = BiGRU(D, H, 2, dropout=0.5).train()
    x = torch.randn(B, T, D)
    with torch.no_grad():
        a = port(x, torch.Generator().manual_seed(1))[0]
        b = port(x, torch.Generator().manual_seed(1))[0]
        c = port(x, torch.Generator().manual_seed(2))[0]
        off = port.eval()(x)[0]
        on = BiGRU(D, H, 2, dropout=0.0)
        on.load_state_dict(port.state_dict())
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(off, on.eval()(x)[0])


# --- transformer blocks ------------------------------------------------------

def _transformer_case(name, jdtype, tdtype):
    """(JAX module, port module, inputs) of one block: d_model D, d_hidden
    2D, 4 heads, an encoding of width 12 and 7 steps for the cross
    attentions."""
    rng = np.random.RandomState(TRANSFORMER.index(name))
    x = rng.randn(B, T, D).astype(np.float32)
    enc = rng.randn(B, 7, 12).astype(np.float32)
    if name == 'residual_ff':
        jm = JT.ResidualBlock(layer=JT.FeedForward(2 * D, dtype=jdtype),
                              dropout=0.0, dtype=jdtype)
        pm = PT.ResidualBlock(PT.FeedForward(D, 2 * D, tdtype), D, 0.0, tdtype)
        args = (x,)
    elif name == 'feed_forward':
        jm, pm, args = (JT.FeedForward(2 * D, dtype=jdtype),
                        PT.FeedForward(D, 2 * D, tdtype), (x,))
    elif name == 'encoder':
        jm = JT.EncoderLayer(D, 2 * D, 4, 0.0, dtype=jdtype)
        pm, args = PT.EncoderLayer(D, 2 * D, 4, 0.0, tdtype), (x,)
    elif name.startswith('decoder'):
        causal = name == 'decoder_causal'
        jm = JT.DecoderLayer(D, 2 * D, 4, 0.0, causal=causal, dtype=jdtype)
        pm = PT.DecoderLayer(D, 2 * D, 4, 0.0, causal=causal, dtype=tdtype,
                             d_encoding=12)
        args = (x, enc)
    else:
        jm = JT.MHAttLayer(D, 2 * D, 4, 0.0, dtype=jdtype)
        pm = PT.MHAttLayer(D, 2 * D, 4, 0.0, tdtype, d_kv=12)
        args = (x, enc)
    tree = _init(jm, *map(jnp.asarray, args))
    return jm, tree, _load(pm, tree, interop.dense_tree_to_torch), args


TRANSFORMER = ('residual_ff', 'feed_forward', 'encoder', 'decoder_causal',
               'decoder', 'mhatt')


@pytest.mark.parametrize('name', TRANSFORMER)
def test_transformer_matches_jax(name):
    jm, tree, pm, args = _transformer_case(name, jnp.float32, torch.float32)
    want = _apply(jm, tree, *map(jnp.asarray, args))
    with torch.no_grad():
        got = pm(*map(_t, args))
    _close(got, want, FWD_ATOL, FWD_RTOL)


@pytest.mark.parametrize('name', TRANSFORMER)
def test_transformer_bf16_matches_jax(name, widened):
    jm, tree, pm, args = _transformer_case(name, jnp.bfloat16, torch.bfloat16)
    want = _apply(jm, tree, *map(jnp.asarray, args), dtype=jnp.bfloat16)
    with torch.no_grad():
        got = pm(*map(_t, args))
    # bf16, or f32 where an f32 input adds bf16 branches, as JAX promotes
    assert str(got.dtype) == f'torch.{want.dtype}'
    _close_bf16(got, want)


def test_decoder_self_attention_is_causal():
    """A causal decoder's step t does not see the steps after it."""
    torch.manual_seed(0)
    layer = PT.DecoderLayer(D, 2 * D, 4, 0.0, d_encoding=12).eval()
    x, enc = torch.randn(B, T, D), torch.randn(B, 7, 12)
    moved = x.clone()
    moved[:, T // 2:] += 1.0
    with torch.no_grad():
        a, b = layer(x, enc), layer(moved, enc)
    torch.testing.assert_close(a[:, :T // 2], b[:, :T // 2])
    assert not torch.allclose(a[:, T // 2:], b[:, T // 2:])


def test_transformer_dropout_follows_its_generator():
    layer = PT.EncoderLayer(D, 2 * D, 4, 0.5).train()
    x = torch.randn(B, T, D)
    with torch.no_grad():
        a = layer(x, torch.Generator().manual_seed(3))
        b = layer(x, torch.Generator().manual_seed(3))
        c = layer(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- sentence graph ----------------------------------------------------------

M_OBJ, M_REL, N_WORDS = 4, 5, 9


def _graph_inputs(seed):
    rng = np.random.RandomState(seed)
    words = rng.randn(B, N_WORDS, D).astype(np.float32)
    obs = rng.randint(0, N_WORDS, (B, M_OBJ, 2)).astype(np.int32)
    rls = rng.randint(0, N_WORDS, (B, M_REL, 3)).astype(np.int32)
    return words, obs, rls


def test_word_feat_from_idx_matches_jax():
    words, _, rls = _graph_inputs(0)
    want = JG.word_feat_from_idx(jnp.asarray(words), jnp.asarray(rls))
    got = PG.word_feat_from_idx(_t(words), torch.from_numpy(rls))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def _graph_case(name, connect, jdtype, tdtype):
    words, obs, rls = _graph_inputs(1)
    if name == 'trilinear':
        rl, ob, sub = (words[:, i:i + M_REL] for i in range(3))
        jm = JG.TriLinear(D, connect, dtype=jdtype)
        pm = PG.TriLinear(D, D, connect, tdtype)
        args = (rl, ob, sub)
    else:
        jm = JG.GraphModelingTriplet(D, connect, dtype=jdtype)
        pm = PG.GraphModelingTriplet(D, D, connect, tdtype)
        args = (words, obs, rls)
    tree = _init(jm, *map(jnp.asarray, args), seed=2)
    return jm, tree, _load(pm, tree, interop.dense_tree_to_torch), args


def _port_args(args):
    return [torch.from_numpy(a) if a.dtype == np.int32 else _t(a)
            for a in args]


GRAPH = [(n, c) for n in ('trilinear', 'triplet')
         for c in ('hadamard product', 'concat')]


@pytest.mark.parametrize('name,connect', GRAPH)
def test_graph_matches_jax(name, connect):
    jm, tree, pm, args = _graph_case(name, connect, jnp.float32,
                                     torch.float32)
    want = _apply(jm, tree, *map(jnp.asarray, args))
    with torch.no_grad():
        got = pm(*_port_args(args))
    if name == 'triplet':
        assert got.shape == (B, M_OBJ + M_REL, D)
    _close(got, want, FWD_ATOL, FWD_RTOL)


@pytest.mark.parametrize('name,connect', GRAPH)
def test_graph_bf16_matches_jax(name, connect):
    jm, tree, pm, args = _graph_case(name, connect, jnp.bfloat16,
                                     torch.bfloat16)
    want = _apply(jm, tree, *map(jnp.asarray, args), dtype=jnp.bfloat16)
    with torch.no_grad():
        got = pm(*_port_args(args))
    _close_bf16(got, want)


# --- content predictors ------------------------------------------------------

MLP_H, LSTM_H = 12, 8
CONTENT = ('mlp', 'tied_lstm', 'condi_lstm')


def _content_case(name, jdtype, tdtype, seed=0):
    feat = np.random.RandomState(20 + seed).randn(B, T, D).astype(np.float32)
    if name == 'mlp':
        jm = JC.MLPContentPredictor(MLP_H, dtype=jdtype)
        pm = PC.MLPContentPredictor(D, MLP_H, tdtype)
    elif name == 'tied_lstm':
        jm = JC.TiedLSTMContentPredictor(LSTM_H, MLP_H, 0.0, dtype=jdtype)
        pm = PC.TiedLSTMContentPredictor(D, LSTM_H, MLP_H, 0.0, tdtype)
    elif name == 'condi_lstm':
        jm = JC.ConditionalLSTMContentPredictor(LSTM_H, 0.0, dtype=jdtype)
        pm = PC.ConditionalLSTMContentPredictor(D, LSTM_H, 0.0, tdtype)
    else:
        jm = JC.StartConditionedPredictor(MLP_H, LSTM_H, 0.0, dtype=jdtype)
        pm = PC.StartConditionedPredictor(D, MLP_H, LSTM_H, 0.0, tdtype)
    args = (jnp.asarray(feat),)
    if name == 'start_conditioned':
        args += (jnp.asarray(np.arange(B) * 3 % T, jnp.int32),)
    tree = _init(jm, *args, seed=seed)
    return jm, tree, _load(pm, tree, interop._predictor_to_torch), feat


def _hold_probs(got, want, atol, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, T)
        _close(g, w, atol, rtol)


@pytest.mark.parametrize('name', CONTENT)
def test_content_predictor_matches_jax(name):
    jm, tree, pm, feat = _content_case(name, jnp.float32, torch.float32)
    want = _apply(jm, tree, jnp.asarray(feat))
    with torch.no_grad():
        got = pm(_t(feat))
    _hold_probs(got, want, FWD_ATOL, FWD_RTOL)


@pytest.mark.parametrize('name', CONTENT)
def test_content_predictor_bf16_matches_jax(name, widened):
    jm, tree, pm, feat = _content_case(name, jnp.bfloat16, torch.bfloat16)
    want = _apply(jm, tree, jnp.asarray(feat), dtype=jnp.bfloat16)
    with torch.no_grad():
        got = pm(_t(feat))
    _hold_probs(got, want, BF16_PROB, 0)


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('method', ['forward', 'inference'])
def test_start_conditioned_predictor_matches_jax(method, precision,
                                                 monkeypatch):
    bf16 = precision == 'bf16'
    if bf16:
        monkeypatch.setattr(jax_rnn, 'jnp', _WidenedEinsum())
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    jm, tree, pm, feat = _content_case('start_conditioned', jdt, tdt)
    start = np.arange(B) * 5 % T
    args = (jnp.asarray(feat),) + ((jnp.asarray(start, jnp.int32),)
                                   if method == 'forward' else ())
    want = _apply(jm, tree, *args, dtype=jdt,
                  method=None if method == 'forward' else jm.inference)
    with torch.no_grad():
        got = (pm(_t(feat), torch.from_numpy(start)) if method == 'forward'
               else pm.inference(_t(feat)))
    if bf16:
        _hold_probs(got, want, BF16_PROB, 0)
    else:
        _hold_probs(got, want, FWD_ATOL, FWD_RTOL)


GRAD_CASES = ('tied_lstm', 'condi_lstm', 'start_conditioned')


@pytest.mark.parametrize('name', GRAD_CASES)
def test_lstm_content_predictor_gradients_match_jax(name):
    """Gradients of a random weighting of the probabilities (their sum
    is 1 a head) with respect to every weight and the features: the
    port's K3/K4 plain versions through ``LSTMRecurrence`` against
    ``jax.grad`` of JAX's ``lax.scan`` BiLSTM."""
    jm, tree, pm, feat = _content_case(name, jnp.float32, torch.float32,
                                       seed=3)
    rng = np.random.RandomState(30)
    heads = 2 if name == 'start_conditioned' else 3
    weights = rng.randn(heads, B, T).astype(np.float32)
    start = (np.arange(B) * 7 % T).astype(np.int32)
    extra = (start,) if name == 'start_conditioned' else ()

    def loss(p, x):
        probs = jm.apply({'params': p}, x, *map(jnp.asarray, extra))
        return sum(jnp.sum(pr * w) for pr, w in zip(probs, weights))

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(tree, jnp.asarray(feat))
    pm.train()
    x = _t(feat).requires_grad_()
    before = lstm_scan.lstm_recurrence_train.launches
    probs = pm(x, *map(torch.from_numpy, extra))
    sum((p * _t(w)).sum() for p, w in zip(probs, weights)).backward()
    assert lstm_scan.lstm_recurrence_train.launches == before  # plain, CPU
    want = {}
    interop._predictor_to_torch(jax.tree.map(np.asarray, want_p), 'm', want)
    got = dict(pm.named_parameters())
    assert set(got) == {k[2:] for k in want}
    for k, w in want.items():
        np.testing.assert_allclose(got[k[2:]].grad.numpy(), w.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), _np(want_x), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


def test_start_conditioned_inference_takes_no_dropout():
    """JAX's ``inference`` runs its end BiLSTM deterministically; the
    port's does so in training mode too, and leaves the mode as it was."""
    pm = PC.StartConditionedPredictor(D, MLP_H, LSTM_H, 0.5).train()
    x = torch.randn(B, T, D)
    with torch.no_grad():
        a = pm.inference(x)
        b = pm.eval().inference(x)
    assert pm.end_lstm['lstm'].training is False
    pm.train()
    with torch.no_grad():
        pm.inference(x)
    assert pm.end_lstm['lstm'].training
    for g, w in zip(a, b):
        assert torch.equal(g, w)
