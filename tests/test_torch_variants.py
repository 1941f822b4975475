"""The model variants a config selects, against the JAX package at small
widths: every span predictor and its aliases, the three cross-modal
interactions, CSMM without and with its LSTM temporal model, QAVE and the
RNN video encoder; GMD's and the baseline's ``eval_forward`` at shared
weights carried by ``state_dict_from_jax`` in f32 and bf16, the serve
methods' fallbacks for the RNN encoder against ``eval_forward``, and a
strict ``.ckp`` round trip of every variant.

JAX runs as its own ``tests/test_variants.py`` runs it: on the CPU,
``fused`` off, every BiLSTM through ``lax.scan``. Its weights are drawn
with numpy into the shapes of ``jax.eval_shape(model.init)``. The whole
models' references are computed in child processes side by side
(``tests/variant_refs.py``) while the tests that need none run first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import variant_refs
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model
from shufflingvideosfortsg_tpu.models.components import \
    SpanPredictorBoundary as JaxSpanPredictor
from shufflingvideosfortsg_tpu.models.components import cmi_apply as jax_cmi
from shufflingvideosfortsg_tpu.models.components import cmi_dim as jax_cmi_dim
from shufflingvideosfortsg_tpu.ops.attention import \
    multi_head_attention as jax_mha
from shufflingvideosfortsg_tpu.ops.attention import \
    positional_encodings_like as jax_encodings
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models import components as C
from shufflingvideosfortsg_torch.models.baseline import Baseline
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.models.gmd import GMD
from shufflingvideosfortsg_torch.ops.attention import (
    multi_head_attention, positional_encodings_like)
from shufflingvideosfortsg_torch.ops.span import span_decode
from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
from shufflingvideosfortsg_torch.utils import interop
from shufflingvideosfortsg_torch.utils.interop import (load_reference_ckp,
                                                       state_dict_from_jax)
from test_torch_bf16 import _hold_model
from torch_one_thread import one_torch_thread  # noqa: F401
from variant_refs import (CASES, D, MLP, MPRED, SPAN, V2, W, H, N, T, B,
                          fill, init_args, inputs, shared)

TOL = 1e-5  # f32: sums in another order than XLA's

# each predictor's name and its aliases (JAX components.py:523-549)
PREDICTORS = {'mlp': ('a',), 'tied_lstm': ('b',), 'cat_tied_lstm': ('b2',),
              'condi_lstm': ('c',), 'cat_condi_lstm': ('c2',),
              'conv': ('e',), 'self_attn': ('d',)}
CMIS = {'a': ('onlyvideo', 'a', 'OnlyVideo'),
        'vs': ('videosentconcat', 'vs', 'b'),
        'tall': ('tall', 'mm', 'c', 'TALL')}
BF16_CASES = ('V1', 'V2', 'rnn_conv')


@pytest.fixture(scope='module', autouse=True)
def children(tmp_path_factory):
    """JAX's ``eval_forward`` of every case (f32) and of BF16_CASES
    (bf16), with their weights, computed by three child processes from
    the module's first test on."""
    jobs = [f'eval:{c}:f32' for c in CASES] + \
        [f'eval:{c}:bf16' for c in BF16_CASES]
    group = {'V1': 0, 'V2': 1, 'rnn_conv': 1}
    groups = [[j for j in jobs if group.get(j.split(':')[1], 2) == i]
              for i in range(3)]
    kids = variant_refs.Children(groups,
                                 tmp_path_factory.mktemp('variant_refs'))
    yield kids
    kids.close()


@pytest.fixture(scope='module')
def refs(children):
    return children.wait()


def _port_model(kind, dtype=torch.float32, **over):
    cls = GMD if kind == 'gmd' else Baseline
    return cls(video_feature_dim=D, word_dim=W, dtype=dtype,
               **shared(kind, **over))


def _loaded(kind, weights, dtype=torch.float32, **over):
    port = _port_model(kind, dtype, **over)
    port.load_state_dict(state_dict_from_jax(weights,
                                             baseline=kind == 'baseline'),
                         strict=True)
    return port.eval()


# --- names, aliases and the pieces -------------------------------------------

def _predictor_keys(name):
    """The port's keys and shapes of JAX's predictor ``name`` over
    16-wide features, through ``state_dict_from_jax``'s mapping."""
    sp = JaxSpanPredictor(name, MLP, SPAN, 0.0)
    shapes = jax.eval_shape(sp.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, T, 16)), jnp.ones((2, T)))
    out = {}
    interop._predictor_to_torch(fill(shapes['params']['predictor'], 0), 'p',
                                out)
    return {k[2:]: tuple(v.shape) for k, v in out.items()}


@pytest.mark.parametrize('name', [n for p, a in PREDICTORS.items()
                                  for n in (p,) + a])
def test_predictor_names_and_aliases_build_what_jax_builds(name):
    """Each name and alias builds, over 16-wide features, the predictor
    whose parameters JAX's name builds; an alias is its name's class."""
    port = C.SpanPredictorBoundary(name, 16, MLP, SPAN)
    canonical = next(p for p, a in PREDICTORS.items() if name in (p,) + a)
    assert type(port.predictor) is type(
        C.SpanPredictorBoundary(canonical, 16, MLP, SPAN).predictor)
    got = {k[len('predictor.'):]: tuple(v.shape)
           for k, v in port.state_dict().items()}
    assert got == _predictor_keys(name)
    probs = port.eval()(torch.randn(2, T, 16), torch.ones(2, T))
    for p in probs:
        torch.testing.assert_close(p.sum(1), torch.ones(2))


def test_unknown_names_raise_as_jax_raises():
    with pytest.raises(ValueError, match='unknown predictor: boundary'):
        C.SpanPredictorBoundary('boundary', 16, MLP, SPAN)
    with pytest.raises(ValueError, match='unknown predictor: MLP'):
        C.SpanPredictorBoundary('MLP', 16, MLP, SPAN)  # names are exact
    for fn, args in ((C.cmi_dim, (16, 16)),
                     (C.cmi_apply, (torch.zeros(1, T, 4),) * 3)):
        with pytest.raises(ValueError, match='unknown CMI: concat'):
            fn('concat', *args)
    with pytest.raises(ValueError, match='unknown CMI: x'):
        jax_cmi_dim('x', 16, 16)
    with pytest.raises(ValueError, match='equal video and sentence'):
        C.cmi_dim('tall', 16, 8)


@pytest.mark.parametrize('name', [n for a in CMIS.values() for n in a])
def test_cmi_matches_jax(name):
    rng = np.random.RandomState(3)
    video = rng.randn(B, T, 16).astype(np.float32)
    words = rng.randn(B, N, 16).astype(np.float32)
    sent = rng.randn(B, 16).astype(np.float32)
    want = jax_cmi(name, *map(jnp.asarray, (video, words, sent)))
    got = C.cmi_apply(name, *map(torch.from_numpy, (video, words, sent)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert C.cmi_dim(name, 16, 16) == jax_cmi_dim(name, 16, 16) \
        == got.shape[-1]


def test_positional_encodings_match_jax():
    """Built on the input's device in its dtype; f32 sin and cos of the
    same angles within 1e-5 (the angles reach T = 37 radians)."""
    x = torch.zeros(2, 37, 24)
    got = positional_encodings_like(x)
    want = jax_encodings(jnp.zeros((2, 37, 24)))
    assert got.dtype == torch.float32 and got.shape == (37, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert positional_encodings_like(x.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_multi_head_attention_matches_jax(causal, masked):
    """JAX's core with its -1e10 fill of causal and key-masked logits,
    scaled by sqrt(D): within 1e-5."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(B, T, 16).astype(np.float32) for _ in range(3))
    mask = (rng.rand(B, T) > 0.3).astype(np.int32) if masked else None
    want = jax_mha(*map(jnp.asarray, (q, k, v)), 4, 16, causal=causal,
                   mask=None if mask is None else jnp.asarray(mask))
    got = multi_head_attention(*map(torch.from_numpy, (q, k, v)), 4, 16,
                               causal=causal,
                               mask=None if mask is None
                               else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_self_attention_with_encodings_matches_jax():
    """``position_encoding`` True, which no config reaches (the dispatcher
    builds it False, as JAX's does), still matches JAX's module."""
    from shufflingvideosfortsg_tpu.models.components import \
        SelfAttentionPredictor as JaxSelfAttn
    jm = JaxSelfAttn(4, True, 0.0)
    feat = np.random.RandomState(4).randn(B, T, 16).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, T, 16)))['params']
    weights = fill(shapes, 2)
    want = jax.jit(jm.apply)({'params': weights}, jnp.asarray(feat))
    port = C.SelfAttentionPredictor(16, 4, True, 0.0)
    out = {}
    interop._predictor_to_torch(weights, 'p', out)
    port.load_state_dict({k[2:]: v for k, v in out.items()}, strict=True)
    got = port(torch.from_numpy(feat))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=TOL, rtol=0)


# --- the configs and the drivers' checkpoints --------------------------------

def _params(**over):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=D, sent_embedding_dim=W,
                  sent_rnn_hiddendim=H, video_rnn_hiddendim=H,
                  mlp_hidden_dim=MLP, span_hidden_dim=SPAN,
                  m_pred_hidden=MPRED, video_len=T, sent_len=N)
    params.update(over)
    return params


CONFIGS = {
    'V1': dict(predictor='cat_condi_lstm', m_temp='lstm', crossmodal='tall',
               remat=True),
    'V2': dict(video_encoder='rnn', predictor='self_attn', crossmodal='a'),
    **{p: dict(predictor=p) for p in PREDICTORS},
    'onlyvideo': dict(crossmodal='onlyvideo'),
}


@pytest.mark.parametrize('config', ['V1', 'V2'])
@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_build_model_builds_what_jax_builds(config, kind):
    """The flat config's keys reach the port's model as they reach JAX's
    (``span_hidden_dim``, ``remat``, ``m_temp`` and its fixed 256 x 2
    BiLSTM): the same parameter names and shapes."""
    params = _params(**CONFIGS[config])
    shapes = jax.eval_shape(jax_build_model(params, kind).init,
                            jax.random.PRNGKey(0), *init_args(kind))
    want = state_dict_from_jax(fill(shapes['params'], 0),
                               baseline=kind == 'baseline')
    model = build_model(params, kind, device='cpu')
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    if kind == 'gmd' and config == 'V1':
        assert model.csmm.temporal['lstm']['lstm'].hidden_size == 256
        assert model.video_encoder.remat
    if config == 'V2':
        assert isinstance(model.video_encoder, C.VideoRNNEncoder)


@pytest.mark.parametrize('config', list(CONFIGS))
@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_ckp_roundtrip_is_strict_for_every_variant(config, kind, tmp_path):
    """A reference ``.ckp`` of a variant (a raw state_dict, as the drivers
    write it) loads strictly into a fresh build of the same config and
    gives the same outputs."""
    params = _params(**CONFIGS[config])
    torch.manual_seed(0)
    model = build_model(params, kind, device='cpu').eval()
    path = str(tmp_path / 'v.ckp')
    torch.save(model.state_dict(), path)
    torch.manual_seed(1)
    again = build_model(params, kind, device='cpu').eval()
    again.load_state_dict(load_reference_ckp(path), strict=True)
    video, query, vmask = (torch.from_numpy(a) for a in inputs(2, 2))
    with torch.no_grad():
        a = model.eval_forward(video, query, vmask)
        b = again.eval_forward(video, query, vmask)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- whole models against JAX ------------------------------------------------

@pytest.mark.parametrize('case', list(CASES))
def test_eval_forward_matches_jax(case, refs):
    kind, over = CASES[case]
    weights, want = refs[f'eval:{case}:f32']
    video, query, vmask = inputs(0)
    port = _loaded(kind, weights, **over)
    with torch.no_grad():
        got = port.eval_forward(*map(torch.from_numpy, (video, query, vmask)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (B, T)
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize('case', BF16_CASES)
def test_eval_forward_bf16_matches_jax(case, refs):
    """tests/test_torch_bf16.py's bounds (``_hold_model``): probabilities
    within 1e-3, match logits within 1e-2, spans equal but near ties."""
    kind, over = CASES[case]
    weights, want = refs[f'eval:{case}:bf16']
    video, query, vmask = inputs(1)
    port = _loaded(kind, weights, torch.bfloat16, **over)
    with torch.no_grad():
        got = port.eval_forward(*map(torch.from_numpy, (video, query, vmask)))
    assert got['start_prob'].dtype == torch.float32
    _hold_model(got, want, tuple(want))


# --- serving with the RNN video encoder --------------------------------------

@pytest.fixture(scope='module')
def rnn_model(refs):
    return _loaded('gmd', refs['eval:V2:f32'][0], **V2)


def test_serve_fallbacks_match_eval_forward(rnn_model):
    """With no block 0 to cache, ``precompute_video`` gives the features
    and the serve methods run the whole encoder on each query's video:
    equal to ``eval_forward`` on the broadcast (or gathered) videos."""
    model, Q = rnn_model, 6
    video, query, vmask = (torch.from_numpy(a) for a in inputs(6, Q))
    one = video[:1]
    with torch.no_grad():
        assert torch.equal(model.precompute_video(video), video)
        want = model.eval_forward(one.expand(Q, -1, -1), query, vmask)
        cached = model.serve_cached(model.precompute_video(one), query, vmask)
        multi = model.serve_multi_query(one, query, vmask)
        ids = torch.tensor([3, 0, 0, 5, 1, 2])
        gathered = model.serve_cached_multi(model.precompute_video(video),
                                            query, ids)
        want_g = model.eval_forward(video[ids], query)
    for got, ref in ((cached, want), (multi, want), (gathered, want_g)):
        assert set(got) == set(ref)
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], atol=1e-6, rtol=0)


def test_grounder_serves_an_rnn_encoder_model(rnn_model):
    """``MultiQueryGrounder`` on an RNN-encoder GMD: a resident video and a
    bank of videos against their ``eval_forward`` spans."""
    params = _params(**CONFIGS['V2'], dropout=0.0)
    g = MultiQueryGrounder(params, rnn_model.state_dict(), device='cpu',
                           query_batch=4)
    video, query, _ = inputs(7, 6)
    spans, scores = g.ground(video[0], query)
    with torch.no_grad():
        out = rnn_model.eval_forward(
            torch.from_numpy(video[:1]).expand(6, -1, -1),
            torch.from_numpy(query))
    want, want_s = span_decode(out['start_prob'], out['end_prob'])
    np.testing.assert_array_equal(spans, want.numpy())
    np.testing.assert_allclose(scores, want_s.numpy(), atol=1e-6)
    g.set_videos(video)
    ids = np.array([5, 4, 0, 1, 1, 3], np.int32)
    spans_b, _ = g.ground_bank(query, ids)
    with torch.no_grad():
        out = rnn_model.eval_forward(torch.from_numpy(video[ids]),
                                     torch.from_numpy(query))
    np.testing.assert_array_equal(
        spans_b, span_decode(out['start_prob'], out['end_prob'])[0].numpy())
