"""``precision: bf16`` on the evaluation and serving paths, against the
JAX package.

The plain versions of K1 (the flat recurrence with bf16 xw and W_hh) and
K2 (the SCDM attention in bf16) are held against the JAX contracts with
XLA's excess precision off (on the CPU XLA otherwise drops the bf16
roundings between element-wise operations that the contracts spell out);
the dense layer and LayerNorm against ``TDense`` and ``LayerNorm``; GMD's
``eval_forward``, the baseline, ``main_test`` and ``MultiQueryGrounder``
at bf16 against the JAX model run as the TPU runs it: ``fused_inference``
on, so that the Pallas kernels run, H=128 (``ops/rnn.py`` sends other H
to a scan whose h and c are bf16, another contract) and batches a
multiple of 8 (``components.py:157``).

Two workarounds on the JAX side (:func:`tpu_like`), at run time; nothing
in the JAX package changes:
- the Pallas kernels run with ``interpret=True``, as the JAX package's
  kernel tests run them, not under ``pltpu.force_tpu_interpret_mode()``:
  that mode's host callbacks cannot take the replicated sharding of the
  drivers' and the grounder's jitted steps (an XLA RET_CHECK in the SPMD
  partitioner);
- XLA on the CPU cannot execute the fused BiLSTM's input projection,
  ``jnp.einsum('btf,fg->tbg')`` of bf16 operands into f32 ("Unsupported
  element type for DotThunk::Execute: BF16 x BF16 = F32"), so the test
  widens both operands to f32 first: a product of two bf16 values is
  exact in f32, so the sum is the same f32 sum.

Whole-model tolerances are wider than the kernels': every bf16 rounding
that an f32 sum in another order moves by one ulp (2^-8 relative) moves
everything after it, so two bf16 runs of a model lie a few bf16 ulps of
their logits apart; each is stated with what was measured.
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import shufflingvideosfortsg_tpu.ops.pallas.lstm_scan as jax_lstm_scan
import shufflingvideosfortsg_tpu.ops.pallas.scdm_fused as jax_scdm_fused
import shufflingvideosfortsg_tpu.ops.rnn as jax_rnn
from shufflingvideosfortsg_tpu import cli as jax_cli
from shufflingvideosfortsg_tpu.data.featpack import \
    PackedFeatureSource as JaxPack
from shufflingvideosfortsg_tpu.models import GMD as JaxGMD
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model
from shufflingvideosfortsg_tpu.models.baseline import Baseline as JaxBaseline
from shufflingvideosfortsg_tpu.models.components import LayerNorm, TDense
from shufflingvideosfortsg_tpu.ops.attention import scdm_attention
from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import \
    lstm_scan_pallas_flat
from shufflingvideosfortsg_tpu.ops.pallas.scdm_fused import \
    scdm_attention_fused
from shufflingvideosfortsg_tpu.serving import MultiQueryGrounder as JaxGrounder
from shufflingvideosfortsg_tpu.utils.torch_interop import save_reference_ckp
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.data.pipeline import BatchLoader
from shufflingvideosfortsg_torch.data.featpack import PackedFeatureSource
from shufflingvideosfortsg_torch.models.baseline import Baseline
from shufflingvideosfortsg_torch.models.gmd import GMD
from shufflingvideosfortsg_torch.ops import lstm_scan as L
from shufflingvideosfortsg_torch.ops import scdm_fused as S
from shufflingvideosfortsg_torch.ops.dense import dense, layer_norm
from shufflingvideosfortsg_torch.ops.span import span_decode
from shufflingvideosfortsg_torch.serving import (MultiQueryGrounder,
                                                 _bank_rows, bank_nbytes)
from shufflingvideosfortsg_torch.utils.interop import (load_reference_ckp,
                                                       state_dict_from_jax)
from jax_cpu import _no_excess, _WidenedEinsum
from test_torch_serving import _write_pack
from torch_one_thread import one_torch_thread  # noqa: F401

BF16 = jnp.bfloat16
ULP = 2.0 ** -8  # one bf16 rounding, relative
# K1: the plain version and the Pallas kernel round at the same points and
# differ only by f32 sums in another order, which can move a bf16 value of
# `out` by one ulp (2e-3 admits that for values below 0.5, as
# tests/test_torch_stacked_lstm.py's K6A_BF16_TOL); the f32 states h_T
# and c_T lie within 1e-5 (measured: 1.1e-6 at H=128), where the f32
# recurrence of the same inputs lies 1.4e-4 to 4.6e-4 off, so the state
# tolerance tells the two precisions apart
K1_BF16_TOL = 2e-3
K1_STATE_TOL = 1e-5
# K2 against ops/attention.py::scdm_attention: the same rounding points;
# an f32 sum in another order can move a logit's bf16 rounding by one ulp
# (measured: no difference at all); the f32 attention of the same inputs
# lies 2.9e-3 to 5.4e-3 off
K2_BF16_TOL = 1e-3
# K2 against the Pallas kernel, whose own bf16 contract differs from
# scdm_attention's: it rounds every a * w to bf16 before the sum over k;
# held to 4 bf16 ulps of the largest |C| (measured: one ulp of values in
# [1, 2), 7.8e-3, at most 0.6% of the largest |C|)
K2_FUSED_SHARE = 4 * ULP
# whole models at bf16 (see the module docstring): start/end
# probabilities of at most 0.1 (T=10) measured 1.7e-4 apart; the CSMM
# match logits, a sum of 24 bf16 products of both signs, 2.9e-3
PROB_ATOL = 1e-3
MATCH_ATOL = 1e-2
# span scores (the sum of two probabilities, about 0.08) as the driver
# writes them: measured 8.2e-5 apart; two bf16 ulps, relative
SCORE_RTOL = 2 * ULP

W, D, H, MLP, MPRED = 20, 12, 128, 8, 24
B, T, N = 16, 10, 5


@pytest.fixture
def tpu_like(monkeypatch):
    """The JAX model's Pallas kernels, interpreted, where ``fused_inference``
    sends them (the BiLSTM and the attention import them at call time)."""
    monkeypatch.setattr(jax_rnn, 'jnp', _WidenedEinsum())
    monkeypatch.setattr(jax_lstm_scan, 'lstm_scan_pallas_flat',
                        functools.partial(lstm_scan_pallas_flat,
                                          interpret=True))
    monkeypatch.setattr(jax_scdm_fused, 'scdm_attention_fused',
                        functools.partial(scdm_attention_fused,
                                          interpret=True))


def _t(a, dtype=torch.bfloat16) -> torch.Tensor:
    """A JAX (or numpy) array as a torch tensor of ``dtype``: the values
    the JAX side sees."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(dtype)


def _np(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - _np(want)).max())


def _within_an_ulp(got: torch.Tensor, want: np.ndarray) -> bool:
    """Each element of ``got`` at most one bf16 ulp from ``want``'s: an
    ulp of v is at most 2^-7 |v|."""
    return bool((np.abs(got.float().numpy() - want)
                 <= 2 * ULP * np.abs(want)).all())


# --- K1 and K2, plain versions, against the JAX contracts --------------------

@pytest.mark.parametrize('T_,B_,H_', [(12, 4, 16), (7, 2, 8), (33, 3, 8),
                                      (20, 8, 128)])
def test_k1_plain_bf16_matches_pallas_flat_kernel(T_, B_, H_):
    rng = np.random.RandomState(T_ * 10 + B_)
    jx = jnp.asarray((rng.randn(T_, B_, 8 * H_) * 0.5).astype(np.float32)
                     ).astype(BF16)
    jw = jnp.asarray((rng.randn(2, H_, 4 * H_) / math.sqrt(H_))
                     .astype(np.float32)).astype(BF16)
    want = _no_excess(lambda x, w: lstm_scan_pallas_flat(x, w, interpret=True),
                      jx, jw)
    got = L.lstm_recurrence(_t(jx), _t(jw))  # CPU tensors: the plain version
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == BF16
    assert got[1].dtype == got[2].dtype == torch.float32
    assert _err(got[0], want[0]) <= K1_BF16_TOL
    for name, g, w in zip(('h_T', 'c_T'), got[1:], want[1:]):
        assert _err(g, w) <= K1_STATE_TOL, name
    f32 = L.lstm_recurrence(_t(jx, torch.float32), _t(jw, torch.float32))
    assert max(_err(g, w) for g, w in zip(f32[1:], want[1:])) > K1_STATE_TOL


K2_SHAPES = [(8, 20, 7, 24, 24), (3, 11, 17, 40, 36), (8, 6, 1, 8, 16),
             (16, 16, 15, 64, 48)]


def _k2_inputs(B_, T_, N_, Dh, Ds):
    rng = np.random.RandomState(B_ + T_ + N_)
    return [jnp.asarray((rng.randn(*shape) * scale).astype(np.float32)
                        ).astype(BF16)
            for shape, scale in (((B_, T_, Dh), 0.5), ((B_, N_, Dh), 0.5),
                                 ((Dh,), 1 / math.sqrt(Dh)),
                                 ((B_, N_, Ds), 1.0))]


def test_k2_plain_bf16_matches_scdm_attention():
    f32_err = 0.0
    for shape in K2_SHAPES:
        args = _k2_inputs(*shape)
        want = _no_excess(scdm_attention, *args)
        got = S.scdm_attention_fused(*map(_t, args))
        assert got.dtype == torch.bfloat16 and want.dtype == BF16
        assert _err(got, want) <= K2_BF16_TOL, shape
        f32_err = max(f32_err, _err(S.scdm_attention_fused(
            *(_t(a, torch.float32) for a in args)), want))
    assert f32_err > K2_BF16_TOL  # the tolerance tells bf16 from f32


@pytest.mark.parametrize('shape', [s for s in K2_SHAPES if s[0] % 8 == 0])
def test_k2_plain_bf16_matches_pallas_kernel(shape):
    args = _k2_inputs(*shape)
    want = _no_excess(lambda *a: scdm_attention_fused(*a, interpret=True),
                      *args)
    got = S.scdm_attention_fused(*map(_t, args))
    assert _err(got, want) <= K2_FUSED_SHARE * np.abs(_np(want)).max()


# --- the dense layer and LayerNorm -------------------------------------------

def test_dense_and_layer_norm_match_tdense_and_layernorm():
    """Equal to JAX's up to one bf16 ulp of each output (a product summed
    in f32 in another order can round to the neighbouring bf16); the bias
    added after the product's rounding, as JAX adds it: rounding once
    (``F.linear`` in f32, then to bf16) gives other values."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 9, 48).astype(np.float32)
    dense_mod = TDense(40, dtype=BF16)
    params = jax.tree.map(np.asarray, dense_mod.init(
        jax.random.PRNGKey(1), jnp.asarray(x))['params'])
    params['bias'] = (params['bias'] * 40).astype(np.float32)  # bias matters
    want = _np(_no_excess(lambda p, a: dense_mod.apply({'params': p}, a),
                          params, jnp.asarray(x)))
    weight = torch.from_numpy(params['kernel'].T.copy())
    bias = torch.from_numpy(params['bias'])
    got = dense(torch.from_numpy(x), weight, bias, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and _within_an_ulp(got, want)
    once = torch.nn.functional.linear(torch.from_numpy(x).bfloat16().float(),
                                      weight.bfloat16().float(),
                                      bias.bfloat16().float()).bfloat16()
    assert (once.float().numpy() != want).any()
    assert torch.equal(dense(torch.from_numpy(x), weight, bias,
                             torch.float32),
                       torch.nn.functional.linear(torch.from_numpy(x),
                                                  weight, bias))

    norm_mod = LayerNorm(dtype=BF16)
    xb = jnp.asarray(x).astype(BF16)
    p = {'scale': (1 + 0.1 * rng.randn(48)).astype(np.float32),
         'bias': (0.1 * rng.randn(48)).astype(np.float32)}
    want = _np(_no_excess(lambda p, a: norm_mod.apply({'params': p}, a),
                          p, xb))
    norm = torch.nn.LayerNorm(48, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(p['scale']))
        norm.bias.copy_(torch.from_numpy(p['bias']))
        got = layer_norm(norm, _t(xb), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and _within_an_ulp(got, want)


# --- GMD and the baseline at bf16 --------------------------------------------

_MODEL = dict(sent_hidden=H, sent_layers=2, video_hidden=H, video_layers=2,
              nblocks=2, cross_name='vs', predictor_name='mlp',
              mlp_hidden_dim=MLP, video_if_mask=False, dropout=0.0)
_GMD = dict(m_temp='none', m_pred_hidden=MPRED, m_pred_activ='relu')


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    video = rng.randn(B, T, D).astype(np.float32)
    query = rng.randn(B, N, W).astype(np.float32)
    vmask = (np.arange(T)[None] <= rng.randint(4, T, (B, 1))).astype(np.int32)
    return video, query, vmask


@pytest.fixture(scope='module')
def gmd_params():
    ones_t = jnp.ones((2, T), jnp.int32)
    video = jnp.zeros((2, T, D))
    variables = JaxGMD(**_MODEL, **_GMD).init(
        jax.random.PRNGKey(7), jnp.zeros((2, N, W)),
        jnp.ones((2, N), jnp.int32), video, ones_t, video, ones_t,
        *[ones_t] * 6)
    return jax.tree.map(np.asarray, variables['params'])


@pytest.fixture(scope='module')
def baseline_params():
    variables = JaxBaseline(**_MODEL).init(
        jax.random.PRNGKey(8), jnp.zeros((2, T, D)), jnp.zeros((2, N, W)),
        jnp.ones((2, T), jnp.int32), jnp.ones((2, N), jnp.int32))
    return jax.tree.map(np.asarray, variables['params'])


def _port_kwargs(dtype):
    return dict(video_feature_dim=D, word_dim=W, sent_hidden=H,
                sent_layers=2, video_hidden=H, video_layers=2, nblocks=2,
                cross_name='vs', predictor_name='mlp', mlp_hidden_dim=MLP,
                video_if_mask=False, dropout=0.0, dtype=dtype)


def _spans_equal_but_near_ties(start, end, pred, want_pred, err):
    """Spans decoded from (start, end) equal ``want_pred`` except on rows
    whose best two spans lie within 2 ``err`` (a row's summed start and
    end probability error; a scalar or one a row) of each other. With
    random weights the distributions over T are nearly flat, and many
    rows are such near ties."""
    ties = chip_smoke.tie_rows(start, end, 2 * err + 1e-7)
    differ = (torch.as_tensor(pred) != torch.as_tensor(want_pred)).any(1)
    assert not (differ & ~ties).any()


def _hold_model(got, want, keys):
    """Probabilities (and match logits) within the bf16 tolerances, spans
    equal but near ties (the window from each row's measured errors)."""
    for k in keys:
        tol = MATCH_ATOL if k == 'match_prob' else PROB_ATOL
        assert _err(got[k], want[k]) <= tol, k
    ws, we = (torch.from_numpy(_np(want[k])) for k in ('start_prob',
                                                        'end_prob'))
    row_err = sum((got[k].float() - w).abs().amax(1)
                  for k, w in (('start_prob', ws), ('end_prob', we)))
    _spans_equal_but_near_ties(
        ws, we, span_decode(got['start_prob'], got['end_prob'])[0],
        span_decode(ws, we)[0], row_err)


def test_gmd_eval_forward_bf16_matches_jax(gmd_params, tpu_like):
    video, query, vmask = _inputs()
    jm = JaxGMD(dtype=BF16, fused_inference=True, **_MODEL, **_GMD)
    want = _no_excess(
        lambda p, v, q, m: jm.apply({'params': p}, v, q, m, None,
                                    method=jm.eval_forward),
        gmd_params, jnp.asarray(video), jnp.asarray(query), jnp.asarray(vmask))
    port = GMD(**_port_kwargs(torch.bfloat16), **_GMD)
    port.load_state_dict(state_dict_from_jax(gmd_params), strict=True)
    with torch.no_grad():
        got = port.eval().eval_forward(*map(torch.from_numpy,
                                            (video, query, vmask)))
    assert got['start_prob'].dtype == got['end_prob'].dtype == torch.float32
    assert got['match_prob'].dtype == torch.bfloat16
    _hold_model(got, want, ('start_prob', 'end_prob', 'match_prob'))


def test_baseline_bf16_matches_jax(baseline_params, tpu_like):
    video, query, vmask = _inputs(1)
    jm = JaxBaseline(dtype=BF16, fused_inference=True, **_MODEL)
    want = _no_excess(lambda p, v, q, m: jm.apply({'params': p}, v, q, m),
                      baseline_params, jnp.asarray(video),
                      jnp.asarray(query), jnp.asarray(vmask))
    port = Baseline(**_port_kwargs(torch.bfloat16))
    port.load_state_dict(state_dict_from_jax(baseline_params, baseline=True),
                         strict=True)
    with torch.no_grad():
        got = port.eval().eval_forward(*map(torch.from_numpy,
                                            (video, query, vmask)))
    _hold_model(got, want, ('start_prob', 'end_prob'))


# --- main_test at bf16 -------------------------------------------------------

DRIVER = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
          '--sent_rnn_hiddendim', str(H), '--video_rnn_hiddendim', str(H),
          '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
          '--batch_size', '8', '8', '8', '--batch_log_interval', '1',
          '--precision', 'bf16']


def _port_probs(params, ckp):
    """The port's bf16 start/end probabilities [T] of each sentence of the
    test split, by (video id, sentence)."""
    model = GMD(**dict(_port_kwargs(torch.bfloat16), video_feature_dim=32,
                       word_dim=300, mlp_hidden_dim=8), m_temp='none',
                m_pred_hidden=16, m_pred_activ='relu')
    model.load_state_dict(load_reference_ckp(ckp), strict=True)
    dataset = port_cli.make_dataset(params, 'test_data', 'test_featpath',
                                    'test')
    probs = {}
    for batch in BatchLoader(dataset, 8, shuffle=False):
        with torch.no_grad():
            out = model.eval().eval_forward(
                *(torch.from_numpy(np.asarray(batch[k]))
                  for k in ('video_feat', 'sent_feat', 'video_mask')))
        for i in range(batch['n_valid']):
            probs[batch['vid'][i], batch['sentence'][i]] = (
                out['start_prob'][i], out['end_prob'][i])
    return probs


def test_main_test_bf16_matches_jax_driver(tmp_path, tpu_like):
    """Both drivers on one corpus (26 sentences, the last batch padded)
    and one reference .ckp: scores within SCORE_RTOL, spans equal but on
    rows the port's probabilities put within the model test's error
    (2 PROB_ATOL) of a tie, equal metric tables where no span differs.
    The JAX driver compiles its own step, with XLA's default excess
    precision (another source of bf16 noise, within the tolerance)."""
    root = str(tmp_path)
    params = jax_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + DRIVER,
                                  default_model='GMD')
    anno, feats, vocab, n = chip_smoke.write_corpus(root, params, n_videos=8)
    weights = jax_cli.init_model_params(
        jax_build_model(params, 'gmd', inference=True), params,
        jax.random.PRNGKey(3), 'gmd')
    ckp = os.path.join(root, 'seeded.ckp')
    save_reference_ckp(jax.tree.map(np.asarray, weights), ckp, kind='gmd')
    argv = ['--cfg', 'charades_cd_i3d.yml', *DRIVER,
            '--runs', os.path.join(root, 'runs'), '--test_data', anno,
            '--test_featpath', feats, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init'],
            '--start_from', ckp]

    def run(cli, params):
        submit = cli.main_test(params)
        with open(submit) as f, open(submit + '.metrics.json') as g:
            metrics = json.load(g)
            metrics.pop('elapsed_loop_s')
            return json.load(f)['results'], metrics

    jparams = jax_cli.parse_params(argv + ['--alias', 'jax_bf16'],
                                   default_model='GMD')
    jparams['fused_inference'] = True
    want, want_metrics = run(jax_cli, jparams)
    pparams = port_cli.parse_params(
        argv + ['--alias', 'port_bf16', '--device', 'cpu'],
        default_model='GMD')
    got, got_metrics = run(port_cli, pparams)
    rows = [(vid, g, w) for vid in want for g, w in zip(got[vid], want[vid])]
    assert len(rows) == n == sum(map(len, got.values()))
    probs = _port_probs(pparams, ckp)
    for vid, g, w in rows:
        assert g['sentence'] == w['sentence']
        assert abs(g['score'] - w['score']) <= SCORE_RTOL * abs(w['score'])
        if g['timestamp'] != w['timestamp']:
            start, end = probs[vid, g['sentence']]
            assert chip_smoke.tie_rows(start[None], end[None],
                                       4 * PROB_ATOL).all(), g['sentence']
    if all(g['timestamp'] == w['timestamp'] for _, g, w in rows):
        assert got_metrics == want_metrics


# --- MultiQueryGrounder at bf16 ----------------------------------------------

TS, NS, DV = 20, 6, 16
_SERVE = dict(sent_rnn_hiddendim=H, sent_rnn_layers=1,
              video_rnn_hiddendim=H, video_rnn_layers=1, mlp_hidden_dim=8,
              m_pred_hidden=16, m_pred_activ='relu', m_temp='none',
              dropout=0.0, mask=False, sent_len=NS, precision='bf16')


@pytest.fixture(scope='module')
def serve_weights():
    """(JAX parameters, the port's state dict of them) of a GMD at the
    serving test's width, one layer a BiLSTM, H=128."""
    model = JaxGMD(sent_hidden=H, sent_layers=1, video_hidden=H,
                   video_layers=1, nblocks=2, cross_name='vs',
                   predictor_name='mlp', mlp_hidden_dim=8, span_hidden_dim=8,
                   video_if_mask=False, dropout=0.0, m_temp='none',
                   m_pred_hidden=16, m_pred_activ='relu')
    mt, mn = jnp.ones((2, TS), jnp.int32), jnp.ones((2, NS), jnp.int32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((2, NS, 300)),
                            mn, jnp.zeros((2, TS, DV)), mt,
                            jnp.zeros((2, TS, DV)), mt, mt, mt, mt, mt, mt,
                            mt)
    params = jax.tree.map(np.asarray, v['params'])
    return params, state_dict_from_jax(params, sent_layers=1, video_layers=1)


def _grounders(serve_weights, **cfg):
    params, sd = serve_weights
    serve = dict(_SERVE, **cfg)
    jax_cfg = dict(serve, video_encoder='query_aware_encoder',
                   crossmodal='vs', predictor='mlp', span_hidden_dim=8,
                   mesh_shape=[8], fused_inference=True)
    port = load_config('charades_cd_i3d.yml')
    port.update(video_feature_dim=DV, sent_embedding_dim=300, **serve)
    return (JaxGrounder(jax_cfg, params, query_batch=8),
            MultiQueryGrounder(port, sd, device='cpu', query_batch=8))


def _hold_grounding(g, got, want, queries, ids=None):
    """Scores within SCORE_RTOL; spans equal but on rows that the port's
    probabilities (from ``g``'s model, as its serve functions run it: the
    resident video, or the bank rows ``ids``) put within the model test's
    error, 2 PROB_ATOL, of a tie."""
    np.testing.assert_allclose(got[1], _np(want[1]), atol=0,
                               rtol=SCORE_RTOL)
    q = torch.from_numpy(np.asarray(queries, np.float32))
    with torch.no_grad():
        out = (g.model.serve_cached(g._resident_rnn0, q) if ids is None
               else g.model.serve_gathered(
                   _bank_rows(g._resident_bank, torch.from_numpy(ids).long()),
                   q))
    _spans_equal_but_near_ties(out['start_prob'], out['end_prob'], got[0],
                               np.asarray(want[0]), 2 * PROB_ATOL)


def test_grounder_bf16_matches_jax(serve_weights, tmp_path, tpu_like):
    """One video against 11 queries (a full and a padded batch of 8),
    f16 shipping and token ids, a bank of 3 videos, and a 7-video pack
    pinned raw (bf16: half the f32 bytes) and int8 (quantised from the
    bf16 recurrences in f32, as JAX quantises them)."""
    jg, pg = _grounders(serve_weights)
    j16, p16 = _grounders(serve_weights, serve_query_dtype='f16')
    rng = np.random.RandomState(4)
    video = rng.randn(TS, DV).astype(np.float32)
    videos = rng.randn(3, TS, DV).astype(np.float32)
    queries = rng.randn(11, NS, 300).astype(np.float32)
    ids = (np.arange(11) % 3).astype(np.int32)
    emb = rng.randn(50, 300).astype(np.float32)
    tokens = rng.randint(0, 50, (11, NS)).astype(np.int32)

    _hold_grounding(pg, pg.ground(video, queries),
                    jg.ground(video, queries), queries)
    assert pg._resident_rnn0.dtype == torch.bfloat16
    _hold_grounding(p16, p16.ground(video, queries),
                    j16.ground(video, queries),
                    queries.astype(np.float16).astype(np.float32))
    for g in (jg, pg):
        g.set_videos(videos)
        g.set_vocab(emb)
    _hold_grounding(pg, pg.ground_bank(queries, ids),
                    jg.ground_bank(queries, ids), queries, ids)
    _hold_grounding(pg, pg.ground_tokens(tokens, ids),
                    jg.ground_tokens(tokens, ids), emb[tokens], ids)

    root = _write_pack(rng, str(tmp_path / 'pack'))
    _, p32 = _grounders(serve_weights, precision='f32')
    p32.set_corpus(PackedFeatureSource(root, use_native=False),
                   chunk_videos=4)
    names = [f'v{i % 7:03d}' for i in range(11)]
    rows = (np.arange(11) % 7).astype(np.int32)
    for tier in ('raw', 'int8'):
        jg.set_corpus(JaxPack(root, use_native=False), chunk_videos=4,
                      dtype=tier)
        pg.set_corpus(PackedFeatureSource(root, use_native=False),
                      chunk_videos=4, dtype=tier)
        jbank = jg._resident_bank
        jparts = jbank if isinstance(jbank, tuple) else (jbank,)
        assert bank_nbytes(pg._resident_bank) == sum(p.nbytes for p in jparts)
        if tier == 'raw':
            assert pg._resident_bank.dtype == torch.bfloat16
            assert 2 * bank_nbytes(pg._resident_bank) == \
                bank_nbytes(p32._resident_bank)
            bf16_bank = pg._resident_bank
        else:
            # the int8 tier quantises the bf16 recurrences, taken in f32
            q, s = pg._resident_bank
            deq = q.float() * s[..., None]
            bound = bf16_bank.float().abs().amax(-1, keepdim=True) \
                * chip_smoke.INT8_BOUND
            assert ((deq - bf16_bank.float()).abs() <= bound).all()
        _hold_grounding(pg, pg.ground_vids(queries, names),
                        jg.ground_vids(queries, names), queries, rows)
