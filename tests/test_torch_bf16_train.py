"""Training at ``precision: bf16`` against the JAX package.

The plain versions of K3 (the flat train recurrence with bf16 xw, W_hh and
out), K4 (its backward, with the weight gradient) and K5 (the SCDM
attention's backward in bf16) are held against the Pallas kernels run with
``interpret=True`` and against ``jax.vjp`` of the JAX functions; autograd
of the dense layer and LayerNorm against ``jax.vjp`` of ``TDense`` and
``LayerNorm``; a GMD and a baseline train step at bf16 against JAX's, with
the model's Pallas kernels interpreted (``patch_tpu_like`` in
tests/bf16_train_refs.py: the training build's ``lstm_flat_fused`` and
``scdm_attention_fused_trainable``, H=128, batches a multiple of 8, as in
tests/test_torch_bf16.py); and ``main_train --precision bf16`` on the
CPU, whose checkpoint the port's ``main_test --precision bf16`` reads
back. Every JAX reference that runs a Pallas kernel in interpret mode is
computed once, in a child process with a deadline
(tests/bf16_train_refs.py, fixture ``jax_refs``).

Rounding points of JAX's bf16 VJPs, as their jaxprs write them and XLA's
CPU backend computes them (measured bit for bit):
- a product's cotangent is taken in f32 and each operand's cotangent is
  the f32-accumulated product rounded to bf16, then widened by the
  ``astype`` VJP to the f32 parameter: autograd of ``torch.matmul`` in
  bf16 has the same points;
- the cotangent of a broadcast (a bias, the tiled sentence, the SCDM
  attention's [B, T, N, Dh] sum) is a bf16 ``reduce_sum``, which XLA's CPU
  backend adds in bf16 one element after another; the port's sums (torch's
  and K5's) run in f32 and round once. Over many rows the two differ by
  more than a bf16 ulp, and where a gradient's value cancels below that
  rounding noise (the SCDM projections' at initialisation: sum_n dl = 0
  and a small) the two bf16 gradients are both mostly noise. Such a
  tensor is held by its distance from JAX's f32 gradient of the same
  weights instead (:func:`_hold_grads`).
"""

import functools
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bf16_train_refs
import chip_smoke
from bf16_train_refs import BF16, LR, LSTM_SHAPES, VJP_SHAPES
from shufflingvideosfortsg_tpu.models.components import LayerNorm, TDense
from shufflingvideosfortsg_tpu.ops.attention import scdm_attention
from shufflingvideosfortsg_tpu.train import state as jax_state
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.ops import lstm_scan as L
from shufflingvideosfortsg_torch.ops import scdm_fused as S
from shufflingvideosfortsg_torch.ops.dense import dense, layer_norm
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (
    HOST_PAIR_KEYS, STEP_KEYS, make_baseline_train_step, make_gmd_train_step)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from test_torch_bf16 import _no_excess
from torch_one_thread import one_torch_thread  # noqa: F401

ULP = 2.0 ** -8  # one bf16 rounding, relative
# K3: the plain version and the Pallas kernel round at the same points (h
# f32, rounded to bf16 for the product; out rounded; c f32) and differ
# only by f32 sums in another order, which can move a bf16 value of out by
# one ulp (2e-3 for values below 0.5, as test_torch_bf16.py's K1_BF16_TOL;
# measured: equal); the f32 states within 1e-5 (measured: 1.5e-7), where
# the f32 recurrence of the same inputs lies 3.5e-4 to 6.1e-4 off
K3_OUT_TOL = 2e-3
K3_STATE_TOL = 1e-5
# K4 and LSTMRecurrence: dgates rounds to bf16 for both products from f32
# values that a sum in another order can move across a rounding boundary;
# 4 ulps of each output's largest |value| (measured: K4 2.8e-5 of it, the
# weight gradient alone 2.8e-5, LSTMRecurrence's cotangents 4.5e-4)
K4_SHARE = 2.0 ** -6
# K5's plain backward against jax.vjp(scdm_attention): the same rounding
# points but for the two sums of the [B, T, N, Dh] cotangent, bf16 one
# element after another on XLA's CPU backend, f32 rounded once in the port
# (module docstring); 8 ulps of each gradient's largest |value| (measured:
# d_video_proj 1.2e-2 of it, d_sent_proj 7.2e-3, d_w and d_sent_feat equal)
K5_SHARE = 2.0 ** -5
# a train step: the loss terms to 4 ulps relative (measured: at most
# 2.0e-4, GMD's loss_intra), each gradient tensor to 8 ulps of its L2 norm
# (measured: 69 of GMD's 80 tensors, at most 3.08e-2, and 37 of the
# baseline's 72, at most 2.83e-2) or else by :func:`_hold_grads` (the rest:
# the port's bf16 gradient 0.03 to 1.54 times as far from JAX's f32 one as
# JAX's bf16 gradient lies)
LOSS_RTOL = 2.0 ** -6
GRAD_REL_L2 = 2.0 ** -5


def _t(a, dtype=torch.bfloat16) -> torch.Tensor:
    """A JAX (or numpy) array as a torch tensor of ``dtype``."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(dtype)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _share(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|."""
    want = _np(want)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope='module')
def jax_refs(tmp_path_factory):
    """Every reference of this module that runs the JAX package's Pallas
    kernels in interpret mode (K3, K4, ``jax.vjp`` of ``lstm_flat_fused``,
    the GMD and baseline train steps), computed once in a child process
    with a deadline (``tests/bf16_train_refs.py``): interpret mode can
    deadlock inside JAX, and a child that hangs is killed and started
    afresh instead of holding the test run."""
    return bf16_train_refs.run_in_child(
        tmp_path_factory.mktemp('bf16_train_refs'))


# --- K3, K4 and LSTMRecurrence ------------------------------------------------

@pytest.fixture(scope='module')
def lstm_refs(jax_refs):
    """Per shape: the inputs, the Pallas train kernels' results
    (interpreted, XLA's excess precision off) and, for VJP_SHAPES,
    ``jax.vjp`` of ``lstm_flat_fused`` over them."""
    return jax_refs['lstm']


@pytest.mark.parametrize('shape', LSTM_SHAPES)
def test_k3_plain_bf16_matches_pallas_train_kernel(shape, lstm_refs):
    """out within K3_OUT_TOL, c_seq, h_T and c_T within K3_STATE_TOL; the
    f32 recurrence's states lie farther."""
    (xw, w, *_), want, _, _ = lstm_refs[shape]
    got = L.lstm_recurrence_train(_t(xw), _t(w))  # CPU: the plain version
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == BF16
    assert all(g.dtype == torch.float32 for g in got[1:])
    assert _share(got[0], want[0]) * np.abs(_np(want[0])).max() <= K3_OUT_TOL
    for name, g, v in zip(('c_seq', 'h_T', 'c_T'), got[1:], want[1:]):
        assert float(np.abs(g.numpy() - _np(v)).max()) <= K3_STATE_TOL, name
    f32 = L.lstm_recurrence_train(_t(xw, torch.float32), _t(w, torch.float32))
    assert max(float(np.abs(g.numpy() - _np(v)).max())
               for g, v in zip(f32[1:], want[1:])) > K3_STATE_TOL


@pytest.mark.parametrize('shape', LSTM_SHAPES)
def test_k4_plain_bf16_matches_pallas_bwd_kernel(shape, lstm_refs):
    """On the Pallas forward's out and c_seq: d_xw and d_w_hh within
    K4_SHARE of each one's largest |value|, and the weight gradient alone
    on the flat bf16 layout against the kernel's d_w_hh."""
    (xw, w, d_out, d_h, d_c), fwd, want, _ = lstm_refs[shape]
    args = (_t(xw), _t(w), _t(fwd[0]), _t(fwd[1], torch.float32),
            _t(d_out), _t(d_h, torch.float32), _t(d_c, torch.float32))
    got = L.lstm_recurrence_bwd(*args)
    assert all(g.dtype == torch.float32 for g in got)
    for name, g, v in zip(('d_xw', 'd_w_hh'), got, want):
        assert _share(g, v) <= K4_SHARE, name
    d_w = L.lstm_weight_grad(args[2], got[0], torch.bfloat16, L.FLAT)
    assert _share(d_w, want[1]) <= K4_SHARE


@pytest.mark.parametrize('shape', VJP_SHAPES)
def test_lstm_recurrence_bf16_matches_lstm_flat_fused_vjp(shape, lstm_refs):
    """Autograd of ``LSTMRecurrence`` at bf16 against ``jax.vjp`` of
    ``lstm_flat_fused`` (the custom VJP over the interpreted kernels):
    the outputs as K3's, the cotangents of xw and w_hh in bf16 within
    K4_SHARE of their largest |value|."""
    (xw, w, d_out, d_h, d_c), _, _, (want, want_grads) = lstm_refs[shape]
    x, v = _t(xw).requires_grad_(), _t(w).requires_grad_()
    got = L.lstm_recurrence(x, v)
    grads = torch.autograd.grad(got, (x, v), (_t(d_out), _t(d_h, torch.float32),
                                              _t(d_c, torch.float32)))
    assert _share(got[0], want[0]) * np.abs(_np(want[0])).max() <= K3_OUT_TOL
    for g, u in zip(got[1:], want[1:]):
        assert float(np.abs(g.detach().numpy() - _np(u)).max()) <= K3_STATE_TOL
    for name, g, u in zip(('d_xw', 'd_w_hh'), grads, want_grads):
        assert g.dtype == torch.bfloat16 and u.dtype == BF16
        assert _share(g, u) <= K4_SHARE, name


# --- K5 -----------------------------------------------------------------------

K5_SHAPES = [(8, 10, 5, 32, 24), (3, 11, 17, 40, 36), (16, 16, 15, 64, 48),
             (2, 9, 25, 33, 20)]


@pytest.mark.parametrize('shape', K5_SHAPES)
def test_k5_plain_bf16_backward_matches_jax_vjp(shape):
    """``scdm_attention_bwd_plain`` and autograd of the trainable wrapper
    (CPU: the plain forward and backward) against ``jax.vjp`` of
    ``scdm_attention`` at bf16: every gradient within K5_SHARE of its
    largest |value|."""
    args = _k5_inputs(*shape)
    g = args[-1]
    _, fn = jax.vjp(scdm_attention, *args[:4])
    want = fn(g)
    got = S.scdm_attention_bwd_plain(*map(_t, args))
    inputs = [_t(a).requires_grad_() for a in args[:4]]
    out = S.scdm_attention_fused_trainable(*inputs)
    auto = torch.autograd.grad(out, inputs, _t(g))
    for grads in (got, auto):
        for name, a, b in zip(('vp', 'sp', 'w', 'sf'), grads, want):
            assert a.dtype == torch.bfloat16
            assert _share(a, b) <= K5_SHARE, name


def _k5_inputs(B_, T_, N_, Dh, Ds):
    rng = np.random.RandomState(B_ + T_ + N_)
    return [jnp.asarray((rng.randn(*shape) * scale).astype(np.float32)
                        ).astype(BF16)
            for shape, scale in (((B_, T_, Dh), 0.5), ((B_, N_, Dh), 0.5),
                                 ((Dh,), 1 / math.sqrt(Dh)),
                                 ((B_, N_, Ds), 1.0), ((B_, T_, Ds), 1.0))]


# --- the dense layer and LayerNorm --------------------------------------------

# the bias's cotangent: a sum over the rows, bf16 one element after another
# in JAX (on the CPU), each add rounded, f32 rounded once in the port,
# which lies within an ulp of the exact sum; over R rows the sequential
# sum may drift R/2 ulps of its partial sums: JAX's held to 8 ulps of the
# largest |value| (measured: 1.2e-2 of it over 54 rows)
BIAS_SHARE = 2.0 ** -5


def _within_an_ulp(got: torch.Tensor, want) -> bool:
    want = _np(want)
    return bool((np.abs(got.float().numpy() - want)
                 <= 2 * ULP * np.abs(want)).all())


def test_dense_and_layer_norm_gradients_match_jax_vjp():
    """Autograd of ``dense`` and ``layer_norm`` at bf16 against ``jax.vjp``
    of ``TDense`` and ``LayerNorm``: the input's cotangent and the
    kernel's (rounded to bf16, widened to f32) one ulp an element, where
    the points match; the bias's within BIAS_SHARE (its sum, above); the
    LayerNorm's scale and bias cotangents (f32) within 1e-5 relative."""
    rng = np.random.RandomState(3)
    x = rng.randn(6, 9, 48).astype(np.float32)
    g = rng.randn(6, 9, 40).astype(np.float32)
    mod = TDense(40, dtype=BF16)
    params = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(1),
                                               jnp.asarray(x))['params'])

    def vjp(p, a, ct):
        _, fn = jax.vjp(lambda p, a: mod.apply({'params': p}, a), p, a)
        return fn(ct)

    dp, dx = _no_excess(vjp, params, jnp.asarray(x),
                        jnp.asarray(g).astype(BF16))
    weight = torch.from_numpy(params['kernel'].T.copy()).requires_grad_()
    bias = torch.from_numpy(params['bias'].copy()).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = dense(xt, weight, bias, torch.bfloat16)
    gx, gw, gb = torch.autograd.grad(y, (xt, weight, bias), _t(g))
    assert gx.dtype == gw.dtype == gb.dtype == torch.float32
    assert _within_an_ulp(gx, dx)
    assert _within_an_ulp(gw.t(), dp['kernel'])
    exact = _t(g).double().sum((0, 1)).float()
    assert _within_an_ulp(gb, exact.numpy())
    assert _share(gb, dp['bias']) <= BIAS_SHARE

    norm_mod = LayerNorm(dtype=BF16)
    xb = jnp.asarray(x[..., :40]).astype(BF16)
    p = {'scale': (1 + 0.1 * rng.randn(40)).astype(np.float32),
         'bias': (0.1 * rng.randn(40)).astype(np.float32)}

    def ln_vjp(p, a, ct):
        _, fn = jax.vjp(lambda p, a: norm_mod.apply({'params': p}, a), p, a)
        return fn(ct)

    dp, dx = _no_excess(ln_vjp, p, xb, jnp.asarray(g).astype(BF16))
    norm = torch.nn.LayerNorm(40, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(p['scale']))
        norm.bias.copy_(torch.from_numpy(p['bias']))
    xt = _t(xb).requires_grad_()
    y = layer_norm(norm, xt, torch.bfloat16)
    gx, gs, gb = torch.autograd.grad(y, (xt, norm.weight, norm.bias), _t(g))
    assert gx.dtype == torch.bfloat16 and _within_an_ulp(gx, dx)
    np.testing.assert_allclose(gs.numpy(), _np(dp['scale']), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), _np(dp['bias']), rtol=1e-5,
                               atol=1e-6)


# --- the train steps ----------------------------------------------------------

def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb else float(
        np.linalg.norm(a))


def _hold_grads(got, want, want_f32):
    """Each gradient tensor of ``got`` (the port at bf16) within
    GRAD_REL_L2 of ``want`` (JAX at bf16), relative L2; or else, where
    JAX's bf16 gradient itself lies about that far from JAX's f32 gradient
    of the same weights (bias sums over many rows, added in bf16 one after
    another on XLA's CPU backend; gradients below bf16's rounding noise),
    the port's within GRAD_REL_L2 of that f32 gradient's norm, or no
    farther from it than twice JAX's bf16 one (in norms: a gradient that
    is zero in exact arithmetic, as a bias before a softmax, has an f32
    norm near 0). Returns {name: (rel L2 to JAX bf16, the port's and JAX's
    bf16 distance from JAX's f32)}."""
    seen = {}
    for k, g in got.items():
        a, b, c = g.numpy(), want[k].numpy(), want_f32[k].numpy()
        assert np.isfinite(a).all(), k
        rel = _rel_l2(a, b)
        port, own = np.linalg.norm(a - c), np.linalg.norm(b - c)
        seen[k] = (rel, port, own)
        assert rel <= GRAD_REL_L2 or port <= max(
            GRAD_REL_L2 * np.linalg.norm(c), 2 * own), (k, seen[k])
    return seen


def hold_bf16_moves(what, got, want, before, grads, lr, wd, agree=None):
    """Parameters after one bf16 Adam update (``got``) against the
    reference's (``want``), both from ``before``, held by their moves, as
    :func:`test_train_step_bf16_matches_jax` holds them: every element's
    move within 2 lr of the reference's (Adam's first step is about lr
    sign(g + wd p)), and in the tensors of ``agree`` (default: all; those
    whose gradients agree within GRAD_REL_L2) the same way as the
    reference's wherever what Adam took, the reference's gradient
    ``grads`` plus the decay's wd p (``group_weight`` off: every tensor
    decays), is at least 2^-5 of its tensor's largest. A skipped update,
    or one that went the other way, fails there."""
    assert set(got) == set(want) == set(before), what
    for k, w0 in before.items():
        moved, jmoved = got[k] - w0, want[k] - w0
        far = (moved - jmoved).abs().max().item() if w0.numel() else 0.0
        assert far <= 2 * lr + 1e-6, (what, k, far)
        if agree is not None and k not in agree:
            continue
        taken = (grads[k] + wd * w0).abs()
        big = taken >= 2 ** -5 * taken.max()
        assert (torch.sign(moved[big]) == torch.sign(jmoved[big])).all(), (
            what, k)


@pytest.fixture(scope='module')
def step_refs(jax_refs):
    """Per kind: the config (H=128, batches of 8, dropout off, JAX's fused
    kernels on), the shared weights, the batch and JAX's bf16 and f32 loss
    terms and gradients (the bf16 ones with the Pallas kernels
    interpreted)."""
    return jax_refs['steps']


@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_train_step_bf16_matches_jax(kind, step_refs):
    """One train step at bf16 against JAX's at shared weights (carried by
    ``state_dict_from_jax``, f32 on both sides): the loss terms within
    LOSS_RTOL; each gradient tensor as :func:`_hold_grads` says; the
    parameters after one Adam update of both within 2 lr, and moved the
    same way where what Adam takes, g plus the weight decay's wd p, is at
    least 2^-5 of its tensor's largest, in the tensors whose gradients
    agree (Adam's first step is about lr sign(g + wd p); where g cancels
    the decay, its sign is either)."""
    ref = step_refs[kind]
    params, weights, b = ref['params'], ref['weights'], ref['batch']
    baseline = kind == 'baseline'
    model = build_model(params, kind, device='cpu')
    model.load_state_dict(state_dict_from_jax(weights, baseline=baseline),
                          strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.bfloat16
    keys = HOST_PAIR_KEYS if kind == 'gmd' else STEP_KEYS
    tb = {k: torch.from_numpy(np.array(b[k])) for k in keys}
    state = TrainState(model, params, steps_per_epoch=2)
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    step = make(model, state, params)
    model.train()
    if kind == 'gmd':
        pseudo = {k[len('pseudo_'):]: v for k, v in tb.items()
                  if k.startswith('pseudo_')}
        loss, aux = step.loss_fn(tb, pseudo, None)
        terms = ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d')
    else:
        loss, aux = step.loss_fn(tb, None)
        terms = ('loss',)
    loss.backward()
    jaux = ref['bf16'][0]
    for k in terms:
        got, want = float(aux[k].detach()), float(jaux[k])
        assert abs(got - want) <= LOSS_RTOL * abs(want), k
    convert = functools.partial(state_dict_from_jax, baseline=baseline)
    want = convert(jax.tree.map(np.asarray, ref['bf16'][1]))
    want_f32 = convert(jax.tree.map(np.asarray, ref['f32'][1]))
    got = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    seen = _hold_grads(got, want, want_f32)

    # one Adam update of both from the same weights and gradients
    jstate = jax_state.create_train_state(
        weights, jax_state.make_optimizer(params, steps_per_epoch=2))
    new = convert(jax.tree.map(np.asarray,
                               jstate.apply_gradients(ref['bf16'][1]).params))
    model.load_state_dict(state_dict_from_jax(weights, baseline=baseline))
    model.zero_grad()
    metrics = step(tb, None)
    assert math.isfinite(float(metrics['loss']))
    before = state_dict_from_jax(weights, baseline=baseline)
    wd = float(params['weight_decay'])
    for k, p in model.state_dict().items():
        moved, jmoved = p - before[k], new[k] - before[k]
        assert (moved - jmoved).abs().max().item() <= 2 * LR + 1e-6, k
        # what Adam takes: the gradient plus the decay's wd * p
        g = (want[k] + wd * before[k]).abs()
        big = g >= 2 ** -5 * g.max()
        if seen[k][0] <= GRAD_REL_L2:
            assert (torch.sign(moved[big]) == torch.sign(jmoved[big])).all(), k


# --- the driver ---------------------------------------------------------------

TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '1']


def test_main_train_bf16_writes_a_ckp_that_main_test_bf16_reads(tmp_path):
    """``main_train --precision bf16 --device cpu`` for one epoch at tiny
    widths writes a reference ``.ckp`` of f32 weights, which the port's
    ``main_test --precision bf16`` evaluates."""
    root = str(tmp_path)
    params = port_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                                   default_model='GMD')
    anno, feats, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=8, name='charades_train.json')
    for split in ('charades_val.json', 'charades_test_ood.json'):
        shutil.copy(anno, os.path.join(root, split))
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY, '--precision', 'bf16',
            '--device', 'cpu', '--runs', os.path.join(root, 'runs'),
            '--train_data', anno,
            '--val_data', os.path.join(root, 'charades_val.json'),
            '--test_data', os.path.join(root, 'charades_test_ood.json'),
            '--train_featpath', feats, '--valid_featpath', feats,
            '--test_featpath', feats, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init']]
    stats = port_cli.main_train(port_cli.parse_params(
        argv + ['--alias', 'bf16_train', '--epoch', '1'],
        default_model='GMD'))
    assert math.isfinite(stats['loss'][0]) and list(stats['mIoU']) == [0]
    ckp = os.path.join(root, 'runs', 'bf16_train', 'model',
                       'bf16_train_00000.ckp')
    saved = torch.load(ckp, weights_only=True)
    assert saved and all(v.dtype == torch.float32 for v in saved.values())
    submit = port_cli.main_test(port_cli.parse_params(
        argv + ['--alias', 'test_bf16_from_train', '--start_from', ckp],
        default_model='GMD'))
    with open(submit) as f:
        rows = [r for v in json.load(f)['results'].values() for r in v]
    assert len(rows) == n and all(math.isfinite(r['score']) for r in rows)
