"""The JAX references of tests/test_torch_bf16_train.py, computed in a
child process with a deadline.

Those references run the JAX package's Pallas train kernels with
``interpret=True``: K3 and K4 directly, ``jax.vjp`` of ``lstm_flat_fused``
over them, and ``jax.value_and_grad`` of whole GMD and baseline losses with
the model's kernels interpreted. Pallas's interpret mode can deadlock
inside JAX (a thread in its host callback dispatching while the main
thread waits: ROADMAP.md §3, F3 and F4), and a hang inside a pytest worker
holds the whole test run until its time limit. So :func:`run_in_child`
computes them in a fresh Python process, which pickles them as numpy
arrays (bf16 ones keep their dtype) into the test's temporary directory;
a child that passes its deadline is killed and a fresh one started, once.
The hang lies in JAX's interpreter, not in the port, and a fresh process
computes the same values from the same seeds: nothing the tests compare
changes.

Not a test module (pytest collects ``test_*.py`` only). The child runs
this file as a script::

    python tests/bf16_train_refs.py <output.pkl>
"""

import functools
import math
import os
import pickle
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

jax.config.update('jax_platforms', 'cpu')  # as tests/conftest.py

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
for _p in (_ROOT, _TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import shufflingvideosfortsg_tpu.ops.pallas.lstm_scan as jax_lstm_scan  # noqa: E402
import shufflingvideosfortsg_tpu.ops.pallas.scdm_fused as jax_scdm_fused  # noqa: E402
import shufflingvideosfortsg_tpu.ops.rnn as jax_rnn  # noqa: E402
from shufflingvideosfortsg_tpu import cli as jax_cli  # noqa: E402
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model  # noqa: E402
from shufflingvideosfortsg_tpu.ops import augment_device as jax_aug  # noqa: E402
from shufflingvideosfortsg_tpu.ops import losses as jax_losses  # noqa: E402
from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (  # noqa: E402
    lstm_scan_pallas_bwd_flat, lstm_scan_pallas_flat,
    lstm_scan_pallas_train_flat)
from shufflingvideosfortsg_tpu.ops.pallas.scdm_fused import \
    scdm_attention_fused  # noqa: E402
from shufflingvideosfortsg_tpu.train.steps import \
    make_gmd_train_step as jax_gmd_step  # noqa: E402
from shufflingvideosfortsg_torch.config import load_config  # noqa: E402
from test_torch_bf16 import _WidenedEinsum, _no_excess  # noqa: E402

BF16 = jnp.bfloat16
LR = 1e-3
H, D, W, B, T, N = 128, 24, 300, 8, 10, 5
# K3/K4 shapes, and those of which jax.vjp of lstm_flat_fused is taken
LSTM_SHAPES = [(12, 8, 16), (7, 3, 8), (10, 8, 128)]
VJP_SHAPES = LSTM_SHAPES[1:]
# a child's deadline: the references take 20-60 s on a loaded host
DEADLINE_S = 240
ATTEMPTS = 2


def patch_tpu_like(m):
    """The JAX training build's Pallas kernels, interpreted where the
    model calls them (at call time: the BiLSTM imports ``lstm_flat_fused``,
    whose forward and backward call the train kernels, and the attention
    ``scdm_attention_fused_trainable``, whose forward calls K2); the
    BiLSTM's bf16 einsum widened (tests/test_torch_bf16.py). ``m`` is a
    ``pytest.MonkeyPatch``."""
    m.setattr(jax_rnn, 'jnp', _WidenedEinsum())
    for name, fn in (('lstm_scan_pallas_flat', lstm_scan_pallas_flat),
                     ('lstm_scan_pallas_train_flat',
                      lstm_scan_pallas_train_flat),
                     ('lstm_scan_pallas_bwd_flat', lstm_scan_pallas_bwd_flat)):
        m.setattr(jax_lstm_scan, name, functools.partial(fn, interpret=True))
    m.setattr(jax_scdm_fused, 'scdm_attention_fused',
              functools.partial(scdm_attention_fused, interpret=True))


def lstm_case(T_, B_, H_):
    rng = np.random.RandomState(T_ * 10 + B_)
    f32 = np.float32
    xw = jnp.asarray((rng.randn(T_, B_, 8 * H_) * 0.5).astype(f32)).astype(BF16)
    w = jnp.asarray((rng.randn(2, H_, 4 * H_) / math.sqrt(H_)).astype(f32)
                    ).astype(BF16)
    d_out = jnp.asarray(rng.randn(T_, B_, 2 * H_).astype(f32)).astype(BF16)
    d_h = jnp.asarray(rng.randn(2, B_, H_).astype(f32))
    d_c = jnp.asarray(rng.randn(2, B_, H_).astype(f32))
    return xw, w, d_out, d_h, d_c


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def lstm_refs():
    """Per shape: (the inputs, the Pallas train kernels' forward and
    backward results (interpreted, XLA's excess precision off), and for
    VJP_SHAPES the outputs and cotangents of ``jax.vjp`` of
    ``lstm_flat_fused`` over the interpreted kernels, else None)."""
    refs = {}
    mp = pytest.MonkeyPatch()
    try:
        for shape in LSTM_SHAPES:
            xw, w, d_out, d_h, d_c = case = lstm_case(*shape)
            fwd = _no_excess(lambda x, v: lstm_scan_pallas_train_flat(
                x, v, interpret=True), xw, w)
            bwd = _no_excess(lambda *a: lstm_scan_pallas_bwd_flat(
                *a, interpret=True), xw, w, fwd[0], fwd[1], d_out, d_h, d_c)
            vjp = None
            if shape in VJP_SHAPES:
                def fn(x, v, *cot):
                    outs, back = jax.vjp(jax_lstm_scan.lstm_flat_fused, x, v)
                    return outs, back(cot)

                with mp.context() as m:
                    patch_tpu_like(m)
                    vjp = _no_excess(fn, *case)
            refs[shape] = _numpy((case, fwd, bwd, vjp))
    finally:
        mp.undo()
    return refs


def params(kind: str, precision: str = 'bf16', **overrides):
    """A small config at H=128 (the Pallas kernels' width) and batches of
    8, dropout off, the loader's pseudo videos (GMD), JAX's fused kernels
    on in the training build."""
    p = load_config('charades_cd_i3d.yml')
    p.update(video_feature_dim=D, sent_embedding_dim=W,
             sent_rnn_hiddendim=H, video_rnn_hiddendim=H,
             mlp_hidden_dim=8, m_pred_hidden=16, video_len=T,
             sent_len=N, lr=LR, dropout=0.0, disc_dropout=0.0,
             on_device_aug=False, grad_clip_max=0.5,
             precision=precision, fused_inference=precision == 'bf16',
             model='GMD' if kind == 'gmd' else 'QAVE')
    p.update(overrides)
    return p


def batch(seed: int):
    """A host-made pair batch of B rows (the JAX augmentation at a fixed
    key), as tests/test_torch_train.py makes it."""
    from test_torch_train import _spans
    rng = np.random.RandomState(seed)
    framestps, nfeats = _spans(rng, B, T)
    framestps[:, 1] = np.minimum(framestps[:, 1], nfeats - 1)
    video = rng.randn(B, T, D).astype(np.float32)
    video[np.arange(T)[None] >= nfeats[:, None]] = 0.0
    raw = jax_aug.device_masks(*map(jnp.asarray, (framestps[:, 0],
                                                  framestps[:, 1], nfeats)), T)
    pfeat, pfs, pm = jax_aug.gt_translate_batch(
        jax.random.PRNGKey(seed), jnp.asarray(video), jnp.asarray(framestps),
        jnp.asarray(nfeats))
    out = {'video_feat': video,
           'sent_feat': rng.randn(B, N, W).astype(np.float32),
           'sent_mask': np.ones((B, N), np.int32),
           'framestps': framestps,
           'timestps': framestps.astype(np.float32), 'nfeats': nfeats,
           'duration': np.full(B, 30.0, np.float32),
           'pseudo_video_feat': pfeat, 'pseudo_framestps': pfs,
           **{k: raw[k] for k in ('video_mask', 'temporal_labels',
                                  'fore_masks', 'back_masks')},
           **{'pseudo_' + k: v for k, v in pm.items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_grads(p, kind, weights, jb, pseudo):
    """JAX's loss terms and gradients at ``p``'s precision (its train
    build, the kernels interpreted at bf16), compiled with XLA's excess
    precision off: GMD's ``loss_fn`` of ``make_gmd_train_step``, the
    baseline's loss as its train step takes it (``train/steps.py:367``)."""
    model = jax_build_model(p, kind)
    if kind == 'gmd':
        loss_fn = jax_gmd_step(model, p).loss_fn
    else:
        def loss_fn(w, b, _pseudo, key):
            out = model.apply({'params': w}, b['video_feat'],
                              b['sent_feat'], b['video_mask'],
                              b['sent_mask'], deterministic=False,
                              rngs={'dropout': key})
            loss = jax_losses.span_ground_loss(
                out['start_prob'], out['end_prob'], b['framestps'])
            return loss, {'loss': loss}
    (_, aux), grads = _no_excess(jax.value_and_grad(loss_fn, has_aux=True),
                                 weights, jb, pseudo or {},
                                 jax.random.PRNGKey(0))
    return _numpy((aux, grads))


def step_refs():
    """Per kind: the config, the shared weights, the batch and JAX's bf16
    and f32 loss terms and gradients (the bf16 ones with the Pallas kernels
    interpreted)."""
    mp = pytest.MonkeyPatch()
    refs = {}
    try:
        for kind in ('gmd', 'baseline'):
            p = params(kind)
            model = jax_build_model(p, kind)
            weights = _numpy(jax_cli.init_model_params(
                model, p, jax.random.PRNGKey(5), kind))
            b = batch(seed=3 if kind == 'gmd' else 4)
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            pseudo = {k: jnp.asarray(b['pseudo_' + k]) for k in
                      ('video_feat', 'framestps', 'video_mask',
                       'temporal_labels', 'fore_masks', 'back_masks')
                      } if kind == 'gmd' else None
            f32 = _jax_grads(params(kind, 'f32'), kind, weights, jb, pseudo)
            with mp.context() as m:
                patch_tpu_like(m)
                bf16 = _jax_grads(p, kind, weights, jb, pseudo)
            refs[kind] = dict(params=p, weights=weights, batch=b, bf16=bf16,
                              f32=f32)
    finally:
        mp.undo()
    return refs


def compute():
    return dict(lstm=lstm_refs(), steps=step_refs())


def run_in_child(tmp_dir, deadline: float = DEADLINE_S,
                 attempts: int = ATTEMPTS):
    """:func:`compute` in a child process (this file run as a script)
    that writes its pickle into ``tmp_dir``; a child that has not ended
    within ``deadline`` seconds is killed with its process group and a
    fresh one started, up to ``attempts`` children in all. Raises if a
    child fails or every one times out."""
    out = os.path.join(str(tmp_dir), 'bf16_train_refs.pkl')
    for _ in range(attempts):
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=deadline)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            continue
        if proc.returncode:
            raise RuntimeError(f'the JAX references failed (exit '
                               f'{proc.returncode}):\n{log[-4000:]}')
        with open(out, 'rb') as f:
            return pickle.load(f)
    raise RuntimeError(f'the JAX references did not finish within '
                       f'{deadline} s in {attempts} child processes')


if __name__ == '__main__':
    refs = compute()
    with open(sys.argv[1] + '.tmp', 'wb') as f:
        pickle.dump(refs, f)
    os.replace(sys.argv[1] + '.tmp', sys.argv[1])
