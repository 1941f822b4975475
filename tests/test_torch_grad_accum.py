"""Gradient accumulation in the port's train steps (``grad_accum_steps``,
``train/steps._backward``) against the port's own single update and
against the JAX package's ``_accumulate_grads``.

- accum 4 (GMD) and 2 (baseline) against accum 1 at dropout 0 and
  uniform masks, where every loss term reduces identically: the
  tolerances of ``tests/test_grad_accum.py`` (loss and mIoU rtol 1e-5,
  parameters after the update rtol 1e-3, atol 2e-5);
- the port's accumulated update against JAX's at shared weights, dropout
  0, the pseudo stream made by JAX on the host and ragged masks (so the
  microbatches' BCE normalisers differ): the loss terms and the
  parameters after two updates within ``tests/test_torch_train.py``'s
  tolerances;
- an ``accum`` that does not divide the batch raises JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shufflingvideosfortsg_tpu.train import state as jax_state
from shufflingvideosfortsg_tpu.train import steps as jax_steps
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (
    HOST_PAIR_KEYS, STEP_KEYS, TRAIN_KEYS, make_baseline_train_step,
    make_gmd_train_step)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from test_torch_train import (_batch, _conditioned, _jax_setup, _params,
                              _port_model, _t)
from torch_one_thread import one_torch_thread  # noqa: F401

B, T, N, DV = 8, 16, 7, 32
LR = 1e-3


def _uniform_params(accum):
    return load_config(None, overrides=dict(
        video_len=T, video_feature_dim=DV, sent_len=N,
        sent_rnn_hiddendim=16, video_rnn_hiddendim=16, mlp_hidden_dim=16,
        m_pred_hidden=16, dropout=0.0, disc_dropout=0.0, lr=LR,
        grad_accum_steps=accum))


def _uniform_batch(seed=0):
    """``tests/test_grad_accum.py``'s batch: every mask all ones."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, T - 4, B).astype(np.int32)
    e = s + 2
    ones = np.ones((B, T), np.int32)
    return {'sent_feat': _t(rng.randn(B, N, 300).astype(np.float32)),
            'sent_mask': _t(np.ones((B, N), np.int32)),
            'video_feat': _t(rng.randn(B, T, DV).astype(np.float32)),
            'video_mask': _t(ones), 'nfeats': _t(np.full(B, T, np.int32)),
            'framestps': _t(np.stack([s, e], -1)),
            'timestps': _t(np.stack([s, e], -1).astype(np.float32)),
            'duration': _t(np.full(B, float(T), np.float32)),
            'temporal_labels': _t(ones), 'fore_masks': _t(ones),
            'back_masks': _t(ones)}


def _update(kind, accum, keys):
    """One update of a seeded port model at ``accum``: (metrics, weights)."""
    params = _uniform_params(accum)
    torch.manual_seed(0)
    model = build_model(params, kind, device='cpu')
    state = TrainState(model, params, steps_per_epoch=10)
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    step = make(model, state, params)
    batch = {k: v for k, v in _uniform_batch().items() if k in keys}
    metrics = step(batch, torch.Generator().manual_seed(7))
    return metrics, model.state_dict()


@pytest.mark.parametrize('kind, accum, keys', [
    ('gmd', 4, TRAIN_KEYS), ('baseline', 2, STEP_KEYS)])
def test_accum_equals_single_update(kind, accum, keys):
    m1, w1 = _update(kind, 1, keys)
    mk, wk = _update(kind, accum, keys)
    assert set(mk) == set(m1)
    for k in m1:
        np.testing.assert_allclose(float(mk[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=k)
    for k, v in w1.items():
        np.testing.assert_allclose(wk[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize('accum', [2, 4])
def test_accum_matches_jax(accum):
    """Two updates at ``grad_accum_steps`` = accum against the JAX step
    at the same setting (the tolerances of ``test_train_step_matches_jax``:
    loss rtol 2e-4, mIoU atol 1e-6, parameters atol 2e-6 rtol 5e-3 where
    the first accumulated gradient is above the f32 noise floor, within
    Adam's drift elsewhere)."""
    params = _params(grad_accum_steps=accum)
    jm, weights = _jax_setup(params)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(b[k]) for k in HOST_PAIR_KEYS}
    jstep = jax_steps.make_gmd_train_step(jm, params)
    key = jax.random.PRNGKey(0)
    model = _port_model(params, weights)
    step = make_gmd_train_step(model, TrainState(model, params, 2), params)
    jstate = jax_state.create_train_state(
        weights, jax_state.make_optimizer(params, steps_per_epoch=2))
    for n in range(2):
        jstate, jaux = jstep(jstate, jb, key)
        metrics = step(tb, None)
        if n == 0:  # where the first accumulated gradient is above noise
            cond = _conditioned({k: p.grad
                                 for k, p in model.named_parameters()})
        for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'):
            np.testing.assert_allclose(float(metrics[k]), float(jaux[k]),
                                       rtol=2e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(metrics['miou']),
                                   float(jaux['miou']), atol=1e-6)
        want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
        for k, p in model.state_dict().items():
            g, w, m = p.numpy(), want[k].numpy(), cond[k]
            np.testing.assert_allclose(g[m], w[m], atol=2e-6, rtol=5e-3,
                                       err_msg=f'{k} after update {n + 1}')
            if (~m).any():
                assert np.abs(g[~m] - w[~m]).max() <= 2 * LR * (n + 1) + 1e-6


@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_accum_must_divide_the_batch(kind):
    params = _uniform_params(3)  # B=8
    model = build_model(params, kind, device='cpu')
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    step = make(model, TrainState(model, params, 1), params)
    with pytest.raises(ValueError, match=r'grad_accum_steps=3 must divide '
                       r'the batch size \(8\)'):
        step(_uniform_batch(), torch.Generator().manual_seed(0))
