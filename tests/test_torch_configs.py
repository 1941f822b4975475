"""Every shipped config at its real dimensions, and the ActivityNet shape
against the JAX package.

- For each of the seven ``cfgs/*.yml`` (the port's twin of
  ``tests/test_all_configs.py``): GMD and the QAVE baseline built at the
  config's own ``video_len``, ``sent_len``, ``video_feature_dim`` and
  widths have the JAX model's parameter count (``jax.eval_shape`` of its
  init, no compute), each tensor the shape the JAX tree maps to; and one
  forward at B=1 on the CPU gives finite outputs of the right shapes.
- At ``cfgs/anet_cd_c3d.yml``'s shape (T=240, N=25, C3D D=500) with
  narrow widths: one eval step (``make_gmd_test_step``) and one train step
  (loss terms, gradients, the parameters after an update) against JAX's,
  within the tolerances of ``tests/test_torch_gmd.py`` and
  ``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shufflingvideosfortsg_tpu.config import load_config as jax_load_config
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model
from shufflingvideosfortsg_tpu.ops import augment_device as jax_aug
from shufflingvideosfortsg_tpu.train import state as jax_state
from shufflingvideosfortsg_tpu.train import steps as jax_steps
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (HOST_PAIR_KEYS,
                                                     STEP_KEYS,
                                                     make_gmd_test_step,
                                                     make_gmd_train_step)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from test_all_configs import CFGS, REPO
from test_torch_train import _conditioned, _jax_setup, _port_model, _t
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5  # f32, as tests/test_torch_gmd.py


def _jax_shapes(params, kind):
    """The JAX model's parameter tree as ShapeDtypeStructs."""
    B, T, N = 2, params['video_len'], params['sent_len']
    video = jax.ShapeDtypeStruct((B, T, params['video_feature_dim']),
                                 jnp.float32)
    sent = jax.ShapeDtypeStruct((B, N, 300), jnp.float32)
    m_t = jax.ShapeDtypeStruct((B, T), jnp.int32)
    m_n = jax.ShapeDtypeStruct((B, N), jnp.int32)
    model = jax_build_model(params, kind)
    if kind == 'gmd':
        args = (sent, m_n, video, m_t, video, m_t, *[m_t] * 6)
    else:
        args = (video, sent, m_t, m_n)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)['params']


@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
@pytest.mark.parametrize('cfg', CFGS)
def test_config_builds_at_its_real_dimensions(cfg, kind):
    params = load_config(cfg)
    assert params['video_len'] == jax_load_config(
        f'{REPO}/cfgs/{cfg}')['video_len']
    shapes = _jax_shapes(jax_load_config(f'{REPO}/cfgs/{cfg}'), kind)
    want = state_dict_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        baseline=kind == 'baseline')
    torch.manual_seed(0)
    model = build_model(params, kind, device='cpu').eval()
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax > 1e6

    T, N = params['video_len'], params['sent_len']
    rng = np.random.RandomState(0)
    video = _t(rng.randn(1, T, params['video_feature_dim'])
               .astype(np.float32))
    sent = _t(rng.randn(1, N, 300).astype(np.float32))
    vmask = _t((np.arange(T)[None] < T - 7).astype(np.int32))
    with torch.no_grad():
        if kind == 'gmd':
            out = model.eval_forward(video, sent, vmask)
            assert out['match_prob'].shape == (1, T)
        else:
            out = model(video, sent, vmask)
    for k in ('start_prob', 'end_prob'):
        assert out[k].shape == (1, T) and torch.isfinite(out[k]).all()


# --- the ActivityNet shape against JAX ---------------------------------------

ANET = dict(video_len=240, sent_len=25, video_feature_dim=500)
B = 4


def _anet_params(**over):
    params = load_config('anet_cd_c3d.yml')
    assert {k: params[k] for k in ANET} == ANET
    params.update(sent_rnn_hiddendim=8, video_rnn_hiddendim=16,
                  mlp_hidden_dim=8, m_pred_hidden=16, lr=1e-3, dropout=0.0,
                  disc_dropout=0.0, on_device_aug=False, **over)
    return params


def _anet_batch(seed=5):
    """A host-made pair batch at T=240, N=25, D=500 (JAX's pseudo videos
    at a fixed key), with ragged videos and sentences."""
    T, N, D = ANET['video_len'], ANET['sent_len'], ANET['video_feature_dim']
    rng = np.random.RandomState(seed)
    nfeats = rng.randint(40, T + 1, B).astype(np.int32)
    s = np.array([rng.randint(0, n - 10) for n in nfeats], np.int32)
    e = np.minimum(s + rng.randint(1, 30, B), nfeats - 1).astype(np.int32)
    framestps = np.stack([s, e], -1)
    video = rng.randn(B, T, D).astype(np.float32)
    video[np.arange(T)[None] >= nfeats[:, None]] = 0.0
    words = rng.randint(3, N + 1, B)
    raw = jax_aug.device_masks(jnp.asarray(s), jnp.asarray(e),
                               jnp.asarray(nfeats), T)
    pfeat, pfs, pm = jax_aug.gt_translate_batch(
        jax.random.PRNGKey(seed), jnp.asarray(video), jnp.asarray(framestps),
        jnp.asarray(nfeats))
    batch = {'video_feat': video,
             'sent_feat': rng.randn(B, N, 300).astype(np.float32),
             'sent_mask': (np.arange(N)[None] < words[:, None])
             .astype(np.int32),
             'framestps': framestps, 'timestps': framestps.astype(np.float32),
             'nfeats': nfeats, 'duration': np.full(B, 120.0, np.float32),
             'pseudo_video_feat': pfeat, 'pseudo_framestps': pfs,
             **{k: raw[k] for k in ('video_mask', 'temporal_labels',
                                    'fore_masks', 'back_masks')},
             **{'pseudo_' + k: v for k, v in pm.items()}}
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def anet():
    params = _anet_params()
    jm, weights = _jax_setup(params)
    return params, jm, weights, _anet_batch()


def test_anet_eval_step_matches_jax(anet):
    params, jm, weights, b = anet
    want = jax.jit(jax_steps.make_gmd_test_step(jm))(
        weights, {k: jnp.asarray(b[k]) for k in STEP_KEYS})
    model = _port_model(params, weights)
    got = make_gmd_test_step(model)({k: _t(b[k]) for k in STEP_KEYS})
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(got['score'].numpy(), np.asarray(want['score']),
                               atol=TOL)
    np.testing.assert_array_equal(got['pred_time'].numpy(),
                                  np.asarray(want['pred_time']))
    np.testing.assert_allclose(float(got['miou']), float(want['miou']),
                               atol=1e-6)


def test_anet_train_step_matches_jax(anet):
    """``test_train_step_matches_jax``'s tolerances: loss rtol 2e-4, terms
    rtol 5e-4, gradients atol 1e-6 rtol 2e-3, the parameters after the
    update atol 2e-6 rtol 5e-3 where the gradient is above 1e-5."""
    params, jm, weights, b = anet
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(b[k]) for k in HOST_PAIR_KEYS}
    jstep = jax_steps.make_gmd_train_step(jm, params)
    pseudo = {k: jb['pseudo_' + k] for k in
              ('video_feat', 'framestps', 'video_mask', 'temporal_labels',
               'fore_masks', 'back_masks')}
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(
        jstep.loss_fn, has_aux=True))(weights, jb, pseudo,
                                      jax.random.PRNGKey(0))
    # the JAX step's update and statistics, from these gradients
    jstate = jax.jit(lambda st, g: st.apply_gradients(grads=g))(
        jax_state.create_train_state(
            weights, jax_state.make_optimizer(params, steps_per_epoch=2)),
        jgrads)
    *_, jmiou = jax.jit(jax_steps._stats, static_argnums=3)(
        jaux['start_prob'], jaux['end_prob'], jb, False)
    model = _port_model(params, weights)
    metrics = make_gmd_train_step(model, TrainState(model, params, 2),
                                  params)(tb, None)
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'):
        np.testing.assert_allclose(float(metrics[k]), float(jaux[k]),
                                   rtol=2e-4 if k == 'loss' else 5e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics['miou']), float(jmiou),
                               atol=1e-6)
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   atol=1e-6, rtol=2e-3, err_msg=k)
    cond = _conditioned(want_grads)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, p in model.state_dict().items():
        g, w, m = p.numpy(), want[k].numpy(), cond[k]
        np.testing.assert_allclose(g[m], w[m], atol=2e-6, rtol=5e-3,
                                   err_msg=k)
        if (~m).any():
            assert np.abs(g[~m] - w[~m]).max() <= 2e-3 + 1e-6
