"""The port's training slice against the JAX package at small widths:
on-device pseudo videos, the losses, the GMD pair forward, the optimizer
pieces, and the train step (loss terms, gradients and parameters after 3
updates) against ``make_gmd_train_step`` at shared weights carried by
``state_dict_from_jax``. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shufflingvideosfortsg_tpu import cli as jax_cli
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model
from shufflingvideosfortsg_tpu.ops import augment_device as jax_aug
from shufflingvideosfortsg_tpu.ops import losses as jax_losses
from shufflingvideosfortsg_tpu.train import state as jax_state
from shufflingvideosfortsg_tpu.train.steps import \
    make_gmd_train_step as jax_train_step
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.ops import augment_device, losses
from shufflingvideosfortsg_torch.ops.rnn import dropout
from shufflingvideosfortsg_torch.train.state import (TrainState,
                                                     clip_by_global_norm,
                                                     decay_groups,
                                                     lr_schedule_fn)
from shufflingvideosfortsg_torch.train.steps import (HOST_PAIR_KEYS,
                                                     TRAIN_KEYS,
                                                     make_gmd_train_step,
                                                     make_gmd_valid_step)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5  # f32
B, T, N, D = 4, 20, 7, 10
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


# --- pseudo videos on the device -------------------------------------------

def _spans(rng, B, T):
    n = rng.randint(3, T + 1, B)
    s = np.array([rng.randint(0, k) for k in n])
    e = np.array([rng.randint(a, k) for a, k in zip(s, n)])
    # edge rows: a one-frame span and a span as long as the video (no-ops)
    s[0], e[0] = 2, 2
    s[1], e[1], n[1] = 0, n[1] - 1, n[1]
    return np.stack([s, e], -1).astype(np.int32), n.astype(np.int32)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gt_translate_batch_matches_jax_at_the_jax_draw(seed):
    rng = np.random.RandomState(seed)
    Bt, Tt = 12, 16
    framestps, nfeats = _spans(rng, Bt, Tt)
    video = rng.randn(Bt, Tt, 5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_feat, want_fs, want_masks = jax_aug.gt_translate_batch(
        key, jnp.asarray(video), jnp.asarray(framestps), jnp.asarray(nfeats))
    u = np.asarray(jax.random.uniform(key, (Bt,)))  # the JAX function's draw
    feat, fs, masks = augment_device.gt_translate_batch(
        _t(u), _t(video), _t(framestps), _t(nfeats))
    np.testing.assert_array_equal(feat.numpy(), np.asarray(want_feat))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(want_fs))
    assert fs.dtype == torch.int32
    assert set(masks) == set(want_masks)
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy(),
                                      np.asarray(want_masks[k]), err_msg=k)
    # the translated span keeps its length; the moment moves with it
    L = framestps[:, 1] - framestps[:, 0]
    np.testing.assert_array_equal(fs[:, 1].numpy() - fs[:, 0].numpy(), L)
    for i in range(Bt):
        s, e = framestps[i]
        ps, pe = fs[i].tolist()
        np.testing.assert_array_equal(feat[i, ps:pe + 1].numpy(),
                                      video[i, s:e + 1])


def test_device_masks_match_jax_at_the_edges():
    s = np.array([0, 3, 5, 30], np.int32)
    e = np.array([0, 9, 40, 31], np.int32)
    n = np.array([1, 12, 50, 31], np.int32)
    want = jax_aug.device_masks(*map(jnp.asarray, (s, e, n)), 32)
    got = augment_device.device_masks(_t(s), _t(e), _t(n), 32)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize('T_len, seg_len', [(16, 4), (19, 4), (20, 7)])
def test_segment_shuffle_matches_jax_at_the_jax_permutations(T_len, seg_len):
    """``segment_shuffle`` at the permutations JAX's
    ``segment_shuffle_batch`` draws equals its output, a ragged tail kept
    in place; ``segment_shuffle_batch`` permutes each row's segments
    from its generator, the same seed giving the same rows."""
    rng = np.random.RandomState(T_len)
    Bs, n_seg = 6, T_len // seg_len
    video = rng.randn(Bs, T_len, 3).astype(np.float32)
    key = jax.random.PRNGKey(seg_len)
    want = jax_aug.segment_shuffle_batch(key, jnp.asarray(video), seg_len)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n_seg))(
        jax.random.split(key, Bs))
    got = augment_device.segment_shuffle(_t(video), _t(perms), seg_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = [augment_device.segment_shuffle_batch(
        torch.Generator().manual_seed(1), _t(video), seg_len)
        for _ in range(2)]
    assert torch.equal(drawn[0], drawn[1])
    body = drawn[0][:, :n_seg * seg_len].reshape(Bs, n_seg, seg_len, 3)
    for b in range(Bs):
        segs = _t(video[b, :n_seg * seg_len]).reshape(n_seg, seg_len, 3)
        order = [int((segs == body[b, i]).all(-1).all(-1).nonzero())
                 for i in range(n_seg)]
        assert sorted(order) == list(range(n_seg))
    np.testing.assert_array_equal(drawn[0][:, n_seg * seg_len:].numpy(),
                                  video[:, n_seg * seg_len:])


# --- losses -----------------------------------------------------------------

def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    Bl, Tl = 6, 24
    fs1 = np.sort(rng.randint(0, Tl, (Bl, 2)), axis=1).astype(np.int32)
    fs2 = fs1 - fs1[:, :1] + rng.randint(0, 5, (Bl, 1)).astype(np.int32)
    fs2 = np.clip(fs2, 0, Tl - 1)
    probs = rng.dirichlet(np.ones(Tl), size=(2, Bl)).astype(np.float32)
    return dict(
        logits=rng.randn(Bl, Tl).astype(np.float32) * 3,
        labels=(rng.rand(Bl, Tl) > 0.5).astype(np.int32),
        mask=(np.arange(Tl)[None] <= rng.randint(4, Tl, (Bl, 1))
              ).astype(np.int32),
        p1=probs[0], p2=probs[1], fs1=fs1, fs2=fs2,
        disc=rng.randn(2, Bl, 2).astype(np.float32))


_LOSSES = {
    'masked_softmax': lambda m, x: m.masked_softmax(x['logits'], x['labels']),
    'span_ground_loss': lambda m, x: m.span_ground_loss(x['p1'], x['p2'],
                                                        x['fs1']),
    'bce_loss': lambda m, x: m.bce_loss(x['logits'], x['labels'], x['mask']),
    'matching_kl_divergence': lambda m, x: m.matching_kl_divergence(
        x['p1'], x['p2'], x['fs1'], x['fs2']),
    'temporal_order_discrimination_loss':
        lambda m, x: m.temporal_order_discrimination_loss(x['disc'][0],
                                                          x['disc'][1]),
}


@pytest.mark.parametrize('name', sorted(_LOSSES))
def test_loss_matches_jax(name):
    x = _loss_inputs(len(name))
    want = _LOSSES[name](jax_losses, {k: jnp.asarray(v) for k, v in x.items()})
    got = _LOSSES[name](losses, {k: _t(v) for k, v in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --- the model and the train step -------------------------------------------

def _params(**overrides):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=D, sent_embedding_dim=300,
                  sent_rnn_hiddendim=8, video_rnn_hiddendim=16,
                  mlp_hidden_dim=8, m_pred_hidden=16, video_len=T, sent_len=N,
                  lr=LR, dropout=0.0, disc_dropout=0.0, on_device_aug=False,
                  grad_clip_max=0.5)
    params.update(overrides)
    return params


def _batch(seed=3, n_words=N):
    """A host-made pair batch (the JAX augmentation at a fixed key)."""
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
    batch = {'video_feat': video, 'sent_feat': rng.randn(B, n_words, 300)
             .astype(np.float32),
             'sent_mask': np.ones((B, n_words), np.int32),
             'framestps': framestps,
             'timestps': framestps.astype(np.float32), 'nfeats': nfeats,
             'duration': np.full(B, 30.0, np.float32),
             'pseudo_video_feat': pfeat, 'pseudo_framestps': pfs,
             **{k: raw[k] for k in ('video_mask', 'temporal_labels',
                                    'fore_masks', 'back_masks')},
             **{'pseudo_' + k: v for k, v in pm.items()}}
    return {k: np.asarray(v) for k, v in batch.items()}


def _jax_setup(params):
    model = jax_build_model(params, 'gmd')
    weights = jax_cli.init_model_params(model, params, jax.random.PRNGKey(5),
                                        'gmd')
    return model, jax.tree.map(np.asarray, weights)


def _port_model(params, weights):
    model = build_model(params, 'gmd', device='cpu')
    model.load_state_dict(state_dict_from_jax(weights), strict=True)
    return model


def _jax_pseudo(batch):
    return {k: jnp.asarray(batch['pseudo_' + k]) for k in
            ('video_feat', 'framestps', 'video_mask', 'temporal_labels',
             'fore_masks', 'back_masks')}


@pytest.mark.parametrize('pseudo_ground', [False, True])
def test_pair_forward_matches_jax(pseudo_ground):
    params = _params(loss_pseudo_ground_lambda=2.0 if pseudo_ground else 0.0)
    jm, weights = _jax_setup(params)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    args = ('sent_feat', 'sent_mask', 'video_feat', 'video_mask',
            'pseudo_video_feat', 'pseudo_video_mask', 'temporal_labels',
            'fore_masks', 'back_masks', 'pseudo_temporal_labels',
            'pseudo_fore_masks', 'pseudo_back_masks')
    want = jm.apply({'params': weights}, *(jb[k] for k in args))
    model = _port_model(params, weights).train()
    with torch.no_grad():
        got = model(*(_t(b[k]) for k in args))
    assert set(got) == set(want)
    assert ('pseudo_start_prob' in got) == pseudo_ground
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=1e-4, err_msg=k)


def _conditioned(grads_sd):
    return {k: np.abs(v.numpy()) >= 1e-5 for k, v in grads_sd.items()}


@pytest.mark.parametrize('case', [
    dict(),
    dict(loss_pseudo_ground_lambda=2.0),
    dict(group_weight=True, grad_clip=True),
    dict(optim='sgd', lr_schd='l', lr=0.5),
    # the widths that raised on the card before (faults F1 and F2): the
    # video BiLSTMs at H=512 and the attention past 32 words. One update:
    # at H=512 the trained weights' gradients change sign from step to
    # step in many small elements, and Adam, which divides by their
    # running size, turns the f32 difference of such a gradient into a
    # visible difference of the parameter from the second update on (in
    # a few elements of `word_embed` in one run, in hundreds of the
    # second QAVE block's LSTM weights in another); the first update is
    # lr * sign(g) and is held as in the other cases
    dict(video_rnn_hiddendim=512, sent_len=40, updates=1),
])
def test_train_step_matches_jax(case):
    """Tolerances of tests/test_grad_parity.py: loss rtol 2e-4, terms rtol
    5e-4, gradients atol 1e-6 rtol 2e-3, parameters after each update
    atol 2e-6 rtol 5e-3 where the step-1 gradient is above the f32 noise
    floor (1e-5) and within Adam's largest drift (2 lr a step) elsewhere."""
    case = dict(case)
    updates = case.pop('updates', 3)
    params = _params(**case)
    lr = float(params['lr'])
    jm, weights = _jax_setup(params)
    b = _batch(n_words=params['sent_len'])
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(b[k]) for k in HOST_PAIR_KEYS}
    model = _port_model(params, weights)
    state = TrainState(model, params, steps_per_epoch=2)
    step = make_gmd_train_step(model, state, params)

    # the loss and its gradient at the shared weights
    key = jax.random.PRNGKey(0)
    jstep = jax_train_step(jm, params)
    (_, jaux), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        weights, jb, _jax_pseudo(b), key)
    pseudo = {k[len('pseudo_'):]: v for k, v in tb.items()
              if k.startswith('pseudo_')}
    model.train()
    loss, aux = step.loss_fn(tb, pseudo, None)
    loss.backward()
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=2e-4 if k == 'loss' else 5e-4,
                                   atol=1e-5, err_msg=k)
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(),
                                   atol=1e-6, rtol=2e-3, err_msg=k)
    cond = _conditioned(want_grads)

    # three updates on both sides from the same weights
    jstate = jax_state.create_train_state(
        weights, jax_state.make_optimizer(params, steps_per_epoch=2))
    for n in range(updates):
        jstate, jm_aux = jstep(jstate, jb, key)
        metrics = step(tb, None)
        np.testing.assert_allclose(float(metrics['loss']),
                                   float(jm_aux['loss']), rtol=2e-4)
        np.testing.assert_allclose(float(metrics['miou']),
                                   float(jm_aux['miou']), atol=1e-6)
        want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
        for k, p in model.state_dict().items():
            g, w, m = p.numpy(), want[k].numpy(), cond[k]
            np.testing.assert_allclose(
                g[m], w[m], atol=2e-6, rtol=5e-3,
                err_msg=f'{k} after update {n + 1}')
            if (~m).any():
                assert np.abs(g[~m] - w[~m]).max() <= 2 * lr * (n + 1) + 1e-6
    assert state.step == updates


def test_train_step_on_device_pseudo_runs_and_is_seeded():
    """The default path: pseudo videos drawn on the device and dropout on,
    both from the step's generator; one seed gives one result."""
    params = _params(on_device_aug=True, dropout=0.5, disc_dropout=0.5)
    _, weights = _jax_setup(params)
    b = _batch()
    results = []
    for _ in range(2):
        model = _port_model(params, weights)
        state = TrainState(model, params, steps_per_epoch=4)
        step = make_gmd_train_step(model, state, params)
        gen = torch.Generator().manual_seed(11)
        metrics = [step({k: _t(b[k]) for k in TRAIN_KEYS}, gen)
                   for _ in range(2)]
        results.append((metrics, model.state_dict()))
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d', 'miou'):
        assert torch.isfinite(results[0][0][1][k])
        assert torch.equal(results[0][0][1][k], results[1][0][1][k])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k
    valid = make_gmd_valid_step(model, params)
    out = valid({k: _t(b[k]) for k in TRAIN_KEYS},
                torch.Generator().manual_seed(0))
    assert out['pred_time'].shape == (B, 2) and torch.isfinite(out['loss'])
    assert not model.training


# --- optimizer pieces --------------------------------------------------------

@pytest.mark.parametrize('schd', ['ms', 'l'])
def test_lr_schedule_matches_jax(schd):
    params = dict(lr=1e-3, lr_schd=schd, lr_step=[2, 5], lr_decay_rate=0.1)
    want = jax_state.lr_schedule_fn(params, steps_per_epoch=3)
    got = lr_schedule_fn(params, steps_per_epoch=3)
    for step in range(20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize('max_norm', [0.1, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
    for p, a in zip(params, arrays):
        p.grad = _t(a)
    clip_by_global_norm(params, max_norm)
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(a) for a in arrays], tx.init(arrays))
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize('grouped', [False, True])
def test_sgd_matches_torch_sgd_and_jax(grouped):
    """The port's SGD (tensor arithmetic, so that a CUDA graph captures
    it) over 3 updates of a Linear and a LayerNorm, with momentum 0.8 and
    L2 decay (on the Linear weight only with ``group_weight``), against
    ``torch.optim.SGD`` on the same groups and against the JAX package's
    optax chain; parameters within test_grad_parity.py's tolerances after
    every update (atol 2e-6, rtol 5e-3)."""
    params = dict(optim='sgd', lr=0.5, lr_schd='ms', lr_step=[15],
                  momentum=0.8, weight_decay=1e-2, group_weight=grouped)
    rng = np.random.RandomState(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.LayerNorm(4))
    ref = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.LayerNorm(4))
    ref.load_state_dict(model.state_dict())
    state = TrainState(model, params, steps_per_epoch=2)
    assert type(state.optimizer).__name__ == 'SGD'
    assert not isinstance(state.optimizer, torch.optim.SGD)
    torch_sgd = torch.optim.SGD(decay_groups(ref, 1e-2, grouped), lr=0.5,
                                momentum=0.8)
    tree = {'dense': {'kernel': model[0].weight.detach().numpy().T.copy(),
                      'bias': model[0].bias.detach().numpy().copy()},
            'norm': {'scale': model[1].weight.detach().numpy().copy(),
                     'bias': model[1].bias.detach().numpy().copy()}}
    tx = jax_state.make_optimizer(params, steps_per_epoch=2)
    opt_state = tx.init(tree)
    for _ in range(3):
        grads = {k: {n: rng.randn(*a.shape).astype(np.float32)
                     for n, a in v.items()} for k, v in tree.items()}
        for net in (model, ref):
            net[0].weight.grad = _t(grads['dense']['kernel'].T.copy())
            net[0].bias.grad = _t(grads['dense']['bias'])
            net[1].weight.grad = _t(grads['norm']['scale'])
            net[1].bias.grad = _t(grads['norm']['bias'])
        state.apply_gradients()
        torch_sgd.step()
        updates, opt_state = tx.update(grads, opt_state, tree)
        tree = jax.tree.map(np.asarray, optax.apply_updates(tree, updates))
        want = {'0.weight': tree['dense']['kernel'].T,
                '0.bias': tree['dense']['bias'],
                '1.weight': tree['norm']['scale'],
                '1.bias': tree['norm']['bias']}
        for k, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[k], atol=2e-6,
                                       rtol=5e-3, err_msg=k)
            np.testing.assert_allclose(p.numpy(),
                                       ref.state_dict()[k].numpy(),
                                       atol=2e-6, rtol=5e-3, err_msg=k)


def test_decay_groups_follow_group_weight_mask():
    params = _params()
    _, weights = _jax_setup(params)
    mask = jax_state.group_weight_mask(weights)
    as_arrays = jax.tree.map(lambda m, w: np.full(np.shape(w), float(m)),
                             mask, weights)
    want = {k: bool(v.min()) for k, v in state_dict_from_jax(as_arrays).items()}
    assert {k: bool(v.max()) for k, v in state_dict_from_jax(as_arrays).items()} \
        == want  # one decision per tensor
    model = _port_model(params, weights)
    names = {id(p): k for k, p in model.named_parameters()}
    decay, no_decay = decay_groups(model, 1e-4, grouped=True)
    assert {names[id(p)] for p in decay['params']} == \
        {k for k, v in want.items() if v}
    assert {names[id(p)] for p in no_decay['params']} == \
        {k for k, v in want.items() if not v}
    assert no_decay['weight_decay'] == 0.0
    (everything,) = decay_groups(model, 1e-4, grouped=False)
    assert len(everything['params']) == len(want)


def test_dropout_uses_its_generator():
    x = torch.ones(64, 32)
    masks = [dropout(x, 0.5, True, torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(masks[0], masks[1])
    assert set(masks[0].unique().tolist()) == {0.0, 2.0}
    assert 0.35 < (masks[0] == 0).float().mean().item() < 0.65
    assert dropout(x, 0.5, False) is x and dropout(x, 0.0, True) is x
