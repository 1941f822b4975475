"""The port's model axis (``parallel/tensor_parallel.py``,
``train/tp.py``) on the CPU over gloo, against JAX's tensor-parallel GMD.

Ranks started once for the module by ``tests/dp_group.py``: a group of
two (a (1, 2) mesh) and one of four (a (2, 2) mesh), at JAX's test sizes
(B=8, T=16, N=7, D=32, H=16; ``tests/test_tp_train.py:24-35``):

- (a) 2 updates at 1x2 and 2x2, dropout 0, JAX's pseudo stream, against
  JAX's ``make_gmd_tp_train_step`` on ``create_tp_mesh(1, 2)`` and
  ``(2, 2)`` and against JAX's plain step: every metric rel 2e-4 abs
  2e-5, parameters rtol 5e-4 atol 5e-6 (JAX's own bounds,
  ``test_tp_train.py:96-104``); the ranks bit for bit;
- (b) ``grad_accum_steps`` 2 at 1x2 against JAX's plain step at 2;
- (c) dropout 0.5 with the pseudo videos drawn on the device: finite, and
  its masks are those of the one-process step (the same generator), so
  it equals that step within (a)'s bounds;
- (d) ``bilstm_hidden_sharded`` at two ranks: forward and gradients
  against ``ops/rnn.BiLSTM``;
- (e) the parity rule of the parallel checks (``utils/parity.py``,
  fault F7): 8 updates at 1x2 with dropout on against one process; and
  the rule itself, and its bf16 gradient rule, on made-up runs;
- (f) JAX's refusals, with JAX's messages; ``python -m
  shufflingvideosfortsg_torch.train --tensor_parallel 2`` under torchrun;
- (g) ``precision: bf16``: one update at 1x2 against JAX's TP step at
  bf16 (its loss compiled with XLA's excess precision off, the bf16
  einsums widened, ``tests/jax_cpu.py``) at the bf16 bounds of a train
  step (``tests/test_torch_bf16_train.py``): the loss and its terms 2^-6
  relative (a term below one bf16 rounding of the loss within that
  rounding), each gradient 2^-5 relative L2 (or, where JAX's bf16
  gradient is itself that far from its f32 one, ``_hold_grads``'s
  rule), each parameter's move by the Adam update within 2 lr of JAX's
  and, where the gradients agree, the same way as JAX's where the
  gradient is large (``test_torch_bf16_train.hold_bf16_moves``); the
  ranks bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import dp_group
from torch_one_thread import one_torch_thread  # noqa: F401

B, T, N, DV, H = 8, 16, 7, 32, 16
LR = 1e-3
LOSS_REL, LOSS_ABS = 2e-4, 2e-5
P_RTOL, P_ATOL = 5e-4, 5e-6
F7_UPDATES = 8
BF16_TERMS = ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d')


def _overrides(**over):
    base = dict(video_len=T, video_feature_dim=DV, sent_len=N,
                sent_rnn_hiddendim=16, video_rnn_hiddendim=H,
                mlp_hidden_dim=16, span_hidden_dim=16, m_pred_hidden=16,
                dropout=0.0, disc_dropout=0.0, lr=LR, on_device_aug=False)
    base.update(over)
    return base


def port_params(**over):
    from shufflingvideosfortsg_torch.config import load_config
    return load_config(None, overrides=_overrides(**over))


def jax_params(**over):
    from shufflingvideosfortsg_tpu.config import load_config
    return load_config(None, overrides=_overrides(**over))


def pair_batch(seed=0):
    """A host-made pair batch at (B, T, N, D): the pseudo stream is JAX's
    ``gt_translate_batch`` at a fixed key, so both sides read it."""
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops import augment_device as jax_aug
    rng = np.random.RandomState(seed)
    s = rng.randint(0, T - 4, B).astype(np.int32)
    e = (s + 2).astype(np.int32)
    nfeats = np.full(B, T, np.int32)
    framestps = np.stack([s, e], -1)
    video = rng.randn(B, T, DV).astype(np.float32)
    raw = jax_aug.device_masks(jnp.asarray(s), jnp.asarray(e),
                               jnp.asarray(nfeats), T)
    pfeat, pfs, pm = jax_aug.gt_translate_batch(
        jax.random.PRNGKey(seed), jnp.asarray(video), jnp.asarray(framestps),
        jnp.asarray(nfeats))
    batch = {'video_feat': video,
             'sent_feat': rng.randn(B, N, 300).astype(np.float32),
             'sent_mask': np.ones((B, N), np.int32), 'framestps': framestps,
             'timestps': framestps.astype(np.float32), 'nfeats': nfeats,
             'duration': np.full(B, float(T), np.float32),
             'pseudo_video_feat': pfeat, 'pseudo_framestps': pfs,
             **{k: raw[k] for k in ('video_mask', 'temporal_labels',
                                    'fore_masks', 'back_masks')},
             **{'pseudo_' + k: v for k, v in pm.items()}}
    return {k: np.asarray(v) for k, v in batch.items()}


def jax_weights(params):
    import jax
    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.models import build_model
    model = build_model(params, 'gmd')
    return model, jax.tree.map(np.asarray, jax_cli.init_model_params(
        model, params, jax.random.PRNGKey(0), 'gmd'))


def jax_run(model, params, weights, batch, step, n=2, to_sequential=None):
    """JAX's updates: (metrics of the last, the port's state dict of the
    parameters; a pipelined state's ``to_sequential`` first)."""
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.train.state import (create_train_state,
                                                       make_optimizer)
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    state = create_train_state(weights, make_optimizer(params,
                                                       steps_per_epoch=10))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(n):
        state, metrics = step(state, jb, jax.random.PRNGKey(100 + i))
    tree = jax.tree.map(np.asarray, jax.device_get(state.params))
    if to_sequential is not None:
        tree = to_sequential(tree)
    nblocks = sum(k.startswith('block') for k in tree['video_encoder'])
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_jax(tree, nblocks=nblocks))


def _port_tree(tree):
    """A JAX GMD tree (sequential layout) as the port's state dict."""
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    return state_dict_from_jax(tree, nblocks=sum(
        k.startswith('block') for k in tree['video_encoder']))


def jax_bf16_ref(step, params, weights, batch, f32_grads,
                 to_sequential=None):
    """JAX's bf16 update of ``step`` (a TP or pipelined step at
    ``precision: bf16``) from ``weights``: its loss terms and gradients,
    with ``step.loss_fn`` compiled with XLA's excess precision off and
    the bf16 einsums of the BiLSTM and the sharded recurrence widened
    (``tests/jax_cpu.py``: XLA on the CPU cannot run a BF16 x BF16 = F32
    product), and the parameters after one Adam update of those
    gradients; ``f32_grads`` (JAX's f32 gradients of the same weights,
    for ``_hold_grads``) passes through. Gradients and parameters (before
    and after the update) as the port's state dicts (``to_sequential``
    first, for a pipelined layout)."""
    import jax
    import jax.numpy as jnp
    import shufflingvideosfortsg_tpu.ops.rnn as jax_rnn
    import shufflingvideosfortsg_tpu.parallel.tensor_parallel as jax_tp
    from jax_cpu import _no_excess, _WidenedEinsum
    from shufflingvideosfortsg_tpu.train.state import (create_train_state,
                                                       make_optimizer)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pseudo = {k[len('pseudo_'):]: v for k, v in jb.items()
              if k.startswith('pseudo_')}
    with pytest.MonkeyPatch.context() as m:
        for module in (jax_rnn, jax_tp):
            m.setattr(module, 'jnp', _WidenedEinsum())
        (_, aux), grads = _no_excess(
            jax.value_and_grad(step.loss_fn, has_aux=True), weights, jb,
            pseudo, jax.random.PRNGKey(0))
    state = create_train_state(weights, make_optimizer(params,
                                                       steps_per_epoch=10))
    after = jax.tree.map(np.asarray, state.apply_gradients(grads).params)
    grads = jax.tree.map(np.asarray, grads)
    before = jax.tree.map(np.asarray, weights)
    if to_sequential is not None:
        after, grads, before = map(to_sequential, (after, grads, before))
    return {'terms': {k: float(aux[k]) for k in BF16_TERMS},
            'lr': params['lr'], 'wd': params['weight_decay'],
            'grads': _port_tree(grads), 'f32_grads': f32_grads,
            'before': _port_tree(before), 'weights': _port_tree(after)}


def jax_f32_grads(model, params, weights, batch):
    """JAX's plain f32 step's gradients at ``weights``, as a state dict."""
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.train.steps import make_gmd_train_step
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pseudo = {k[len('pseudo_'):]: v for k, v in jb.items()
              if k.startswith('pseudo_')}
    loss_fn = make_gmd_train_step(model, params).loss_fn
    _, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        weights, jb, pseudo, jax.random.PRNGKey(0))
    return _port_tree(jax.tree.map(np.asarray, grads))


def hold_bf16_update(got, ref, one_process=None, own_step=()):
    """A port rank's bf16 update (its metrics, gradients and weights)
    against :func:`jax_bf16_ref`'s: the loss terms, each gradient by
    ``_hold_grads``, the parameters by ``hold_bf16_moves``. A gradient
    named in ``own_step`` may instead lie within 2^-5 relative L2 of
    ``one_process`` (the port's one-process bf16 gradients at the same
    weights and batch): where the two packages' parallel steps round the
    recurrence at other points (the pipe axis: JAX's stages run
    ``lax.scan`` with h and c in bf16, the port's K3/K4 with c in f32), the
    check is that the parallel step adds nothing to the port's own bf16
    step, which ``tests/test_torch_bf16_train.py`` holds against JAX's
    kernels. Returns the names held that way."""
    from test_torch_bf16_train import (GRAD_REL_L2, LOSS_RTOL, _hold_grads,
                                       _rel_l2, hold_bf16_moves)
    metrics = got['metrics'][-1]
    # a term below one bf16 rounding of the loss (loss_inter, a KL of two
    # nearly equal distributions: 2.3e-05 of a loss of 7.6) is held to
    # that rounding, 2^-8 of the loss
    ulp = 2.0 ** -8 * abs(ref['terms']['loss'])
    for k in BF16_TERMS:
        want = ref['terms'][k]
        assert abs(metrics[k] - want) <= max(LOSS_RTOL * abs(want),
                                             ulp if k != 'loss' else 0.0), (
            k, metrics[k], want)
    assert set(got['grads']) == set(ref['grads'])
    held_by_own_step, agree = [], set()
    for k, g in got['grads'].items():
        try:
            seen = _hold_grads({k: g}, ref['grads'], ref['f32_grads'])
        except AssertionError:
            if k not in own_step:
                raise
            assert _rel_l2(g.numpy(), one_process[k].numpy()) <= \
                GRAD_REL_L2, k
            held_by_own_step.append(k)
            continue
        if seen[k][0] <= GRAD_REL_L2:
            agree.add(k)
    hold_bf16_moves('bf16 update', got['weights'], ref['weights'],
                    ref['before'], ref['grads'], float(ref['lr']),
                    float(ref['wd']), agree=agree)
    return held_by_own_step


def save_inputs(path, params, weights, batch):
    torch.save({'params': params, 'weights': weights,
                'batch': {k: torch.from_numpy(np.array(v))
                          for k, v in batch.items()}}, path)
    return path


def port_plain(inputs, n, generator_seed=None):
    """The one-process port step on the inputs' whole batch."""
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import make_gmd_train_step
    data = torch.load(inputs, weights_only=False)
    model = build_model(data['params'], 'gmd', device='cpu')
    model.load_state_dict(data['weights'])
    state = TrainState(model, data['params'], steps_per_epoch=10)
    step = make_gmd_train_step(model, state, data['params'])
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    metrics = [{k: float(v) for k, v in step(data['batch'], gen).items()}
               for _ in range(n)]
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}


TINY = ['--cfg', 'charades_cd_i3d.yml', '--video_feature_dim', '32',
        '--video_len', '24', '--sent_len', '8', '--sent_rnn_hiddendim', '8',
        '--video_rnn_hiddendim', '8', '--mlp_hidden_dim', '8',
        '--m_pred_hidden', '16', '--batch_size', '4', '4', '4',
        '--device', 'cpu']


def tiny_corpus(root, flags):
    """The drivers' argv over 8 videos x 4 sentences at tiny widths (4 rows
    a batch: 8 train batches), the same split for train, valid and test,
    with ``flags``."""
    import shutil

    import chip_smoke
    from shufflingvideosfortsg_torch import cli
    params = cli.parse_params(TINY, default_model='GMD')
    anno, feats, vocab, _ = chip_smoke.write_corpus(
        root, params, n_videos=8, sentences_per_video=4,
        name='charades_train.json')
    for split in ('val', 'test_ood'):
        shutil.copy(anno, os.path.join(root, f'charades_{split}.json'))
    return TINY + [
        '--runs', os.path.join(root, 'runs'), '--train_data', anno,
        '--val_data', os.path.join(root, 'charades_val.json'),
        '--test_data', os.path.join(root, 'charades_test_ood.json'),
        '--wordtoix_path', vocab['wordtoix'],
        '--ixtoword_path', vocab['ixtoword'],
        '--word_fts_path', vocab['word_glove_fts_init'],
        '--train_featpath', feats, '--valid_featpath', feats,
        '--test_featpath', feats, *flags]


def bilstm_inputs(root):
    from shufflingvideosfortsg_torch.ops.rnn import BiLSTM
    torch.manual_seed(7)
    shape = (24, 16, 2)  # D, H, layers
    lstm = BiLSTM(*shape)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (8, 12, 24)).astype(np.float32))
    path = os.path.join(root, 'bilstm.pt')
    torch.save({'shape': shape, 'weights': lstm.state_dict(), 'x': x}, path)
    return path


@pytest.fixture(scope='module')
def tp(tmp_path_factory):
    """The ranks' results by task, started here and waited for by the
    first test that asks; JAX's references computed meanwhile; the
    inputs."""
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    root = str(tmp_path_factory.mktemp('torch_tp'))
    params = jax_params()
    model, weights = jax_weights(params)
    batch = pair_batch()
    sd = state_dict_from_jax(weights)
    inputs = {
        'a': save_inputs(os.path.join(root, 'a.pt'), port_params(), sd,
                         batch),
        'b': save_inputs(os.path.join(root, 'b.pt'),
                         port_params(grad_accum_steps=2), sd, batch),
        'c': save_inputs(os.path.join(root, 'c.pt'),
                         port_params(dropout=0.5, disc_dropout=0.5,
                                     on_device_aug=True), sd, batch),
        'bf16': save_inputs(os.path.join(root, 'bf16.pt'),
                            port_params(precision='bf16'), sd, batch)}
    tasks2 = [
        ['mp_ranks:tp_steps', {'inputs': inputs['a'], 'dp': 1, 'mp': 2}],
        ['mp_ranks:tp_steps', {'inputs': inputs['b'], 'dp': 1, 'mp': 2}],
        ['mp_ranks:tp_steps', {'inputs': inputs['c'], 'dp': 1, 'mp': 2,
                               'generator_seed': 5, 'train_dropout': True}],
        ['mp_ranks:tp_steps', {'inputs': inputs['c'], 'dp': 1, 'mp': 2,
                               'n': F7_UPDATES, 'generator_seed': 9,
                               'train_dropout': True}],
        ['mp_ranks:tp_bilstm', {'inputs': bilstm_inputs(root), 'mp': 2}],
        ['driver', {'argv': tiny_corpus(root, ['--tensor_parallel', '2'])
                    + ['--alias', 'tp_entry', '--epoch', '1'],
                    'entry': 'train', 'maker': 'make_gmd_tp_train_step',
                    'module': 'shufflingvideosfortsg_torch.train'}],
        ['mp_ranks:tp_steps', {'inputs': inputs['bf16'], 'dp': 1, 'mp': 2,
                               'n': 1, 'grads': True}]]
    two = dp_group.launch(os.path.join(root, 'two'), tasks2)
    four = dp_group.launch(os.path.join(root, 'four'), [
        ['mp_ranks:tp_steps', {'inputs': inputs['a'], 'dp': 2, 'mp': 2}]],
        world=4)

    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.parallel.tensor_parallel import \
        create_tp_mesh
    from shufflingvideosfortsg_tpu.train.steps import make_gmd_train_step
    from shufflingvideosfortsg_tpu.train.tp import make_gmd_tp_train_step
    refs = {'plain': jax_run(model, params, weights, batch,
                             make_gmd_train_step(model, params))}
    for dp in (1, 2):
        refs[f'tp{dp}x2'] = jax_run(
            model, params, weights, batch,
            make_gmd_tp_train_step(model, params, create_tp_mesh(dp, 2),
                                   train_dropout=False))
    accum = jax_params(grad_accum_steps=2)
    refs['accum'] = jax_run(model, accum, weights, batch,
                            make_gmd_train_step(model, accum))
    bf16 = jax_params(precision='bf16')
    bf16_model = build_model(bf16, 'gmd')
    refs['bf16'] = jax_bf16_ref(
        make_gmd_tp_train_step(bf16_model, bf16, create_tp_mesh(1, 2),
                               train_dropout=False),
        bf16, weights, batch, jax_f32_grads(model, params, weights, batch))
    cache = {}

    def results():
        if not cache:
            names = ['1x2', 'accum', 'dropout', 'f7', 'bilstm', 'driver',
                     'bf16']
            per_rank = two.results()
            cache.update({n: [r[i] for r in per_rank]
                          for i, n in enumerate(names)})
            cache['2x2'] = [r[0] for r in four.results()]
        return cache

    return results, refs, inputs


def _hold_metrics(got, want):
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL,
                                       abs=LOSS_ABS), k


def _hold_params(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=k)


@pytest.mark.parametrize('mesh', ['1x2', '2x2'])
@pytest.mark.parametrize('ref', ['tp', 'plain'])
def test_tp_step_equals_jax(tp, mesh, ref):
    """(a) the port's TP updates against JAX's TP step on the same mesh
    and against JAX's plain step."""
    results, refs, _ = tp
    got = results()[mesh][0]
    metrics, params = refs['plain' if ref == 'plain' else f'tp{mesh}']
    _hold_metrics(got['metrics'][-1], metrics)
    _hold_params(got['weights'], params)


@pytest.mark.parametrize('mesh', ['1x2', '2x2'])
def test_tp_ranks_agree_bit_for_bit(tp, mesh):
    results, _, _ = tp
    runs = results()[mesh]
    for r in runs[1:]:
        assert r['metrics'] == runs[0]['metrics']
        assert all(torch.equal(v, r['weights'][k])
                   for k, v in runs[0]['weights'].items())


def test_tp_bf16_step_equals_jax(tp):
    """(g) one TP update at 1x2 with ``precision: bf16`` against JAX's TP
    step at bf16; the two ranks bit for bit."""
    results, refs, _ = tp
    runs = results()['bf16']
    hold_bf16_update(runs[0], refs['bf16'])
    for r in runs[1:]:
        assert r['metrics'] == runs[0]['metrics']
        for part in ('weights', 'grads'):
            assert all(torch.equal(v, r[part][k])
                       for k, v in runs[0][part].items()), part


def test_tp_grad_accum_equals_jax(tp):
    """(b) grad_accum_steps 2 at 1x2 against JAX's plain step at 2."""
    results, refs, _ = tp
    got = results()['accum'][0]
    metrics, params = refs['accum']
    _hold_metrics(got['metrics'][-1], metrics)
    _hold_params(got['weights'], params)


def test_tp_dropout_is_finite_and_draws_the_unsharded_masks(tp):
    """(c) dropout 0.5, pseudo videos drawn on the device."""
    results, _, inputs = tp
    got = results()['dropout'][0]
    assert all(np.isfinite(m['loss']) for m in got['metrics'])
    assert all(torch.isfinite(v).all() for v in got['weights'].values())
    metrics, weights = port_plain(inputs['c'], 2, generator_seed=5)
    _hold_metrics(got['metrics'][-1], metrics[-1])
    _hold_params(got['weights'], weights)


def test_bilstm_hidden_sharded_equals_bilstm(tp):
    """(d) the sharded recurrence's output and gradients against the
    port's BiLSTM: the input's, and each weight's summed over the ranks."""
    from shufflingvideosfortsg_torch.ops.rnn import BiLSTM
    results, _, _ = tp
    data = torch.load(os.path.join(os.path.dirname(tp[2]['a']), 'bilstm.pt'),
                      weights_only=False)
    lstm = BiLSTM(*data['shape'])
    lstm.load_state_dict(data['weights'])
    x = data['x'].clone().requires_grad_()
    out = lstm(x)[0]
    out.sin().sum().backward()
    for got in results()['bilstm']:
        np.testing.assert_allclose(got['out'].numpy(), out.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got['dx'].numpy(), x.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
        for k, p in lstm.named_parameters():
            np.testing.assert_allclose(got['grads'][k].numpy(),
                                       p.grad.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_tp_trains_through_the_entry_point_under_torchrun(tp):
    """``python -m shufflingvideosfortsg_torch.train --tensor_parallel 2``
    at two ranks: both hold the same weights, rank 0 alone wrote the
    checkpoint, equal to them, and the valid pass ran."""
    import json

    from shufflingvideosfortsg_torch.utils.saver import load_checkpoint
    results, _, _ = tp
    runs = results()['driver']
    ckp = os.path.join(runs[0]['run'], 'model', 'tp_entry_00000.ckp')
    weights, resume, _ = load_checkpoint(ckp)
    for r in runs:
        got, = r['weights']
        assert all(torch.equal(v, got[k]) for k, v in weights.items())
    assert resume['train_state']['step'] == 8
    with open(os.path.join(runs[0]['run'], 'metrics.jsonl')) as f:
        assert [json.loads(x)['phase'] for x in f] == ['train', 'valid']


def test_f7_rule_holds_tp_against_one_process_over_8_updates(tp):
    """(e) 8 updates at 1x2, dropout on, against the one-process step from
    the same generator, held by the parallel checks' parity rule."""
    from shufflingvideosfortsg_torch.utils.parity import hold_weights
    results, _, inputs = tp
    got = results()['f7'][0]
    metrics, weights = port_plain(inputs['c'], F7_UPDATES, generator_seed=9)
    assert got['metrics'][0]['loss'] == pytest.approx(metrics[0]['loss'],
                                                      rel=1e-5)
    res = hold_weights('[tp] 1x2 against one process', got['weights'],
                       weights, LR, F7_UPDATES)
    assert res['share_near'] < 5e-3


def _synthetic(shift=0.0, leaf_scale=1.0, share=0.0):
    g = torch.Generator().manual_seed(0)
    want = {'a': torch.randn(10000, generator=g),
            'b': torch.randn(10, generator=g) * 1e-3}
    got = {k: v.clone() for k, v in want.items()}
    got['b'] += shift * leaf_scale
    n = int(share * 10010)
    got['a'][:n] += 0.5 * LR
    return got, want


@pytest.mark.parametrize('case', ['exact', 'adam_step', 'past_steps',
                                  'too_many_apart'])
def test_parity_rule(case):
    """(e) the rule on made-up runs of 8 updates: a leaf past the relative
    L2 passes within 2.5 lr an update of each element, fails past it, and
    fails where too many of the model's elements lie 0.2 lr apart."""
    from shufflingvideosfortsg_torch.utils.parity import hold_weights
    shift = {'exact': 0.0, 'adam_step': 2.0 * LR * F7_UPDATES,
             'past_steps': 2.6 * LR * F7_UPDATES,
             'too_many_apart': 2.0 * LR * F7_UPDATES}[case]
    got, want = _synthetic(shift, share=0.01 if case == 'too_many_apart'
                           else 0.0)
    if case in ('past_steps', 'too_many_apart'):
        with pytest.raises(AssertionError):
            hold_weights(case, got, want, LR, F7_UPDATES)
        return
    res = hold_weights(case, got, want, LR, F7_UPDATES)
    assert res['adam_leaves'] == ([] if case == 'exact' else ['b'])


@pytest.mark.parametrize('case', ['within', 'noise', 'past_noise',
                                  'off_signal', 'cross_budget'])
def test_bf16_gradient_rule(case):
    """(e) the bf16 gradient rule (``hold_bf16_grads``) on made-up
    gradients: a leaf within 2^-5 relative L2 of one process's bf16
    gradient passes; a leaf whose f32 gradient is 0 but for rounding
    passes while it lies no farther from it than twice one process's bf16
    gradient, and fails past that; a leaf with a real gradient 2^-4 off
    fails, and one 2^-4.5 off passes at the doubled budget of other
    rounding points (``BF16_CROSS_REL_L2``) but not at 2^-5."""
    from shufflingvideosfortsg_torch.utils.parity import (BF16_CROSS_REL_L2,
                                                          hold_bf16_grads)
    g = torch.Generator().manual_seed(0)
    f32 = {'a': torch.randn(1000, generator=g),
           'b': torch.randn(10, generator=g) * 1e-9}
    want = {'a': f32['a'] * (1 + 2.0 ** -9),
            'b': torch.randn(10, generator=g) * 1e-3}
    got = {k: v.clone() for k, v in want.items()}
    got['a'] += {'off_signal': 2.0 ** -4, 'cross_budget': 2.0 ** -4.5}.get(
        case, 2.0 ** -7) * \
        f32['a'].norm() * torch.randn(1000, generator=g) / 1000 ** 0.5
    got['b'] = {'within': want['b'] * (1 + 2.0 ** -7),
                'past_noise': -2.5 * want['b']}.get(
        case, torch.randn(10, generator=g) * 1e-3)
    if case == 'cross_budget':
        hold_bf16_grads(case, got, want, f32, BF16_CROSS_REL_L2)
    if case in ('past_noise', 'off_signal', 'cross_budget'):
        leaf = 'b' if case == 'past_noise' else 'a'
        with pytest.raises(AssertionError, match=f'gradient of {leaf} '):
            hold_bf16_grads(case, got, want, f32)
        return
    res = hold_bf16_grads(case, got, want, f32)
    assert res['f32_clause_leaves'] == ([] if case == 'within' else ['b'])


# --- (f) JAX's refusals ----------------------------------------------------

def _axis(n, name='model'):
    from shufflingvideosfortsg_torch.parallel.mesh import MeshAxis
    return MeshAxis(name, 0, n, None, list(range(n)), torch.device('cpu'))


def test_hidden_indivisible_raises():
    from shufflingvideosfortsg_torch.ops.rnn import BiLSTM
    from shufflingvideosfortsg_torch.parallel.tensor_parallel import \
        bilstm_hidden_sharded
    with pytest.raises(ValueError, match='divide'):
        bilstm_hidden_sharded(BiLSTM(24, 16), torch.zeros(2, 3, 24), _axis(3))


def test_tp_forward_hidden_indivisible_raises():
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.tp import make_tp_forward
    model = build_model(port_params(), 'gmd', device='cpu')
    with pytest.raises(ValueError, match='must divide the 3-way'):
        make_tp_forward(model, _axis(3))


def test_too_few_devices_raises():
    from shufflingvideosfortsg_torch.parallel.tensor_parallel import \
        create_tp_mesh
    with pytest.raises(ValueError, match='devices'):
        create_tp_mesh(4, 4, 'cpu')


def test_perm_cols_matches_jax():
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.parallel.tensor_parallel import \
        _perm_cols as jax_perm
    from shufflingvideosfortsg_torch.parallel.tensor_parallel import _perm_cols
    w = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_array_equal(_perm_cols(torch.from_numpy(w), 16, 4),
                                  np.asarray(jax_perm(jnp.asarray(w), 16, 4)))


@pytest.mark.parametrize('over,match', [
    (dict(tensor_parallel=0), None), (dict(tensor_parallel=1), None),
    (dict(tensor_parallel=2, fsdp=True), 'fsdp'),
    (dict(tensor_parallel=2, multi_seed=3), 'multi_seed'),
    (dict(tensor_parallel=2, pipeline_stages=2), 'tensor_parallel'),
    (dict(tensor_parallel=2), 'device count')])
def test_tp_validate_as_jax(over, match):
    """The port's validation raises where JAX's does, with its message
    (one process here: a 2-way axis needs a world of 2)."""
    from shufflingvideosfortsg_torch import cli
    params = port_params(**over)
    check = (cli._pipeline_validate if over.get('pipeline_stages')
             else cli._tp_validate)
    if match is None:
        assert check(params) == 0
        return
    with pytest.raises(ValueError, match=match):
        check(params)


def test_tp_validate_hidden(monkeypatch):
    from shufflingvideosfortsg_torch import cli
    monkeypatch.setattr(cli, 'world_size', lambda: 2)
    assert cli._tp_validate(port_params(tensor_parallel=2)) == 2
    with pytest.raises(ValueError, match='video_rnn_hiddendim'):
        cli._tp_validate(port_params(tensor_parallel=2,
                                     video_rnn_hiddendim=15))
