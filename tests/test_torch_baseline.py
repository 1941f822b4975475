"""The port's QAVE baseline against the JAX package's: the model's
probabilities at shared weights carried by ``state_dict_from_jax``, the
reference checkpoint keys, one train step and three updates against
``make_baseline_train_step``, and the evaluation driver against the JAX
``main_test_baseline`` span for span; then the port's training driver
writes a reference ``.ckp`` that both packages read. Inputs are made with
numpy from a seed."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_tpu import cli as jax_cli
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model
from shufflingvideosfortsg_tpu.models.baseline import Baseline as JaxBaseline
from shufflingvideosfortsg_tpu.ops import losses as jax_losses
from shufflingvideosfortsg_tpu.train import state as jax_state
from shufflingvideosfortsg_tpu.train.steps import \
    make_baseline_train_step as jax_train_step
from shufflingvideosfortsg_tpu.utils.saver import \
    load_checkpoint as jax_load_checkpoint
from shufflingvideosfortsg_tpu.utils.torch_interop import (
    convert_to_reference_state_dict, save_reference_ckp)
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models.baseline import Baseline
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (
    STEP_KEYS, make_baseline_eval_step, make_baseline_train_step)
from shufflingvideosfortsg_torch.utils.interop import (load_reference_ckp,
                                                       state_dict_from_jax)
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5  # f32
SCORE_TOL = 1e-5  # f32 span scores
W, HS, D, HV, MLP = 20, 8, 12, 16, 8
B, T, N = 4, 18, 7
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--batch_size', '8', '8', '8',
        '--batch_log_interval', '1']


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_model(mask):
    return JaxBaseline(sent_hidden=HS, sent_layers=2, video_hidden=HV,
                       video_layers=2, nblocks=2, cross_name='vs',
                       predictor_name='mlp', mlp_hidden_dim=MLP,
                       video_if_mask=mask, dropout=0.0)


def _port_model(mask):
    return Baseline(video_feature_dim=D, word_dim=W, sent_hidden=HS,
                    sent_layers=2, video_hidden=HV, video_layers=2, nblocks=2,
                    cross_name='vs', predictor_name='mlp', mlp_hidden_dim=MLP,
                    video_if_mask=mask, dropout=0.0)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    video = rng.randn(B, T, D).astype(np.float32)
    query = rng.randn(B, N, W).astype(np.float32)
    vmask = (np.arange(T)[None] <= rng.randint(4, T, (B, 1))).astype(np.int32)
    smask = (np.arange(N)[None] <= rng.randint(2, N, (B, 1))).astype(np.int32)
    return video, query, vmask, smask


@pytest.fixture(scope='module')
def jax_params():
    variables = _jax_model(False).init(
        jax.random.PRNGKey(7), jnp.zeros((2, T, D)), jnp.zeros((2, N, W)),
        jnp.ones((2, T), jnp.int32), jnp.ones((2, N), jnp.int32))
    return jax.tree.map(np.asarray, variables['params'])


@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('training', [False, True])
def test_baseline_matches_jax(jax_params, mask, training):
    """Probabilities at shared weights; with dropout 0 the training
    forward is the same function."""
    arrays = _inputs()
    want = _jax_model(mask).apply({'params': jax_params},
                                  *map(jnp.asarray, arrays))
    port = _port_model(mask)
    port.load_state_dict(state_dict_from_jax(jax_params, baseline=True),
                         strict=True)
    port.train(training)
    with torch.no_grad():
        got = (port(*map(_t, arrays)) if training
               else port.eval_forward(*map(_t, arrays)))
    assert set(got) == set(want) == {'start_prob', 'end_prob'}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)


def test_baseline_reference_state_dict_loads_strictly(jax_params, tmp_path):
    """The JAX package's export (the reference .ckp keys, no csmm/tod) and
    the port's own mapping name and fill the same tensors."""
    ref = convert_to_reference_state_dict(jax_params, kind='baseline')
    ours = state_dict_from_jax(jax_params, baseline=True)
    port = _port_model(False)
    assert set(ref) == set(ours) == set(port.state_dict())
    assert not any(k.startswith(('csmm.', 'tod.')) for k in ours)
    path = str(tmp_path / 'baseline.ckp')
    save_reference_ckp(jax_params, path, kind='baseline')
    port.load_state_dict(load_reference_ckp(path), strict=True)
    for k, v in ours.items():
        assert torch.equal(port.state_dict()[k], v), k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


# --- the train step ----------------------------------------------------------

def _params(**overrides):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=D, sent_embedding_dim=300,
                  sent_rnn_hiddendim=8, video_rnn_hiddendim=16,
                  mlp_hidden_dim=8, video_len=T, sent_len=N, lr=1e-3,
                  dropout=0.0, grad_clip_max=0.5)
    params.update(overrides)
    return params


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    nfeats = rng.randint(6, T + 1, B).astype(np.int32)
    s = np.array([rng.randint(0, n - 2) for n in nfeats])
    e = np.array([rng.randint(a, n) for a, n in zip(s, nfeats)])
    framestps = np.stack([s, e], -1).astype(np.int32)
    video = rng.randn(B, T, D).astype(np.float32)
    video[np.arange(T)[None] >= nfeats[:, None]] = 0.0
    return {'video_feat': video,
            'sent_feat': rng.randn(B, N, 300).astype(np.float32),
            'video_mask': (np.arange(T)[None] < nfeats[:, None]).astype(np.int32),
            'sent_mask': np.ones((B, N), np.int32), 'framestps': framestps,
            'timestps': framestps.astype(np.float32), 'nfeats': nfeats,
            'duration': np.full(B, 30.0, np.float32)}


@pytest.mark.parametrize('case', [
    dict(), dict(group_weight=True, grad_clip=True),
    dict(optim='sgd', lr_schd='l', lr=0.5)])
def test_baseline_train_step_matches_jax(case):
    """Tolerances of tests/test_torch_train.py (tests/test_grad_parity.py):
    loss rtol 2e-4, gradients atol 1e-6 rtol 2e-3, parameters after each
    update atol 2e-6 rtol 5e-3 where the step-1 gradient is above the f32
    noise floor (1e-5) and within Adam's largest drift (2 lr a step)
    elsewhere."""
    params = _params(**case)
    lr = float(params['lr'])
    jm = jax_build_model(params, 'baseline')
    weights = jax.tree.map(np.asarray, jax_cli.init_model_params(
        jm, params, jax.random.PRNGKey(5), 'baseline'))
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(b[k]) for k in STEP_KEYS}
    model = build_model(params, 'baseline', device='cpu')
    model.load_state_dict(state_dict_from_jax(weights, baseline=True),
                          strict=True)
    state = TrainState(model, params, steps_per_epoch=2)
    step = make_baseline_train_step(model, state, params)

    def jax_loss(p):
        out = jm.apply({'params': p}, jb['video_feat'], jb['sent_feat'],
                       jb['video_mask'], jb['sent_mask'])
        return jax_losses.span_ground_loss(out['start_prob'], out['end_prob'],
                                           jb['framestps'])

    jloss, jgrads = jax.value_and_grad(jax_loss)(weights)
    model.train()
    loss, _ = step.loss_fn(tb, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4)
    want_grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                     baseline=True)
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(),
                                   atol=1e-6, rtol=2e-3, err_msg=k)
    cond = {k: np.abs(v.numpy()) >= 1e-5 for k, v in want_grads.items()}

    jstep = jax_train_step(jm, params)
    jstate = jax_state.create_train_state(
        weights, jax_state.make_optimizer(params, steps_per_epoch=2))
    key = jax.random.PRNGKey(0)
    for n in range(3):
        jstate, jm_aux = jstep(jstate, jb, key)
        metrics = step(tb, None)
        assert set(metrics) == {'loss', 'miou'}
        np.testing.assert_allclose(float(metrics['loss']),
                                   float(jm_aux['loss']), rtol=2e-4)
        np.testing.assert_allclose(float(metrics['miou']),
                                   float(jm_aux['miou']), atol=1e-6)
        want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   baseline=True)
        for k, p in model.state_dict().items():
            g, w, m = p.numpy(), want[k].numpy(), cond[k]
            np.testing.assert_allclose(
                g[m], w[m], atol=2e-6, rtol=5e-3,
                err_msg=f'{k} after update {n + 1}')
            if (~m).any():
                assert np.abs(g[~m] - w[~m]).max() <= 2 * lr * (n + 1) + 1e-6
    assert state.step == 3


def test_baseline_train_step_with_dropout_is_seeded():
    """Dropout masks come from the step's generator: one seed, one
    result."""
    params = _params(dropout=0.5)
    b = _batch()
    results = []
    for _ in range(2):
        torch.manual_seed(0)
        model = build_model(params, 'baseline', device='cpu')
        step = make_baseline_train_step(
            model, TrainState(model, params, steps_per_epoch=4), params)
        gen = torch.Generator().manual_seed(11)
        metrics = [step({k: _t(b[k]) for k in STEP_KEYS}, gen)
                   for _ in range(2)]
        results.append((metrics, model.state_dict()))
    for k in ('loss', 'miou'):
        assert torch.isfinite(results[0][0][1][k])
        assert torch.equal(results[0][0][1][k], results[1][0][1][k])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


def test_baseline_steps_refuse_what_is_not_ported():
    # grad_accum_steps is ported (tests/test_torch_grad_accum.py): the
    # step refuses only an accum that does not divide the batch of 4
    params = _params(grad_accum_steps=3)
    model = build_model(params, 'baseline', device='cpu')
    step = make_baseline_train_step(model, TrainState(model, params, 1),
                                    params)
    b = _batch()
    with pytest.raises(ValueError, match='grad_accum_steps=3 must divide'):
        step({k: _t(b[k]) for k in STEP_KEYS}, None)
    # eval_topk > 1 is ported: the step adds each row's NMS proposals
    out = make_baseline_eval_step(model, topk=3)(
        {k: _t(b[k]) for k in STEP_KEYS})
    B = out['pred_time'].shape[0]
    assert out['pred_time_topk'].shape == (B, 3, 2)
    assert out['score_topk'].shape == (B, 3)
    assert torch.equal(out['pred_time_topk'][:, 0], out['pred_time'])


# --- the drivers ---------------------------------------------------------------

@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """argv of a tiny corpus (26 sentences, the same synthetic videos under
    the three split names) and a reference .ckp of seeded JAX baseline
    weights."""
    root = str(tmp_path_factory.mktemp('torch_baseline_driver'))
    params = jax_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                                  default_model='QAVE')
    anno, feats, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=8, name='charades_train.json')
    for split in ('charades_val.json', 'charades_test_ood.json'):
        shutil.copy(anno, os.path.join(root, split))
    model = jax_build_model(params, 'baseline', inference=True)
    weights = jax_cli.init_model_params(model, params, jax.random.PRNGKey(3),
                                        'baseline')
    ckp = os.path.join(root, 'seeded_baseline.ckp')
    save_reference_ckp(jax.tree.map(np.asarray, weights), ckp,
                       kind='baseline')
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY,
            '--runs', os.path.join(root, 'runs'), '--train_data', anno,
            '--val_data', os.path.join(root, 'charades_val.json'),
            '--test_data', os.path.join(root, 'charades_test_ood.json'),
            '--train_featpath', feats, '--valid_featpath', feats,
            '--test_featpath', feats, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init']]
    return root, argv, ckp, n


def _run_test(cli, argv, capsys):
    submit = cli.main_test_baseline(cli.parse_params(argv,
                                                     default_model='QAVE'))
    table = capsys.readouterr().out.splitlines()[1:]  # after the path line
    with open(submit) as f, open(submit + '.metrics.json') as g:
        metrics = json.load(g)
        metrics.pop('elapsed_loop_s', None)
        return json.load(f)['results'], metrics, table


def test_port_baseline_test_driver_matches_jax(corpus, capsys):
    _, argv, ckp, n = corpus
    argv = argv + ['--start_from', ckp]
    assert n % 8  # the last batch carries wrap-around padding
    want, want_metrics, want_table = _run_test(
        jax_cli, argv + ['--alias', 'test_jax_baseline'], capsys)
    got, got_metrics, got_table = _run_test(
        port_cli, argv + ['--alias', 'test_port_baseline', '--device', 'cpu'],
        capsys)
    assert list(got) == list(want)
    rows = [(g, w) for vid in want for g, w in zip(got[vid], want[vid])]
    assert len(rows) == n == sum(map(len, got.values()))
    for g, w in rows:
        assert g['timestamp'] == w['timestamp']  # spans exact
        for k in ('sentence', 'gt_timestamp', 'video_duration'):
            assert g[k] == w[k], k
        assert abs(g['score'] - w['score']) <= SCORE_TOL
    assert got_metrics == want_metrics
    assert got_table == want_table and len(got_table) >= 4


def test_port_baseline_train_driver_writes_a_reference_ckp(corpus, capsys):
    root, argv, _, n = corpus
    stats = port_cli.main_train_baseline(port_cli.parse_params(
        argv + ['--alias', 'tiny_baseline', '--epoch', '1', '--device', 'cpu'],
        default_model='QAVE'))
    printed = capsys.readouterr().out
    assert 'loss :' in printed and 'Max mIoU:' in printed
    assert set(stats) == {'loss', 'mIoU'} and list(stats['mIoU']) == [0]
    run = os.path.join(root, 'runs', 'tiny_baseline')
    ckp = os.path.join(run, 'model', 'tiny_baseline_00000.ckp')
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert [r['phase'] for r in records] == ['train', 'valid']
    assert set(records[0]) == {'epoch', 'phase', 'seconds', 'loss', 'miou'}
    with open(os.path.join(run, 'submits',
                           'tiny_baseline_00000_charades_val.json')) as f:
        assert sum(map(len, json.load(f)['results'].values())) == n

    # the JAX drivers read it as a reference baseline checkpoint
    payload, is_ref = jax_load_checkpoint(
        ckp, torch_convert_kwargs=dict(kind='baseline', predictor_name='mlp'))
    assert is_ref
    saved = torch.load(ckp, map_location='cpu', weights_only=True)
    mapped = state_dict_from_jax(payload['params'], baseline=True)
    assert set(mapped) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(mapped[k].numpy(), v.numpy(), err_msg=k)

    # and the port's baseline evaluation driver runs from it
    submit = port_cli.main_test_baseline(port_cli.parse_params(
        argv + ['--alias', 'test_baseline_from_train', '--start_from', ckp,
                '--device', 'cpu'], default_model='QAVE'))
    with open(submit) as f:
        assert sum(map(len, json.load(f)['results'].values())) == n


def test_port_baseline_validation_matches_jax_evaluation_of_its_ckp(
        corpus, capsys):
    """The training driver's valid pass runs the model in eval mode: with
    dropout 0.5 configured, its submit equals, span for span, the JAX
    ``main_test_baseline``'s on the same split from the checkpoint the
    epoch ends with (the weights the valid pass saw)."""
    root, argv, _, n = corpus
    params = port_cli.parse_params(
        argv + ['--alias', 'valid_baseline', '--epoch', '1', '--device',
                'cpu'], default_model='QAVE')
    assert params['dropout'] == 0.5  # a pass in train mode would differ
    port_cli.main_train_baseline(params)
    capsys.readouterr()
    run = os.path.join(root, 'runs', 'valid_baseline')
    with open(os.path.join(run, 'submits',
                           'valid_baseline_00000_charades_val.json')) as f:
        got = json.load(f)['results']
    want, _, _ = _run_test(jax_cli, argv + [
        '--alias', 'valid_baseline_jax', '--test_data',
        os.path.join(root, 'charades_val.json'), '--start_from',
        os.path.join(run, 'model', 'valid_baseline_00000.ckp')], capsys)
    assert list(got) == list(want)
    rows = [(g, w) for vid in want for g, w in zip(got[vid], want[vid])]
    assert len(rows) == n == sum(map(len, got.values()))
    for g, w in rows:
        assert g['timestamp'] == w['timestamp']  # spans exact
        assert g['sentence'] == w['sentence']
        assert abs(g['score'] - w['score']) <= SCORE_TOL


def test_baseline_drivers_default_to_cuda_and_raise_without_a_card(
        corpus, monkeypatch):
    root, argv, _, _ = corpus
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for alias, main in (('no_card_train', port_cli.main_train_baseline),
                        ('no_card_test', port_cli.main_test_baseline)):
        params = port_cli.parse_params(argv + ['--alias', alias],
                                       default_model='QAVE')
        assert params['device'] == 'cuda' and params['model'] == 'QAVE'
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main(params)
        assert not os.path.exists(os.path.join(root, 'runs', alias))
