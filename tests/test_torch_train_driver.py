"""The port's training driver: ``main_train --device cpu`` at tiny widths
for one epoch over a synthetic Charades-CD corpus writes a reference
``.ckp`` that the JAX package's ``load_checkpoint`` reads as such and the
port's ``main_test`` evaluates; ``--start_from auto`` resumes at the next
epoch (as ``tests/test_drivers.py``'s JAX run does); a non-finite loss
leaves the emergency checkpoint; async checkpoints equal synchronous
ones; ``SVTSG_TRACE_DIR`` writes a trace; unported options and a missing
card raise before any work. Multi-seed runs: ``test_torch_multiseed.py``."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_tpu.utils.saver import \
    load_checkpoint as jax_load_checkpoint
from shufflingvideosfortsg_torch import cli
from shufflingvideosfortsg_torch.utils import saver
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '1']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """argv of a tiny train/valid/test corpus (the same synthetic videos
    under the three split names)."""
    root = str(tmp_path_factory.mktemp('torch_train_driver'))
    params = cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                              default_model='GMD')
    anno, feats, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=8, name='charades_train.json')
    for split in ('charades_val.json', 'charades_test_ood.json'):
        shutil.copy(anno, os.path.join(root, split))
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY,
            '--runs', os.path.join(root, 'runs'), '--train_data', anno,
            '--val_data', os.path.join(root, 'charades_val.json'),
            '--test_data', os.path.join(root, 'charades_test_ood.json'),
            '--train_featpath', feats, '--valid_featpath', feats,
            '--test_featpath', feats, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init']]
    return root, argv, n


def test_train_driver_writes_a_reference_ckp(corpus, capsys):
    root, argv, n = corpus
    params = cli.parse_params(argv + ['--alias', 'tiny_train', '--epoch', '1',
                                      '--device', 'cpu'], default_model='GMD')
    stats = cli.main_train(params)
    printed = capsys.readouterr().out
    assert 'loss :' in printed and 'Max mIoU:' in printed
    assert set(stats) == {'loss', 'mIoU'} and list(stats['mIoU']) == [0]
    run = os.path.join(root, 'runs', 'tiny_train')
    ckp = os.path.join(run, 'model', 'tiny_train_00000.ckp')
    assert os.path.isfile(ckp)
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        phases = [json.loads(line)['phase'] for line in f]
    assert phases == ['train', 'valid']
    with open(os.path.join(run, 'submits', 'tiny_train_00000_charades_val.json')) as f:
        assert sum(map(len, json.load(f)['results'].values())) == n

    # the JAX drivers read it as a reference checkpoint, to the same weights
    payload, is_ref = jax_load_checkpoint(
        ckp, torch_convert_kwargs=dict(kind='gmd', predictor_name='mlp',
                                       m_temp='none'))
    assert is_ref
    saved = torch.load(ckp, map_location='cpu', weights_only=True)
    mapped = state_dict_from_jax(payload['params'])
    assert set(mapped) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(mapped[k].numpy(), v.numpy(), err_msg=k)

    # and the port's evaluation driver runs from it
    submit = cli.main_test(cli.parse_params(
        argv + ['--alias', 'test_from_train', '--start_from', ckp,
                '--device', 'cpu'], default_model='GMD'))
    with open(submit) as f:
        assert sum(map(len, json.load(f)['results'].values())) == n


def _run(argv, alias, *flags, kind='GMD'):
    train = cli.main_train if kind == 'GMD' else cli.main_train_baseline
    return train(cli.parse_params(argv + ['--alias', alias, '--device', 'cpu',
                                          *flags], default_model=kind))


def _ckp(root, alias, epoch):
    return os.path.join(root, 'runs', alias, 'model',
                        f'{alias}_{epoch:05d}.ckp')


def test_auto_resume_continues_at_the_next_epoch(corpus):
    """JAX ``test_auto_resume_continues_at_next_epoch``: a restart with
    ``--start_from auto`` reuses the run directory, loads the newest
    checkpoint with its sidecar and runs the epochs after it; on a fresh
    alias it starts at epoch 0."""
    root, argv, n = corpus
    _run(argv, 'resume', '--epoch', '1')
    assert os.path.isfile(_ckp(root, 'resume', 0))
    stats = _run(argv, 'resume', '--epoch', '3', '--start_from', 'auto')
    assert 0 not in stats['loss'] and set(stats['mIoU']) == {1, 2}
    n_batches = -(-n // 8)
    for epoch in (1, 2):
        _, state, weights_only = saver.load_checkpoint(
            _ckp(root, 'resume', epoch))
        assert not weights_only
        assert state['train_state']['step'] == (epoch + 1) * n_batches
    with open(os.path.join(root, 'runs', 'resume', 'metrics.jsonl')) as f:
        epochs = [json.loads(line)['epoch'] for line in f]
    assert epochs == [0, 0, 1, 1, 2, 2]  # train and valid a run's epoch
    fresh = _run(argv, 'fresh_auto', '--epoch', '1', '--start_from', 'auto')
    assert 0 in fresh['loss']


def test_non_finite_loss_leaves_the_emergency_checkpoint(corpus):
    """A NaN rate (SGD's: Adam refuses one) makes the weights NaN after
    the first update, so the second step's loss is NaN; with batch
    logging off the watchdog still checks every ``nan_check_interval``
    steps, writes ``_99999.ckp`` and its sidecar and raises."""
    root, argv, _ = corpus
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        _run(argv, 'nan_run', '--epoch', '1', '--optim', 'sgd', '--lr',
             'nan', '--batch_log_interval', '-1', '--nan_check_interval', '1')
    weights, state, weights_only = saver.load_checkpoint(
        _ckp(root, 'nan_run', 99999))
    assert not weights_only and state['train_state']['step'] == 2
    assert set(state['generators']) == {'train', 'valid'}
    assert not all(torch.isfinite(v).all() for v in weights.values())
    assert saver.latest_checkpoint(os.path.dirname(
        _ckp(root, 'nan_run', 0)))[1] == 99999


@pytest.mark.parametrize('kind', ['GMD', 'QAVE'])
def test_async_checkpoints_equal_synchronous_ones(corpus, kind):
    """Two epochs at ``grad_accum_steps`` 2 with ``--async_checkpoint`` and
    without: every ``.ckp`` and sidecar equal bit for bit."""
    root, argv, _ = corpus
    for alias, flags in (('sync_' + kind, ()),
                         ('async_' + kind, ('--async_checkpoint',))):
        _run(argv, alias, '--epoch', '2', '--grad_accum_steps', '2', *flags,
             kind=kind)
    for epoch in (0, 1):
        a = saver.load_checkpoint(_ckp(root, 'sync_' + kind, epoch))
        b = saver.load_checkpoint(_ckp(root, 'async_' + kind, epoch))
        assert chip_smoke._same_tree(a, b)


def test_trace_dir_writes_a_chrome_trace(corpus, tmp_path, monkeypatch):
    root, argv, _ = corpus
    monkeypatch.setenv('SVTSG_TRACE_DIR', str(tmp_path / 'trace'))
    _run(argv, 'traced', '--epoch', '1', kind='QAVE')
    with open(tmp_path / 'trace' / 'traced.pt.trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name', '').startswith('aten::') for e in events)


@pytest.mark.parametrize('flag', [
    ['--pipeline_stages', '1'], ['--tensor_parallel', '2'], ['--fsdp']])
def test_train_driver_refuses_what_is_not_ported(corpus, flag):
    root, argv, _ = corpus
    params = cli.parse_params(argv + ['--alias', 'refused', '--device', 'cpu',
                                      *flag], default_model='GMD')
    with pytest.raises(NotImplementedError, match='not ported'):
        cli.main_train(params)
    assert not os.path.exists(os.path.join(root, 'runs', 'refused'))


def test_train_driver_defaults_to_cuda_and_raises_without_a_card(
        corpus, monkeypatch):
    root, argv, _ = corpus
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params = cli.parse_params(argv + ['--alias', 'no_card'],
                              default_model='GMD')
    assert params['device'] == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main_train(params)
    assert not os.path.exists(os.path.join(root, 'runs', 'no_card'))
