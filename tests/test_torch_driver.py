"""The port's evaluation driver against the JAX package's: both
``main_test`` drivers on one tiny synthetic Charades-CD corpus and one
reference ``.ckp``. Their submit files must match span for span and their
metric tables must be equal."""

import json
import os

import jax
import numpy as np
import pytest

import chip_smoke
from shufflingvideosfortsg_tpu import cli as jax_cli
from shufflingvideosfortsg_tpu.models import build_model as jax_build_model
from shufflingvideosfortsg_tpu.utils.torch_interop import save_reference_ckp
from shufflingvideosfortsg_torch import cli as port_cli
from torch_one_thread import one_torch_thread  # noqa: F401

SCORE_TOL = 1e-5  # f32 span scores
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '1']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """argv for both drivers: a synthetic corpus (26 sentences, so the last
    batch of 8 is padded) and a reference .ckp of seeded JAX weights."""
    root = str(tmp_path_factory.mktemp('torch_driver'))
    params = jax_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                                  default_model='GMD')
    anno, feats, vocab, n = chip_smoke.write_corpus(root, params, n_videos=8)
    model = jax_build_model(params, 'gmd', inference=True)
    weights = jax_cli.init_model_params(model, params,
                                        jax.random.PRNGKey(3), 'gmd')
    ckp = os.path.join(root, 'seeded.ckp')
    save_reference_ckp(jax.tree.map(np.asarray, weights), ckp, kind='gmd')
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY,
            '--runs', os.path.join(root, 'runs'), '--test_data', anno,
            '--test_featpath', feats, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init'],
            '--start_from', ckp]
    return argv, n


def _run(cli, argv, capsys):
    submit = cli.main_test(cli.parse_params(argv, default_model='GMD'))
    table = capsys.readouterr().out.splitlines()[1:]  # after the path line
    with open(submit) as f, open(submit + '.metrics.json') as g:
        metrics = json.load(g)
        metrics.pop('elapsed_loop_s')
        return json.load(f)['results'], metrics, table


@pytest.mark.parametrize('vfeat_fn', ['raw', 'lg'])
def test_port_driver_matches_jax_driver(corpus, capsys, vfeat_fn):
    argv, n = corpus
    argv = argv + ['--vfeat_fn', vfeat_fn]
    assert n % 8  # the last batch carries wrap-around padding
    want, want_metrics, want_table = _run(
        jax_cli, argv + ['--alias', f'test_jax_{vfeat_fn}'], capsys)
    got, got_metrics, got_table = _run(
        port_cli, argv + ['--alias', f'test_port_{vfeat_fn}', '--device', 'cpu'],
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


def test_port_driver_debug_keeps_four_batches(corpus):
    argv, n = corpus
    params = port_cli.parse_params(
        argv + ['--alias', 'test_port_debug', '--device', 'cpu', '--debug',
                '--batch_size', '4', '4', '4'], default_model='GMD')
    with open(port_cli.main_test(params)) as f:
        results = json.load(f)['results']
    assert n > 16 and sum(map(len, results.values())) == 16


def test_port_driver_refuses_top_k(corpus):
    """``eval_topk`` > 1 is no longer refused (the JAX driver's top-k
    submit is held in tests/test_torch_serving.py): every sentence gets
    its proposals, the first the top-1 span, the rest non-overlapping
    past the NMS threshold. ``precision: bf16`` runs the test driver
    (its submit against the JAX driver's: tests/test_torch_bf16.py) and
    is refused, by name, in training only."""
    argv, n = corpus
    params = port_cli.parse_params(
        argv + ['--alias', 'test_port_topk', '--device', 'cpu',
                '--eval_topk', '3'], default_model='GMD')
    with open(port_cli.main_test(params)) as f:
        results = json.load(f)['results']
    rows = [r for v in results.values() for r in v]
    assert len(rows) == n
    for r in rows:
        props = r['timestamps_topk']
        assert 1 <= len(props) == len(r['scores_topk']) <= 3
        assert props[0] == r['timestamp']
        assert r['scores_topk'] == sorted(r['scores_topk'], reverse=True)
    bf16 = argv + ['--alias', 'test_port_bf16', '--device', 'cpu',
                   '--precision', 'bf16']
    with open(port_cli.main_test(port_cli.parse_params(
            bf16, default_model='GMD'))) as f:
        results = json.load(f)['results']
    assert sum(map(len, results.values())) == n
    for train in (port_cli.main_train, port_cli.main_train_baseline):
        with pytest.raises(NotImplementedError, match='precision bf16'):
            train(port_cli.parse_params(bf16, default_model='GMD'))
