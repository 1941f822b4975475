"""The port's banked evaluation and drivers on packed features.

On one tiny synthetic Charades-CD corpus and its FEATPAK1 packs
(``tools/make_synth_pack.py`` at T=24, D=32) with a reference ``.ckp`` of
seeded JAX weights:

- the grouped ``[G*B]`` tick of ``cli._banked_eval_epoch`` against the
  step batch by batch, at G = 1, 3 and 8 (a padded last tick);
- ``main_test`` and ``main_test_baseline`` on the pack against the JAX
  drivers on the same ``.ckp`` (the JAX package runs its own bank and
  whole-epoch scan): spans equal, scores within 1e-5, for the raw, bf16
  and int8 tiers and with the bank off (the host gather);
- the train drivers on the pack with the bank against the same drivers
  with it off (bit for bit: the assembled batch is the host batch), and
  with the bf16 and int8 tiers;
- on a card (skipped without one): the graphed epoch against the eager
  banked one and the host gather, and two graphed runs bit for bit.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_banked_eval.py
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.data import device_bank
from shufflingvideosfortsg_torch.data.pipeline import BatchLoader
from shufflingvideosfortsg_torch.train.steps import (make_gmd_test_step,
                                                     to_device)
from shufflingvideosfortsg_torch.utils.interop import load_reference_ckp
from torch_one_thread import one_torch_thread  # noqa: F401

SCORE_TOL = 1e-5  # f32 span scores
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '-1']
MODELS = {'gmd': 'GMD', 'baseline': 'QAVE'}
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.fixture(autouse=True)
def fresh_banks(monkeypatch):
    monkeypatch.setattr(device_bank, '_BANK_CACHE', {})


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """(argv without feature paths, packs by dtype, the root, the sentence
    count): 30 videos of 2-5 sentences, 102 in all: 13 batches of 8, the
    last one padded."""
    root = str(tmp_path_factory.mktemp('torch_banked'))
    params = port_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                                   default_model='GMD')
    anno, _, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=30, name='charades_train.json',
        features=False)
    splits = {'train_data': anno}
    for key, name in (('val_data', 'charades_val.json'),
                      ('test_data', 'charades_test_ood.json')):
        splits[key] = os.path.join(root, name)
        with open(anno) as f, open(splits[key], 'w') as g:
            g.write(f.read())
    packs = {dtype: chip_smoke.write_pack(root, dtype, 30, 24, 32)
             for dtype in ('f16', 'f32')}
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY,
            '--runs', os.path.join(root, 'runs'),
            '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init']]
    for key, path in splits.items():
        argv += ['--' + key, path]
    return argv, packs, root, n


@pytest.fixture(scope='module')
def jax_ckps(corpus):
    """A reference .ckp of seeded JAX weights by kind."""
    import jax

    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.utils.torch_interop import \
        save_reference_ckp
    argv, _, root, _ = corpus
    params = jax_cli.parse_params(argv, default_model='GMD')
    ckps = {}
    for kind in MODELS:
        model = build_model(params, kind, inference=True)
        weights = jax_cli.init_model_params(model, params,
                                            jax.random.PRNGKey(5), kind)
        ckps[kind] = os.path.join(root, f'{kind}.ckp')
        save_reference_ckp(jax.tree.map(np.asarray, weights), ckps[kind],
                           kind=kind)
    return ckps


def _feat_argv(pack):
    return ['--train_featpath', pack, '--valid_featpath', pack,
            '--test_featpath', pack]


def _params(cli, argv, kind, alias, tier):
    """Driver params on the pack of ``tier`` ('off': the bank off)."""
    params = cli.parse_params(argv + ['--alias', alias], MODELS[kind])
    params['device_bank'] = tier != 'off'
    params['device_bank_dtype'] = 'raw' if tier == 'off' else tier
    return params


def _submit(path):
    with open(path) as f:
        return json.load(f)['results']


def _assert_same_submit(got, want, n):
    assert list(got) == list(want)
    rows = [(g, w) for vid in want for g, w in zip(got[vid], want[vid])]
    assert len(rows) == n == sum(map(len, got.values()))
    for g, w in rows:
        assert g['timestamp'] == w['timestamp']  # spans exact
        for k in ('sentence', 'gt_timestamp', 'video_duration'):
            assert g[k] == w[k], k
        assert abs(g['score'] - w['score']) <= SCORE_TOL


def _tiny_test_step(corpus, pack_dtype='f16'):
    """(test step of seeded weights over the bank, the bank, the
    index-only host batches)."""
    argv, packs, _, _ = corpus
    params = _params(port_cli, argv + _feat_argv(packs[pack_dtype]) +
                     ['--device', 'cpu'], 'gmd', 'tick', 'raw')
    model = port_cli._seeded_model(params, CPU, 'gmd')
    ds = port_cli.make_dataset(params, 'test_data', 'test_featpath', 'test')
    bank = device_bank.maybe_device_bank(params, ds, CPU)
    batches = list(BatchLoader(ds, 8, shuffle=False, prefetch=0,
                               device_assemble=True))
    return make_gmd_test_step(model, assembler=bank.assemble), bank, batches


@pytest.mark.parametrize('group', [1, 3, 8])
def test_grouped_tick_matches_the_step_batch_by_batch(corpus, group):
    step, bank, batches = _tiny_test_step(corpus)
    assert corpus[3] == 102 and len(batches) == 13
    assert group == 1 or len(batches) % group  # the last tick is padded
    outs = [step(bank.attach(to_device(b, CPU, device_bank.INDEX_KEYS)))
            for b in batches]
    want = {k: np.stack([o[k].numpy() for o in outs]) for k in outs[0]}
    got = port_cli._banked_eval_epoch(step, batches, bank, CPU, group=group)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got['pred_time'], want['pred_time'])
    np.testing.assert_allclose(got['score'], want['score'], rtol=0,
                               atol=SCORE_TOL)
    # per-batch means over each batch's own 8 rows
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-6)
    np.testing.assert_allclose(got['miou'], want['miou'], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('kind,tier', [
    ('gmd', 'raw'), ('gmd', 'int8'), ('gmd', 'bf16'), ('gmd', 'off'),
    ('baseline', 'raw'), ('baseline', 'off')])
def test_port_test_driver_on_a_pack_matches_jax(corpus, jax_ckps, kind,
                                                tier):
    from shufflingvideosfortsg_tpu import cli as jax_cli
    argv, packs, _, n = corpus
    pack = packs['f32' if tier == 'bf16' else 'f16']
    argv = argv + _feat_argv(pack) + ['--start_from', jax_ckps[kind]]
    run = {'gmd': 'main_test', 'baseline': 'main_test_baseline'}[kind]
    want = _submit(getattr(jax_cli, run)(
        _params(jax_cli, argv, kind, f'test_jax_{kind}_{tier}', tier)))
    got = _submit(getattr(port_cli, run)(
        _params(port_cli, argv + ['--device', 'cpu'], kind,
                f'test_port_{kind}_{tier}', tier)))
    _assert_same_submit(got, want, n)


def _train_run(corpus, kind, alias, tier, pack_dtype='f16'):
    argv, packs, _, _ = corpus
    params = _params(port_cli, argv + _feat_argv(packs[pack_dtype]) +
                     ['--device', 'cpu', '--epoch', '1'], kind, alias, tier)
    train = {'gmd': port_cli.main_train,
             'baseline': port_cli.main_train_baseline}[kind]
    stats = train(params)
    run = os.path.join(params['runs'], alias)
    ckp = load_reference_ckp(os.path.join(run, 'model',
                                          f'{alias}_00000.ckp'))
    valid = _submit(os.path.join(run, 'submits',
                                 f'{alias}_00000_charades_val.json'))
    return stats, ckp, valid


@pytest.mark.parametrize('kind', list(MODELS))
def test_banked_train_driver_equals_the_host_gather(corpus, kind):
    """The train and valid batches assembled on the device are the host's
    batches, so a banked epoch trains the same weights, bit for bit."""
    stats, ckp, valid = _train_run(corpus, kind, f'bank_{kind}', 'raw')
    stats_h, ckp_h, valid_h = _train_run(corpus, kind, f'host_{kind}', 'off')
    assert stats == stats_h and np.isfinite(stats['loss'][0])
    assert ckp.keys() == ckp_h.keys()
    for k in ckp:
        assert torch.equal(ckp[k], ckp_h[k]), k
    assert valid == valid_h


@pytest.mark.parametrize('tier', ['bf16', 'int8'])
def test_train_drivers_run_on_the_bf16_and_int8_tiers(corpus, tier):
    stats, ckp, valid = _train_run(corpus, 'baseline', f'tier_{tier}', tier,
                                   pack_dtype='f32')
    assert np.isfinite(stats['loss'][0]) and 0 in stats['mIoU']
    assert all(torch.isfinite(v).all() for v in ckp.values()
               if v.is_floating_point())
    assert sum(map(len, valid.values())) == corpus[3]


@pytest.mark.requires_cuda
@pytest.mark.parametrize('kind', list(MODELS))
def test_graphed_epoch_matches_eager_and_host_gather_on_cuda(corpus, kind):
    argv, packs, root, n = corpus
    model = port_cli._seeded_model(
        port_cli.parse_params(argv, MODELS[kind]), CPU, kind)
    ckp = os.path.join(root, f'port_{kind}.ckp')
    torch.save(model.state_dict(), ckp)
    # ticks of 3 batches: 5 ticks, so the graph is captured after its 2
    # eager calls and replayed
    argv = argv + _feat_argv(packs['f16']) + ['--start_from', ckp,
                                              '--device', 'cuda',
                                              '--eval_scan_group', '3']
    run = getattr(port_cli, {'gmd': 'main_test',
                             'baseline': 'main_test_baseline'}[kind])
    graphed = [_submit(run(_params(port_cli, argv, kind, f'g{i}_{kind}',
                                   'raw'))) for i in range(2)]
    eager = _submit(run(_params(port_cli, argv, kind, f'e_{kind}', 'raw'),
                        _graphed=False))
    host = _submit(run(_params(port_cli, argv, kind, f'h_{kind}', 'off')))
    assert graphed[0] == graphed[1]  # bit for bit
    _assert_same_submit(graphed[0], eager, n)
    _assert_same_submit(graphed[0], host, n)
