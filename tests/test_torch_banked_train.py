"""The port's chunked GMD training and grouped valid pass on a device bank.

On a tiny synthetic Charades-CD corpus and its f16 FEATPAK1 pack
(``tools/make_synth_pack.py`` at T=24, D=32, batches of 8):

- ``cli._banked_train_chunks_factory`` at chunks of 3 over 7 batches (a
  tail of 1) against the train step batch by batch: weights, Adam state
  and generator state equal bit for bit, each chunk's means the means of
  its steps, the epoch's average weighted by chunk size as JAX's;
- ``main_train --device cpu`` on the pack at ``train_scan_chunk`` 16 and
  1: the same checkpoints, valid submits and generator states;
- the chunk loop against JAX's ``_banked_train_chunks_factory`` from one
  seeded JAX ``.ckp``, with the random draws out of the comparison (every
  moment spans its whole video, so the pseudo video is the video; no
  dropout): chunk-mean losses and the parameters after 6 updates;
- ``make_gmd_valid_step(...).grouped`` at G = 1, 3 and 8 against the
  valid step batch by batch with the same generator;
- on a card (skipped without one): the graphed chunks and the graphed
  driver (train and valid) against the eager ones, bit for bit.

JAX is imported inside the JAX comparison only, so the CUDA cases also run
on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_banked_train.py
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.data import device_bank
from shufflingvideosfortsg_torch.data.featpack import PackedFeatureSource
from shufflingvideosfortsg_torch.data.pipeline import BatchLoader
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (make_gmd_train_step,
                                                     make_gmd_valid_step,
                                                     to_device)
from shufflingvideosfortsg_torch.utils.interop import (load_reference_ckp,
                                                       state_dict_from_jax)
from torch_one_thread import one_torch_thread  # noqa: F401

SCORE_TOL = 1e-5  # f32 span scores
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '-1']
CPU = torch.device('cpu')
METRICS = ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d', 'miou')


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
    """(argv on the pack, the root, the sentence count): 30 videos of 2-5
    sentences, 102 in all: 13 batches of 8, the last one padded; the
    same sentences under the three split names."""
    root = str(tmp_path_factory.mktemp('torch_banked_train'))
    params = port_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                                   default_model='GMD')
    anno, _, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=30, name='charades_train.json',
        features=False)
    pack = chip_smoke.write_pack(root, 'f16', 30, 24, 32)
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY,
            '--runs', os.path.join(root, 'runs'),
            '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init'],
            '--train_data', anno, '--train_featpath', pack,
            '--valid_featpath', pack, '--test_featpath', pack]
    for key, name in (('val_data', 'charades_val.json'),
                      ('test_data', 'charades_test_ood.json')):
        path = os.path.join(root, name)
        with open(anno) as f, open(path, 'w') as g:
            g.write(f.read())
        argv += ['--' + key, path]
    return argv, root, n


def _setup(corpus, device=CPU, split=('train_data', 'train_featpath',
                                       'train')):
    """(params, the bank, the index-only host batches of ``split``) on
    ``device``; the batches in loader order, unshuffled."""
    argv, _, _ = corpus
    params = port_cli.parse_params(argv + ['--device', device.type],
                                   default_model='GMD')
    ds = port_cli.make_dataset(params, *split)
    bank = device_bank.maybe_device_bank(params, ds, device)
    batches = list(BatchLoader(ds, 8, shuffle=False, prefetch=0,
                               device_assemble=True))
    return params, bank, batches


def _train_step(params, bank, device=CPU, weights=None):
    """A GMD train step over ``bank`` of seeded weights (or ``weights``,
    a JAX tree), its state at 10 steps an epoch."""
    model = port_cli._seeded_model(params, device, 'gmd')
    if weights is not None:
        model.load_state_dict(state_dict_from_jax(weights))
    state = TrainState(model, params, steps_per_epoch=10)
    return make_gmd_train_step(model, state, params,
                               assembler=bank.assemble)


def _attached(bank, batch, device=CPU):
    return bank.attach(to_device(batch, device, device_bank.INDEX_KEYS))


def _per_step(params, bank, batches, device=CPU):
    """The steps batch by batch: (step, per-step metrics, generator)."""
    step = _train_step(params, bank, device)
    gen = torch.Generator(device).manual_seed(7)
    metrics = [step(_attached(bank, b, device), gen) for b in batches]
    return step, metrics, gen


def _chunked(params, bank, batches, sizes, device=CPU, graphed=True):
    """The same steps in chunks of ``sizes``: (step, chunk means,
    generator)."""
    step = _train_step(params, bank, device)
    run = port_cli._banked_train_chunks_factory(step, bank, device, graphed)
    gen = torch.Generator(device).manual_seed(7)
    means, at = [], 0
    for n in sizes:
        means.append(run(batches[at:at + n], gen))
        at += n
    assert at == len(batches)
    return step, means, gen


def _assert_same_training(a, b):
    """Two train steps' states equal bit for bit: weights, the optimizer's
    moments and counts, the update count."""
    sa, sb = a.state, b.state
    assert sa.step == sb.step
    for (k, v), (k2, w) in zip(sa.model.state_dict().items(),
                               sb.model.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k
    oa, ob = sa.optimizer.state_dict(), sb.optimizer.state_dict()
    assert oa['state'].keys() == ob['state'].keys()
    for i in oa['state']:
        for k, v in oa['state'][i].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob['state'][i][k])), (i, k)


def test_chunk_loop_equals_the_per_step_loop(corpus):
    params, bank, batches = _setup(corpus)
    batches = batches[:7]
    step_a, metrics, gen_a = _per_step(params, bank, batches)
    sizes = (3, 3, 1)  # train_scan_chunk 3 over 7 batches: a tail of 1
    step_b, means, gen_b = _chunked(params, bank, batches, sizes)
    _assert_same_training(step_a, step_b)
    assert step_b.state.step == 7
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    at = 0
    for n, mean in zip(sizes, means):
        assert set(mean) == set(METRICS)
        for k in METRICS:
            want = np.mean([float(m[k]) for m in metrics[at:at + n]])
            np.testing.assert_allclose(float(mean[k]), want, rtol=1e-6,
                                       err_msg=k)
        at += n
    # the epoch's average weights each chunk's mean by its size
    fetched = port_cli._fetch(means)
    for k in METRICS:
        np.testing.assert_allclose(
            port_cli._avg(fetched, k, list(sizes)),
            np.mean([float(m[k]) for m in metrics]), rtol=1e-6, err_msg=k)


def _driver_run(corpus, alias, *flags, device='cpu', graphed=True):
    """main_train for 2 epochs on the pack, the rate decayed after the
    first: (statistics, checkpoints, valid submits, generator states)."""
    argv, root, _ = corpus
    params = port_cli.parse_params(
        argv + ['--alias', alias, '--epoch', '2', '--lr_step', '1',
                '--device', device, *flags], default_model='GMD')
    stats, states = chip_smoke.main_train_and_step(params, graphed)
    run = os.path.join(root, 'runs', alias)
    ckps, submits = [], []
    for epoch in range(2):
        ckps.append(load_reference_ckp(
            os.path.join(run, 'model', f'{alias}_{epoch:05d}.ckp')))
        with open(os.path.join(run, 'submits',
                               f'{alias}_{epoch:05d}_charades_val.json')) as f:
            submits.append(json.load(f)['results'])
    return stats, ckps, submits, states


def _assert_same_runs(a, b):
    stats, ckps, submits, states = a
    assert stats == b[0] and np.isfinite(stats['loss'][0])
    for ckp, other in zip(ckps, b[1]):
        assert ckp.keys() == other.keys()
        for k in ckp:
            assert torch.equal(ckp[k], other[k]), k
    assert submits == b[2]
    assert states.keys() == b[3].keys() == {'train', 'valid'}
    for k in states:
        assert torch.equal(states[k], b[3][k]), k


def test_train_driver_chunked_equals_per_step(corpus):
    chunked = _driver_run(corpus, 'chunk16', '--train_scan_chunk', '16')
    per_step = _driver_run(corpus, 'chunk1', '--train_scan_chunk', '1')
    _assert_same_runs(chunked, per_step)


def _whole_moment_batches(pack, n_vocab: int, n: int, B: int, N: int,
                          seed: int = 0):
    """n index batches of B sentences whose moments span their whole
    videos (so the pseudo video is the video itself)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        rows = rng.randint(0, pack.num_videos, B)
        nfeats = pack.nfeats[rows].astype(np.int32)
        framestps = np.stack([np.zeros(B), nfeats - 1], -1).astype(np.int32)
        duration = np.full(B, 30.0, np.float32)
        out.append({
            'pack_row': rows.astype(np.int64),
            'token_ids': rng.randint(0, n_vocab, (B, N)).astype(np.int64),
            'sent_len': rng.randint(3, N, B).astype(np.int64),
            'framestps': framestps, 'nfeats': nfeats,
            'timestps': np.stack([np.zeros(B), duration], -1)
            .astype(np.float32),
            'duration': duration})
    return out


def test_chunk_loop_matches_jax_chunks(corpus):
    """Tolerances of tests/test_grad_parity.py: chunk-mean loss rtol 2e-4,
    parameters after 6 updates atol 2e-6 rtol 5e-3."""
    import jax

    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.data.device_bank import \
        DeviceFeatureBank as JaxBank
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.parallel.mesh import create_mesh
    from shufflingvideosfortsg_tpu.train.state import (create_train_state,
                                                       make_optimizer)
    from shufflingvideosfortsg_tpu.train.steps import \
        make_gmd_train_step as jax_train_step
    argv, _, _ = corpus
    argv = argv + ['--dropout', '0', '--disc_dropout', '0']
    params = port_cli.parse_params(argv + ['--device', 'cpu'], 'GMD')
    jparams = jax_cli.parse_params(argv, default_model='GMD')
    model = build_model(jparams, 'gmd')
    weights = jax.tree.map(np.asarray, jax_cli.init_model_params(
        model, jparams, jax.random.PRNGKey(5), 'gmd'))
    pack = PackedFeatureSource(params['train_featpath'])
    vocab = types.SimpleNamespace(embeddings=np.load(
        params['word_fts_path']))
    batches = _whole_moment_batches(pack, len(vocab.embeddings), 6, 8,
                                    params['sent_len'])

    mesh = create_mesh([1])
    jbank = JaxBank(pack, vocab, mesh)
    jstep = jax_train_step(model, jparams, assembler=jbank.assemble)
    run_jax = jax_cli._banked_train_chunks_factory(jstep, jbank, mesh)
    jstate = create_train_state(weights, make_optimizer(jparams,
                                                        steps_per_epoch=10))
    key = jax.random.PRNGKey(11)
    want = []
    for at in (0, 3):
        jstate, key, m = run_jax(jstate, key, batches[at:at + 3])
        want.append(float(m['loss']))

    bank = device_bank.DeviceFeatureBank(pack, vocab, CPU)
    pack.close()
    step = _train_step(params, bank, weights=weights)
    run = port_cli._banked_train_chunks_factory(step, bank, CPU)
    gen = torch.Generator().manual_seed(0)
    got = [float(run(batches[at:at + 3], gen)['loss']) for at in (0, 3)]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert step.state.step == 6
    want_params = state_dict_from_jax(jax.tree.map(np.asarray,
                                                   jstate.params))
    got_params = step.state.model.state_dict()
    assert got_params.keys() == want_params.keys()
    for k, v in got_params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k].numpy(),
                                   atol=2e-6, rtol=5e-3, err_msg=k)


@pytest.mark.parametrize('group', [1, 3, 8])
def test_grouped_valid_matches_the_step_batch_by_batch(corpus, group):
    params, bank, batches = _setup(
        corpus, split=('val_data', 'valid_featpath', 'valid'))
    step = make_gmd_valid_step(port_cli._seeded_model(params, CPU, 'gmd'),
                               params, assembler=bank.assemble)
    assert len(batches) == 13
    assert group == 1 or len(batches) % group  # the last tick is padded
    gen_a = torch.Generator().manual_seed(3)
    outs = [step(_attached(bank, b), gen_a) for b in batches]
    want = {k: np.stack([o[k].numpy() for o in outs]) for k in outs[0]}
    gen_b = torch.Generator().manual_seed(3)
    got = port_cli._banked_eval_epoch(step, batches, bank, CPU, group=group,
                                      generator=gen_b)
    # the last, shorter tick draws for its own batches alone
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got['pred_time'], want['pred_time'])
    np.testing.assert_allclose(got['score'], want['score'], rtol=0,
                               atol=SCORE_TOL)
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'miou'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.requires_cuda
def test_graphed_chunks_equal_eager_chunks_on_cuda(corpus):
    """Chunks of 3 over 7 steps: 2 warm-up steps, a capture, then 5
    replays; against the same chunks run eagerly and the steps batch by
    batch."""
    dev = torch.device('cuda', 0)
    params, bank, batches = _setup(corpus, dev)
    batches = batches[:7]
    sizes = (3, 3, 1)
    graphed, g_means, g_gen = _chunked(params, bank, batches, sizes, dev)
    assert len(graphed.graphs) == 1
    eager, e_means, e_gen = _chunked(params, bank, batches, sizes, dev,
                                     graphed=False)
    per_step, _, p_gen = _per_step(params, bank, batches, dev)
    for other, gen in ((eager, e_gen), (per_step, p_gen)):
        _assert_same_training(graphed, other)
        assert torch.equal(g_gen.get_state(), gen.get_state())
    for a, b in zip(g_means, e_means):
        for k in METRICS:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.requires_cuda
def test_graphed_train_driver_equals_eager_on_cuda(corpus):
    """main_train on the card: the graphed chunks and valid ticks against
    the eager ones (checkpoints, valid submits, generator states)."""
    graphed = _driver_run(corpus, 'cuda_graphed', '--eval_scan_group', '3',
                          device='cuda')
    eager = _driver_run(corpus, 'cuda_eager', '--eval_scan_group', '3',
                        device='cuda', graphed=False)
    _assert_same_runs(graphed, eager)
