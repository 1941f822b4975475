"""The port's multi-seed training (``train/multiseed.py``, ``cli``'s
``--multi_seed S``) against the JAX package and against single-seed runs,
at tiny widths, inputs made with numpy from a seed:

- the multi-seed state stacks and unstacks, and refuses seeds whose
  optimizers differ;
- parity with JAX: the S=2 inits of JAX's ``init_multiseed_states``
  (seeds 3 and 11) carried into the port's two seeds by
  ``state_dict_from_jax``, dropout off and host-made pseudo pairs; after
  2 updates of JAX's ``make_multiseed_train_step`` and the port's the
  per-seed losses (rtol 2e-4) and weights (atol 2e-6, rtol 5e-3 where
  the first gradient is above 1e-5, within Adam's largest drift of 2 lr
  a step elsewhere: ``tests/test_torch_train.py``'s bounds) agree, for
  GMD and the baseline;
- per-seed bits (JAX ``test_vmapped_equals_sequential``): with dropout
  and on-device augmentation on, seed i of an S=2 step equals a
  single-seed step over seed i's init and generator, ``torch.equal``, for
  the compositions the port runs (bf16, gradient accumulation, remat, a
  model variant, host-made pseudo pairs) and for the baseline;
- the valid step per seed, as the driver runs it (each seed's eval pass
  under ``make_multiseed_valid_step``), against JAX's
  ``make_multiseed_valid_step`` (every moment spans its video, so the
  pseudo video is the video and the draws leave the comparison; 1e-5),
  and every seed drawing the same pseudo videos;
- JAX's ``ValueError`` with ``fsdp`` and with ``start_from``;
- the drivers on the CPU (JAX ``tests/test_drivers.py:321-370``):
  ``main_train`` (in chunks on a pack and step by step, equal bit for
  bit) and ``main_train_baseline`` with ``--multi_seed 2`` write
  ``_s0``/``_s1`` checkpoints that differ, ``.s{i}`` submits and
  ``miou_per_seed``; seed 0 equals a single-seed run bit for bit; the
  port's test drivers read ``_s1.ckp``;
- ``--multi_seed 1`` is the single-seed run: its files, bit for bit, and
  its emergency checkpoint;
- a non-finite loss writes no emergency checkpoint, as in JAX, whose
  watchdog raises ``TypeError`` on the stacked state before it writes;
- on a card (skipped without one): the graphed multi-seed chunk equals
  the eager one bit for bit.

JAX is imported inside the JAX comparisons and the child processes that
compute JAX's references (``tests/multiseed_refs.py``) only, so the CUDA
case also runs on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_multiseed.py
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import multiseed_refs
from multiseed_refs import (B, JAX_PARAMS, LR, SEEDS, TRAIN_KEYS_OF,
                            UPDATES, VALID_SEED, make_batch, make_params)
from shufflingvideosfortsg_torch import cli
from shufflingvideosfortsg_torch.data import device_bank
from shufflingvideosfortsg_torch.data.pipeline import BatchLoader
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.train.multiseed import (
    init_multiseed_states, make_multiseed_train_step,
    make_multiseed_valid_step, n_seeds_of, seed_of, stack_states,
    unstack_state)
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (
    HOST_PAIR_KEYS, STEP_KEYS, TRAIN_KEYS, make_baseline_train_step,
    make_gmd_train_step, make_gmd_valid_step)
from shufflingvideosfortsg_torch.utils import saver
from shufflingvideosfortsg_torch.utils.interop import (load_reference_ckp,
                                                       state_dict_from_jax)
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = torch.device('cpu')
GMD_METRICS = ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d',
               'miou')
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '-1']


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.fixture(autouse=True)
def fresh_banks(monkeypatch):
    monkeypatch.setattr(device_bank, '_BANK_CACHE', {})


@pytest.fixture(scope='module', autouse=True)
def children(tmp_path_factory):
    """JAX's references for GMD and the baseline, computed by two child
    processes from the module's first test on (none where JAX is not
    installed: the card's machine runs the CUDA case alone)."""
    if importlib.util.find_spec('jax') is None:
        yield None
        return
    kids = multiseed_refs.Children(
        ('gmd', 'baseline'), tmp_path_factory.mktemp('multiseed_refs'))
    yield kids
    kids.close()


@pytest.fixture(scope='module')
def jax_refs(children):
    return children.wait()


# --- the multi-seed state ----------------------------------------------------

def test_stack_unstack_roundtrip():
    """JAX ``test_stack_unstack_roundtrip``: seed i of the stacked state
    holds seed i's init; the update count and rate act on every seed."""
    params = make_params()

    def init(seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return build_model(params, 'gmd', device='cpu')

    stacked = init_multiseed_states(init, SEEDS, params, steps_per_epoch=2)
    assert n_seeds_of(stacked) == 2
    for i, seed in enumerate(SEEDS):
        got = unstack_state(stacked, i).model.state_dict()
        want = init(seed).state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(v, want[k]) for k, v in got.items())
    stacked.step = 5
    assert [unstack_state(stacked, i).step for i in range(2)] == [5, 5]
    stacked.set_lr()
    for state in stacked.states:
        assert state.optimizer.param_groups[0]['lr'] == state.schedule(5)
    other = TrainState(init(1), dict(params, optim='sgd'), 2)
    with pytest.raises(ValueError, match='share one optimizer'):
        stack_states([unstack_state(stacked, 0), other])


def test_seed_zero_is_the_single_seed_run():
    """Seed 0's init and train stream are the single-seed run's; the other
    seeds' are their own and the same from call to call."""
    params = make_params(seed=123)
    assert seed_of(123, 0) == 123
    assert seed_of(123, 1) == seed_of(123, 1) != seed_of(123, 2)
    assert len({seed_of(s, i) for s in (0, 1, 123) for i in (1, 2, 3)}) == 9
    single = cli._seeded_model(params, CPU, 'gmd').state_dict()
    zero = cli._seeded_model(params, CPU, 'gmd', 0).state_dict()
    one = cli._seeded_model(params, CPU, 'gmd', 1).state_dict()
    assert all(torch.equal(v, zero[k]) for k, v in single.items())
    assert not all(torch.equal(v, one[k]) for k, v in single.items())


def test_every_seed_draws_the_same_pseudo_videos():
    """Two seeds at the same weights give the same valid outputs bit for
    bit, and the generator ends where one seed's pass leaves it."""
    params = make_params()
    model = cli._seeded_model(params, CPU, 'gmd')
    batch = make_batch(params, 6, keys=TRAIN_KEYS)
    valid = make_multiseed_valid_step([make_gmd_valid_step(model, params)] * 2)
    gen, one = torch.Generator().manual_seed(9), \
        torch.Generator().manual_seed(9)
    got = valid(batch, generator=gen)
    alone = make_gmd_valid_step(model, params)(batch, one)
    for k, v in alone.items():
        assert torch.equal(got[0][k], got[1][k]) and \
            torch.equal(got[0][k], v), k
    assert torch.equal(gen.get_state(), one.get_state())
    assert make_multiseed_valid_step([abs, str])(-3) == [3, '-3']


# --- seed i equals its single-seed run, bit for bit ------------------------------

COMPOSITIONS = {
    'gmd': ('gmd', {}),
    'gmd_bf16': ('gmd', dict(precision='bf16')),
    'gmd_accum2': ('gmd', dict(grad_accum_steps=2)),
    'gmd_remat': ('gmd', dict(remat=True)),
    # 'tall' multiplies video and sentence features: equal widths
    'gmd_variant': ('gmd', dict(predictor='cat_condi_lstm', m_temp='lstm',
                                crossmodal='tall', sent_rnn_hiddendim=16)),
    'gmd_host_pair': ('gmd', dict(on_device_aug=False)),
    'baseline': ('baseline', {}),
}


def _seed_run(kind, params, index):
    """Seed ``index``'s model (``cli._seeded_model``), state, train step
    and generator (``seed_of``)."""
    model = cli._seeded_model(params, CPU, kind, index)
    state = TrainState(model, params, steps_per_epoch=10)
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    gen = torch.Generator().manual_seed(seed_of(params['seed'], index))
    return model, state, make(model, state, params), gen


@pytest.mark.parametrize('name', sorted(COMPOSITIONS))
def test_each_seed_equals_its_single_seed_run(name):
    """JAX ``test_vmapped_equals_sequential``: 2 updates of an S=2 step,
    dropout (0.5) and on-device augmentation live, against a single-seed
    run of each seed: metrics, weights and generator equal bit for bit."""
    kind, over = COMPOSITIONS[name]
    params = make_params(seed=7, dropout=0.5, disc_dropout=0.5, **over)
    host_pair = not params.get('on_device_aug', True)
    keys = (STEP_KEYS if kind == 'baseline' else
            HOST_PAIR_KEYS if host_pair else TRAIN_KEYS)
    batches = [make_batch(params, n, host_pair, keys=keys) for n in range(2)]
    runs = [_seed_run(kind, params, i) for i in range(2)]
    multi = make_multiseed_train_step([r[2] for r in runs], 2)
    gens = tuple(r[3] for r in runs)
    got = [multi(b, *gens) for b in batches]
    for i in range(2):
        model, _, step, gen = _seed_run(kind, params, i)
        want = [step(b, gen) for b in batches]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert torch.equal(g[k][i], w[k]), (i, k)
        mine = runs[i][0].state_dict()
        for k, v in model.state_dict().items():
            assert torch.equal(mine[k], v), (i, k)
        assert torch.equal(gens[i].get_state(), gen.get_state())
    assert not torch.equal(got[1]['loss'][0], got[1]['loss'][1])
    if kind == 'gmd':  # the chunked form: the inner step and the state
        assert hasattr(multi, 'inner') and multi.state.step == 2


# --- the drivers ---------------------------------------------------------------------

@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """(argv on a pack, the root, the sentence count): 10 videos of 2-5
    sentences under the three split names, an f16 pack of them."""
    root = str(tmp_path_factory.mktemp('torch_multiseed'))
    params = cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                              default_model='GMD')
    anno, _, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=10, name='charades_train.json',
        features=False)
    pack = chip_smoke.write_pack(root, 'f16', 10, 24, 32)
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


@pytest.mark.parametrize('flags, match', [
    (['--fsdp'], 'does not compose with --fsdp'),
    (['--start_from', 'whatever.ckp'], 'cannot resume')])
def test_refusals_match_jax_before_any_work(corpus, flags, match):
    from shufflingvideosfortsg_tpu import cli as jax_cli
    argv, root, _ = corpus
    params = cli.parse_params(argv + ['--alias', 'refused_ms', '--device',
                                      'cpu', '--multi_seed', '2', *flags],
                              default_model='GMD')
    with pytest.raises(ValueError, match=match) as got:
        cli.main_train(params)
    with pytest.raises(ValueError) as want:
        jax_cli._multiseed_validate(dict(params))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=match):
        cli.main_train_baseline(params)
    assert not os.path.exists(os.path.join(root, 'runs', 'refused_ms'))
    assert cli._multiseed_validate(dict(multi_seed=1, fsdp=True)) == 1


def _drive(corpus, alias, kind='GMD', *flags):
    """A driver run for one epoch on the pack: (statistics, the run's
    directory, its metrics records)."""
    argv, root, _ = corpus
    train = cli.main_train if kind == 'GMD' else cli.main_train_baseline
    stats = train(cli.parse_params(argv + ['--alias', alias, '--device',
                                           'cpu', '--epoch', '1', *flags],
                                   default_model=kind))
    run = os.path.join(root, 'runs', alias)
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    return stats, run, records


def _files(run, alias, suffix=''):
    """(the .ckp, its sidecar, the valid submit) of epoch 0."""
    ckp = os.path.join(run, 'model', f'{alias}_00000{suffix}.ckp')
    return (ckp, saver.sidecar_path(ckp),
            os.path.join(run, 'submits',
                         f'{alias}_00000_charades_val'
                         f'{"." + suffix[1:] if suffix else ""}.json'))


def _same_files(a, b) -> bool:
    """Two runs' checkpoints (with their sidecars) and valid submits equal
    bit for bit."""
    ckp_a, _, sub_a = a
    ckp_b, _, sub_b = b
    with open(sub_a) as f, open(sub_b) as g:
        same_submit = json.load(f)['results'] == json.load(g)['results']
    return same_submit and chip_smoke._same_tree(
        saver.load_checkpoint(ckp_a), saver.load_checkpoint(ckp_b))


@pytest.fixture(scope='module')
def single_runs(corpus):
    """kind -> (the directory, the alias) of a single-seed run of that
    driver, driven once for the module."""
    runs = {}

    def run(kind):
        if kind not in runs:
            alias = f'single_{kind}'
            runs[kind] = (_drive(corpus, alias, kind)[1], alias)
        return runs[kind]
    return run


@pytest.mark.parametrize('kind', ['GMD', 'QAVE'])
def test_driver_trains_seeds_with_per_seed_files(corpus, single_runs, kind):
    """JAX ``test_multiseed_gmd_driver`` and ``..._baseline_driver``: the
    per-seed checkpoints and submits, the seed-meaned statistics, seed 0
    equal to a single-seed run bit for bit (checkpoint, sidecar, valid
    submit), seed 1 different, and the port's test driver on ``_s1``."""
    argv, root, n = corpus
    alias = f'ms_{kind}'
    stats, run, records = _drive(corpus, alias, kind, '--multi_seed', '2')
    valid = records[1]
    assert [r['phase'] for r in records] == ['train', 'valid']
    assert len(valid['miou_per_seed']) == 2
    assert valid['miou'] == pytest.approx(np.mean(valid['miou_per_seed']))
    assert stats['mIoU'][0] == round(valid['miou'] * 100, 2)
    seeds = [_files(run, alias, f'_s{i}') for i in range(2)]
    for ckp, side, submit in seeds:
        assert os.path.isfile(ckp) and os.path.isfile(side)
        with open(submit) as f:
            assert sum(map(len, json.load(f)['results'].values())) == n
    assert not os.path.exists(_files(run, alias)[0])
    w0, w1 = (load_reference_ckp(s[0]) for s in seeds)
    assert not all(torch.equal(v, w1[k]) for k, v in w0.items())
    assert _same_files(seeds[0], _files(*single_runs(kind)))
    test = cli.main_test if kind == 'GMD' else cli.main_test_baseline
    submit = test(cli.parse_params(
        argv + ['--alias', f'test_ms_{kind}', '--start_from', seeds[1][0],
                '--device', 'cpu'], default_model=kind))
    with open(submit) as f:
        assert sum(map(len, json.load(f)['results'].values())) == n


@pytest.mark.parametrize('kind', ['GMD', 'QAVE'])
def test_multi_seed_one_is_the_single_seed_run(corpus, single_runs, kind):
    """``--multi_seed 1`` is off, as in JAX (``_multiseed_setup`` returns
    0 for S <= 1): the single-seed run's files and nothing else (no
    ``_s0`` checkpoint, no ``.s0`` submit, no ``miou_per_seed``), equal to
    a single-seed run's bit for bit, and ``--start_from auto`` finds its
    checkpoint."""
    alias = f'ms1_{kind}'
    _, run, records = _drive(corpus, alias, kind, '--multi_seed', '1')
    assert [r['phase'] for r in records] == ['train', 'valid']
    assert 'miou_per_seed' not in records[1]
    ckp, side, submit = _files(run, alias)
    assert sorted(os.listdir(os.path.join(run, 'model'))) == \
        sorted(os.path.basename(p) for p in (ckp, side))
    assert os.listdir(os.path.join(run, 'submits')) == \
        [os.path.basename(submit)]
    assert saver.latest_checkpoint(os.path.join(run, 'model')) == (ckp, 0)
    assert _same_files((ckp, side, submit), _files(*single_runs(kind)))


def test_multi_seed_one_writes_the_emergency_checkpoint(corpus):
    """At ``--multi_seed 1`` (off) a non-finite loss writes the emergency
    checkpoint and its sidecar, as a single-seed run does."""
    argv, root, _ = corpus
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        _drive(corpus, 'ms1_nan', 'GMD', '--multi_seed', '1', '--optim',
               'sgd', '--lr', 'nan', '--nan_check_interval', '1')
    ckp = os.path.join(root, 'runs', 'ms1_nan', 'model', 'ms1_nan_99999.ckp')
    assert sorted(os.listdir(os.path.dirname(ckp))) == \
        sorted(os.path.basename(p) for p in (ckp, saver.sidecar_path(ckp)))


def test_driver_chunks_equal_steps(corpus):
    """GMD with ``--multi_seed 2`` in chunks of 16 on the bank (one
    multi-seed ``inner`` a step) and step by step: each seed's checkpoint,
    sidecar and valid submit equal bit for bit."""
    runs = {}
    for chunk in ('16', '1'):
        alias = f'ms_chunk{chunk}'
        _, run, _ = _drive(corpus, alias, 'GMD', '--multi_seed', '2',
                           '--train_scan_chunk', chunk)
        runs[chunk] = [_files(run, alias, f'_s{i}') for i in range(2)]
    for a, b in zip(runs['16'], runs['1']):
        assert _same_files(a, b)


# --- parity with the JAX package ----------------------------------------------

def _port_seeds(kind, inits):
    """The port's two seeds at JAX's initial weights (``inits``, one tree
    a seed), as ``init_multiseed_states`` builds them."""
    params = make_params(**JAX_PARAMS)

    def init(seed):
        model = build_model(params, kind, device='cpu')
        model.load_state_dict(state_dict_from_jax(
            inits[SEEDS.index(seed)], baseline=kind == 'baseline'),
            strict=True)
        return model
    return params, init_multiseed_states(init, SEEDS, params,
                                         steps_per_epoch=2)


@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_two_updates_match_jax_multiseed_step(jax_refs, kind):
    ref = jax_refs[kind]
    params, ported = _port_seeds(kind, ref['init'])
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    multi = make_multiseed_train_step(
        [make(s.model, s, params) for s in ported.states], 2)
    gens = tuple(torch.Generator().manual_seed(i) for i in range(2))
    cond = None
    for n in range(UPDATES):
        metrics = multi(make_batch(params, n, host_pair=True,
                                   keys=TRAIN_KEYS_OF[kind]), *gens)
        assert metrics['loss'].shape == (2,)
        np.testing.assert_allclose(metrics['loss'].numpy(), ref['loss'][n],
                                   rtol=2e-4)
        if cond is None:  # the first update's gradients, above f32 noise
            cond = [{k: (p.grad.abs() >= 1e-5).numpy()
                     for k, p in s.model.named_parameters()}
                    for s in ported.states]
        for i in range(2):
            want = state_dict_from_jax(ref['params'][n][i],
                                       baseline=kind == 'baseline')
            got = ported.states[i].model.state_dict()
            assert got.keys() == want.keys()
            for k, v in got.items():
                g, w, m = v.numpy(), want[k].numpy(), cond[i][k]
                np.testing.assert_allclose(
                    g[m], w[m], atol=2e-6, rtol=5e-3,
                    err_msg=f'seed {i} {k} after update {n + 1}')
                if (~m).any():
                    assert np.abs(g[~m] - w[~m]).max() <= \
                        2 * LR * (n + 1) + 1e-6
    assert ported.step == UPDATES


def test_valid_step_per_seed_matches_jax(jax_refs):
    """JAX ``test_multiseed_valid_step``: each seed's outputs at its own
    weights, the pseudo video its video (1e-5; pred_time exact), through
    the driver's path: each seed's eval pass (``cli._eval_epoch``, which
    ``cli.run_valid`` runs) under ``make_multiseed_valid_step``, as
    ``cli._train`` runs its valid passes."""
    want = jax_refs['gmd']['valid']
    params, ported = _port_seeds('gmd', jax_refs['gmd']['init'])
    valid = make_multiseed_valid_step(
        [functools.partial(cli._eval_epoch,
                           make_gmd_valid_step(s.model, params))
         for s in ported.states])
    batch = make_batch(params, VALID_SEED, whole=True, keys=TRAIN_KEYS)
    passes = valid([batch], None, CPU, TRAIN_KEYS,
                   generator=torch.Generator().manual_seed(VALID_SEED))
    got = {k: np.stack([fetched[k][0] for _, fetched in passes])
           for k in passes[0][1]}
    assert got['pred_time'].shape == (2, B, 2)
    np.testing.assert_array_equal(got['pred_time'], want['pred_time'])
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'miou', 'score'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_non_finite_loss_writes_no_emergency_checkpoint(corpus, jax_refs):
    """JAX's watchdog under multi-seed hands the stacked state to its
    serialiser, whose ``int()`` of the [S] update count raises
    ``TypeError`` before a file is opened; the port writes no emergency
    checkpoint either and raises ``FloatingPointError``."""
    assert jax_refs['gmd']['emergency'] == ('TypeError', [])
    argv, root, _ = corpus
    with pytest.raises(FloatingPointError, match='non-finite loss'):
        _drive(corpus, 'ms_nan', 'GMD', '--multi_seed', '2', '--optim',
               'sgd', '--lr', 'nan', '--nan_check_interval', '1')
    assert os.listdir(os.path.join(root, 'runs', 'ms_nan', 'model')) == []


# --- on the card -----------------------------------------------------------------------

def _multi_chunks(params, bank, batches, sizes, device, graphed):
    """An S=2 GMD step over ``bank`` run in chunks of ``sizes``: (the
    seeds' states, chunk means, generators)."""
    steps, gens = [], []
    for i in range(2):
        model = cli._seeded_model(params, device, 'gmd', i)
        state = TrainState(model, params, steps_per_epoch=10)
        steps.append(make_gmd_train_step(model, state, params,
                                         assembler=bank.assemble))
        gens.append(torch.Generator(device).manual_seed(seed_of(7, i)))
    step = cli._multiseed_step(steps)
    run = cli._banked_train_chunks_factory(step, bank, device, graphed)
    means, at = [], 0
    for n in sizes:
        means.append(run(batches[at:at + n], *gens))
        at += n
    return step, step.state, means, gens


@pytest.mark.requires_cuda
def test_graphed_multiseed_chunks_equal_eager_on_cuda(corpus):
    """S=2 chunks over the corpus's batches (2 eager warm-up steps, a
    capture of both seeds' updates in one graph, replays) against the
    same chunks run eagerly: both seeds' weights and Adam state, the
    chunk means and both generators, bit for bit."""
    dev = torch.device('cuda', 0)
    argv, _, _ = corpus
    params = cli.parse_params(argv + ['--device', 'cuda'],
                              default_model='GMD')
    ds = cli.make_dataset(params, 'train_data', 'train_featpath', 'train')
    bank = device_bank.maybe_device_bank(params, ds, dev)
    batches = list(BatchLoader(ds, 8, shuffle=False, prefetch=0,
                               device_assemble=True))
    sizes = (3, len(batches) - 3)  # 2 warm-up steps, the capture, replays
    assert sizes[1] >= 2
    g_step, g_state, g_means, g_gens = _multi_chunks(
        params, bank, batches, sizes, dev, graphed=True)
    assert len(g_step.graphs) == 1
    e_step, e_state, e_means, e_gens = _multi_chunks(
        params, bank, batches, sizes, dev, graphed=False)
    for a, b in zip(g_means, e_means):
        for k in GMD_METRICS:
            assert torch.equal(a[k], b[k]), k
    for sa, sb, ga, gb in zip(g_state.states, e_state.states, g_gens,
                              e_gens):
        assert sa.step == sb.step == len(batches)
        for k, v in sa.model.state_dict().items():
            assert torch.equal(v, sb.model.state_dict()[k]), k
        oa, ob = sa.optimizer.state_dict(), sb.optimizer.state_dict()
        for i in oa['state']:
            for k, v in oa['state'][i].items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(ob['state'][i][k]))
        assert torch.equal(ga.get_state(), gb.get_state())
