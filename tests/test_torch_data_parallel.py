"""The port's data axis (``parallel/mesh.py``) on the CPU over gloo.

Two ranks, started once for the module by ``tests/dp_group.py``
(``torchrun --standalone --nproc_per_node 2``, a 240 s deadline and one
restart), run at small widths (H=8, T=24, D=32, N=8), 4 rows a rank:

- (a) the port's ``BatchLoader`` stripes equal JAX's, index for index
  and with its ``n_valid``, for 1-4 processes and uneven corpora (numpy,
  no ranks);
- (b) 3 GMD train steps at 2 ranks x 2 rows, dropout on and pseudo videos
  drawn on the device, against the single-process step at 4 rows: step-1
  loss rtol 1e-5, each parameter's relative L2 within 1e-4 after 3 Adam
  steps, both ranks' parameters equal bit for bit;
- (c) the GMD and baseline steps at 2 ranks against JAX's step on a
  2-device CPU mesh at shared weights (dropout 0, JAX's pseudo stream),
  within ``tests/test_torch_train.py``'s tolerances;
- (d) ``main_test`` at 2 ranks, on the bank and without it: the merged
  ``.part{rank}`` submits equal the single-process submit, prediction for
  prediction, and so does the R@1/mIoU table; ``merge_submits`` equals
  ``tools/merge_submits.merge``;
- (e) ``python -m shufflingvideosfortsg_torch.train`` under torchrun
  (rank 0 writes the one checkpoint, each rank its part), ``main_train``
  on the bank against the single-process run at the global batch within
  (b)'s tolerance, and ``--start_from`` of its checkpoint on both ranks;
- (f) ``--multi_seed 2`` at 2 ranks against its single-process run, and
  ``--multi_seed`` with ``--fsdp`` refused with JAX's message;
- the baseline trainer at 2 ranks against its single-process run;
- (h) a ``mesh_shape`` that disagrees with the world size raises;
- (i) ``precision: bf16``: one GMD step at 2 ranks x 2 rows (dropout on,
  pseudo videos drawn on the device) against the one-process step at 4
  rows, at the bf16 bounds of a train step (``PERF.md`` §2): the loss and
  its terms 2^-6 relative, each gradient 2^-5 relative L2, each
  parameter's move by the update within 2 lr of the one process's and
  the same way where the gradient is large
  (``test_torch_bf16_train.hold_bf16_moves``); the ranks bit for bit.

On a card (``requires_cuda``, ``--noconftest``): the graphed ``main_train``
on a bank in a one-rank NCCL group against the run with no group, bit
for bit.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
import dp_group
from shufflingvideosfortsg_torch import merge_submits
from shufflingvideosfortsg_torch.data.pipeline import BatchLoader
from shufflingvideosfortsg_torch.eval.iou import retrieval_eval
from shufflingvideosfortsg_torch.parallel.mesh import create_mesh
# the bf16 bounds of a train step
from test_torch_bf16_train import GRAD_REL_L2 as BF16_REL_L2
from test_torch_bf16_train import LOSS_RTOL as BF16_LOSS_RTOL
from test_torch_bf16_train import hold_bf16_moves
from torch_one_thread import one_torch_thread  # noqa: F401

TINY = ['--cfg', 'charades_cd_i3d.yml', '--video_feature_dim', '32',
        '--video_len', '24', '--sent_len', '8', '--sent_rnn_hiddendim', '8',
        '--video_rnn_hiddendim', '8', '--mlp_hidden_dim', '8',
        '--m_pred_hidden', '16', '--batch_log_interval', '1']
LOCAL, GLOBAL = ['--batch_size', '4', '4', '4'], ['--batch_size', '8', '8', '8']
LOSS_RTOL, PARAM_REL_L2 = 1e-5, 1e-4
# the biases added to every start or end logit before the softmax over
# the clips: their gradient is 0 in exact arithmetic and f32 rounding
# noise in practice, which Adam scales up to a step of up to lr either
# way; they are held within Adam's largest drift (2 lr a step), as
# tests/test_torch_train.py holds its sub-noise-floor elements
SHIFT_INVARIANT = ('span_predictor.predictor.start_mlp_2.bias',
                   'span_predictor.predictor.end_mlp_2.bias')


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def write_dp_corpus(root):
    """argv of a corpus of 8 videos x 4 sentences (32: full global batches
    of 8) for train and valid, and a test split of 29 of them (uneven
    stripes); its npy features, its f16 pack."""
    from shufflingvideosfortsg_torch import cli
    params = cli.parse_params(TINY, default_model='GMD')
    anno, feats, vocab, n = chip_smoke.write_corpus(
        root, params, n_videos=8, sentences_per_video=4,
        name='charades_train.json')
    assert n == 32
    shutil.copy(anno, os.path.join(root, 'charades_val.json'))
    with open(anno) as f:
        test = json.load(f)
    for vid in ('V0001', 'V0004', 'V0006'):
        for key in ('sentences', 'timestamps', 'framestamps'):
            test[vid][key] = test[vid][key][:-1]
    with open(os.path.join(root, 'charades_test_ood.json'), 'w') as f:
        json.dump(test, f)
    pack = chip_smoke.write_pack(root, 'f16', 8, 24, 32)
    argv = TINY + ['--runs', os.path.join(root, 'runs'),
                   '--train_data', anno,
                   '--val_data', os.path.join(root, 'charades_val.json'),
                   '--test_data', os.path.join(root, 'charades_test_ood.json'),
                   '--wordtoix_path', vocab['wordtoix'],
                   '--ixtoword_path', vocab['ixtoword'],
                   '--word_fts_path', vocab['word_glove_fts_init'],
                   '--device', 'cpu']
    return argv, feats, pack


def feat_argv(path):
    return ['--train_featpath', path, '--valid_featpath', path,
            '--test_featpath', path]


def step_inputs(root):
    """The step cases' inputs, saved for the ranks: (b) port weights with
    dropout and the device's pseudo draws; (c) JAX's weights, dropout 0
    and JAX's pseudo stream, GMD and the baseline."""
    import test_torch_baseline as tb
    import test_torch_train as tt

    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.steps import (HOST_PAIR_KEYS,
                                                         STEP_KEYS,
                                                         TRAIN_KEYS)
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    paths = {}
    b = tt._batch()
    params = tt._params(on_device_aug=True, dropout=0.5, disc_dropout=0.5)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        weights = build_model(params, 'gmd', device='cpu').state_dict()
    cases = {'b': (params, weights, {k: b[k] for k in TRAIN_KEYS}),
             'bf16': (dict(params, precision='bf16'), weights,
                      {k: b[k] for k in TRAIN_KEYS})}
    params = tt._params()
    _, jweights = tt._jax_setup(params)
    cases['c_gmd'] = (params, state_dict_from_jax(jweights),
                      {k: b[k] for k in HOST_PAIR_KEYS})
    jax_models = {'c_gmd': jweights}
    params = tb._params()
    import jax
    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.models import build_model as jax_build
    jweights = jax.tree.map(np.asarray, jax_cli.init_model_params(
        jax_build(params, 'baseline'), params, jax.random.PRNGKey(5),
        'baseline'))
    bb = tb._batch()
    cases['c_baseline'] = (params, state_dict_from_jax(jweights,
                                                       baseline=True),
                           {k: bb[k] for k in STEP_KEYS})
    jax_models['c_baseline'] = jweights
    for name, (params, weights, batch) in cases.items():
        paths[name] = os.path.join(root, f'steps_{name}.pt')
        torch.save({'params': params, 'weights': weights,
                    'batch': {k: torch.from_numpy(np.array(v))
                              for k, v in batch.items()}}, paths[name])
    return paths, jax_models, {'gmd': b, 'baseline': bb}


TASKS = ['entry', 'gmd', 'resume', 'baseline', 'multiseed', 'test_bank',
         'test_npy', 'step_b', 'step_c_gmd', 'step_c_baseline', 'mesh_shape',
         'step_bf16']


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The two ranks' results by task (started here, waited for by the
    first test that asks), the corpus, the step inputs and the root."""
    root = str(tmp_path_factory.mktemp('torch_dp'))
    argv, feats, pack = write_dp_corpus(root)
    inputs, jax_models, batches = step_inputs(root)
    ab = argv + LOCAL
    tasks = [
        ['driver', {'argv': ab + feat_argv(feats) + [
            '--alias', 'dp_entry', '--epoch', '1'], 'entry': 'train',
            'module': 'shufflingvideosfortsg_torch.train'}],
        ['driver', {'argv': ab + feat_argv(pack) + [
            '--alias', 'dp_gmd', '--epoch', '1'], 'entry': 'train'}],
        ['driver', {'argv': ab + feat_argv(pack) + [
            '--alias', 'dp_resume', '--epoch', '1', '--start_from',
            resume_from(root)], 'entry': 'train'}],
        ['driver', {'argv': ab + feat_argv(feats) + [
            '--alias', 'dp_base', '--epoch', '1'], 'kind': 'baseline',
            'entry': 'train',
            'module': 'shufflingvideosfortsg_torch.train_baseline'}],
        ['driver', {'argv': ab + feat_argv(pack) + [
            '--alias', 'dp_ms', '--epoch', '1', '--multi_seed', '2'],
            'entry': 'train'}],
        ['driver', {'argv': ab + feat_argv(pack) + ['--alias', 'test_dp_bank'],
                    'entry': 'test'}],
        ['driver', {'argv': ab + feat_argv(feats) + ['--alias', 'test_dp_npy'],
                    'entry': 'test'}],
        ['steps', {'inputs': inputs['b'], 'generator_seed': 11}],
        ['steps', {'inputs': inputs['c_gmd']}],
        ['steps', {'inputs': inputs['c_baseline'], 'kind': 'baseline'}],
        ['mesh_shape_error', {}],
        ['steps', {'inputs': inputs['bf16'], 'generator_seed': 11, 'n': 1,
                   'grads': True}],
    ]
    group = dp_group.launch(os.path.join(root, 'ranks'), tasks)
    cache = {}

    def results():
        if not cache:
            per_rank = group.results()
            cache.update({name: [r[i] for r in per_rank]
                          for i, name in enumerate(TASKS)})
        return cache

    from shufflingvideosfortsg_torch import cli
    updates = 32 // 8  # an epoch's updates at the global batch
    drift = 2 * float(cli.parse_params(argv)['lr']) * updates
    return dict(results=results, argv=argv, feats=feats, pack=pack,
                inputs=inputs, jax=jax_models, batches=batches, root=root,
                drift=drift)


def resume_from(root):
    """Rank 0's checkpoint of the 2-rank GMD run, which the resumed run
    starts from."""
    return os.path.join(root, 'runs', 'dp_gmd', 'model', 'dp_gmd_00000.ckp')


def one_process(argv, kind='gmd', entry='train'):
    """The single-process run of ``dp_group.driver``'s task."""
    return dp_group.driver(argv, kind, entry)


def rel_l2(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / max(want.norm(), 1e-12))


def assert_ranks_equal(weights):
    for k, v in weights[0].items():
        assert torch.equal(v, weights[1][k]), k


def assert_close_weights(got, want, what, drift=None):
    """Each parameter within PARAM_REL_L2; with ``drift`` (2 lr x the
    updates) the SHIFT_INVARIANT ones within it instead."""
    assert set(got) == set(want)
    for k, v in want.items():
        if drift is not None and k in SHIFT_INVARIANT:
            err = float((got[k] - v).abs().max())
            assert err <= drift, f'{what}: {k} moved {err:.3e} apart'
            continue
        err = rel_l2(got[k], v)
        assert err <= PARAM_REL_L2, f'{what}: {k} relative L2 {err:.3e}'


def ckp(run, epoch, suffix=''):
    alias = os.path.basename(run)
    return torch.load(os.path.join(run, 'model',
                                   f'{alias}_{epoch:05d}{suffix}.ckp'),
                      map_location='cpu', weights_only=True)


# --- (a) stripes ---------------------------------------------------------------

class _Rows:
    """A dataset stand-in: ``build_record`` gives the sample's index (and
    one token, which the port's loader embeds)."""

    vocab = type('Vocab', (), {'embeddings': np.zeros((1, 1), np.float32)})

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def build_record(self, i, host_pair_aug=False):
        return {'index': np.int64(i), 'token_ids': np.zeros(1, np.int64)}


@pytest.mark.parametrize('count', [1, 2, 3, 4])
@pytest.mark.parametrize('n', [4, 13, 29, 32])
def test_loader_stripes_equal_jax(count, n):
    from shufflingvideosfortsg_tpu.data.pipeline import \
        BatchLoader as JaxLoader
    for shuffle in (False, True):
        for index in range(count):
            kw = dict(batch_size=3, shuffle=shuffle, seed=5, prefetch=0,
                      process_index=index, process_count=count)
            port = BatchLoader(_Rows(n), **kw)
            jax_loader = JaxLoader(_Rows(n), embed_tokens=False, **kw)
            assert len(port) == len(jax_loader)
            for epoch in range(2):
                got = [(b['index'].tolist(), b['n_valid']) for b in port]
                want = [(b['index'].tolist(), b['n_valid'])
                        for b in jax_loader]
                assert got == want, (index, count, epoch)


def test_stripes_deal_the_global_batches():
    """The ranks' batch i together hold the single process's batch i at
    the global batch, rank r its rows r, r + P, ...: the row layout the
    data-parallel draws keep (``parallel/mesh.uniform``)."""
    one = [b['index'] for b in BatchLoader(_Rows(24), 8, True, seed=3,
                                           prefetch=0)]
    ranks = [[b['index'] for b in BatchLoader(
        _Rows(24), 4, True, seed=3, prefetch=0, process_index=r,
        process_count=2)] for r in range(2)]
    for i, whole in enumerate(one):
        for r in range(2):
            np.testing.assert_array_equal(ranks[r][i], whole[r::2])


# --- the mesh --------------------------------------------------------------------

def test_mesh_without_a_group_is_one_rank_and_checks_mesh_shape():
    mesh = create_mesh(None, 'cpu')
    assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, False)
    assert create_mesh([1], 'cpu').world == 1
    with pytest.raises(ValueError, match='holds 2 devices'):
        create_mesh([2], 'cpu')


def test_mesh_shape_that_disagrees_with_the_group_raises(ranks):
    errors = [r['error'] for r in ranks['results']()['mesh_shape']]
    assert all(e and 'holds 4 devices, the process group 2 ranks' in e
               for e in errors), errors


# --- (b), (c) steps --------------------------------------------------------------

def _one_process_steps(inputs, kind='gmd', generator_seed=None, n=3,
                       grads=None):
    """The one-process run of ``n`` steps on the inputs' whole batch:
    (metrics, state dict); a dict ``grads`` receives the last step's
    gradients."""
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import (
        make_baseline_train_step, make_gmd_train_step)
    data = torch.load(inputs, weights_only=False)
    model = build_model(data['params'], kind, device='cpu')
    model.load_state_dict(data['weights'], strict=True)
    state = TrainState(model, data['params'], steps_per_epoch=2)
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    step = make(model, state, data['params'])
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    metrics = [{k: float(v) for k, v in step(data['batch'], gen).items()}
               for _ in range(n)]
    if grads is not None:
        grads.update({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()})
    return metrics, model.state_dict()


def test_gmd_step_at_two_ranks_equals_one_process(ranks):
    got = ranks['results']()['step_b']
    metrics, weights = _one_process_steps(ranks['inputs']['b'],
                                          generator_seed=11)
    assert_ranks_equal([r['weights'] for r in got])
    for r in got:
        assert r['metrics'] == got[0]['metrics']  # the global means
    np.testing.assert_allclose(got[0]['metrics'][0]['loss'],
                               metrics[0]['loss'], rtol=LOSS_RTOL)
    for k in ('loss_g', 'loss_intra', 'loss_inter', 'loss_d', 'miou'):
        np.testing.assert_allclose(got[0]['metrics'][0][k], metrics[0][k],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert_close_weights(got[0]['weights'], weights, 'after 3 steps')


def test_bf16_gmd_step_at_two_ranks_equals_one_process(ranks):
    """(i) one bf16 GMD step at 2 ranks x 2 rows against one process at 4
    rows: the loss and its terms (a term below one bf16 rounding of the
    loss within that rounding), the gradients, the parameters."""
    got = ranks['results']()['step_bf16']
    grads = {}
    metrics, weights = _one_process_steps(ranks['inputs']['bf16'],
                                          generator_seed=11, n=1,
                                          grads=grads)
    assert_ranks_equal([r['weights'] for r in got])
    assert_ranks_equal([r['grads'] for r in got])
    assert got[0]['metrics'] == got[1]['metrics']
    ulp = 2.0 ** -8 * abs(metrics[0]['loss'])
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'):
        want = metrics[0][k]
        assert abs(got[0]['metrics'][0][k] - want) <= max(
            BF16_LOSS_RTOL * abs(want), ulp if k != 'loss' else 0.0), k
    for k, g in grads.items():
        assert rel_l2(got[0]['grads'][k], g) <= BF16_REL_L2, k
    data = torch.load(ranks['inputs']['bf16'], weights_only=False)
    hold_bf16_moves('bf16 step', got[0]['weights'], weights, data['weights'],
                    grads, float(data['params']['lr']),
                    float(data['params']['weight_decay']))


def _jax_mesh_steps(kind, params, weights, batch, n=3):
    """JAX's train step on a 2-device data mesh: (metrics, params)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from shufflingvideosfortsg_tpu.models import build_model as jax_build
    from shufflingvideosfortsg_tpu.parallel.mesh import (DATA_AXIS,
                                                         create_mesh as jmesh,
                                                         replicate_tree)
    from shufflingvideosfortsg_tpu.train import state as jax_state
    from shufflingvideosfortsg_tpu.train import steps as jax_steps
    if len(jax.devices()) < 2:
        pytest.skip('needs 2 JAX devices')
    mesh = jmesh([2])
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    jb = {k: jax.device_put(jnp.asarray(v), sharding)
          for k, v in batch.items()}
    model = jax_build(params, kind)
    make = (jax_steps.make_gmd_train_step if kind == 'gmd'
            else jax_steps.make_baseline_train_step)
    step = make(model, params)
    state = replicate_tree(mesh, jax_state.create_train_state(
        weights, jax_state.make_optimizer(params, steps_per_epoch=2)))
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(n):
        state, aux = step(state, jb, key)
        out.append({k: float(v) for k, v in aux.items()
                    if np.ndim(v) == 0})
    return out, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_step_at_two_ranks_equals_jax_on_a_two_device_mesh(ranks, kind):
    """Tolerances of tests/test_torch_train.py: loss rtol 2e-4, miou atol
    1e-6, parameters atol 2e-6 rtol 5e-3 where the step-1 gradient is
    above 1e-5 and within Adam's largest drift (2 lr a step) elsewhere;
    the gradient's size is taken from JAX's first step."""
    import jax

    import test_torch_baseline as tb
    import test_torch_train as tt
    from shufflingvideosfortsg_tpu.train.steps import \
        make_gmd_train_step as jax_gmd_step
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    from shufflingvideosfortsg_tpu.models import build_model as jax_build
    from shufflingvideosfortsg_tpu.ops import losses as jax_losses
    name = f'c_{kind}'
    got = ranks['results']()[f'step_{name}']
    assert_ranks_equal([r['weights'] for r in got])
    params = tt._params() if kind == 'gmd' else tb._params()
    weights = ranks['jax'][name]
    batch = ranks['batches'][kind]
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    jm = jax_build(params, kind)
    if kind == 'gmd':
        _, g = jax.value_and_grad(jax_gmd_step(jm, params).loss_fn,
                                  has_aux=True)(weights, jb, tt._jax_pseudo(
                                      batch), jax.random.PRNGKey(0))
    else:
        def loss(p):
            out = jm.apply({'params': p}, jb['video_feat'], jb['sent_feat'],
                           jb['video_mask'], jb['sent_mask'])
            return jax_losses.span_ground_loss(
                out['start_prob'], out['end_prob'], jb['framestps'])
        g = jax.grad(loss)(weights)
    grads = state_dict_from_jax(jax.tree.map(np.asarray, g),
                                baseline=kind == 'baseline')
    metrics, want = _jax_mesh_steps(kind, params, weights, batch)
    want = state_dict_from_jax(want, baseline=kind == 'baseline')
    lr = float(params['lr'])
    for n, (m, w) in enumerate(zip(got[0]['metrics'], metrics)):
        np.testing.assert_allclose(m['loss'], w['loss'], rtol=2e-4,
                                   err_msg=f'update {n + 1}')
        np.testing.assert_allclose(m['miou'], w['miou'], atol=1e-6)
    for k, v in got[0]['weights'].items():
        g, w = v.numpy(), want[k].numpy()
        cond = np.abs(grads[k].numpy()) >= 1e-5
        np.testing.assert_allclose(g[cond], w[cond], atol=2e-6, rtol=5e-3,
                                   err_msg=k)
        if (~cond).any():
            assert np.abs(g[~cond] - w[~cond]).max() <= 2 * lr * 3 + 1e-6


# --- (d) evaluation ----------------------------------------------------------------

def _rows(submit):
    return {vid: sorted(json.dumps(r, sort_keys=True) for r in rows)
            for vid, rows in submit['results'].items()}


@pytest.mark.parametrize('where', ['bank', 'npy'])
def test_test_driver_parts_merge_to_the_one_process_submit(ranks, where):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'tools_merge_submits', os.path.join(os.path.dirname(chip_smoke.__file__),
                                            'tools', 'merge_submits.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    got = ranks['results']()[f'test_{where}']
    parts = [r['submit'] for r in got]
    assert [p.endswith(f'.part{r}.json') for r, p in enumerate(parts)] == \
        [True, True]
    feats = ranks['pack'] if where == 'bank' else ranks['feats']
    want = one_process(ranks['argv'] + LOCAL + feat_argv(feats) + [
        '--alias', f'test_one_{where}'], entry='test')['submit']
    merged = merge_submits.merge(parts)
    assert merged == tool.merge(parts)
    with open(want) as f:
        single = json.load(f)
    assert _rows(merged) == _rows(single)
    assert sum(map(len, merged['results'].values())) == 29
    out = os.path.join(ranks['root'], f'merged_{where}.json')
    assert merge_submits.main([out] + parts) == 0
    assert retrieval_eval(out) == retrieval_eval(want)


# --- (e), (f) the drivers -------------------------------------------------------------

def test_torchrun_of_the_train_entry_point(ranks):
    """``python -m shufflingvideosfortsg_torch.train`` under torchrun: one
    checkpoint (rank 0's), one valid part a rank, rank 0's metrics."""
    ranks['results']()
    run = os.path.join(ranks['root'], 'runs', 'dp_entry')
    assert sorted(os.listdir(os.path.join(run, 'model'))) == \
        ['dp_entry_00000.ckp', 'dp_entry_00000.state.pt']
    assert sorted(os.listdir(os.path.join(run, 'submits'))) == [
        f'dp_entry_00000_charades_val.part{r}.json' for r in range(2)]
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        assert [json.loads(line)['phase'] for line in f] == ['train', 'valid']


@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_trainer_at_two_ranks_equals_one_process(ranks, kind):
    """Rank 0's checkpoint against the single-process run at the global
    batch: each parameter within (b)'s relative L2, the epoch's mean loss
    likewise; both ranks' weights bit for bit; GMD on the bank in chunks,
    the baseline batch by batch through ``python -m
    shufflingvideosfortsg_torch.train_baseline``."""
    got = ranks['results']()['gmd' if kind == 'gmd' else 'baseline']
    assert_ranks_equal([r['weights'][0] for r in got])
    alias = 'dp_gmd' if kind == 'gmd' else 'dp_base'
    feats = ranks['pack'] if kind == 'gmd' else ranks['feats']
    want = one_process(ranks['argv'] + GLOBAL + feat_argv(feats) + [
        '--alias', alias + '_one', '--epoch', '1'], kind)
    saved = ckp(got[0]['run'], 0)
    for k, v in got[0]['weights'][0].items():
        assert torch.equal(saved[k], v), k
    assert_close_weights(saved, ckp(want['run'], 0), kind, ranks['drift'])
    # the epoch's mean train loss, from each run's metrics.jsonl
    losses = []
    for run in (got[0]['run'], want['run']):
        with open(os.path.join(run, 'metrics.jsonl')) as f:
            losses.append(json.loads(f.readline())['loss'])
    np.testing.assert_allclose(losses[0], losses[1], rtol=PARAM_REL_L2)


def test_start_from_broadcasts_to_both_ranks(ranks):
    """A resumed 2-rank run from rank 0's checkpoint: both ranks start
    from its weights and state, so they end equal, and equal to the
    single-process run resumed from the same file."""
    got = ranks['results']()['resume']
    start = resume_from(ranks['root'])
    weights = [r['weights'][0] for r in got]
    assert_ranks_equal(weights)
    want = one_process(ranks['argv'] + GLOBAL + feat_argv(ranks['pack']) + [
        '--alias', 'dp_resume_one', '--epoch', '1', '--start_from', start])
    assert_close_weights(weights[0], want['weights'][0], 'resumed',
                         ranks['drift'])


def test_multi_seed_at_two_ranks_equals_one_process(ranks):
    got = ranks['results']()['multiseed']
    for i in range(2):
        assert_ranks_equal([r['weights'][i] for r in got])
    want = one_process(ranks['argv'] + GLOBAL + feat_argv(ranks['pack']) + [
        '--alias', 'dp_ms_one', '--epoch', '1', '--multi_seed', '2'])
    for i in range(2):
        assert_close_weights(ckp(got[0]['run'], 0, f'_s{i}'),
                             ckp(want['run'], 0, f'_s{i}'), f'seed {i}',
                             ranks['drift'])


def test_multi_seed_with_fsdp_is_refused_with_jax_message(ranks):
    from shufflingvideosfortsg_torch import cli
    params = cli.parse_params(ranks['argv'] + LOCAL + feat_argv(
        ranks['feats']) + ['--alias', 'refused', '--multi_seed', '2',
                           '--fsdp'], default_model='GMD')
    with pytest.raises(ValueError, match='does not compose with --fsdp'):
        cli.main_train(params)


# --- on the card ------------------------------------------------------------------

@pytest.mark.requires_cuda
def test_one_rank_nccl_graphed_training_equals_no_group(tmp_path):
    """``main_train`` graphed on a bank in a one-rank NCCL group (the
    all-reduces captured in the chunks' CUDA graph) against the same run
    with no process group: checkpoint and generators bit for bit."""
    assert chip_smoke.ddp_one_rank_check(str(tmp_path), tiny=True)
