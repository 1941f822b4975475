"""FSDP in the port (``parallel/fsdp.py``): ZeRO-3 sharding of the train
state over the data axis, on the CPU over gloo at two ranks.

One group of two ranks for the module (``tests/dp_group.py``, a 240 s
deadline and one restart), at small widths:

- each parameter's split axis, or its replication, equals JAX's
  ``sharding_for_leaf`` on a tree of the same shapes (the Adam moments
  share their parameters' shapes, so the same rule places them);
- a rank's resident state is at most half the replicated state plus the
  replicated leaves;
- 3 GMD steps sharded equal 3 replicated data-parallel steps from the
  same weights and draws (loss rtol 1e-5, each parameter and Adam moment
  within a relative L2 of 1e-4), both ranks alike;
- the checkpoint round trip: rank 0 writes the gathered state, whose
  ``.ckp`` holds the full weights; a fresh sharded state resumed from it
  takes the next step as the running one does (as ``tests/test_fsdp.py``
  holds JAX's round trip);
- ``main_train --fsdp`` at 2 ranks against the replicated 2-rank run,
  checkpoint for checkpoint, and ``--start_from`` of its checkpoint;
- ``shard_dim``'s rule on the JAX function's own cases, in one process;
- ``precision: bf16``: 3 sharded GMD steps at 2 ranks against the
  one-process steps at the global batch, at the bf16 bounds of a train
  step (``PERF.md`` §2): each step's loss and its terms 2^-6 relative,
  the gradients of the first update (the reduce-scattered slices
  gathered) 2^-5 relative L2, each parameter's move by that update
  within 2 lr of the one process's and the same way where the gradient
  is large (``test_torch_bf16_train.hold_bf16_moves``), after the third
  every element within 2.5 lr an update (``utils/parity.py``); both
  ranks alike.
"""

import os

import numpy as np
import pytest
import torch

import dp_group
import test_torch_data_parallel as tdp
from shufflingvideosfortsg_torch.parallel.fsdp import shard_dim
from torch_one_thread import one_torch_thread  # noqa: F401

MIN_BYTES = 256  # small enough that the tiny model's matrices split
TASKS = ['steps', 'fsdp_driver', 'replicated_driver', 'fsdp_resume',
         'steps_bf16']


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_fsdp'))
    argv, feats, pack = tdp.write_dp_corpus(root)
    import test_torch_train as tt
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.train.steps import TRAIN_KEYS
    params = tt._params(on_device_aug=True, dropout=0.5, disc_dropout=0.5,
                        video_rnn_hiddendim=32, grad_clip=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        weights = build_model(params, 'gmd', device='cpu').state_dict()
    b = tt._batch()
    inputs = os.path.join(root, 'fsdp_steps.pt')
    torch.save({'params': params, 'weights': weights,
                'batch': {k: torch.from_numpy(np.array(b[k]))
                          for k in TRAIN_KEYS}}, inputs)
    inputs_bf16 = os.path.join(root, 'fsdp_steps_bf16.pt')
    torch.save({'params': dict(params, precision='bf16'), 'weights': weights,
                'batch': {k: torch.from_numpy(np.array(b[k]))
                          for k in TRAIN_KEYS}}, inputs_bf16)
    base = argv + tdp.LOCAL + tdp.feat_argv(pack) + [
        '--epoch', '1', '--fsdp_min_bytes', str(MIN_BYTES)]
    fsdp_ckp = os.path.join(root, 'runs', 'dp_fsdp', 'model',
                            'dp_fsdp_00000.ckp')
    tasks = [
        ['fsdp_steps', {'inputs': inputs, 'min_bytes': MIN_BYTES,
                        'ckpt': os.path.join(root, 'round_trip.ckp')}],
        ['driver', {'argv': base + ['--alias', 'dp_fsdp', '--fsdp'],
                    'entry': 'train'}],
        ['driver', {'argv': base + ['--alias', 'dp_repl'], 'entry': 'train'}],
        ['driver', {'argv': base + ['--alias', 'dp_fsdp_resume', '--fsdp',
                                    '--start_from', fsdp_ckp],
                    'entry': 'train'}],
        ['fsdp_steps', {'inputs': inputs_bf16, 'min_bytes': MIN_BYTES,
                        'ckpt': os.path.join(root, 'round_trip_bf16.ckp'),
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
    return dict(results=results, params=params, weights=weights, root=root,
                argv=base, inputs_bf16=inputs_bf16,
                drift=2 * float(cli.parse_params(argv)['lr']) * updates)


def test_shard_dim_is_jax_rule_on_its_cases():
    assert shard_dim((2, 24, 64), 4, 8, 0) == 2
    assert shard_dim((), 4, 8, 0) is None
    assert shard_dim((300, 33), 4, 8, 0) is None
    assert shard_dim((8, 8), 4, 8, 2**20) is None
    assert shard_dim((64, 64), 4, 1, 0) is None


def test_split_axes_equal_jax_sharding_for_leaf(ranks):
    import jax

    from shufflingvideosfortsg_tpu.parallel.fsdp import sharding_for_leaf
    from shufflingvideosfortsg_tpu.parallel.mesh import DATA_AXIS, create_mesh
    if len(jax.devices()) < 2:
        pytest.skip('needs 2 JAX devices')
    mesh = create_mesh([2])
    plans = [r['sharded']['plan']
             for r in ranks['results']()['steps']]
    assert plans[0] == plans[1]
    shapes = {k: tuple(v.shape) for k, v in ranks['weights'].items()}
    assert set(plans[0]) == set(shapes)
    split = 0
    for name, dim in plans[0].items():
        spec = sharding_for_leaf(np.zeros(shapes[name], np.float32), mesh,
                                 min_bytes=MIN_BYTES).spec
        want = next((i for i, a in enumerate(spec) if a == DATA_AXIS), None)
        assert dim == want, name
        split += dim is not None
    assert split >= 10 and split < len(shapes)


def test_resident_state_is_at_most_half_plus_replicated_leaves(ranks):
    for r in ranks['results']()['steps']:
        s = r
        repl = s['replicated']['resident_bytes']
        sharded = s['sharded']['resident_bytes']
        assert sharded <= repl / 2 + s['sharded']['replicated_leaf_bytes']
        assert sharded < 0.75 * repl


def test_sharded_steps_equal_replicated_steps(ranks):
    got = ranks['results']()['steps']
    tdp.assert_ranks_equal([r['sharded']['weights'] for r in got])
    s = got[0]
    for m, w in zip(s['sharded']['metrics'], s['replicated']['metrics']):
        for k in w:
            np.testing.assert_allclose(m[k], w[k], rtol=tdp.LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
    tdp.assert_close_weights(s['sharded']['weights'],
                             s['replicated']['weights'], 'sharded')
    want_opt = s['replicated']['opt_state']
    assert want_opt.keys() == s['sharded']['opt_state'].keys()
    for i, per in want_opt.items():
        for k, v in per.items():
            err = tdp.rel_l2(s['sharded']['opt_state'][i][k], v)
            assert err <= tdp.PARAM_REL_L2, (i, k, err)


def test_bf16_sharded_steps_equal_one_process(ranks):
    """3 ZeRO-3-sharded bf16 steps at 2 ranks against the one-process
    steps at the global batch, from the same weights and draws: the first
    update's gradients and moves, each update's loss terms, the weights
    after the third."""
    from shufflingvideosfortsg_torch.utils.parity import ADAM_STEPS
    got = ranks['results']()['steps_bf16']
    for part in ('weights', 'grads'):
        tdp.assert_ranks_equal([r['sharded']['step1'][part] for r in got])
    tdp.assert_ranks_equal([r['sharded']['weights'] for r in got])
    s = got[0]['sharded']
    grads = {}
    first, step1 = tdp._one_process_steps(ranks['inputs_bf16'],
                                          generator_seed=11, n=1, grads=grads)
    step1 = {k: v.clone() for k, v in step1.items()}
    metrics, weights = tdp._one_process_steps(ranks['inputs_bf16'],
                                              generator_seed=11)
    assert first[0] == metrics[0]
    assert set(s['step1']['grads']) == set(grads)
    for k, g in grads.items():
        assert tdp.rel_l2(s['step1']['grads'][k], g) <= tdp.BF16_REL_L2, k
    lr = float(ranks['params']['lr'])
    tdp.hold_bf16_moves('bf16 sharded, update 1', s['step1']['weights'],
                        step1, ranks['weights'], grads, lr,
                        float(ranks['params']['weight_decay']))
    for i, m in enumerate(metrics):
        ulp = 2.0 ** -8 * abs(m['loss'])
        for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'):
            assert abs(s['metrics'][i][k] - m[k]) <= max(
                tdp.BF16_LOSS_RTOL * abs(m[k]),
                ulp if k != 'loss' else 0.0), (i, k)
    # after the third update: every element within the parity rule's
    # Adam-step bound (utils/parity.py) of the one process's
    for k, v in weights.items():
        far = (s['weights'][k] - v).abs().max().item() if v.numel() else 0.0
        assert far <= ADAM_STEPS * lr * len(metrics), (k, far)


def test_checkpoint_round_trip(ranks):
    for r in ranks['results']()['steps']:
        s = r['sharded']
        for k, v in s['weights'].items():
            assert torch.equal(s['loaded'][k], v), k
        for k, v in s['continued_metrics'].items():
            assert s['resumed_metrics'][k] == v, k
        for k, v in s['continued_weights'].items():
            assert torch.equal(s['resumed_weights'][k], v), k


def test_fsdp_driver_equals_replicated_driver(ranks):
    res = ranks['results']()
    for task in ('fsdp_driver', 'fsdp_resume'):
        tdp.assert_ranks_equal([r['weights'][0] for r in res[task]])
    fsdp = tdp.ckp(res['fsdp_driver'][0]['run'], 0)
    for k, v in res['fsdp_driver'][0]['weights'][0].items():
        assert torch.equal(fsdp[k], v), k
    tdp.assert_close_weights(fsdp, tdp.ckp(res['replicated_driver'][0]['run'],
                                           0), 'fsdp driver', ranks['drift'])
    side = os.path.join(res['fsdp_driver'][0]['run'], 'model',
                        'dp_fsdp_00000.state.pt')
    assert os.path.isfile(side)


def test_fsdp_resume_continues_from_the_checkpoint(ranks):
    """``--start_from`` of the sharded run's checkpoint with ``--fsdp``:
    both ranks resume the gathered state (one more epoch trains from it),
    and the run equals the replicated single-process run resumed from the
    same file."""
    res = ranks['results']()
    start = os.path.join(res['fsdp_driver'][0]['run'], 'model',
                         'dp_fsdp_00000.ckp')
    want = tdp.one_process(ranks['argv'] + tdp.GLOBAL + [
        '--alias', 'dp_fsdp_resume_one', '--start_from', start])
    tdp.assert_close_weights(res['fsdp_resume'][0]['weights'][0],
                             want['weights'][0], 'fsdp resumed',
                             ranks['drift'])
