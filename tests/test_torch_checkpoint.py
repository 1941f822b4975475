"""The port's full-state checkpoints (``utils/saver.py``) and resumed
training steps.

- a checkpoint round trip: the reference ``.ckp`` and its sidecar (the
  train state and the generators) back bit for bit, and a ``.ckp``
  without a sidecar read as weights only;
- ``latest_checkpoint`` against the JAX package's on the same directory;
- ``AsyncCheckpointer`` writes what a synchronous save writes, and a
  writer's error is raised by ``wait`` and by the next save;
- the JAX package's ``load_checkpoint`` still reads the ``.ckp`` as a
  reference checkpoint, to the same weights, with the sidecar beside it;
- ``TrainState.load_state_dict`` fills the optimizer's tensors in place;
- a resumed step: one step, save, load into a new model and state, one
  step, equals two straight steps bit for bit (Adam, AdamW and SGD,
  dropout and device-made pseudo videos on); and matches JAX's one step,
  ``save_checkpoint``, ``restore_train_state``, one step within
  ``tests/test_torch_train.py``'s tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _same_tree
from shufflingvideosfortsg_tpu.train import state as jax_state
from shufflingvideosfortsg_tpu.train.steps import \
    make_gmd_train_step as jax_train_step
from shufflingvideosfortsg_tpu.utils import saver as jax_saver
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (HOST_PAIR_KEYS,
                                                     TRAIN_KEYS,
                                                     make_gmd_train_step)
from shufflingvideosfortsg_torch.utils import saver
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from test_torch_train import (_batch, _conditioned, _jax_setup, _params,
                              _port_model, _t)
from torch_one_thread import one_torch_thread  # noqa: F401

LR = 1e-3


@pytest.fixture(scope='module')
def weights():
    return _jax_setup(_params())[1]


def _trainer(params, weights, seed=11):
    model = _port_model(params, weights)
    state = TrainState(model, params, steps_per_epoch=4)
    step = make_gmd_train_step(model, state, params)
    return model, state, step, {'train': torch.Generator().manual_seed(seed),
                                'valid': torch.Generator().manual_seed(99)}


def _stepped(params, weights, n=1, batch_keys=TRAIN_KEYS):
    model, state, step, gens = _trainer(params, weights)
    b = _batch()
    for _ in range(n):
        step({k: _t(b[k]) for k in batch_keys}, gens['train'])
    return model, state, step, gens


def _run_manager(tmp_path, **over):
    return saver.RunManager(dict(runs=str(tmp_path), alias='ck', **over))


def test_checkpoint_round_trip(weights, tmp_path):
    params = _params(on_device_aug=True, dropout=0.5)
    model, state, _, gens = _stepped(params, weights, n=2)
    path = _run_manager(tmp_path).save_checkpoint(3, model, state, gens)
    assert os.path.basename(path) == 'ck_00003.ckp'
    assert os.path.isfile(tmp_path / 'ck' / 'model' / 'ck_00003.state.pt')
    assert not any(n.endswith('.tmp')
                   for n in os.listdir(tmp_path / 'ck' / 'model'))
    got, side, weights_only = saver.load_checkpoint(path)
    assert not weights_only and side['format'] == saver.STATE_FORMAT
    assert _same_tree(got, model.state_dict())
    assert side['train_state']['step'] == state.step == 2
    assert _same_tree(side['train_state'], state.state_dict())
    assert _same_tree(side['generators'],
                 {k: g.get_state() for k, g in gens.items()})
    # a reference .ckp alone: weights only
    os.remove(saver.sidecar_path(path))
    got, side, weights_only = saver.load_checkpoint(path)
    assert weights_only and side is None
    assert _same_tree(got, model.state_dict())


def test_latest_checkpoint_matches_jax(tmp_path):
    model_dir = tmp_path / 'model'
    assert saver.latest_checkpoint(str(model_dir)) is None
    model_dir.mkdir()
    assert saver.latest_checkpoint(str(model_dir)) is None
    for name in ('a_00002.ckp', 'a_00002.state.pt', 'a_00011.state.pt',
                 'a_00010.ckp', 'a_00010.ckp.tmp', 'a_best.ckp', 'notes.txt',
                 'b_00007.ckp'):
        (model_dir / name).write_bytes(b'')
    got = saver.latest_checkpoint(str(model_dir))
    assert got == jax_saver.latest_checkpoint(str(model_dir))
    assert got == (str(model_dir / 'a_00010.ckp'), 10)


def test_async_save_writes_what_a_sync_save_writes(weights, tmp_path):
    params = _params(on_device_aug=True, dropout=0.5)
    model, state, _, gens = _stepped(params, weights, n=1)
    sync = _run_manager(tmp_path / 's')
    lazy = _run_manager(tmp_path / 'a', async_checkpoint=True)
    assert lazy._async is not None and sync._async is None
    paths = [m.save_checkpoint(0, model, state, gens) for m in (sync, lazy)]
    # the snapshot is taken at save: a later update does not reach the file
    before = {k: v.clone() for k, v in model.state_dict().items()}
    b = _batch()
    make_gmd_train_step(model, state, params)(
        {k: _t(b[k]) for k in TRAIN_KEYS}, gens['train'])
    lazy.wait()
    a, s = (saver.load_checkpoint(p) for p in paths)
    assert _same_tree(a, s) and _same_tree(a[0], before)


def test_a_failed_async_write_raises_on_wait(weights, tmp_path):
    model = _port_model(_params(), weights)
    ck = saver.AsyncCheckpointer()
    missing = str(tmp_path / 'no_such_dir' / 'x_00000.ckp')
    ck.save(missing, model)
    with pytest.raises(RuntimeError):
        ck.wait()
    ck.wait()  # raised once
    ck.save(missing, model)
    with pytest.raises(RuntimeError):  # by the next save, which is not made
        ck.save(str(tmp_path / 'x_00001.ckp'), model)
    ck.save(str(tmp_path / 'x_00002.ckp'), model)
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ['x_00002.ckp']


def test_jax_reads_the_ckp_as_a_reference_checkpoint(weights, tmp_path):
    params = _params()
    model, state, _, gens = _stepped(params, weights, n=1,
                                     batch_keys=HOST_PAIR_KEYS)
    path = _run_manager(tmp_path).save_checkpoint(0, model, state, gens)
    assert os.path.isfile(saver.sidecar_path(path))
    payload, is_ref = jax_saver.load_checkpoint(
        path, torch_convert_kwargs=dict(kind='gmd', predictor_name='mlp',
                                        m_temp='none'))
    assert is_ref and payload['opt_state'] is None
    mapped = state_dict_from_jax(jax.tree.map(np.asarray, payload['params']))
    assert _same_tree(mapped, model.state_dict())


def test_train_state_loads_in_place(weights):
    params = _params()
    _, state, _, _ = _stepped(params, weights, n=2, batch_keys=HOST_PAIR_KEYS)
    sd = state.state_dict()
    saved = {'step': sd['step'], 'optimizer': {
        'state': {i: {k: v.clone() for k, v in s.items()}
                  for i, s in sd['optimizer']['state'].items()},
        'param_groups': sd['optimizer']['param_groups']}}
    _, other, _, _ = _stepped(params, weights, n=1, batch_keys=HOST_PAIR_KEYS)
    live = {id(t): t.data_ptr() for s in other.optimizer.state.values()
            for t in s.values()}
    other.load_state_dict(saved)
    assert other.step == 2
    assert _same_tree(other.state_dict()['optimizer']['state'],
                 saved['optimizer']['state'])
    assert {id(t): t.data_ptr() for s in other.optimizer.state.values()
            for t in s.values()} == live
    # into a state that has taken no update yet: the tensors are made
    _, fresh, _, _ = _trainer(params, weights)
    fresh.load_state_dict(saved)
    assert _same_tree(fresh.state_dict()['optimizer']['state'],
                 saved['optimizer']['state'])


@pytest.mark.parametrize('optim', ['adam', 'adamw', 'sgd'])
def test_resumed_step_equals_straight_steps(weights, tmp_path, optim):
    params = _params(on_device_aug=True, dropout=0.5, disc_dropout=0.5,
                     optim=optim, lr=0.05 if optim == 'sgd' else LR)
    b = {k: _t(v) for k, v in _batch().items() if k in TRAIN_KEYS}
    model_a, state_a, step, gens = _trainer(params, weights)
    straight = [step(b, gens['train']) for _ in range(2)]

    model, state, step, gens = _trainer(params, weights)
    first = step(b, gens['train'])
    path = _run_manager(tmp_path).save_checkpoint(0, model, state, gens)
    got, side, _ = saver.load_checkpoint(path)
    model, state, step, gens = _trainer(params, weights, seed=0)
    model.load_state_dict(got)
    state.load_state_dict(side['train_state'])
    for k, g in gens.items():
        g.set_state(side['generators'][k])
    second = step(b, gens['train'])
    assert _same_tree([first, second], straight)
    assert _same_tree(model.state_dict(), model_a.state_dict())
    assert _same_tree(state.state_dict(), state_a.state_dict())


def test_resumed_step_matches_jax(weights, tmp_path):
    """JAX: one step, ``save_checkpoint`` (msgpack), ``load_checkpoint``,
    ``restore_train_state``, one step; the port: one step, its
    checkpoint, a new model and state loaded from it, one step. Dropout
    off and the pseudo stream made by JAX on the host; parameters within
    ``test_train_step_matches_jax``'s tolerances."""
    params = _params()
    jm, _ = _jax_setup(params)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(b[k]) for k in HOST_PAIR_KEYS}
    key = jax.random.PRNGKey(0)
    jstep = jax_train_step(jm, params)
    tx = jax_state.make_optimizer(params, steps_per_epoch=4)
    jstate, _ = jstep(jax_state.create_train_state(weights, tx), jb, key)
    jpath = str(tmp_path / 'jax_00000.ckp')
    jax_saver.save_checkpoint(jpath, jstate, key)
    payload, is_ref = jax_saver.load_checkpoint(jpath)
    assert not is_ref
    jstate = jax_saver.restore_train_state(
        jax_state.create_train_state(weights, tx), payload)
    jstate, jaux = jstep(jstate, jb, key)

    model, state, step, gens = _trainer(params, weights)
    step(tb, None)
    cond = _conditioned({k: p.grad for k, p in model.named_parameters()})
    path = _run_manager(tmp_path).save_checkpoint(0, model, state, gens)
    got, side, _ = saver.load_checkpoint(path)
    model, state, step, _ = _trainer(params, weights)
    model.load_state_dict(got)
    state.load_state_dict(side['train_state'])
    metrics = step(tb, None)
    assert state.step == int(jstate.step) == 2
    np.testing.assert_allclose(float(metrics['loss']), float(jaux['loss']),
                               rtol=2e-4)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, p in model.state_dict().items():
        g, w, m = p.numpy(), want[k].numpy(), cond[k]
        np.testing.assert_allclose(g[m], w[m], atol=2e-6, rtol=5e-3,
                                   err_msg=k)
        if (~m).any():
            assert np.abs(g[~m] - w[~m]).max() <= 2 * LR * 2 + 1e-6
