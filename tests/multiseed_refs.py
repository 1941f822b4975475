"""The JAX references of tests/test_torch_multiseed.py, computed in child
processes running side by side, and the inputs both sides share.

For GMD and for the QAVE baseline, at tiny widths with dropout off and
host-made pseudo pairs: JAX's S=2 stacked state from
``train/multiseed.init_multiseed_states`` at SEEDS (each seed's initial
weights), the per-seed losses and weights after each of UPDATES updates
of ``make_multiseed_train_step``; for GMD also the per-seed outputs of
``make_multiseed_valid_step`` on a batch whose moments span their videos,
and what JAX's watchdog (``cli._check_finite``) does with the stacked
state. A child traces and compiles one kind's step on the CPU (some ten
seconds each for the init and the vmapped step), so the module starts
both children at its first test and runs its tests that need no
reference while they work. Each child pickles its references as plain
dicts of numpy arrays into the test's temporary directory; a child that
passes its deadline is killed and the wait raises.

JAX is imported inside the children only: the test module imports this
file on a machine without JAX too. Not a test module (pytest collects
``test_*.py`` only). A child runs this file as a script::

    python tests/multiseed_refs.py <output.pkl> <gmd|baseline>
"""

import os
import pickle
import signal
import subprocess
import sys
from collections.abc import Mapping

import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
for _p in (_ROOT, _TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from shufflingvideosfortsg_torch.config import load_config  # noqa: E402
from shufflingvideosfortsg_torch.ops.augment_device import (  # noqa: E402
    device_masks, gt_translate_batch)
from shufflingvideosfortsg_torch.profile_train import \
    train_batch  # noqa: E402
from shufflingvideosfortsg_torch.train.steps import (  # noqa: E402
    HOST_PAIR_KEYS, STEP_KEYS, TRAIN_KEYS)

B, T, N, D = 4, 20, 7, 10
SEEDS = (3, 11)  # JAX tests/test_multiseed.py's
LR = 1e-3
UPDATES = 2
# the references: dropout off and host-made pseudo pairs (the valid step
# draws on the device whatever on_device_aug says)
JAX_PARAMS = dict(dropout=0.0, disc_dropout=0.0, on_device_aug=False)
TRAIN_KEYS_OF = {'gmd': HOST_PAIR_KEYS, 'baseline': STEP_KEYS}
VALID_SEED = 5  # the valid batch's seed and JAX's valid key
# a child's deadline: the references take 20-40 s on a loaded host
DEADLINE_S = 300


def make_params(**overrides):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=D, sent_rnn_hiddendim=8,
                  video_rnn_hiddendim=16, mlp_hidden_dim=8,
                  m_pred_hidden=16, span_hidden_dim=8, video_len=T,
                  sent_len=N, lr=LR, grad_clip_max=0.5)
    params.update(overrides)
    return params


def make_batch(params, seed=0, host_pair=False, whole=False, keys=None):
    """A seeded batch on the CPU (``profile_train.train_batch``); with
    ``host_pair`` the pseudo stream made as the loader makes it (the
    translation at a seeded draw); with ``whole`` every moment spans its
    whole video, so a pseudo video is its video whatever the draw;
    ``keys`` of it (all without)."""
    batch = train_batch(params, B, torch.device('cpu'), seed=seed)
    if whole:
        n = batch['nfeats']
        fs = torch.stack([torch.zeros_like(n), n - 1], -1).int()
        batch.update(framestps=fs, timestps=fs.float(),
                     **device_masks(fs[:, 0], fs[:, 1], n,
                                    params['video_len']))
    if host_pair:
        u = torch.from_numpy(np.random.RandomState(seed + 50).rand(B)
                             .astype(np.float32))
        feat, fs, masks = gt_translate_batch(u, batch['video_feat'],
                                             batch['framestps'],
                                             batch['nfeats'])
        batch.update({'pseudo_video_feat': feat, 'pseudo_framestps': fs,
                      **{'pseudo_' + k: v for k, v in masks.items()}})
    return batch if keys is None else {k: batch[k] for k in keys}


def _plain(tree):
    """A parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def compute(kind, tmp_dir):
    """JAX's references for ``kind`` (see the module docstring)."""
    import logging

    import jax
    import jax.numpy as jnp
    jax.config.update('jax_platforms', 'cpu')  # as tests/conftest.py
    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.train import multiseed as jax_ms
    from shufflingvideosfortsg_tpu.train import state as jax_state
    from shufflingvideosfortsg_tpu.train import steps as jax_steps
    from shufflingvideosfortsg_tpu.utils.saver import RunManager

    def on_jax(batch):
        return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    params = make_params(**JAX_PARAMS)
    jm = build_model(params, kind)
    init = jax.jit(jm.init)  # one compile for both seeds
    video = np.zeros((2, T, D), np.float32)
    sent = np.zeros((2, N, 300), np.float32)
    m_t, m_n = np.ones((2, T), np.int32), np.ones((2, N), np.int32)
    args = ((sent, m_n, video, m_t, video, m_t) + (m_t,) * 6
            if kind == 'gmd' else (video, sent, m_t, m_n))
    tx = jax_state.make_optimizer(params, steps_per_epoch=2)
    stacked = jax_ms.init_multiseed_states(
        lambda key: init(key, *args)['params'], SEEDS, tx)

    def seeds(state):
        return [_plain(jax_ms.unstack_state(state, i).params)
                for i in range(len(SEEDS))]

    ref = {'init': seeds(stacked)}
    if kind == 'gmd':
        valid = jax_ms.make_multiseed_valid_step(
            jax_steps.make_gmd_valid_step(jm, params))
        ref['valid'] = _plain(valid(stacked.params, on_jax(make_batch(
            params, VALID_SEED, whole=True, keys=TRAIN_KEYS)),
            jax.random.PRNGKey(VALID_SEED)))
        saver = RunManager(dict(runs=str(tmp_dir), alias='test_jax_nan'))
        try:
            jax_cli._check_finite({'loss': np.float32('nan')}, stacked,
                                  saver, jax.random.PRNGKey(0),
                                  logging.getLogger('test_jax_nan'), 0, 0)
            raised = None
        except Exception as e:  # what the watchdog raises, by name
            raised = type(e).__name__
        ref['emergency'] = (raised, sorted(os.listdir(saver.model_folder)))
        step = jax_steps.make_gmd_train_step(jm, params)
    else:
        step = jax_steps.make_baseline_train_step(jm, params)
    multi = jax_ms.make_multiseed_train_step(step, len(SEEDS))
    key = jax.random.PRNGKey(42)
    ref['loss'], ref['params'] = [], []
    for n in range(UPDATES):  # the step donates the state: one chain
        key, sk = jax.random.split(key)
        stacked, metrics = multi(stacked, on_jax(make_batch(
            params, n, host_pair=True, keys=TRAIN_KEYS_OF[kind])), sk)
        ref['loss'].append(np.asarray(metrics['loss']))
        ref['params'].append(seeds(stacked))
    return ref


class Children:
    """:func:`compute` of each kind in a child process of its own (this
    file run as a script), all started at once, each writing its pickle
    into ``tmp_dir``. :meth:`wait` gives {kind: references}; a child that
    has not ended within ``deadline`` seconds of the wait's start is
    killed with its process group, and the wait raises, as it does when a
    child fails; :meth:`close` kills any child still running."""

    def __init__(self, kinds, tmp_dir):
        self.procs = {}
        for kind in kinds:
            out = os.path.join(str(tmp_dir), f'multiseed_refs_{kind}.pkl')
            self.procs[kind] = (out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), out, kind],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True))

    def wait(self, deadline: float = DEADLINE_S):
        refs, failed = {}, []
        try:
            for kind, (out, proc) in self.procs.items():
                try:
                    log, _ = proc.communicate(timeout=deadline)
                except subprocess.TimeoutExpired:
                    failed.append(f'{kind}: not done within {deadline} s')
                    continue
                if proc.returncode:
                    failed.append(f'{kind}: exit {proc.returncode}\n'
                                  f'{log[-4000:]}')
                    continue
                with open(out, 'rb') as f:
                    refs[kind] = pickle.load(f)
        finally:
            self.close()
        if failed:
            raise RuntimeError('the JAX references failed: '
                               + '\n'.join(failed))
        return refs

    def close(self):
        for _, proc in self.procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


if __name__ == '__main__':
    torch.set_num_threads(1)
    result = compute(sys.argv[2], os.path.dirname(sys.argv[1]))
    with open(sys.argv[1] + '.tmp', 'wb') as f:
        pickle.dump(result, f)
    os.replace(sys.argv[1] + '.tmp', sys.argv[1])
