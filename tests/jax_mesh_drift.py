"""How far reduction order alone moves JAX's own data-parallel training.

JAX's ``make_gmd_train_step`` at the full width of
``cfgs/charades_cd_i3d.yml`` (T=128, D=1024, N=15, H=256, batch 32) runs
``--updates`` Adam updates twice from the same weights, batches and keys:
once on one CPU device, once with every batch sharded over a ``[devices]``
data mesh of forced host devices (the state replicated, as JAX's
``replicate_tree`` places it). The two runs differ only in the order in
which XLA sums the sharded batch. For each parameter it prints the
relative L2 of the mesh run against the one-device run, and the
reference's Adam-step measures: the largest difference in units of
``lr * updates`` and the share of all elements more than ``0.2 lr`` apart.
With ``--port`` the port does the same on the same batch, its ``devices``
gloo ranks against one process, from the same weights.

Not a test module (pytest collects ``test_*.py`` only)::

    JAX_PLATFORMS=cpu python tests/jax_mesh_drift.py [--devices 4] \\
        [--updates 8] [--same-batch] [--port-weights] [--plain] \\
        [--port <dir>] [--leaf video_encoder/norm/bias] [--out drift.json]
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _force_devices(n: int) -> None:
    flags = os.environ.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in flags:
        os.environ['XLA_FLAGS'] = (
            flags + f' --xla_force_host_platform_device_count={n}').strip()


PLAIN = dict(dropout=0.0, disc_dropout=0.0, on_device_aug=False)


def batches(params, n: int, B: int, seed: int, pseudo: bool = False):
    """``n`` seeded batches of B raw videos at the config's shape, with the
    reference's masks (the port's ``profile_train.train_batch`` draws);
    with ``pseudo`` each carries its pseudo videos, JAX's
    ``gt_translate_batch`` at a fixed key, as a host-made pair batch."""
    import numpy as np
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.augment_device import device_masks
    T, D, N = params['video_len'], params['video_feature_dim'], \
        params['sent_len']
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        nfeats = rng.randint(T // 4, T + 1, size=B)
        s = np.array([rng.randint(0, m) for m in nfeats])
        e = np.array([rng.randint(a, m) for a, m in zip(s, nfeats)])
        video = rng.randn(B, T, D).astype(np.float32)
        video[np.arange(T)[None] >= nfeats[:, None]] = 0.0
        framestps = np.stack([s, e], -1).astype(np.int32)
        batch = {'video_feat': video,
                 'sent_feat': rng.randn(B, N, 300).astype(np.float32),
                 'sent_mask': np.ones((B, N), np.int32),
                 'framestps': framestps,
                 'timestps': framestps.astype(np.float32),
                 'nfeats': nfeats.astype(np.int32),
                 'duration': np.full(B, 30.0, np.float32)}
        masks = device_masks(jnp.asarray(s), jnp.asarray(e),
                             jnp.asarray(nfeats), T)
        batch.update({k: np.asarray(v) for k, v in masks.items()})
        if pseudo:
            import jax
            from shufflingvideosfortsg_tpu.ops.augment_device import \
                gt_translate_batch
            feat, fs, pm = gt_translate_batch(
                jax.random.PRNGKey(seed + 100 + i), jnp.asarray(video),
                jnp.asarray(framestps), jnp.asarray(nfeats))
            batch.update(pseudo_video_feat=np.asarray(feat),
                         pseudo_framestps=np.asarray(fs),
                         **{'pseudo_' + k: np.asarray(v)
                            for k, v in pm.items()})
        out.append(batch)
    return out


def port_weights(params, seed: int = 123):
    """The port's seeded GMD weights (``cli._seeded_model``, the weights of
    its data-parallel checks) as JAX's parameter tree."""
    import numpy as np
    from shufflingvideosfortsg_torch import cli as port_cli
    from shufflingvideosfortsg_tpu.utils.torch_interop import \
        convert_reference_state_dict
    model = port_cli._seeded_model(dict(params, seed=seed), 'cpu')
    sd = {k: v.detach().numpy().astype(np.float32)
          for k, v in model.state_dict().items()}
    return convert_reference_state_dict(sd, 'gmd')


def _leaves(want, got, lr, updates):
    """Per-parameter relative L2, largest difference and lr units."""
    import numpy as np
    out = {}
    for k, w in want.items():
        d = np.asarray(got[k], np.float64) - np.asarray(w, np.float64)
        out[k] = dict(rel_l2=float(np.linalg.norm(d) / max(
            np.linalg.norm(np.asarray(w, np.float64)), 1e-12)),
            max_abs=float(np.abs(d).max()),
            max_lr_units=float(np.abs(d).max() / lr / updates))
    return out


def port_run(params, data, n_devices: int, updates: int, root: str):
    """The port's counterpart on the same batch (``--port``): the updates
    of ``n_devices`` gloo ranks (``tests/dp_group.py``, rows r, r + P, ...
    a rank) against one process, from the port's seeded weights; the
    per-parameter comparison."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(_ROOT, 'tests'))
    import dp_group
    from shufflingvideosfortsg_torch import cli as port_cli
    from shufflingvideosfortsg_torch.config import load_config
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import make_gmd_train_step
    port_params = load_config('charades_cd_i3d.yml', overrides={
        k: params[k] for k in PLAIN if k in params})
    model = port_cli._seeded_model(port_params, 'cpu')
    batch = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    inputs = os.path.join(root, 'port_inputs.pt')
    torch.save({'params': port_params, 'weights': model.state_dict(),
                'batch': batch}, inputs)
    group = dp_group.launch(os.path.join(root, 'port_ranks'), [
        ['steps', {'inputs': inputs, 'n': updates}]], world=n_devices)
    state = TrainState(model, port_params, steps_per_epoch=2)
    step = make_gmd_train_step(model, state, port_params)
    for _ in range(updates):
        step(batch, None)
    ranks = group.results()[0][0]['weights']
    return _leaves({k: v.numpy() for k, v in model.state_dict().items()},
                   {k: v.numpy() for k, v in ranks.items()},
                   float(port_params['lr']), updates)


def run(n_devices: int, updates: int, B: int = 32, seed: int = 0,
        same_batch: bool = False, from_port: bool = False,
        plain: bool = False, port_root: str = ''):
    import numpy as np
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from shufflingvideosfortsg_tpu.cli import init_model_params
    from shufflingvideosfortsg_tpu.config import load_config
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.parallel.mesh import (DATA_AXIS,
                                                         create_mesh,
                                                         replicate_tree)
    from shufflingvideosfortsg_tpu.train.state import (create_train_state,
                                                       make_optimizer)
    from shufflingvideosfortsg_tpu.train.steps import make_gmd_train_step
    if len(jax.devices()) < n_devices:
        raise SystemExit(f'{len(jax.devices())} devices, {n_devices} asked')
    params = load_config('charades_cd_i3d.yml',
                         overrides=PLAIN if plain else None)
    model = build_model(params, 'gmd')
    weights = (port_weights(params) if from_port else
               jax.device_get(init_model_params(model, params,
                                                jax.random.PRNGKey(seed),
                                                'gmd')))
    tx = make_optimizer(params, steps_per_epoch=1000)
    data = batches(params, 1 if same_batch else updates, B, seed, plain)
    if same_batch:
        data = data * updates
    mesh = create_mesh([n_devices])
    runs = {}
    for name in ('one_device', 'mesh'):
        step = make_gmd_train_step(model, params)
        state = create_train_state(weights, tx)
        if name == 'mesh':
            state = replicate_tree(mesh, state)
            put = NamedSharding(mesh, P(DATA_AXIS))
        else:
            put = jax.devices()[0]
        key = jax.random.PRNGKey(seed + 1)
        t0 = time.perf_counter()
        losses = []
        for batch in data:
            key, sk = jax.random.split(key)
            state, m = step(state, {k: jax.device_put(v, put)
                                    for k, v in batch.items()}, sk)
            losses.append(float(m['loss']))
        runs[name] = dict(params=jax.device_get(state.params), losses=losses,
                          seconds=time.perf_counter() - t0)
    lr = float(params['lr'])
    flat = {jax.tree_util.keystr(kp, simple=True, separator='/'): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(
                runs['one_device']['params'])}
    got = {jax.tree_util.keystr(kp, simple=True, separator='/'): np.asarray(v)
           for kp, v in jax.tree_util.tree_leaves_with_path(
               runs['mesh']['params'])}
    leaves = _leaves(flat, got, lr, updates)
    worst = max(v['max_abs'] for v in leaves.values())
    total = sum(v.size for v in flat.values())
    far = sum(int((np.abs(np.asarray(got[k], np.float64) - v) > 0.2 * lr
                   ).sum()) for k, v in flat.items())
    port = (port_run(params, data[0], n_devices, updates, port_root)
            if port_root else None)
    return dict(devices=n_devices, updates=updates, batch=B, lr=lr,
                same_batch=same_batch, port_weights=from_port, plain=plain,
                port_leaves=port,
                losses={k: v['losses'] for k, v in runs.items()},
                seconds={k: v['seconds'] for k, v in runs.items()},
                leaves=leaves,
                max_lr_units=worst / lr / updates,
                share_beyond_0_2_lr=far / total,
                jax=jax.__version__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--devices', type=int, default=4)
    ap.add_argument('--updates', type=int, default=8)
    ap.add_argument('--same-batch', action='store_true',
                    help='every update on the first batch')
    ap.add_argument('--port-weights', action='store_true',
                    help="start from the port's seeded weights "
                    "(cli._seeded_model), not JAX's init")
    ap.add_argument('--plain', action='store_true',
                    help='dropout off and the pseudo videos made on the '
                    'host by JAX at a fixed key: the same data on every run')
    ap.add_argument('--port', default='',
                    help='with --same-batch --port-weights --plain: also '
                    'the port at as many gloo ranks on the same batch, '
                    'its files under this directory')
    ap.add_argument('--leaf', default='video_encoder/norm/bias')
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    _force_devices(args.devices)
    sys.path.insert(0, _ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    if args.port and not (args.same_batch and args.port_weights
                          and args.plain):
        raise SystemExit('--port needs --same-batch --port-weights --plain')
    res = run(args.devices, args.updates, same_batch=args.same_batch,
              from_port=args.port_weights, plain=args.plain,
              port_root=args.port)
    ranked = sorted(res['leaves'].items(), key=lambda kv: -kv[1]['rel_l2'])
    for k, v in ranked[:5]:
        print(f"{k}: relative L2 {v['rel_l2']:.3e}, largest difference "
              f"{v['max_abs']:.3e} ({v['max_lr_units']:.3f} lr an update)")
    leaf = res['leaves'][args.leaf]
    print(json.dumps({'leaf': args.leaf, **leaf,
                      'worst_leaf': ranked[0][0],
                      'worst_rel_l2': ranked[0][1]['rel_l2'],
                      'max_lr_units': res['max_lr_units'],
                      'share_beyond_0_2_lr': res['share_beyond_0_2_lr'],
                      'devices': res['devices'], 'updates': res['updates'],
                      'same_batch': res['same_batch'],
                      'port_weights': res['port_weights'],
                      'plain': res['plain'],
                      'seconds': res['seconds'], 'jax': res['jax']}))
    if res['port_leaves']:
        port = res['port_leaves']
        ranked = sorted(port.items(), key=lambda kv: -kv[1]['rel_l2'])
        print(json.dumps({'port_leaf': args.leaf.replace('/', '.'),
                          **port[args.leaf.replace('/', '.')],
                          'port_worst': ranked[:4]}))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
