"""How far the port's parallel axes drift at ``precision: bf16`` on the
CPU, at the tiny widths of ``tests/test_torch_tensor_parallel.py``.

1. Four gloo ranks (``torchrun --nproc_per_node 4``) train GMD for one
   epoch (8 updates at 4 rows a step) with ``--tensor_parallel 4`` (1x4),
   ``--tensor_parallel 2`` (2x2) and ``--pipeline_stages 4`` (1x4), and
   one process trains the same epoch: for TP with its step over a one-way
   model axis (``chip_smoke._one_way_tp_run``, the TP step's rounding
   points), for PP QAVE 5 blocks deep sequentially
   (``chip_smoke._sequential_deep_run``). For each run against its
   reference it prints the parity rule's measures (``utils/parity.py``):
   the worst relative L2, the largest difference in units of lr an update
   and the share of elements more than 0.2 lr apart (the rule's limit
   5e-3), as ``[tp4_bf16]`` and ``[pp4_bf16]`` of ``chip_smoke.py`` do on
   four cards.
2. With ``--jax``, one GPipe update at 1x2 against JAX's at bf16 as
   ``tests/test_torch_pipeline.py`` holds it: the gradient leaves within
   2^-5 relative L2 of JAX's, and those that need the one-process
   fallback of ``hold_bf16_update`` (``PP_OWN_STEP`` there).
3. With ``--tp-plain`` (alone), each package's TP step at bf16 against
   its own plain step at bf16 and f32 (:func:`tp_against_plain`), by
   ``utils/parity.hold_bf16_grads`` at 2^-5 and 2^-4.

Not a test module (pytest collects ``test_*.py`` only)::

    JAX_PLATFORMS=cpu python tests/bf16_axes_drift.py --out <dir> [--jax]
    JAX_PLATFORMS=cpu python tests/bf16_axes_drift.py --out <dir> --tp-plain
"""

import argparse
import json
import os
import subprocess
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
for _p in (_ROOT, _TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

RUNS = (('tp1x4', ['--tensor_parallel', '4']),
        ('tp2x2', ['--tensor_parallel', '2', '--batch_size', '2', '2', '2']),
        ('pp1x4', ['--pipeline_stages', '4']))


def parity_measures(got, want, lr, updates):
    """The parity rule's measures of ``got`` against ``want``."""
    from shufflingvideosfortsg_torch.utils.parity import ADAM_NEAR, rel_l2
    far = total = 0
    largest = worst = 0.0
    for k, v in want.items():
        d = (got[k].double() - v.double()).abs()
        far += int((d > ADAM_NEAR * lr).sum())
        total += d.numel()
        largest = max(largest, float(d.max()))
        worst = max(worst, rel_l2(got[k], v))
    return {'worst_rel_l2': worst, 'max_lr_units': largest / (lr * updates),
            'share_0.2lr': far / total}


def four_ranks(root):
    import torch

    import chip_smoke
    import test_torch_tensor_parallel as ttp
    from shufflingvideosfortsg_torch import cli
    os.makedirs(root)
    argv = ttp.tiny_corpus(root, ['--precision', 'bf16'])
    env = dict(os.environ, OMP_NUM_THREADS='1')
    for alias, flags in RUNS:
        subprocess.run([sys.executable, '-m', 'torch.distributed.run',
                        '--standalone', '--nproc_per_node', '4', '-m',
                        'shufflingvideosfortsg_torch.train', *argv, *flags,
                        '--alias', alias, '--epoch', '1'], env=env,
                       check=True, capture_output=True, cwd=_ROOT)
    one_tp = cli.parse_params(argv + ['--alias', 'one_tp', '--epoch', '1'],
                              default_model='GMD')
    chip_smoke._one_way_tp_run(cli, one_tp)
    one_pp = cli.parse_params(argv + ['--pipeline_stages', '4', '--alias',
                                      'one_pp', '--epoch', '1'],
                              default_model='GMD')
    chip_smoke._sequential_deep_run(cli, one_pp)

    def ckp(alias):
        return torch.load(os.path.join(root, 'runs', alias, 'model',
                                       f'{alias}_00000.ckp'),
                          weights_only=True)

    lr, updates = float(one_tp['lr']), 8
    return {alias: parity_measures(ckp(alias), ckp('one_pp' if alias ==
                                                   'pp1x4' else 'one_tp'),
                                   lr, updates)
            for alias, _ in RUNS}


def gpipe_against_jax(root):
    """The counts of ``tests/test_torch_pipeline.py``'s bf16 case."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np

    import dp_group
    import test_torch_pipeline as tpp
    import test_torch_tensor_parallel as ttp
    from shufflingvideosfortsg_tpu import cli as jax_cli
    from shufflingvideosfortsg_tpu.models import build_model
    from shufflingvideosfortsg_tpu.parallel.pipeline import create_pp_mesh
    from shufflingvideosfortsg_tpu.train.pipelined import (
        make_gmd_pipelined_train_step, stack_encoder_tail,
        unstack_encoder_tail)
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    from test_torch_bf16_train import _rel_l2
    os.makedirs(root)
    stages = tpp.STAGES
    params = tpp.jax_params()
    model = build_model(params, 'gmd')
    weights = jax.tree.map(np.asarray, jax_cli.init_model_params(
        model, params, jax.random.PRNGKey(0), 'gmd'))
    batch = ttp.pair_batch()
    inputs = ttp.save_inputs(os.path.join(root, 'bf16.pt'),
                             tpp.port_params(precision='bf16'),
                             state_dict_from_jax(weights,
                                                 nblocks=stages + 1), batch)
    group = dp_group.launch(os.path.join(root, 'ranks'), [
        ['mp_ranks:pp_steps', {'inputs': inputs, 'dp': 1, 'pp': stages,
                               'n_micro': tpp.N_MICRO, 'n': 1,
                               'grads': True}]])
    bf16 = tpp.jax_params(precision='bf16')
    mesh = create_pp_mesh(1, stages)
    ref = ttp.jax_bf16_ref(
        make_gmd_pipelined_train_step(build_model(bf16, 'gmd'), bf16, mesh,
                                      tpp.N_MICRO, data_axis=None,
                                      train_dropout=False),
        bf16, stack_encoder_tail(weights, model.nblocks, mesh=mesh), batch,
        ttp.jax_f32_grads(model, params, weights, batch),
        to_sequential=unstack_encoder_tail)
    (a,), (b,) = group.results()
    got = dict(a, grads={**b['grads'], **a['grads']})
    # every leaf may take the one-process fallback here: the measurement
    # names those that need it (PP_OWN_STEP of tests/test_torch_pipeline.py)
    own = ttp.hold_bf16_update(got, ref, tpp.one_process_grads(inputs),
                               own_step=tuple(got['grads']))
    within = sum(_rel_l2(g.numpy(), ref['grads'][k].numpy()) <= 2.0 ** -5
                 for k, g in got['grads'].items())
    return {'leaves': len(got['grads']), 'within_2^-5_of_jax': within,
            'held_by_one_process': own}


def _rel_table(a, b):
    from shufflingvideosfortsg_torch.utils.parity import rel_l2
    return {k: rel_l2(torch_tensor(a[k]), torch_tensor(v))
            for k, v in b.items()}


def torch_tensor(x):
    import numpy as np
    import torch
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))


def tp_against_plain(root, leaves=6):
    """Both packages' TP step at bf16 against their own plain steps at
    ``tests/bf16_train_refs.py``'s GMD (H=128, the Pallas kernels' width;
    B=8, T=10), from the same weights and batch: the TP step at 1x2 (the
    video recurrences sharded, h and c in bf16: JAX's ``lax.scan``, the
    port's ``bilstm_hidden_sharded``), the plain step at bf16 (JAX's
    Pallas train kernels interpreted, the port's K3/K4 plain versions: c
    in f32) and at f32. For the ``leaves`` gradients farthest from the
    plain bf16 step's, in each package, their relative L2 from it and the
    TP and plain bf16 steps' from the f32 step's, and whether the TP step
    holds ``utils/parity.hold_bf16_grads`` against the plain steps at its
    budget 2^-5 and at the doubled 2^-4 (the leaves that fail): whether
    JAX's own TP step drifts from its plain step as the port's does on the
    card (``chip_smoke.py`` ``[tp_bf16]``)."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    import numpy as np
    import pytest
    import torch

    import bf16_train_refs as refs
    import dp_group
    import test_torch_tensor_parallel as ttp
    import shufflingvideosfortsg_tpu.ops.rnn as jax_rnn
    import shufflingvideosfortsg_tpu.parallel.tensor_parallel as jax_tp
    from jax_cpu import _WidenedEinsum
    from shufflingvideosfortsg_tpu.parallel.tensor_parallel import \
        create_tp_mesh
    from shufflingvideosfortsg_tpu.train.tp import make_gmd_tp_train_step
    from shufflingvideosfortsg_torch.models.build import \
        build_model as port_build
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import make_gmd_train_step
    from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
    from test_torch_bf16 import _no_excess
    os.makedirs(root)
    p16, p32 = refs.params('gmd'), refs.params('gmd', 'f32')
    model = refs.jax_build_model(p16, 'gmd')
    weights = refs._numpy(refs.jax_cli.init_model_params(
        model, p16, jax.random.PRNGKey(5), 'gmd'))
    b = refs.batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pseudo = {k[len('pseudo_'):]: v for k, v in jb.items()
              if k.startswith('pseudo_')}
    sd = state_dict_from_jax(weights)

    def port(tree):
        return state_dict_from_jax(jax.tree.map(np.asarray, tree))

    jax_g = {'f32': port(refs._jax_grads(p32, 'gmd', weights, jb,
                                         pseudo)[1])}
    with pytest.MonkeyPatch.context() as m:
        refs.patch_tpu_like(m)
        jax_g['plain'] = port(refs._jax_grads(p16, 'gmd', weights, jb,
                                              pseudo)[1])
        m.setattr(jax_tp, 'jnp', _WidenedEinsum())
        m.setattr(jax_rnn, 'jnp', _WidenedEinsum())
        step = make_gmd_tp_train_step(refs.jax_build_model(p16, 'gmd'), p16,
                                      create_tp_mesh(1, 2),
                                      train_dropout=False)
        _, grads = _no_excess(jax.value_and_grad(step.loss_fn, has_aux=True),
                              weights, jb, pseudo, jax.random.PRNGKey(0))
        jax_g['tp'] = port(grads)

    def port_grads(p):
        net = port_build(p, 'gmd', device='cpu')
        net.load_state_dict(sd)
        net.train()
        tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        fn = make_gmd_train_step(net, TrainState(net, p, steps_per_epoch=2),
                                 p).loss_fn
        loss, _ = fn(tb, {k[len('pseudo_'):]: v for k, v in tb.items()
                          if k.startswith('pseudo_')}, None)
        loss.backward()
        return {k: q.grad.detach().clone() for k, q in net.named_parameters()}

    port_g = {'f32': port_grads(p32), 'plain': port_grads(p16)}
    inputs = ttp.save_inputs(os.path.join(root, 'tp.pt'), p16, sd, b)
    group = dp_group.launch(os.path.join(root, 'ranks'), [
        ['mp_ranks:tp_steps', {'inputs': inputs, 'dp': 1, 'mp': 2, 'n': 1,
                               'grads': True}]])
    port_g['tp'] = group.results()[0][0]['grads']
    from shufflingvideosfortsg_torch.utils.parity import (
        BF16_CROSS_REL_L2, BF16_GRAD_REL_L2, hold_bf16_grads)
    out = {}
    for name, g in (('jax', jax_g), ('port', port_g)):
        g = {run: {k: torch_tensor(v) for k, v in grads.items()}
             for run, grads in g.items()}
        rule = {}
        for tag, budget in (('2^-5', BF16_GRAD_REL_L2),
                            ('2^-4', BF16_CROSS_REL_L2)):
            try:
                res = hold_bf16_grads(name, g['tp'], g['plain'], g['f32'],
                                      budget)
                rule[tag] = {'held': True, 'f32_clause_leaves': len(
                    res['f32_clause_leaves']), 'f32_clause_of_bound':
                    res['f32_clause_of_bound']}
            except AssertionError as e:
                rule[tag] = {'held': False,
                             'failed_leaves': str(e).count('gradient of')}
        to_plain = _rel_table(g['tp'], g['plain'])
        tp_f32 = _rel_table(g['tp'], g['f32'])
        plain_f32 = _rel_table(g['plain'], g['f32'])
        out[name] = {
            'hold_bf16_grads': rule,
            'leaves': len(to_plain),
            'past_2^-5_from_plain': sum(v > 2.0 ** -5
                                        for v in to_plain.values()),
            'farthest': {k: {'tp_to_plain_bf16': to_plain[k],
                             'tp_to_f32': tp_f32[k],
                             'plain_bf16_to_f32': plain_f32[k]}
                         for k in sorted(to_plain, key=to_plain.get,
                                         reverse=True)[:leaves]}}
    return out


def main():
    flags = os.environ.get('XLA_FLAGS', '')
    if 'xla_force_host_platform_device_count' not in flags:  # JAX's 1x2 mesh
        os.environ['XLA_FLAGS'] = (
            flags + ' --xla_force_host_platform_device_count=8').strip()
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', required=True,
                    help='a work directory that does not exist yet')
    ap.add_argument('--jax', action='store_true')
    ap.add_argument('--tp-plain', action='store_true',
                    help='only the TP step against the plain step in both '
                    'packages (tp_against_plain)')
    args = ap.parse_args()
    if args.tp_plain:
        print(json.dumps({'tp_against_plain': tp_against_plain(
            os.path.join(args.out, 'tp_plain'))}, indent=1))
        return
    res = {'four_ranks_bf16': four_ranks(os.path.join(args.out, 'four'))}
    if args.jax:
        res['gpipe_against_jax'] = gpipe_against_jax(
            os.path.join(args.out, 'gpipe'))
    print(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()
