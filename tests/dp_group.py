"""The ranks of the parallel CPU tests, and the launcher that starts
them.

``tests/test_torch_data_parallel.py`` and ``tests/test_torch_fsdp.py``
each start one group of two ranks a module (:func:`launch`, behind a
module fixture), ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_pipeline.py`` theirs (the tensor-parallel one a group
of four too), ``tests/test_torch_expert_parallel.py`` one of four:
``torchrun --standalone --nproc_per_node <world>`` of this
file, which runs the tasks a JSON spec names, one after another, on
every rank over gloo on the CPU, and saves each rank's results as
``<out>/rank{r}.pt``. A task is a function of this module, or
``module:function`` of another module under ``tests/``
(``mp_ranks.py``: the model, pipe and expert axes). The first task that reaches ``cli`` starts the
process group from torchrun's environment, as ``python -m
shufflingvideosfortsg_torch.train`` does under torchrun; later tasks
run in it. A group that passes its deadline is killed and a fresh one
started once, on a fresh port (``--standalone`` picks one), as
``tests/bf16_train_refs.py`` does for its child.

Not a test module (pytest collects ``test_*.py`` only)::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/dp_group.py <spec.json>
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)
DEADLINE_S = 240
ATTEMPTS = 2
WORLD = 2


class Group:
    """A started group of ranks: :meth:`results` waits for it (restarting
    it once past its deadline) and returns each rank's results."""

    def __init__(self, spec_path: str, out: str, world: int = WORLD):
        self.spec_path, self.out, self.world = spec_path, out, world
        self.attempt = 0
        self._start()

    def _start(self):
        self.attempt += 1
        env = dict(os.environ, OMP_NUM_THREADS='1',
                   PYTHONPATH=os.pathsep.join(
                       [_ROOT, _TESTS, os.environ.get('PYTHONPATH', '')]))
        self.log = open(os.path.join(self.out, f'log{self.attempt}.txt'), 'w')
        self.proc = subprocess.Popen(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', str(self.world), os.path.abspath(__file__),
             self.spec_path], stdout=self.log, stderr=subprocess.STDOUT,
            env=env, cwd=_ROOT, start_new_session=True)
        self.t0 = time.monotonic()

    def results(self):
        import torch
        while True:
            left = DEADLINE_S - (time.monotonic() - self.t0)
            try:
                rc = self.proc.wait(timeout=max(left, 1))
                break
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait()
                if self.attempt >= ATTEMPTS:
                    raise AssertionError(f'{self.spec_path}: no result in '
                                         f'{DEADLINE_S} s, twice')
                self._start()
        self.log.close()
        if rc != 0:
            with open(self.log.name) as f:
                raise AssertionError(f'ranks exited {rc}:\n{f.read()[-6000:]}')
        return [torch.load(os.path.join(self.out, f'rank{r}.pt'),
                           weights_only=False) for r in range(self.world)]


def launch(out: str, tasks, world: int = WORLD) -> Group:
    """Start ``world`` ranks over ``tasks`` ([[name, kwargs], ...]) with
    results under ``out``."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, 'spec.json')
    with open(spec, 'w') as f:
        json.dump({'out': out, 'tasks': tasks}, f)
    return Group(spec, out, world)


# --- what a rank runs ---------------------------------------------------------

def _cli():
    from shufflingvideosfortsg_torch import cli
    return cli


def _mesh():
    from shufflingvideosfortsg_torch.parallel.mesh import create_mesh
    return create_mesh(None, 'cpu')


def _clone(weights):
    return {k: v.detach().clone() for k, v in weights.items()}


def _capture(cli, name):
    """Patch ``cli.<name>`` (a train step maker, ``(model, state, ...)``)
    to keep the state of every step it makes."""
    made, make = [], getattr(cli, name)

    def keep(*args, **kwargs):
        made.append(args[1])
        return make(*args, **kwargs)

    setattr(cli, name, keep)
    return made, lambda: setattr(cli, name, make)


def _run_module(module, argv):
    """``python -m <module> argv`` as torchrun runs it: the module as
    ``__main__`` with ``sys.argv``."""
    import runpy
    saved = sys.argv
    sys.argv = [module] + list(argv)
    try:
        runpy.run_module(module, run_name='__main__')
    finally:
        sys.argv = saved


def driver(argv, kind='gmd', entry=None, module=None, maker=None):
    """A driver run from argv: ``entry`` 'train' or 'test' of ``kind``
    ('gmd' or 'baseline'), through ``cli`` or, with ``module``, through
    that entry point (``python -m shufflingvideosfortsg_torch.train``).
    Training returns each made step's final weights (the seeds' in turn;
    under FSDP and on a pipelined state gathered, on every rank; ``maker``
    names the step maker ``cli`` calls, GMD's by default) and the path of
    the run; a test run its submit."""
    cli = _cli()
    default = 'GMD' if kind == 'gmd' else 'QAVE'
    params = cli.parse_params(argv, default_model=default)
    if entry == 'test':
        fn = cli.main_test if kind == 'gmd' else cli.main_test_baseline
        return {'submit': fn(params)}
    maker = maker or ('make_gmd_train_step' if kind == 'gmd' else
                      'make_baseline_train_step')
    made, restore = _capture(cli, maker)
    stats = None
    try:
        if module is not None:
            _run_module(module, argv)
        else:
            fn = cli.main_train if kind == 'gmd' else cli.main_train_baseline
            stats = fn(params)
    finally:
        restore()
    return {'weights': [_clone(state.weights()) for state in made],
            'stats': stats,
            'run': os.path.join(params['runs'], params['alias'])}


def _rank_setup(inputs, kind):
    """(mesh, params, model, state on the mesh, this rank's rows) of a
    step case in ``inputs`` (a torch.save of params, weights and batch);
    rank r's rows are r, r + P, ... of the global batch."""
    import torch
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.parallel.mesh import replicate_state
    from shufflingvideosfortsg_torch.train.state import TrainState
    mesh = _mesh()
    data = torch.load(inputs, weights_only=False)
    params = data['params']
    model = build_model(params, kind, device='cpu')
    model.load_state_dict(data['weights'], strict=True)
    state = TrainState(model, params, steps_per_epoch=2)
    state.mesh = mesh
    replicate_state(mesh, state)
    rows = {k: v[mesh.rank::mesh.world] for k, v in data['batch'].items()}
    return mesh, params, model, state, rows


def _run_steps(kind, model, state, params, rows, generator_seed, n):
    import torch
    from shufflingvideosfortsg_torch.train.steps import (
        make_baseline_train_step, make_gmd_train_step)
    make = make_gmd_train_step if kind == 'gmd' else make_baseline_train_step
    step = make(model, state, params)
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    return [{k: float(v) for k, v in step(rows, gen).items()}
            for _ in range(n)], step, gen


def steps(inputs, kind='gmd', n=3, generator_seed=None, grads=False):
    """``n`` train steps of ``kind`` on this rank's rows: the metrics and
    the final weights (``grads``: and the last step's gradients, after
    the all-reduce)."""
    _, params, model, state, rows = _rank_setup(inputs, kind)
    metrics, _, _ = _run_steps(kind, model, state, params, rows,
                               generator_seed, n)
    out = {'metrics': metrics, 'weights': _clone(state.weights())}
    if grads:
        out['grads'] = {k: p.grad.detach().clone()
                        for k, p in model.named_parameters()}
    return out


def _opt_tensors(sd):
    import torch
    return {i: {k: v.clone() for k, v in per.items()
                if isinstance(v, torch.Tensor)}
            for i, per in sd['optimizer']['state'].items()}


def _sharded_grads(sharded):
    """The full gradients the optimizer took in a ZeRO-3 update, by
    parameter name: each split parameter's reduce-scattered slices
    gathered, the replicated leaves' all-reduced gradients."""
    from shufflingvideosfortsg_torch.parallel.fsdp import _gather
    out = {sharded.names[id(p)]: _gather(shard.grad, dim, sharded.mesh)
           for p, shard, dim in sharded.sharded if shard.grad is not None}
    out.update({sharded.names[id(p)]: p.grad.detach().clone()
                for p in sharded.replicated if p.grad is not None})
    return out


def fsdp_steps(inputs, min_bytes, n=3, generator_seed=11, ckpt=None,
               grads=False):
    """``n`` GMD steps replicated on the mesh and ``n`` ZeRO-3-sharded
    (``min_bytes``) from the same weights and draws: each one's metrics,
    weights, full optimizer state and resident bytes, the plan, the
    replicated leaves' bytes (``grads``: and the sharded run's gradients
    of its first update, :func:`_sharded_grads`, and weights after it);
    then the sharded state's
    checkpoint round trip: rank 0 writes ``ckpt`` (after the gather every
    rank joins), a fresh sharded state resumes from it, and one more step
    of each."""
    import torch
    from shufflingvideosfortsg_torch.parallel.fsdp import (
        ShardedState, resident_state_bytes)
    from shufflingvideosfortsg_torch.utils.saver import (load_checkpoint,
                                                         snapshot,
                                                         write_snapshot)
    out = {}
    for name in ('replicated', 'sharded'):
        mesh, params, model, state, rows = _rank_setup(inputs, 'gmd')
        if name == 'sharded':
            state.sharded = ShardedState(state, mesh, min_bytes)
        first = grads and name == 'sharded'
        metrics, step, gen = _run_steps('gmd', model, state, params, rows,
                                        generator_seed, 1 if first else n)
        if first:
            step1 = {'grads': _sharded_grads(state.sharded),
                     'weights': _clone(state.weights())}
            metrics += [{k: float(v) for k, v in step(rows, gen).items()}
                        for _ in range(n - 1)]
        res = {'metrics': metrics, 'weights': _clone(state.weights()),
               'opt_state': _opt_tensors(state.state_dict()),
               'resident_bytes': resident_state_bytes(state)}
        if first:
            res['step1'] = step1
        if name == 'sharded':
            res['plan'] = state.sharded.plan
            opt = state.optimizer.state
            res['replicated_leaf_bytes'] = sum(
                p.numel() * p.element_size()
                + sum(v.numel() * v.element_size()
                      for v in opt.get(p, {}).values()
                      if isinstance(v, torch.Tensor))
                for p in state.sharded.replicated)
            snap = snapshot(model, state, {'train': gen})
            if mesh.is_rank0:
                write_snapshot(ckpt, snap)
            mesh.barrier()
            weights, resume, _ = load_checkpoint(ckpt)
            res['loaded'] = weights
            _, _, model2, state2, _ = _rank_setup(inputs, 'gmd')
            model2.load_state_dict(weights)
            state2.load_state_dict(resume['train_state'])
            state2.sharded = ShardedState(state2, mesh, min_bytes)
            gen2 = torch.Generator().manual_seed(0)
            gen2.set_state(resume['generators']['train'])
            from shufflingvideosfortsg_torch.train.steps import \
                make_gmd_train_step
            more = make_gmd_train_step(model2, state2, params)
            res['resumed_metrics'] = {k: float(v) for k, v in
                                      more(rows, gen2).items()}
            res['resumed_weights'] = _clone(state2.weights())
            res['continued_metrics'] = {k: float(v) for k, v in
                                        step(rows, gen).items()}
            res['continued_weights'] = _clone(state.weights())
        out[name] = res
    return out


def mesh_shape_error():
    """``create_mesh`` with a ``mesh_shape`` of 4 devices on 2 ranks."""
    from shufflingvideosfortsg_torch.parallel.mesh import create_mesh
    try:
        create_mesh([4], 'cpu')
    except ValueError as e:
        return {'error': str(e)}
    return {'error': None}


def main(spec_path: str) -> None:
    import torch
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    results = []
    for name, kwargs in spec['tasks']:
        module, _, fn = name.rpartition(':')
        task = (getattr(importlib.import_module(module), fn) if module
                else globals()[fn])
        results.append(task(**kwargs))
    rank = int(os.environ['RANK'])
    tmp = os.path.join(spec['out'], f'rank{rank}.pt.tmp')
    torch.save(results, tmp)
    os.replace(tmp, os.path.join(spec['out'], f'rank{rank}.pt'))


if __name__ == '__main__':
    main(sys.argv[1])
