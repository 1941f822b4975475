"""The data axis across ranks: GMD train steps under ``torchrun``.

    torchrun --nproc_per_node 4 -m shufflingvideosfortsg_torch.measure_data_parallel \\
        [--global-batch 32 128] [--iters 20] [--out dp.json]
    torchrun --nproc_per_node 4 -m shufflingvideosfortsg_torch.measure_data_parallel \\
        --device cpu --tiny   # the same checks over gloo on the CPU

Every rank builds GMD at the width of ``cfgs/charades_cd_i3d.yml``
(``--tiny``: H=8, T=24, D=32, N=8) from the seeded weights and takes its
rows r, r + P, ... of one seeded global batch (``profile_train.train_batch``)
of each ``--global-batch``:

1. ``ddp``: ``--updates`` (3) eager updates on the mesh and one more,
   timed (wall ms); every rank's weights are then hashed
   (the int32 bits of each parameter, summed in int64) and all-gathered:
   the ranks must agree bit for bit. Rank 0 then runs the single-process
   step at the global batch with no process group, from the same weights
   and generator, and holds the ranks' step-1 loss within 1e-5 and each
   parameter by the parity rule of the parallel checks
   (``utils/parity.py``: a relative L2 of 1e-4, past it the reference's
   Adam-step rule at the update count), naming the worst parameter within
   1e-4 and those past it that passed by the Adam-step rule; each rank's
   resident state bytes and peak memory.
2. ``graphed`` (on a card): the update captured in a CUDA graph with its
   NCCL all-reduces (``cli._GraphedTick``), device ms a replay from CUDA
   events over ``--iters`` replays, beside the same update on the rank's
   rows with no group (no collective), in turns: none, mesh, mesh, none;
   and the flat gradient all-reduce alone (one ``all_reduce`` of the
   gradients' element count, f32), its ms and bus rate, 2 (P - 1) / P of
   its bytes over its time.
3. ``fsdp``: the same updates ZeRO-3-sharded (JAX's rule, 64 KiB)
   against the replicated ones of 1.: the same tolerances, each rank's
   resident state bytes, peak device memory and eager step ms.

Rank 0 prints the card (``nvidia-smi``'s name and power limit) and one
JSON line, also written to ``--out``. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .cli import _GraphedTick, _seeded_model, parse_params
from .config import load_config
from .parallel.fsdp import ShardedState, resident_state_bytes
from .parallel.mesh import create_mesh, replicate_state
from .profile_train import train_batch
from .train.state import TrainState
from .train.steps import make_gmd_train_step
from .utils.device import exact_bf16_products
from .utils.parity import hold_weights

STEPS = 3
LOSS_RTOL = 1e-5
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16']


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _state(params, dev, mesh, sharded=False):
    model = _seeded_model(params, dev).train()
    state = TrainState(model, params, steps_per_epoch=1000)
    if mesh is not None:
        state.mesh = mesh
        replicate_state(mesh, state)
        if sharded:
            state.sharded = ShardedState(state, mesh)
    return state


def _updates(params, dev, state, batch, n):
    """``n`` eager updates of ``state`` on ``batch`` from the seeded
    generator and one more, timed: (the ``n`` updates' metrics, the last
    one's wall ms, peak MiB)."""
    step = make_gmd_train_step(state.model, state, params)
    gen = torch.Generator(dev).manual_seed(0)
    metrics = [{k: float(v) for k, v in step(batch, gen).items()}
               for _ in range(n)]
    _sync(dev)
    t0 = time.perf_counter()
    step(batch, gen)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
            if dev.type == 'cuda' else None)
    return metrics, ms, peak


def _digest(weights) -> torch.Tensor:
    """Each parameter's int32 bits summed in int64: equal digests on every
    rank mean, to any practical certainty, equal bits."""
    return torch.stack([v.detach().contiguous().view(torch.int32)
                        .to(torch.int64).sum() for v in weights.values()])


def _hold(what, got, want, lr, updates):
    """(the worst relative L2 of ``got`` against ``want`` among the
    parameters within 1e-4, its parameter, the parameters past it that
    passed by the Adam-step rule); raises where the parity rule fails."""
    res = hold_weights(what, {k: v.cpu() for k, v in got.items()},
                       {k: v.cpu() for k, v in want.items()}, lr, updates)
    return (res['worst_within_rel_l2'], res['worst_within_leaf'],
            res['adam_leaves'])


def _graphed_ms(params, dev, mesh, batch, iters):
    """Device ms of a replay of the captured update (its collectives
    captured when ``mesh`` has a group)."""
    state = _state(params, dev, mesh)
    step = make_gmd_train_step(state.model, state, params)
    gen = torch.Generator(dev).manual_seed(0)
    state.set_lr()
    tick = _GraphedTick(lambda b: step.inner(b, gen), (gen,))
    for _ in range(_GraphedTick.WARMUP + 1):
        tick(batch)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        tick(batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _allreduce_ms(mesh, numel, dev, iters):
    """(ms, GB/s bus rate) of one flat f32 all-reduce of ``numel``."""
    flat = torch.ones(numel, device=dev)
    for _ in range(3):
        mesh.all_sum_(flat)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        mesh.all_sum_(flat)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    bus = 2 * (mesh.world - 1) / mesh.world * 4 * numel / (ms * 1e-3) / 1e9
    return ms, bus


def measure(args) -> dict:
    mesh = create_mesh(None, args.device)
    dev = mesh.device
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        exact_bf16_products()
    params = (parse_params(['--cfg', 'charades_cd_i3d.yml', *TINY])
              if args.tiny else load_config('charades_cd_i3d.yml'))
    out = {'world': mesh.world, 'backend': mesh.backend,
           'device': str(dev), 'cases': []}
    n = args.updates
    lr = float(params['lr'])
    for global_b in args.global_batch:
        if global_b % mesh.world:
            raise ValueError(f'--global-batch {global_b} over {mesh.world}')
        case = {'global_batch': global_b, 'local_batch': global_b // mesh.world}
        batch = train_batch(params, global_b, dev, seed=0)
        rows = {k: v[mesh.rank::mesh.world] for k, v in batch.items()}
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        repl = _state(params, dev, mesh)
        metrics, ms, peak = _updates(params, dev, repl, rows, n)
        weights = {k: v.detach().clone() for k, v in repl.weights().items()}
        digests = [torch.empty_like(_digest(weights))
                   for _ in range(mesh.world)]
        if mesh.distributed:
            torch.distributed.all_gather(digests, _digest(weights))
        else:
            digests = [_digest(weights)]
        if not all(torch.equal(d, digests[0]) for d in digests):
            raise AssertionError('ddp: the ranks\' weights differ')
        case.update(ranks_bit_equal=True, ddp_eager_ms=ms,
                    ddp_peak_mib=peak,
                    ddp_resident_bytes=resident_state_bytes(repl))
        numel = sum(p.numel() for p in repl.model.parameters())
        del repl
        if mesh.is_rank0:
            one = _state(params, dev, None)
            want, _, _ = _updates(params, dev, one, batch, n)
            err = abs(metrics[0]['loss'] - want[0]['loss']) / \
                abs(want[0]['loss'])
            if err > LOSS_RTOL:
                raise AssertionError(f'ddp step-1 loss {metrics[0]} against '
                                     f'{want[0]}')
            (case['ddp_worst_rel_l2'], case['ddp_worst_parameter'],
             case['ddp_adam_step_parameters']) = _hold(
                'ddp', weights, one.weights(), lr, n + 1)
            case['ddp_step1_loss_rel_err'] = err
            del one
        mesh.barrier()
        if dev.type == 'cuda':
            times = {'none': [], 'mesh': []}
            for name in ('none', 'mesh', 'mesh', 'none'):
                times[name].append(_graphed_ms(
                    params, dev, mesh if name == 'mesh' else None, rows,
                    args.iters))
            case.update(graphed_ms_no_group=times['none'],
                        graphed_ms_mesh=times['mesh'])
            case['allreduce_ms'], case['allreduce_bus_gb_s'] = \
                _allreduce_ms(mesh, numel, dev, args.iters)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        shrd = _state(params, dev, mesh, sharded=mesh.distributed)
        smetrics, sms, speak = _updates(params, dev, shrd, rows, n)
        sweights = shrd.weights()
        err = abs(smetrics[0]['loss'] - metrics[0]['loss']) / \
            abs(metrics[0]['loss'])
        if err > LOSS_RTOL:
            raise AssertionError(f'fsdp step-1 loss {smetrics[0]} against '
                                 f'{metrics[0]}')
        (case['fsdp_worst_rel_l2'], case['fsdp_worst_parameter'],
         case['fsdp_adam_step_parameters']) = _hold(
            'fsdp', sweights, weights, lr, n + 1)
        case.update(fsdp_step1_loss_rel_err=err, fsdp_eager_ms=sms, fsdp_peak_mib=speak,
                    fsdp_resident_bytes=resident_state_bytes(shrd),
                    fsdp_leaves_split=(0 if shrd.sharded is None else sum(
                        d is not None for d in shrd.sharded.plan.values())))
        del shrd
        out['cases'].append(case)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--global-batch', type=int, nargs='+', default=[32])
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--updates', type=int, default=STEPS)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if args.device == 'cpu':
        torch.set_num_threads(1)
    out = measure(args)
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        return 0
    if args.device != 'cpu':
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60).stdout.strip())
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
