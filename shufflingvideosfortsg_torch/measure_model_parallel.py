"""The model and pipe axes across ranks: GMD updates under ``torchrun``.

    torchrun --nproc_per_node 4 -m shufflingvideosfortsg_torch.measure_model_parallel \\
        [--iters 10] [--out mp.json]
    torchrun --standalone --nproc_per_node 4 -m shufflingvideosfortsg_torch.measure_model_parallel \\
        --device cpu --tiny   # the same paths over gloo on the CPU

Every rank builds GMD from the seeded weights at the width of
``cfgs/charades_cd_i3d.yml`` (``--tiny``: H=8, T=24, D=32, N=8) and takes
its rows of one seeded global batch of 32 pairs
(``profile_train.train_batch``):

1. ``one``: on rank 0 alone, no group, the unsharded update at H=512 (the
   widened GMD; K3 and K4 read W_hh from device memory there), and the
   sequential update of QAVE 5 blocks deep at H=256;
2. ``tp``: the tensor-parallel update at H=512 on a (2, 2) and a (1, 4)
   mesh (``train/tp.py``), each rank's device ms;
3. ``allgather``: one per-step all-gather of h ([2, 64, H/n] f32 over the
   model axis), in µs;
4. ``pp``: the pipelined update at 4 stages (QAVE 5 blocks deep, H=256,
   ``train/pipelined.py``) in 4 and 8 microbatches, each rank's device ms;
   and its pipeline alone (``pipeline_blocks``' forward and backward over
   the 64 encoder rows) against n_micro times one stage's forward and
   backward of a microbatch by itself: the measured efficiency (n_micro
   times that over the pipeline's time) beside GPipe's n_micro /
   (n_micro + n - 1), and the bubble share, one less either.

On a card each time is the device ms of a replay of a CUDA graph (the
axis's collectives captured), from CUDA events over ``--iters`` replays;
on the CPU the wall ms of eager calls. Rank 0 prints the card
(``nvidia-smi``'s name and power limit) and one JSON line, also written to
``--out``.
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
from .models.components import QueryAwareEncoder
from .parallel.mesh import replicate_state, world_size
from .parallel.pipeline import create_pp_mesh, pipeline_blocks
from .parallel.tensor_parallel import create_tp_mesh
from .profile_train import train_batch
from .train.pipelined import (make_gmd_pipelined_train_step,
                              to_pipelined_state)
from .train.state import TrainState
from .train.steps import make_gmd_train_step
from .train.tp import make_gmd_tp_train_step
from .utils.device import exact_bf16_products

GLOBAL_BATCH = 32
TP_HIDDEN = 512
PP_STAGES = 4
TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16']


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _timed_ms(fn, dev, iters: int, generators=()) -> float:
    """ms a call of ``fn()``: on a card a replay of its CUDA graph
    (captured after two eager calls, ``generators`` registered), from
    events over ``iters`` replays; on the CPU eager calls on the wall
    clock."""
    if dev.type != 'cuda':
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    tick = _GraphedTick(lambda _: fn() or {}, tuple(generators))
    dummy = {'x': torch.zeros(1, device=dev)}
    for _ in range(_GraphedTick.WARMUP + 1):
        tick(dummy)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        tick(dummy)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _update_ms(params, dev, mesh, kind: str, iters: int,
               n_micro: int = 4) -> float:
    """ms an update of ``kind`` ('plain', 'tp', 'pp') on the mesh's rows
    of the seeded global batch."""
    model = _seeded_model(params, dev).train()
    state = TrainState(model, params, steps_per_epoch=1000)
    if mesh is not None:
        state.mesh = mesh
        replicate_state(mesh, state)
    if kind == 'tp':
        step = make_gmd_tp_train_step(model, state, params, mesh)
    elif kind == 'pp':
        to_pipelined_state(state, mesh)
        step = make_gmd_pipelined_train_step(model, state, params, mesh,
                                             n_micro)
    else:
        step = make_gmd_train_step(model, state, params)
    batch = train_batch(params, GLOBAL_BATCH, dev, seed=0)
    if mesh is not None:
        batch = {k: v[mesh.rank::mesh.world] for k, v in batch.items()}
    gen = torch.Generator(dev).manual_seed(0)
    state.set_lr()
    ms = _timed_ms(lambda: step.inner(batch, gen), dev, iters, (gen,))
    _sync(dev)
    return ms


def _allgather_us(axis, rows: int, H: int, dev, iters: int) -> float:
    """µs of one all-gather of h [2, rows, H/n] f32 over ``axis``,
    ``iters`` of them a timed call."""
    h = torch.randn(2, rows, H // axis.size, device=dev)

    def gathers():
        for _ in range(iters):
            axis.all_gather(h)
    return _timed_ms(gathers, dev, 3) * 1e3 / iters


def _pipeline_ms(params, axis, n_micro: int, dev, iters: int):
    """(ms of the pipeline's forward and backward over the global batch's
    encoder rows, ms of one stage's forward and backward of a microbatch
    alone)."""
    H, T = params['video_rnn_hiddendim'], params['video_len']
    N, Ds = params['sent_len'], 2 * params['sent_rnn_hiddendim']
    torch.manual_seed(0)
    block = QueryAwareEncoder(2 * H, H, params['video_rnn_layers'], 2, Ds,
                              0.0).blocks[1].to(dev)
    rows = 2 * GLOBAL_BATCH
    x = torch.randn(rows, T, 2 * H, device=dev, requires_grad=True)
    w = torch.randn(rows, N, Ds, device=dev, requires_grad=True)
    g = torch.randn(rows, T, 2 * H, device=dev)
    m = rows // n_micro

    def pipe():
        torch.autograd.backward(pipeline_blocks(block, x, w, axis, n_micro),
                                g)

    def alone():
        torch.autograd.backward(block(x[:m], w[:m]), g[:m])

    return _timed_ms(pipe, dev, iters), _timed_ms(alone, dev, iters)


def _gathered(values, dev):
    """Every rank's float, in rank order."""
    t = torch.tensor([float(values)], device=dev)
    if not torch.distributed.is_initialized():
        return [float(t)]
    out = [torch.zeros_like(t) for _ in range(world_size())]
    torch.distributed.all_gather(out, t)
    return [float(o) for o in out]


def measure(args) -> dict:
    device = args.device
    base = (parse_params(['--cfg', 'charades_cd_i3d.yml', *TINY])
            if args.tiny else load_config('charades_cd_i3d.yml'))
    world = world_size()
    if world != PP_STAGES:
        raise ValueError(f'{world} ranks: the axes are measured on '
                         f'{PP_STAGES}')
    wide = dict(base, video_rnn_hiddendim=(base['video_rnn_hiddendim']
                                           if args.tiny else TP_HIDDEN))
    deep = dict(base, pipeline_stages=PP_STAGES)
    out = {'world': world, 'global_batch': GLOBAL_BATCH,
           'H_tp': wide['video_rnn_hiddendim'],
           'H_pp': deep['video_rnn_hiddendim']}
    mesh = create_pp_mesh(1, PP_STAGES, device)  # starts the group
    dev = mesh.device
    out['device'] = str(dev)
    if dev.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        exact_bf16_products()
    if mesh.is_rank0:
        out['one_card_tp_width_update_ms'] = _update_ms(
            wide, dev, None, 'plain', args.iters)
        out['one_card_deep_update_ms'] = _update_ms(deep, dev, None,
                                                    'plain', args.iters)
    mesh.barrier()
    out['tp'] = {}
    for mp in (2, PP_STAGES):
        tp_mesh = create_tp_mesh(world // mp, mp, device)
        ms = _update_ms(wide, dev, tp_mesh, 'tp', args.iters)
        us = _allgather_us(tp_mesh.inner, 2 * GLOBAL_BATCH,
                           wide['video_rnn_hiddendim'], dev, 100)
        out['tp'][str(mp)] = {'mesh': [world // mp, mp],
                              'update_ms': _gathered(ms, dev),
                              'allgather_us': _gathered(us, dev),
                              'allgather_shape': [2, 2 * GLOBAL_BATCH,
                                                  wide['video_rnn_hiddendim']
                                                  // mp]}
    out['pp'] = {}
    for n_micro in (4, 8):
        ms = _update_ms(deep, dev, mesh, 'pp', args.iters, n_micro)
        pipe, alone = _pipeline_ms(deep, mesh.inner, n_micro, dev,
                                   args.iters)
        n = PP_STAGES
        eff = n_micro * max(_gathered(alone, dev)) / max(_gathered(pipe, dev))
        ideal = n_micro / (n_micro + n - 1)
        out['pp'][str(n_micro)] = {
            'update_ms': _gathered(ms, dev),
            'pipeline_ms': _gathered(pipe, dev),
            'stage_microbatch_ms': _gathered(alone, dev),
            'efficiency': eff, 'ideal_efficiency': ideal,
            'bubble_share': 1 - eff, 'ideal_bubble_share': 1 - ideal}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)
    res = measure(args)
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        return 0
    if res['device'].startswith('cuda'):
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(smi[0] if smi else 'nvidia-smi: no answer')
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
