"""Training cells: GMD trained on a resident bank in the port's graphed
chunks (``cli._banked_train_chunks_factory`` over
``train/steps.make_gmd_train_step``), on one card or on P ranks of a
process group (the data axis: one flat all-reduce of the gradients a
step, captured with the step).

Set-up builds the train step, its model and Adam's state once, and drives
that same object through the epoch's first three steps, one chunk of one
step each (the first two run eagerly, the third is captured), keeping
each step's loss, Adam's first moments after step 1 (the first gradient,
as Adam took it) and the weights after step 3; then one whole chunk. The
window runs whole chunks of ``train_scan_chunk`` steps in the sampler's
shuffled order until ``--seconds`` have passed (on P ranks rank 0's clock
decides, broadcast to the others once a chunk). After it, the reference
follows the three steps from the same weights, batches and draws.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from . import check, common, reference, seeded, traffic
from .trace import Trace

TRACE_SECONDS = 2.0
CHECKED_STEPS = 3


def _batches(corpus, T: int, rows: int, seed: int, rank: int, world: int,
             chunk: int):
    """Chunks of index batches, epoch after epoch: the first three steps
    alone, then chunks of ``chunk`` that never straddle an epoch."""
    epoch = 0
    while True:
        order = traffic.epoch_order(corpus.num_pairs, seed, epoch)
        idx = traffic.stripe_batches(order, rows, rank, world)
        batches = [traffic.index_batch(corpus, i, T) for i in idx]
        at = 0
        if epoch == 0:
            for _ in range(CHECKED_STEPS):
                yield batches[at:at + 1]
                at += 1
        while at < len(batches):
            yield batches[at:at + chunk]
            at += chunk
        epoch += 1


def _stop(run: common.Run, elapsed: float) -> bool:
    """Whether the window is over: rank 0's clock, agreed by all ranks."""
    flag = torch.tensor([1.0 if elapsed >= run.seconds else 0.0],
                        device=run.device)
    if run.mesh is not None and run.mesh.distributed:
        torch.distributed.broadcast(flag, 0, group=run.mesh.group)
    return bool(flag.item())


def run_cell(cell: common.Cell, run: common.Run) -> None:
    from shufflingvideosfortsg_torch.cli import _banked_train_chunks_factory
    from shufflingvideosfortsg_torch.parallel.mesh import replicate_state
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import make_gmd_train_step

    dev = run.device
    params = common.port_params(cell.config)
    T, D = params['video_len'], params['video_feature_dim']
    global_rows = int(params['batch_size'][0])
    rows = global_rows // run.world
    chunk = int(params['train_scan_chunk'])
    corpus = traffic.build_corpus(cell.config, common.ROOT)
    words = seeded.words(run.seed, corpus.vocab_size,
                         params['sent_embedding_dim'], dev)
    bank = common.bank(corpus, words, run.seed, T, D, dev)
    w0 = seeded.weights(common.shapes(params), run.seed, dev)
    model = common.port_model(params, w0, dev).train()
    per_epoch = len(traffic.stripe_batches(
        np.arange(corpus.num_pairs), rows, run.rank, run.world))
    state = TrainState(model, params, steps_per_epoch=per_epoch)
    if run.mesh is not None and run.mesh.distributed:
        state.mesh = run.mesh
        replicate_state(run.mesh, state)
    step = make_gmd_train_step(model, state, params, False, bank.assemble)
    gen = seeded.generator(run.seed, 'train', 0, dev)
    chunk_run = _banked_train_chunks_factory(step, bank, dev, graphed=True)
    feed = _batches(corpus, T, rows, run.seed, run.rank, run.world, chunk)

    names = {p: n for n, p in model.named_parameters()}
    beta1 = state.optimizer.param_groups[0]['betas'][0]
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for k in range(CHECKED_STEPS):
        with record_function('bench.train.chunk'):
            out = chunk_run(next(feed), gen)
        losses.append(float(out['loss']))
        if k == 0:
            parts = {t: float(out[t]) for t in reference.TERMS}
            moments = {names[p]: s['exp_avg'] for p, s in
                       state.optimizer.state.items() if 'exp_avg' in s}
            first = {n: (moments[n].detach() / (1 - beta1) if n in moments
                         else torch.zeros_like(p))
                     for n, p in model.named_parameters()}
    change = {n: (p.detach() - w0[n]) for n, p in model.named_parameters()}
    chunk_run(next(feed), gen)
    common.sync(dev)

    trace = Trace() if run.trace else None
    traced_steps, steps, failed = 0, 0, 0
    t0 = run.open_window()
    tracing = trace is not None
    if tracing:
        trace.__enter__()
    while True:
        batches = next(feed)
        with record_function('bench.train.chunk'):
            out = chunk_run(batches, gen)
        loss = float(out['loss'])
        failed += 0 if np.isfinite(loss) else len(batches)
        steps += len(batches)
        now = time.perf_counter() - t0
        if tracing:
            traced_steps += len(batches)
            if now >= TRACE_SECONDS:
                trace.__exit__(None, None, None)
                tracing = False
        if _stop(run, now):
            break
    common.sync(dev)
    run.window_s = time.perf_counter() - t0
    if tracing:
        trace.__exit__(None, None, None)
    run.ctx['note_steps'] = steps
    run.attempted = steps * global_rows
    run.failed = failed * global_rows
    run.metrics['train_pairs_per_s'] = steps * global_rows / run.window_s
    run.memory_peak = common.memory_peak(dev)
    if trace is not None:
        run.ctx.update(trace=trace.reduce(), units=traced_steps,
                       unit_rows=rows, kind='train', params=params)

    del chunk_run, step, state, model, bank, out
    common.free(dev)
    if run.rank != 0:
        return
    ref_batches = _reference_batches(corpus, words, run.seed, T, D,
                                     global_rows, dev)
    cfg = {'sent_layers': params['sent_rnn_layers'],
           'video_layers': params['video_rnn_layers'], 'nblocks': 2,
           'dropout': float(params['dropout']),
           'disc_dropout': float(params['disc_dropout'])}
    with reference.precision(tf32=False):
        ref_losses, ref_first, ref_raw, ref_change, ref_parts = \
            reference.train_steps(
                w0, cfg, ref_batches,
                seeded.generator(run.seed, 'train', 0, dev),
                float(params['lr']), float(params['weight_decay']))
    numbers = check.train_numbers(losses, ref_losses, first, ref_first,
                                  ref_raw, change, ref_change, parts,
                                  ref_parts)
    run.ctx['numbers'] = numbers
    run.ctx['note_losses'] = [losses, ref_losses]
    run.ctx['note_first_loss_terms'] = [parts, ref_parts]
    run.ctx['note_widest_first_grad_leaves'] = check.leaf_gaps(
        first, ref_first, ref_first)[:5]
    run.ctx['note_widest_change_leaves'] = check.leaf_gaps(
        change, ref_change, check.moving_leaves(ref_raw))[:3]


def _reference_batches(corpus, words, seed: int, T: int, D: int,
                       rows: int, dev) -> List[Dict[str, torch.Tensor]]:
    """The first three global batches of the epoch, for the reference: the
    same pairs (a P-rank step's global batch is the single process's, row
    j on rank j % P), the features made again from the seed."""
    order = traffic.epoch_order(corpus.num_pairs, seed, 0)
    out = []
    for k in range(CHECKED_STEPS):
        b = traffic.index_batch(corpus, order[k * rows:(k + 1) * rows], T)
        video = seeded.rows_features(seed, corpus.nfeats, b['pack_row'], T,
                                     D, dev).float()
        out.append({'video': video,
                    'query': words[torch.as_tensor(b['token_ids'],
                                                   device=dev)],
                    'se': torch.as_tensor(b['framestps'], device=dev),
                    'nfeats': torch.as_tensor(b['nfeats'], device=dev)})
    return out
