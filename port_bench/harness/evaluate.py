"""Evaluation cells: the port's banked, graphed evaluation
(``cli._banked_eval_epoch`` over ``train/steps.make_gmd_test_step``) over
the corpus's sentences in file order, at the configuration's test batch
and ``eval_scan_group`` batches a tick.

The epoch goes through in segments of ``segment_batches`` batches, each
one call of ``_banked_eval_epoch`` (its index arrays uploaded once, its
ticks replays of one CUDA graph, its outputs fetched at its end), the
segments in order and round again, until ``--seconds`` have passed. The
first segment's call, which builds and captures the graph, is set-up.
After the window the reference grounds a sample of the batches answered
in it, drawn from the seed.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from . import check, common, reference, seeded, traffic
from .trace import Trace

TRACE_SECONDS = 2.0


def run_cell(cell: common.Cell, run: common.Run) -> None:
    from shufflingvideosfortsg_torch.cli import _banked_eval_epoch
    from shufflingvideosfortsg_torch.train.steps import make_gmd_test_step

    dev = run.device
    params = common.port_params(cell.config)
    T, D = params['video_len'], params['video_feature_dim']
    B, G = int(params['batch_size'][0]), int(params['eval_scan_group'])
    seg = int(cell.mix['segment_batches'])
    corpus = traffic.build_corpus(cell.config, common.ROOT)
    words = seeded.words(run.seed, corpus.vocab_size,
                         params['sent_embedding_dim'], dev)
    bank = common.bank(corpus, words, run.seed, T, D, dev)
    w = seeded.weights(common.shapes(params), run.seed, dev)
    model = common.port_model(params, w, dev).eval()
    step = make_gmd_test_step(model, False, bank.assemble)

    P = corpus.num_pairs
    n_batches = -(-P // B)
    rows = [np.arange(i * B, (i + 1) * B) % P for i in range(n_batches)]
    real = [min(B, P - i * B) for i in range(n_batches)]
    batches = [traffic.index_batch(corpus, r, T) for r in rows]
    segments = [range(s, min(s + seg, n_batches))
                for s in range(0, n_batches, seg)]

    def call(k):
        with record_function('bench.eval.segment'):
            return _banked_eval_epoch(step, [batches[i] for i in segments[k]],
                                      bank, dev, group=G)

    call(0)
    common.sync(dev)
    trace = Trace() if run.trace else None
    answers: Dict[int, Dict[str, np.ndarray]] = {}
    sentences, traced_ticks, k = 0, 0, 1 % len(segments)
    t0 = run.open_window()
    tracing = trace is not None
    if tracing:
        trace.__enter__()
    while True:
        out = call(k)
        for j, i in enumerate(segments[k]):
            answers[i] = {name: v[j] for name, v in out.items()}
        sentences += sum(real[i] for i in segments[k])
        now = time.perf_counter() - t0
        if tracing:
            traced_ticks += -(-len(segments[k]) // G)
            if now >= TRACE_SECONDS:
                trace.__exit__(None, None, None)
                tracing = False
        k = (k + 1) % len(segments)
        if now >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    if tracing:
        trace.__exit__(None, None, None)
    run.attempted = sentences
    run.metrics['eval_sentences_per_s'] = sentences / run.window_s
    run.memory_peak = common.memory_peak(dev)
    if trace is not None:
        run.ctx.update(trace=trace.reduce(), units=traced_ticks,
                       unit_rows=B * G, kind='eval', params=params)
    del step, model, bank
    common.free(dev)

    rng = np.random.RandomState(run.seed % 2 ** 32)
    done = sorted(answers)
    picked = rng.choice(done, min(int(cell.mix['checked_batches']),
                                  len(done)), replace=False)
    ref = reference.Model(w, _ref_cfg(params))
    idx = [batches[i] for i in picked]
    cat = {k: np.concatenate([b[k] for b in idx]) for k in idx[0]}
    with reference.precision(tf32=False), torch.no_grad():
        st, en = ground(ref, cat, words, corpus.nfeats, run.seed, T, D, dev)
    se = torch.as_tensor(cat['framestps'], device=dev)
    ref_nll = reference.nll(st, en, se).view(len(idx), B).mean(1)
    losses = [float(answers[i]['loss']) for i in picked]
    numbers = check.answer_numbers(
        np.concatenate([answers[i]['pred_time'] for i in picked]).round(),
        np.concatenate([answers[i]['score'] for i in picked]), st, en)
    numbers['loss_gap'] = max(abs(p - float(r)) / abs(float(r))
                              for p, r in zip(losses, ref_nll))
    run.ctx['numbers'] = numbers


REF_ROWS = 256  # rows a reference call grounds


def ground(ref, cat: Dict[str, np.ndarray], words, nfeats, seed: int,
           T: int, D: int, dev):
    """The reference's (start, end) probabilities of the pairs ``cat``
    (index arrays), in calls of ``REF_ROWS`` rows, the features made
    again from the seed."""
    starts, ends = [], []
    for lo in range(0, len(cat['pack_row']), REF_ROWS):
        sl = slice(lo, lo + REF_ROWS)
        video = seeded.rows_features(seed, nfeats, cat['pack_row'][sl], T, D,
                                     dev).float()
        query = words[torch.as_tensor(cat['token_ids'][sl], device=dev)]
        st, en = ref.ground(video, query)
        starts.append(st)
        ends.append(en)
    return torch.cat(starts), torch.cat(ends)


def _ref_cfg(params) -> Dict:
    return {'sent_layers': params['sent_rnn_layers'],
            'video_layers': params['video_rnn_layers'], 'nblocks': 2,
            'dropout': float(params['dropout']),
            'disc_dropout': float(params['disc_dropout'])}
