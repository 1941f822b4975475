"""Serving cells: the port's ``gateway.ServingGateway`` over a
``serving.MultiQueryGrounder`` whose corpus (``set_corpus``) holds every
video's block-0 recurrence, under open-loop traffic.

Set-up builds the grounder from the seeded weights, pins the seeded word
vectors (``set_vocab``) and the corpus, starts the gateway with the mix's
``query_batch`` and ``pipeline_depth`` and the gateway's own batching
defaults, and serves ``warmup_batches`` full batches. The window sends
each request (one sentence's token ids against one video row) at its due
time from one client thread, whatever the backlog; the results are
taken once the last is posted. A request is timed from its due time to the moment the
gateway posted its result (its completer's ``complete`` call returned);
one refused, or without a result a minute after the window closed,
counts as failed, at that minute. After the window the reference grounds
a sample of the answered requests, drawn from the seed, with the longest
sentences in it, from the features and weights alone (block 0 worked out
again).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np
import torch

from . import check, common, evaluate, reference, seeded, traffic
from .trace import Trace

TRACE_SECONDS = 3.0
LATE_S = 60.0  # how long past the window a result may come


def _grounder(cell, run, params, corpus, words, w, dev):
    from shufflingvideosfortsg_torch.gateway import ServingGateway
    from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
    T, D = params['video_len'], params['video_feature_dim']
    g = MultiQueryGrounder(params, w, device=dev,
                           query_batch=int(cell.mix['query_batch']))
    g.set_vocab(words.cpu().numpy())
    g.set_corpus(common.SeededPack(run.seed, corpus.nfeats, T, D, dev))
    gw = ServingGateway(g, mode='bank',
                        pipeline_depth=int(cell.mix['pipeline_depth']),
                        capacity=int(cell.mix['queue_capacity']))
    return g, gw


def _posted(gw) -> list:
    """The list of (tickets, host clock) the gateway's results were posted
    at: its queue's ``complete`` wrapped, once, to note the moment each
    batch of results was posted."""
    queue = gw.queue
    if not hasattr(queue, 'bench_posted'):
        complete, posted = queue.complete, []

        def timed(tickets, *rest):
            complete(tickets, *rest)
            posted.append((np.array(tickets), time.perf_counter()))
        queue.complete = timed
        queue.bench_posted = posted
    return queue.bench_posted


def serve_window(gw, corpus, plan: Dict, seconds: float,
                 trace: 'Trace' = None) -> Dict:
    """Sends the plan's requests on time from one thread, whatever the
    backlog, and takes their results once the last is posted (the
    gateway's queue holds them; taking them during the window would put a
    client thread beside the gateway's on the interpreter lock):
    {'latency_s', 'answers' [n, 3] (start, end, score; NaN where none),
    'failed' [n] bool, 'sent_late_s' [n], 'elapsed_s'}."""
    n = len(plan['due'])
    due = plan['due']
    tokens = corpus.token_ids[plan['pair']]
    rows = plan['video_row']
    tickets = np.full(n, -1, np.int64)
    late = np.zeros(n)
    answers = np.full((n, 3), np.nan)
    posted = _posted(gw)
    posted.clear()
    t0 = time.perf_counter()

    def sender():
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t0 - due[i]
            try:
                tickets[i] = gw.submit(tokens[i], int(rows[i]))
            except RuntimeError:
                pass  # refused (queue full, gateway down): failed

    thread = threading.Thread(target=sender, name='bench-sender')
    thread.start()
    if trace is not None:
        with trace:
            time.sleep(min(TRACE_SECONDS, seconds))
    thread.join()
    sent = int((tickets >= 0).sum())
    deadline = time.perf_counter() + LATE_S
    while sum(len(t) for t, _ in list(posted)) < sent and \
            time.perf_counter() < deadline:
        time.sleep(0.005)
    end = time.perf_counter()
    for i in np.nonzero(tickets >= 0)[0]:
        try:
            answers[i] = gw.result(int(tickets[i]),
                                   max(deadline - time.perf_counter(), 0.001))
        except (TimeoutError, RuntimeError):
            pass  # no result by the deadline, or the gateway died: failed
    post = np.full(n, np.nan)
    where = {int(tk): j for j, tk in enumerate(tickets) if tk >= 0}
    for tks, at in list(posted):
        for tk in tks:
            j = where.get(int(tk))
            if j is not None:
                post[j] = at - t0
    failed = ~np.isfinite(answers[:, 2]) | ~np.isfinite(post)
    lat = np.where(failed, seconds + LATE_S - due, post - due)
    return {'latency_s': lat, 'answers': answers, 'failed': failed,
            'sent_late_s': late, 'elapsed_s': end - t0}


def setup(cell: common.Cell, run: common.Run):
    """(params, corpus, word vectors, weights, grounder, gateway), the
    gateway warmed up by ``warmup_batches`` full batches."""
    dev = run.device
    params = common.port_params(cell.config)
    corpus = traffic.build_corpus(cell.config, common.ROOT)
    words = seeded.words(run.seed, corpus.vocab_size,
                         params['sent_embedding_dim'], dev)
    w = seeded.weights(common.shapes(params), run.seed, dev)
    g, gw = _grounder(cell, run, params, corpus, words, w, dev)
    n = g.query_batch * int(cell.mix['warmup_batches'])
    warm = {'due': np.zeros(n), 'pair': np.arange(n) % corpus.num_pairs,
            'video_row': np.arange(n) % corpus.num_videos}
    serve_window(gw, corpus, warm, 0.0)
    common.sync(dev)
    return params, corpus, words, w, g, gw


def run_cell(cell: common.Cell, run: common.Run) -> None:
    dev = run.device
    params, corpus, words, w, g, gw = setup(cell, run)
    T, D = params['video_len'], params['video_feature_dim']
    qb = g.query_batch
    stats0 = gw.stats()

    plan = traffic.schedule(traffic.request_pool(corpus, cell.mix,
                                                 run.seconds), run.seed)
    trace = Trace() if run.trace else None
    run.open_window()
    res = serve_window(gw, corpus, plan, run.seconds, trace)
    run.window_s = res['elapsed_s']
    stats1 = gw.stats()
    gw.close()
    lat_ms = res['latency_s'] * 1e3
    run.attempted = len(lat_ms)
    run.failed = int(res['failed'].sum())
    run.metrics['serve_p95_ms'] = float(np.percentile(lat_ms, 95))
    run.memory_peak = common.memory_peak(dev)
    batches = stats1['batches'] - stats0['batches']
    fill = ((stats1['mean_batch'] * stats1['batches']
             - stats0['mean_batch'] * stats0['batches']) / max(batches, 1))
    late = res['sent_late_s']
    run.ctx.update(note_sender_late_ms_p50_p99=[
        float(np.percentile(late, 50) * 1e3),
        float(np.percentile(late, 99) * 1e3)],
        note_batches=int(batches), note_requests=len(lat_ms))
    run.ctx.update(latency_ms=lat_ms, kind='serve', params=params,
                   unit_rows=qb, batch_fill=fill / gw.max_batch)
    if trace is not None:
        run.ctx['trace'] = trace.reduce()
    del gw, g
    common.free(dev)

    ok = np.nonzero(~res['failed'])[0]
    n_check = min(int(cell.mix['checked_requests']), len(ok))
    longest = ok[np.argsort(-corpus.n_words[plan['pair'][ok]],
                            kind='stable')[:n_check // 16]]
    rng = np.random.RandomState(run.seed % 2 ** 32)
    rest = np.setdiff1d(ok, longest)
    picked = np.concatenate([longest, rng.choice(
        rest, min(n_check - len(longest), len(rest)), replace=False)])
    cat = {'pack_row': plan['video_row'][picked],
           'token_ids': corpus.token_ids[plan['pair'][picked]]}
    ref = reference.Model(w, evaluate._ref_cfg(params))
    with reference.precision(tf32=False), torch.no_grad():
        st, en = evaluate.ground(ref, cat, words, corpus.nfeats, run.seed, T,
                                 D, dev)
    ans = res['answers'][picked]
    run.ctx['numbers'] = check.answer_numbers(ans[:, :2].round(), ans[:, 2],
                                              st, en)
