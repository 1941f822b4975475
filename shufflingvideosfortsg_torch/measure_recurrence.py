"""Time the recurrence kernels K1, K3 and K4 (``lstm_recurrence``,
``lstm_recurrence_train``, ``lstm_recurrence_bwd``) at the shapes the
evaluation, training and serving paths give them, in f32 and bf16.

    python -m shufflingvideosfortsg_torch.measure_recurrence [--iters 20]

Prints the card's name and power limit, then one line a case: the kernel,
(T, B, H), the dtype of xw and W_hh, the kernel's milliseconds and how
they were timed. The cases are K1 at (128, 32, 256) (an evaluation
batch's video layers), (15, 32, 256) (its sentence layers), (128, 256,
256) (the graphed tick), (1024, 1, 256) and (1024, 512, 256) (one served
video and a batch of 512 queries), and K3 and K4 at (128, 64, 256) and
(15, 32, 256) (a train step's); K4's line also gives its weight-gradient
kernel alone (``lstm_weight_grad``) and the recurrence, K4 less that. The
inputs come from ``np.random.RandomState(0)`` (K4's: the forward's
residuals of them, and seeded cotangents). Times come from CUDA events
over ``--iters`` calls after two (3 at T*B above 100,000); at T=15, where
a call lasts about as long as the gaps between launches, over replays of
a CUDA graph of ``--iters`` calls in a row (``timing=graph``).

The file uses nothing of the package but ``lstm_recurrence``,
``lstm_recurrence_train``, ``lstm_recurrence_bwd``, ``lstm_weight_grad``
and ``FLAT``, so another checkout's kernels are timed on the same inputs
by copying this file into that checkout's package and running it there.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from .ops.lstm_scan import (FLAT, lstm_recurrence, lstm_recurrence_bwd,
                            lstm_recurrence_train, lstm_weight_grad)

CASES = (('K1', 128, 32, 256), ('K1', 15, 32, 256), ('K1', 128, 256, 256),
         ('K1', 1024, 1, 256), ('K1', 1024, 512, 256),
         ('K3', 128, 64, 256), ('K3', 15, 32, 256),
         ('K4', 128, 64, 256), ('K4', 15, 32, 256))
GRAPH_T = 15  # cases timed over a CUDA graph of calls
_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Mean milliseconds of fn() on the card, from CUDA events around
    ``replays`` replays of one CUDA graph of ``calls`` calls in a row, so
    that no gap between launches counts (two calls first, outside it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def timed_ms(fn, iters: int, graph: bool) -> float:
    """cuda_ms, or graph_ms where ``graph``, without autograd."""
    with torch.no_grad():
        return graph_ms(fn, iters) if graph else cuda_ms(fn, iters)


def backward_args(x, w, rng):
    """K4's inputs: the forward's (x, w), its residuals out and c_seq from
    ``lstm_recurrence_train`` and seeded cotangents (d_out in x's dtype)."""
    T, B, H = x.shape[0], x.shape[1], x.shape[2] // 8
    with torch.no_grad():
        out, c_seq, _, _ = lstm_recurrence_train(x, w)
    d_out, d_hT, d_cT = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                         .cuda() for shape in ((T, B, 2 * H), (2, B, H),
                                               (2, B, H)))
    return x, w, out, c_seq, d_out.to(x.dtype), d_hT, d_cT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('measure_recurrence: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    rng = np.random.RandomState(0)
    for kernel, T, B, H in CASES:
        xw = torch.from_numpy(rng.randn(T, B, 8 * H).astype(np.float32))
        w_hh = torch.from_numpy(((rng.rand(2, H, 4 * H) * 2 - 1)
                                 / np.sqrt(H)).astype(np.float32))
        iters = 3 if T * B > 100_000 else args.iters
        graph = T == GRAPH_T
        for dtype in (torch.float32, torch.bfloat16):
            x, w = xw.to('cuda', dtype), w_hh.to('cuda', dtype)
            extra = ''
            if kernel == 'K4':
                bwd = backward_args(x, w, rng)
                ms = timed_ms(lambda: lstm_recurrence_bwd(*bwd), iters, graph)
                d_xw, _ = lstm_recurrence_bwd(*bwd)
                wg = timed_ms(lambda: lstm_weight_grad(bwd[2], d_xw, dtype,
                                                       FLAT), iters, graph)
                extra = (f' weight_grad_ms={wg:.4f} '
                         f'recurrence_ms={ms - wg:.4f}')
                del bwd, d_xw
            else:
                fn = lstm_recurrence if kernel == 'K1' else lstm_recurrence_train
                ms = timed_ms(lambda: fn(x, w), iters, graph)
            print(f'{kernel} T={T} B={B} H={H} dtype={_NAMES[dtype]} '
                  f'kernel_ms={ms:.4f}{extra} '
                  f"timing={'graph' if graph else 'events'}", flush=True)
            del x, w
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
