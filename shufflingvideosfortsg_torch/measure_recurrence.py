"""Time the forward recurrence kernels K1 and K3 (``lstm_recurrence``,
``lstm_recurrence_train``) at the shapes the evaluation, training and
serving paths give them, in f32 and bf16.

    python -m shufflingvideosfortsg_torch.measure_recurrence [--iters 20]

Prints the card's name and power limit, then one line a case: the kernel,
(T, B, H), the dtype of xw and W_hh, and the kernel's milliseconds. The
cases are K1 at (128, 32, 256) (an evaluation batch's video layers), (15,
32, 256) (its sentence layers), (128, 256, 256) (the graphed tick),
(1024, 1, 256) and (1024, 512, 256) (one served video and a batch of 512
queries), and K3 at (128, 64, 256) and (15, 32, 256) (a train step's);
the inputs come from ``np.random.RandomState(0)``. Times come from CUDA
events over ``--iters`` calls after two (3 at T*B above 100,000).

The file uses nothing of the package but ``lstm_recurrence`` and
``lstm_recurrence_train``, so another checkout's kernels are timed on the
same inputs by copying this file into that checkout's package and running
it there.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from .ops.lstm_scan import lstm_recurrence, lstm_recurrence_train

CASES = (('K1', 128, 32, 256), ('K1', 15, 32, 256), ('K1', 128, 256, 256),
         ('K1', 1024, 1, 256), ('K1', 1024, 512, 256),
         ('K3', 128, 64, 256), ('K3', 15, 32, 256))
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
        fn = lstm_recurrence if kernel == 'K1' else lstm_recurrence_train
        iters = 3 if T * B > 100_000 else args.iters
        for dtype in (torch.float32, torch.bfloat16):
            x, w = xw.to('cuda', dtype), w_hh.to('cuda', dtype)
            with torch.no_grad():
                ms = cuda_ms(lambda: fn(x, w), iters)
            print(f'{kernel} T={T} B={B} H={H} dtype={_NAMES[dtype]} '
                  f'kernel_ms={ms:.4f}', flush=True)
            del x, w
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
