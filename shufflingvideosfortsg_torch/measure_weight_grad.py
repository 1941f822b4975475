"""Time the weight-gradient kernel of K4 and K6c (``lstm_weight_grad``) at
the shapes the training path gives it.

    python -m shufflingvideosfortsg_torch.measure_weight_grad [--iters 20]

Prints the card's name and power limit, then one line a case: (T, B, H),
layout, the dtypes of ``out`` and of the weights, the kernel's
milliseconds, its plain version's, one einsum a direction on the same
shifted views (cuBLAS with TF32 off, operands cast to the weights' dtype:
the library yardstick), the bound and the share of it the kernel reaches.
The cases are the flat f32 layout at (128, 64, 256), (128, 128, 256),
(15, 32, 256) and (128, 64, 512), and the four stacked instantiations at
(128, 64, 256); the inputs come from ``np.random.RandomState(0)``. Times
come from CUDA events over ``--iters`` calls after two.

The file uses nothing of the package but ``lstm_weight_grad``,
``lstm_weight_grad_plain``, ``FLAT`` and ``STACKED``, so another
checkout's kernel is timed on the same inputs by copying this file into
that checkout's package and running it there.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from .ops.lstm_scan import (FLAT, STACKED, lstm_weight_grad,
                            lstm_weight_grad_plain)

# the H100 SXM's peaks (f32 outside the tensor cores, bf16 dense on them)
# and its memory rate
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLAT_SHAPES = ((128, 64, 256), (128, 128, 256), (15, 32, 256),
               (128, 64, 512))
STACKED_SHAPE = (128, 64, 256)
_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def weight_grad_bound(T: int, B: int, H: int, x_bytes: int,
                      w_dtype: torch.dtype):
    """The least time of d_w_hh at (T, B, H): (ms, 'operations' or
    'bytes'). Each direction contracts the (T-1)*B (step, row) pairs that
    have an h_prev: 2*(T-1)*B*H*4H multiply-adds, at the f32 rate (bf16
    for bf16 weights); it reads those pairs' rows of ``out`` (H elements of
    ``x_bytes``) and of d_xw (4H f32) once and writes d_w_hh once."""
    pairs = 2 * max(T - 1, 0) * B  # both directions
    flops = 2 * pairs * H * 4 * H
    nbytes = pairs * (H * x_bytes + 4 * H * 4) + 2 * H * 4 * H * 4
    peak = PEAK_BF16_FLOPS if w_dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


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


def time_weight_grad(out, d_xw, w_dtype, layout, iters: int = 10) -> dict:
    """The kernel's time beside its plain version's, the library's and the
    bound (:func:`weight_grad_bound`), as printable fields."""
    T, B = out.shape[0], out.shape[-2]
    if layout == FLAT:
        H = out.shape[-1] // 2
        views = ((out[:-1, :, :H], d_xw[1:, :, :4 * H]),
                 (out[1:, :, H:], d_xw[:-1, :, 4 * H:]))
    else:
        H = out.shape[-1]
        views = ((out[:-1, 0], d_xw[1:, 0]), (out[:-1, 1], d_xw[1:, 1]))
    views = [(a.to(w_dtype), b.to(w_dtype)) for a, b in views]
    ms = cuda_ms(lambda: lstm_weight_grad(out, d_xw, w_dtype, layout), iters)
    plain = cuda_ms(lambda: lstm_weight_grad_plain(out, d_xw, w_dtype,
                                                   layout), iters)
    lib = cuda_ms(lambda: [torch.einsum('sbk,sbc->kc', a, b)
                           for a, b in views], iters)
    b_ms, b_by = weight_grad_bound(T, B, H, out.element_size(), w_dtype)
    return dict(kernel_ms=f'{ms:.4f}', plain_ms=f'{plain:.4f}',
                library_ms=f'{lib:.4f}', bound_ms=f'{b_ms:.4f}',
                bound_by=b_by, pct_of_bound=f'{100 * b_ms / ms:.1f}')


def operands(layout: int, x_dtype: torch.dtype, T: int, B: int, H: int,
             device):
    """(out, d_xw) on ``device``: tanh of normal values and normal values
    times 0.1, from ``np.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    shapes = (((T, B, 2 * H), (T, B, 8 * H)) if layout == FLAT
              else ((T, 2, B, H), (T, 2, B, 4 * H)))
    out = torch.from_numpy(np.tanh(rng.randn(*shapes[0])).astype(np.float32))
    d_xw = torch.from_numpy((rng.randn(*shapes[1]) * 0.1).astype(np.float32))
    return out.to(device, x_dtype), d_xw.to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('measure_weight_grad needs an NVIDIA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(FLAT, f32, f32, shape) for shape in FLAT_SHAPES]
    cases += [(STACKED, x, w, STACKED_SHAPE) for x in (f32, bf16)
              for w in (f32, bf16)]
    for layout, x_dtype, w_dtype, (T, B, H) in cases:
        out, d_xw = operands(layout, x_dtype, T, B, H, 'cuda')
        fields = time_weight_grad(out, d_xw, w_dtype, layout, args.iters)
        print(f'[K4w] T={T} B={B} H={H} '
              f'layout={"flat" if layout == FLAT else "stacked"} '
              f'out={_NAMES[x_dtype]} w={_NAMES[w_dtype]} '
              + ' '.join(f'{k}={v}' for k, v in fields.items()), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
