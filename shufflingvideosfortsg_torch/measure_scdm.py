"""Time K2's forward kernel (``scdm_attention_fused``) at the shapes the
evaluation and training paths give it.

    python -m shufflingvideosfortsg_torch.measure_scdm [--reps 20]

Prints the card's name and power limit, then one line a case: B, T, N, Dh,
Ds, whether P is kept (the trainable form's forward, which K5's backward
reads), the kernel's milliseconds, its plain version's, the bound from
bytes and operations and the share of it the kernel reaches, then the
floor of the kernel's tanh design (``sfu_bound_ms``: its two
special-function operations a term, not a floor of the function) and
the share of that. The cases are (32, 128, 15, 512,
512), (64, 128, 15, 512, 512) keeping P, (32, 128, 25, 512, 512),
(32, 128, 40, 512, 512) and (8, 128, 40, 2048, 2048); the inputs come from
``np.random.RandomState(0)``.

``kernel_ms`` and ``plain_ms`` are device times: ``--reps`` calls captured
in one CUDA graph, replayed after a warm-up and timed with CUDA events, so
the host's enqueue rate does not enter. ``eager_ms`` times the same calls
launched one by one from Python, as the models launch them.

The file uses nothing of the package but ``scdm_attention_fused``,
``scdm_attention_fused_trainable`` and ``scdm_attention_plain``, so another
checkout's kernel is timed on the same inputs by copying this file into
that checkout's package and running it there.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from .ops.scdm_fused import (scdm_attention_fused,
                             scdm_attention_fused_trainable,
                             scdm_attention_plain)

# the H100 SXM's f32 peak outside the tensor cores and its memory rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the special-function pipe: 16 operations a clock an SM at the H100 SXM's
# 1.98 GHz boost clock; the kernel's tanh (tanh_fwd in csrc/scdm.cu)
# spends two of them, an ex2 and a reciprocal (a tanh with fewer exists)
SFU_OPS_PER_SM_CLOCK = 16
BOOST_HZ = 1.98e9
TANH_SFU_OPS = 2

# (B, T, N, Dh, Ds, keep P)
CASES = ((32, 128, 15, 512, 512, False), (64, 128, 15, 512, 512, True),
         (32, 128, 25, 512, 512, False), (32, 128, 40, 512, 512, False),
         (8, 128, 40, 2048, 2048, False))


def scdm_bound(B: int, T: int, N: int, Dh: int, Ds: int, keep_p: bool):
    """The least time of the forward: (ms, 'operations' or 'bytes'). One
    add, one tanh and one multiply-add per (b,t,n,k), counted as 4 f32
    operations, and one multiply-add per (b,t,n,d) of the context; each
    input read once, C (and P where kept) written once."""
    flops = B * T * N * 4 * Dh + B * T * N * 2 * Ds
    nbytes = 4 * (B * T * Dh + B * N * Dh + Dh + B * N * Ds + B * T * Ds
                  + (B * T * N if keep_p else 0))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def sfu_bound_ms(B: int, T: int, N: int, Dh: int, sms: int) -> float:
    """The floor of the kernel's tanh design, not of the function: B*T*N*Dh
    tanh of TANH_SFU_OPS each over sms * SFU_OPS_PER_SM_CLOCK * BOOST_HZ
    special-function operations a second."""
    return (B * T * N * Dh * TANH_SFU_OPS
            / (sms * SFU_OPS_PER_SM_CLOCK * BOOST_HZ) * 1e3)


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds of one fn(): ``reps`` calls captured in one CUDA
    graph, replayed twice to warm up, then timed over three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def eager_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() launched from Python, from CUDA events."""
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


def operands(B: int, T: int, N: int, Dh: int, Ds: int, device):
    """(video_proj, sent_proj, w, sent_feat) on ``device`` from
    ``np.random.RandomState(0)``: normal values times 0.5 for the
    projections, uniform in +-1/sqrt(Dh) for w, normal sent_feat."""
    rng = np.random.RandomState(0)
    arrays = ((rng.randn(B, T, Dh) * 0.5), (rng.randn(B, N, Dh) * 0.5),
              (rng.rand(Dh) * 2 - 1) / np.sqrt(Dh), rng.randn(B, N, Ds))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def time_scdm(args, keep_p: bool, reps: int) -> dict:
    """The kernel's device time beside its plain version's, the eager time,
    the bound (:func:`scdm_bound`) and the floor of its tanh design
    (:func:`sfu_bound_ms`), as printable fields."""
    B, T, Dh = args[0].shape
    N, Ds = args[1].shape[1], args[3].shape[-1]
    fused = scdm_attention_fused_trainable if keep_p else scdm_attention_fused
    with torch.no_grad():
        ms = graph_ms(lambda: fused(*args), reps)
        eager = eager_ms(lambda: fused(*args), 5 * reps)
        plain = graph_ms(lambda: scdm_attention_plain(*args), reps)
    b_ms, b_by = scdm_bound(B, T, N, Dh, Ds, keep_p)
    sms = torch.cuda.get_device_properties(args[0].device).multi_processor_count
    sfu = sfu_bound_ms(B, T, N, Dh, sms)
    return dict(kernel_ms=f'{ms:.4f}', eager_ms=f'{eager:.4f}',
                plain_ms=f'{plain:.4f}', bound_ms=f'{b_ms:.4f}',
                bound_by=b_by, pct_of_bound=f'{100 * b_ms / ms:.1f}',
                sfu_bound_ms=f'{sfu:.4f}', tanh_sfu_ops=TANH_SFU_OPS,
                pct_of_sfu_bound=f'{100 * sfu / ms:.1f}')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('measure_scdm needs an NVIDIA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    for B, T, N, Dh, Ds, keep_p in CASES:
        fields = time_scdm(operands(B, T, N, Dh, Ds, 'cuda'), keep_p,
                           args.reps)
        print(f'[K2] B={B} T={T} N={N} Dh={Dh} Ds={Ds} keep_p={keep_p} '
              + ' '.join(f'{k}={v}' for k, v in fields.items()), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
