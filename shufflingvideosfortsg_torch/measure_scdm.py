"""Time K2's forward kernel (``scdm_attention_fused``), or K5's backward
kernel (``scdm_attention_bwd_core``), at the shapes the evaluation and
training paths give them.

    python -m shufflingvideosfortsg_torch.measure_scdm [--reps 20]
    python -m shufflingvideosfortsg_torch.measure_scdm --bwd [--sweep]

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

With ``--bwd``, one line a backward case, (64, 128, 15, 512), (64, 128,
25, 512) and (8, 128, 40, 2048) as (B, T, N, Dh), at the forward's P and
dP = G sent_feat^T of a 512- or 2048-wide context: the kernel's
milliseconds, the plain core's (``scdm_attention_bwd_core_plain``, which
materialises the [B, T, N, Dh] tanh), the two cuBLAS ``bmm`` that the
backward runs beside the kernel (dP and d_sent_feat), the bound
(:func:`scdm_bwd_bound`) and the floor of the tanh's design with the
shares of both, and the launch the plan picks where the package has one
(columns, rows, spans, blocks). ``--sweep`` adds a line a launch override
(columns 32 to 256 by spans 1, 2 and 4).

``kernel_ms`` and ``plain_ms`` are device times: ``--reps`` calls captured
in one CUDA graph, replayed after a warm-up and timed with CUDA events, so
the host's enqueue rate does not enter. ``eager_ms`` times the same calls
launched one by one from Python, as the models launch them.

The file uses nothing of the package but ``ops/scdm_fused``'s
``scdm_attention_fused``, ``scdm_attention_fused_trainable``,
``scdm_attention_plain``, ``scdm_attention_bwd_core`` and
``scdm_attention_bwd_core_plain`` (and the plan where there is one, and
for ``--sweep`` the private launch ``_launch_backward``), so
another checkout's kernels are timed on the same inputs by copying this
file into that checkout's package and running it there.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from .ops import scdm_fused
from .ops.scdm_fused import (scdm_attention_bwd_core,
                             scdm_attention_bwd_core_plain,
                             scdm_attention_fused,
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
# the backward's (B, T, N, Dh, Ds): the GMD train step's, N=25, and N=40 at
# the widest width
BWD_CASES = ((64, 128, 15, 512, 512), (64, 128, 25, 512, 512),
             (8, 128, 40, 2048, 2048))


def scdm_bound(B: int, T: int, N: int, Dh: int, Ds: int, keep_p: bool,
               elem_bytes: int = 4):
    """The least time of the forward: (ms, 'operations' or 'bytes'). One
    add, one tanh and one multiply-add per (b,t,n,k), counted as 4 f32
    operations, and one multiply-add per (b,t,n,d) of the context; each
    input read once, C (and P where kept, in f32) written once, the
    inputs and C in elements of ``elem_bytes`` (f32 4, bf16 2)."""
    flops = B * T * N * 4 * Dh + B * T * N * 2 * Ds
    nbytes = (elem_bytes * (B * T * Dh + B * N * Dh + Dh + B * N * Ds
                            + B * T * Ds) + (4 * B * T * N if keep_p else 0))
    return bound_ms(flops, nbytes)


def scdm_bwd_bound(B: int, T: int, N: int, Dh: int, elem_bytes: int = 4):
    """The least time of the backward kernel's function: (ms, 'operations'
    or 'bytes'). Per (b,t,n,k) the add, the tanh, d_w's multiply-add, 1 -
    a^2 (2), its product with dl and the sums into d_vp and d_sp, counted
    as 10 f32 operations; video_proj, sent_proj, w and dP (elements of
    ``elem_bytes``: f32 4, bf16 2) and P (f32) read once, d_vp, d_sp and
    d_w (in the inputs' type) written once."""
    return bound_ms(10 * B * T * N * Dh,
                    elem_bytes * (2 * (B * T * Dh + B * N * Dh + Dh)
                                  + B * T * N) + 4 * B * T * N)


def bound_ms(flops: float, nbytes: float):
    """(ms, 'operations' or 'bytes'): the larger of flops over the f32
    peak and bytes over the memory rate."""
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


def bwd_operands(B: int, T: int, N: int, Dh: int, Ds: int, device):
    """(video_proj, sent_proj, w, P, dP, sent_feat, G) on ``device``: the
    forward's inputs as :func:`operands`, P its plain softmax, G a normal
    cotangent of the context from ``np.random.RandomState(1)`` and dP =
    G sent_feat^T."""
    vp, sp, w, sf = operands(B, T, N, Dh, Ds, device)
    g_out = torch.from_numpy(np.random.RandomState(1).randn(
        B, T, Ds).astype(np.float32)).to(device)
    with torch.no_grad():
        P = torch.softmax(torch.einsum(
            'btnh,h->btn', torch.tanh(vp[:, :, None] + sp[:, None]), w), -1)
        dP = torch.bmm(g_out, sf.transpose(1, 2))
    return vp, sp, w, P, dP, sf, g_out


def time_scdm_bwd(vp, sp, w, P, dP, sf, g_out, reps: int,
                  **override) -> dict:
    """The backward kernel's device time (with a launch ``override`` of
    columns and spans where given) beside the plain core's and the two
    ``bmm``'s, its bound (:func:`scdm_bwd_bound`), the floor of its tanh
    design (:func:`sfu_bound_ms`) and the launch, as printable fields."""
    B, T, Dh = vp.shape
    N = sp.shape[1]
    args = (vp, sp, w, P, dP)
    fields = {}
    core = scdm_attention_bwd_core
    plan = getattr(scdm_fused, '_scdm_bwd_launch', None)
    if plan is not None:
        p = plan(B, T, N, Dh, vp.device.index or 0, **override)
        fields.update(cols=p.cols, rows=p.rows, spans=p.spans,
                      blocks=p.blocks, smem_bytes=p.smem_bytes)
        if override:
            def core(*a):
                return scdm_fused._launch_backward(a, p)
    with torch.no_grad():
        ms = graph_ms(lambda: core(*args), reps)
        if not override:
            plain = graph_ms(lambda: scdm_attention_bwd_core_plain(*args), 5)
            bmm = graph_ms(lambda: (torch.bmm(g_out, sf.transpose(1, 2)),
                                    torch.bmm(P.transpose(1, 2), g_out)),
                           reps)
            fields.update(plain_ms=f'{plain:.4f}', bmm_ms=f'{bmm:.4f}')
    b_ms, b_by = scdm_bwd_bound(B, T, N, Dh)
    sms = torch.cuda.get_device_properties(vp.device).multi_processor_count
    sfu = sfu_bound_ms(B, T, N, Dh, sms)
    return dict(kernel_ms=f'{ms:.4f}', **fields, bound_ms=f'{b_ms:.4f}',
                bound_by=b_by, pct_of_bound=f'{100 * b_ms / ms:.1f}',
                sfu_bound_ms=f'{sfu:.4f}', tanh_sfu_ops=TANH_SFU_OPS,
                pct_of_sfu_bound=f'{100 * sfu / ms:.1f}')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--bwd', action='store_true',
                    help="time K5's backward kernel instead of K2")
    ap.add_argument('--sweep', action='store_true',
                    help='with --bwd, also every launch override')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('measure_scdm needs an NVIDIA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    if args.bwd:
        for B, T, N, Dh, Ds in BWD_CASES:
            ops = bwd_operands(B, T, N, Dh, Ds, 'cuda')
            overrides = [{}] + ([dict(cols=c, spans=n)
                                 for c in (32, 64, 128, 256)
                                 for n in (1, 2, 4)] if args.sweep else [])
            for override in overrides:
                fields = time_scdm_bwd(*ops, args.reps, **override)
                print(f'[K5 bwd] B={B} T={T} N={N} Dh={Dh} '
                      f'override={bool(override)} '
                      + ' '.join(f'{k}={v}' for k, v in fields.items()),
                      flush=True)
            del ops
        return 0
    for B, T, N, Dh, Ds, keep_p in CASES:
        fields = time_scdm(operands(B, T, N, Dh, Ds, 'cuda'), keep_p,
                           args.reps)
        print(f'[K2] B={B} T={T} N={N} Dh={Dh} Ds={Ds} keep_p={keep_p} '
              + ' '.join(f'{k}={v}' for k, v in fields.items()), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
