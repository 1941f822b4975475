"""Time K2's forward kernel (``scdm_attention_fused``), or K5's backward
kernel (``scdm_attention_bwd_core``), at the shapes the evaluation and
training paths give them.

    python -m shufflingvideosfortsg_torch.measure_scdm [--reps 20]
    python -m shufflingvideosfortsg_torch.measure_scdm --precision bf16 \
        [--sweep]
    python -m shufflingvideosfortsg_torch.measure_scdm --term-rate
    python -m shufflingvideosfortsg_torch.measure_scdm --bwd [--sweep]
    python -m shufflingvideosfortsg_torch.measure_scdm --bwd \
        --precision bf16 [--sweep]
    python -m shufflingvideosfortsg_torch.measure_scdm --sass

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

With ``--precision bf16``, K2 at bf16 (the four inputs and C bf16, the
same values rounded) at the same cases, the graphed evaluation tick's
B=256 and the served batch (512, 1024, 15, 512, 512): the kernel's
milliseconds beside the f32 kernel's on the f32 inputs, the bound (bf16
products on the tensor cores, 2 bytes an element) and the floor the
published special-function rate gives its tanh design, with the shares
of both (no plain version: at the served batch it would hold 16 GB), and
the plan's rows where the package has them; ``--sweep`` adds a line for
each tile of rows the bf16 kernel takes (8, 16 and 32) at every case,
launched through the C entry point ``svtsg_scdm_attention`` with the
rows given.

With ``--term-rate``, the rate of the bf16 kernel's term code from
registers alone (the packed sum, tanh_fwd on both halves and the packed
rounding, 8 independent chains a thread at two blocks an SM), of its
special-function share alone (an ex2 and a reciprocal a term) and of the
bf16 backward's term code (``bwd_term2``: the forward's, then the packed
roundings of the backward and the f32 sums), in terms a second, each
beside the floor the published rate gives (2 operations a term at
SFU_OPS_PER_SM_CLOCK an SM a clock and BOOST_HZ), and the SM clock
``nvidia-smi`` read during the run; then, at each bf16 case, the time the
term code alone would take for the terms the kernel forms
(``term_code_ms``: B*T*Dh times N rounded up to 16 words), and at each
backward case the backward's (``bwd_term_code_ms``: B*T*N*Dh terms). The
term code is built from ``csrc/measure/scdm_term_rate.cu``, which
includes ``csrc/scdm.cu`` and is not part of the kernel library.

With ``--bwd``, one line a backward case, (64, 128, 15, 512), (64, 128,
25, 512) and (8, 128, 40, 2048) as (B, T, N, Dh), at the forward's P and
dP = G sent_feat^T of a 512- or 2048-wide context: the kernel's
milliseconds, the plain core's (``scdm_attention_bwd_core_plain``, which
materialises the [B, T, N, Dh] tanh), the two cuBLAS ``bmm`` that the
backward runs beside the kernel (dP and d_sent_feat), the bound
(:func:`scdm_bwd_bound`) and the floor of the tanh's design with the
shares of both, the launch the plan picks where the package has one
(columns, rows, spans, blocks), and ``digest``, a hash of the three
outputs' bytes (equal digests: equal bits, also across checkouts).
``kernel_ms`` times ``scdm_attention_bwd_core`` (the kernel, the sums of
its partials and, in bf16, the casts of its f32 sums), ``launch_ms`` the
kernel alone (``_bwd_partials``, where the package has it) on outputs
allocated once. ``--sweep`` adds a line a launch override (columns 32 to
256 by spans 1, 2 and 4). With ``--precision bf16`` the same cases in
bf16 (video_proj, sent_proj, w and dP rounded; P the f32 softmax): the
bf16 kernel's times beside the f32 kernel's on the f32 inputs, the bf16
plain core's, the two bf16 ``bmm``, the bound at 2 bytes an element and
the tanh model.

With ``--sass``, ``cuobjdump -sass`` of the package's kernel library: for
each instantiation of the SCDM kernels, the instructions of the basic
block that holds the most MUFU.EX2 (the unrolled term loop; tanh_fwd
spends one ex2 a term), their count a term and the most frequent
opcodes.

``kernel_ms`` and ``plain_ms`` are device times: ``--reps`` calls captured
in one CUDA graph, replayed after a warm-up and timed with CUDA events, so
the host's enqueue rate does not enter. ``eager_ms`` times the same calls
launched one by one from Python, as the models launch them.

The file uses nothing of the package but ``ops/scdm_fused``'s
``scdm_attention_fused``, ``scdm_attention_fused_trainable``,
``scdm_attention_plain``, ``scdm_attention_bwd_core`` and
``scdm_attention_bwd_core_plain`` (and the plan where there is one, for
``--bwd --sweep`` the private launch ``_launch_backward``, for
``launch_ms`` ``_bwd_partials``, and for the
bf16 ``--sweep`` the library's ``svtsg_scdm_attention``), so
another checkout's kernels are timed on the same inputs by copying this
file into that checkout's package and running it there.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import inspect
import os
import re
import subprocess
from typing import Optional

import numpy as np
import torch

from . import _kernels
from .ops import scdm_fused
from .ops.scdm_fused import (scdm_attention_bwd_core,
                             scdm_attention_bwd_core_plain,
                             scdm_attention_fused,
                             scdm_attention_fused_trainable,
                             scdm_attention_plain)

# the H100 SXM's f32 peak outside the tensor cores, its dense bf16
# tensor-core peak, its bf16 peak outside the tensor cores (packed bf16x2
# operations, twice the f32 rate: NVIDIA's H100 architecture whitepaper)
# and its memory rate
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BF16X2_FLOPS = 133.8e12
PEAK_BYTES = 3.35e12
# the special-function pipe: 16 operations a clock an SM at the H100 SXM's
# 1.98 GHz boost clock (the published rate); the kernel's tanh (tanh_fwd in
# csrc/scdm.cu) spends two of them, an ex2 and a reciprocal (a tanh with
# fewer exists). On an NVIDIA H100 80GB HBM3 at 700 W, ex2 and reciprocal
# alone ran at twice this rate (--term-rate), so sfu_bound_ms is a model
# from the published rate, not a floor the card holds to
SFU_OPS_PER_SM_CLOCK = 16
BOOST_HZ = 1.98e9
TANH_SFU_OPS = 2

# (B, T, N, Dh, Ds, keep P)
CASES = ((32, 128, 15, 512, 512, False), (64, 128, 15, 512, 512, True),
         (32, 128, 25, 512, 512, False), (32, 128, 40, 512, 512, False),
         (8, 128, 40, 2048, 2048, False))
# K2 at bf16: the cases above, the graphed evaluation tick (B=256) and the
# served batch (one video of T=1024 against 512 queries)
BF16_CASES = CASES + ((256, 128, 15, 512, 512, False),
                      (512, 1024, 15, 512, 512, False))
# the backward's (B, T, N, Dh, Ds): the GMD train step's, N=25, and N=40 at
# the widest width
BWD_CASES = ((64, 128, 15, 512, 512), (64, 128, 25, 512, 512),
             (8, 128, 40, 2048, 2048))
TERM_RATE_SOURCE = os.path.join(_kernels.CSRC_DIR, 'measure',
                                'scdm_term_rate.cu')
KBF16 = 1  # csrc/common.cuh's dtype code of bf16


def scdm_bound(B: int, T: int, N: int, Dh: int, Ds: int, keep_p: bool,
               elem_bytes: int = 4):
    """The least time of the forward: (ms, 'operations' or 'bytes'). Per
    (b,t,n,k) one add, one tanh and the logit's multiply-add, and per
    (b,t,n,d) the context's multiply-add; each input read once, C (and P
    where kept, in f32) written once, the inputs and C in elements of
    ``elem_bytes`` (f32 4, bf16 2). In f32 all of it at the f32 peak (4
    operations a term, 2 a context element). In bf16 the two products are
    bf16 products, at the tensor-core peak, while the add and the tanh (2
    operations a term) take the f32 peak; the two pipes run at once, so
    the longer of their times counts."""
    terms, ctx = B * T * N * Dh, B * T * N * Ds
    nbytes = (elem_bytes * (B * T * Dh + B * N * Dh + Dh + B * N * Ds
                            + B * T * Ds) + (4 * B * T * N if keep_p else 0))
    if elem_bytes == 4:
        return bound_ms(4 * terms + 2 * ctx, nbytes)
    return _larger(max(2 * terms / PEAK_F32_FLOPS,
                       2 * (terms + ctx) / PEAK_BF16_FLOPS),
                   nbytes / PEAK_BYTES)


def scdm_bwd_bound(B: int, T: int, N: int, Dh: int, elem_bytes: int = 4):
    """The least time of the backward kernel's function: (ms, 'operations'
    or 'bytes'). video_proj, sent_proj, w and dP (elements of
    ``elem_bytes``: f32 4, bf16 2) and P (f32) read once, d_vp, d_sp and
    d_w (in the inputs' type) written once. In f32, per (b,t,n,k) the add,
    the tanh, d_w's multiply-add, 1 - a^2 (2), its product with dl and the
    sums into d_vp and d_sp, counted as 10 f32 operations. In bf16 the
    contract's six bf16 roundings (the add, bf16(dl w), 1 - a, u, u a and
    du) are bf16 operations, at the packed bf16 peak, and the tanh, d_w's
    multiply-add and the two f32 sums 5 f32 operations at the f32 peak;
    both run on the same pipes, so their times add."""
    terms = B * T * N * Dh
    nbytes = (elem_bytes * (2 * (B * T * Dh + B * N * Dh + Dh) + B * T * N)
              + 4 * B * T * N)
    if elem_bytes == 4:
        return bound_ms(10 * terms, nbytes)
    return _larger(6 * terms / PEAK_BF16X2_FLOPS + 5 * terms / PEAK_F32_FLOPS,
                   nbytes / PEAK_BYTES)


def bound_ms(flops: float, nbytes: float):
    """(ms, 'operations' or 'bytes'): the larger of flops over the f32
    peak and bytes over the memory rate."""
    return _larger(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def _larger(t_ops: float, t_bytes: float):
    """(ms, 'operations' or 'bytes') of seconds of operations and bytes."""
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


def time_scdm_bf16(args, keep_p: bool, reps: int,
                   rows: Optional[int] = None) -> dict:
    """The kernel's device time at bf16 (``args`` f32, rounded to bf16;
    at a tile of ``rows`` rows where given, through :func:`launch_rows`,
    else at the plan's, printed where the package has a plan)
    beside the f32 kernel's on ``args``, the bound at 2 bytes an element
    and the floor of its tanh design, as printable fields."""
    B, T, Dh = args[0].shape
    N, Ds = args[1].shape[1], args[3].shape[-1]
    fused = scdm_attention_fused_trainable if keep_p else scdm_attention_fused
    half = [a.bfloat16() for a in args]
    fields = {}
    if rows is None:
        plan = getattr(scdm_fused, '_scdm_rows', None)
        if plan is not None:
            fields['rows'] = plan(B, T, N, 0, 2)

        def run():
            return fused(*half)
    else:
        fields['rows'] = rows

        def run():
            return launch_rows(half, keep_p, rows)
    with torch.no_grad():
        ms = graph_ms(run, reps)
        f32_ms = graph_ms(lambda: fused(*args), reps)
    b_ms, b_by = scdm_bound(B, T, N, Dh, Ds, keep_p, elem_bytes=2)
    sms = torch.cuda.get_device_properties(args[0].device).multi_processor_count
    sfu = sfu_bound_ms(B, T, N, Dh, sms)
    return dict(**fields, kernel_ms=f'{ms:.4f}',
                f32_kernel_ms=f'{f32_ms:.4f}', bound_ms=f'{b_ms:.4f}',
                bound_by=b_by,
                pct_of_bound=f'{100 * b_ms / ms:.1f}',
                sfu_bound_ms=f'{sfu:.4f}', tanh_sfu_ops=TANH_SFU_OPS,
                pct_of_sfu_bound=f'{100 * sfu / ms:.1f}')


def launch_rows(args, keep_p: bool, rows: int):
    """One launch of the bf16 forward on the bf16 CUDA tensors ``args`` at
    a tile of ``rows`` rows, through the library's C entry point (the
    package's launch takes the plan's rows): (C, P or None)."""
    B, T, Dh = args[0].shape
    N, Ds = args[1].shape[1], args[3].shape[-1]
    dev = args[0].device
    out = torch.empty(B, T, Ds, device=dev, dtype=torch.bfloat16)
    P = (torch.empty(B, T, N, device=dev, dtype=torch.float32)
         if keep_p else None)
    err = _kernels.library().svtsg_scdm_attention(
        *(a.data_ptr() for a in args), out.data_ptr(),
        None if P is None else P.data_ptr(), B, T, N, Dh, Ds, rows, KBF16,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, 'scdm_attention_fused')
    return out, P


def term_rate_library() -> ctypes.CDLL:
    """Build ``csrc/measure/scdm_term_rate.cu`` into the package's build
    directory and load it."""
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_kernels.BUILD_DIR,
                       f'libsvtsg_term_rate_{os.getpid()}.so')
    subprocess.run([_kernels.nvcc_path(), *_kernels.ARCH_FLAGS, '-std=c++17',
                    '-O3', '-Xcompiler', '-fPIC', '-shared', TERM_RATE_SOURCE,
                    '-o', lib], check=True, timeout=600)
    try:
        so = ctypes.CDLL(lib)
    finally:
        os.remove(lib)
    so.svtsg_scdm_term_rate.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    so.svtsg_scdm_term_rate.restype = ctypes.c_int
    return so


def term_rates(sms: int, iters: int = 20000) -> dict:
    """Terms a second of ``svtsg_scdm_term_rate``'s modes (0: the forward's
    term code, 1: ex2 and reciprocal alone, 2: the bf16 backward's term
    code) at two blocks an SM, with the SM clock that ``nvidia-smi`` read
    during each run: {mode: (rate, clock)}."""
    fn = term_rate_library().svtsg_scdm_term_rate
    blocks = 2 * sms
    out = torch.empty(blocks * 256, dtype=torch.int32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for mode in (0, 1, 2):
        def launch(n):
            err = fn(mode, out.data_ptr(), blocks, n, 0, stream)
            if err:
                raise RuntimeError(f'term_rate: CUDA error {err}')
        launch(100)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):  # 0.1-0.25 s of work, read by nvidia-smi
            launch(iters)
        end.record()
        clock = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm',
                                '--format=csv,noheader'], check=True,
                               capture_output=True, text=True,
                               timeout=60).stdout.strip()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        rates[mode] = (blocks * 256 * iters * 16 / (ms * 1e-3), clock)
    return rates


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


def _bwd_plan(B, T, N, Dh, device, elem_bytes, **override):
    """The package's backward launch where it has a plan (a checkout
    whose plan takes no ``elem_bytes`` plans its only layout), else None."""
    plan = getattr(scdm_fused, '_scdm_bwd_launch', None)
    if plan is None:
        return None
    if 'elem_bytes' in inspect.signature(plan).parameters:
        override['elem_bytes'] = elem_bytes
    return plan(B, T, N, Dh, device, **override)


def digest(tensors) -> str:
    """The first 12 hex digits of a SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def launch_backward(args, plan):
    """fn() launching the backward kernel once over ``args`` (video_proj,
    sent_proj, w, P, dP on a card) with the blocks of ``plan``, on f32
    outputs allocated here once: the kernel alone, without the wrapper's
    sums and casts. None where the package has no such launch."""
    partials = getattr(scdm_fused, '_bwd_partials', None)
    if partials is None:
        return None
    outs = partials(args, plan)
    return lambda: partials(args, plan, outs)


def time_scdm_bwd(vp, sp, w, P, dP, sf, g_out, reps: int,
                  precision: str = 'f32', **override) -> dict:
    """The backward kernel's device time (with a launch ``override`` of
    columns and spans where given) beside the plain core's and the two
    ``bmm``'s, its bound (:func:`scdm_bwd_bound`), the floor of its tanh
    design (:func:`sfu_bound_ms`), the launch and the digest of its
    outputs, as printable fields. ``precision`` bf16 runs the bf16 kernel
    on the inputs rounded to bf16 (P stays the f32 softmax, dP is the bf16
    ``bmm`` of the rounded G and sent_feat) and also times the f32 kernel
    on the f32 inputs."""
    B, T, Dh = vp.shape
    N = sp.shape[1]
    bf16 = precision == 'bf16'
    elem = 2 if bf16 else 4
    f32_args = (vp, sp, w, P, dP)
    if bf16:
        sf, g_out = sf.bfloat16(), g_out.bfloat16()
        with torch.no_grad():
            dP = torch.bmm(g_out, sf.transpose(1, 2))
        args = (vp.bfloat16(), sp.bfloat16(), w.bfloat16(), P, dP)
    else:
        args = f32_args
    fields = {}
    core = scdm_attention_bwd_core
    p = _bwd_plan(B, T, N, Dh, vp.device.index or 0, elem, **override)
    if p is not None:
        fields.update(cols=p.cols, rows=p.rows, spans=p.spans,
                      blocks=p.blocks, smem_bytes=p.smem_bytes)
        if override:
            def core(*a):
                return scdm_fused._launch_backward(a, p)
    with torch.no_grad():
        ms = graph_ms(lambda: core(*args), reps)
        launch = launch_backward(args, p) if p is not None else None
        if launch is not None:
            fields['launch_ms'] = f'{graph_ms(launch, reps):.4f}'
        fields['digest'] = digest(core(*args))
        if bf16:
            f32_ms = graph_ms(lambda: scdm_attention_bwd_core(*f32_args), reps)
            fields['f32_kernel_ms'] = f'{f32_ms:.4f}'
        if not override:
            plain = graph_ms(lambda: scdm_attention_bwd_core_plain(*args), 5)
            Pt = (P.bfloat16() if bf16 else P).transpose(1, 2)
            bmm = graph_ms(lambda: (torch.bmm(g_out, sf.transpose(1, 2)),
                                    torch.bmm(Pt, g_out)), reps)
            fields.update(plain_ms=f'{plain:.4f}', bmm_ms=f'{bmm:.4f}')
    b_ms, b_by = scdm_bwd_bound(B, T, N, Dh, elem_bytes=elem)
    sms = torch.cuda.get_device_properties(vp.device).multi_processor_count
    sfu = sfu_bound_ms(B, T, N, Dh, sms)
    return dict(kernel_ms=f'{ms:.4f}', **fields, bound_ms=f'{b_ms:.4f}',
                bound_by=b_by, pct_of_bound=f'{100 * b_ms / ms:.1f}',
                sfu_bound_ms=f'{sfu:.4f}', tanh_sfu_ops=TANH_SFU_OPS,
                pct_of_sfu_bound=f'{100 * sfu / ms:.1f}')


# the kernels whose term loops --sass counts (names in the mangled symbols)
SASS_KERNELS = ('scdm_bwd_bf16x2_kernel', 'scdm_bwd_kernel',
                'scdm_fwd_mma_kernel', 'scdm_fwd_kernel')
_SASS_INSN = re.compile(r'^\s*/\*[0-9a-f]+\*/\s+(@!?U?P[T0-9]+\s+)?'
                        r'([A-Z][A-Z0-9_.]*)')


def sass_loops(lib_path: str):
    """For each SCDM kernel instantiation in the library: (mangled name,
    the opcodes of its basic block with the most MUFU.EX2). Blocks split
    at the branch targets (``.L_x_n:``) and after each branch."""
    cuobjdump = os.path.join(os.path.dirname(_kernels.nvcc_path()),
                             'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', lib_path], check=True,
                          capture_output=True, text=True,
                          timeout=600).stdout
    loops = []
    for chunk in re.split(r'\n\s*Function : ', text)[1:]:
        name = chunk.split('\n', 1)[0].strip()
        if not any(k in name for k in SASS_KERNELS):
            continue
        blocks, cur = [], []
        for line in chunk.split('\n'):
            if re.match(r'^\s*\.L_x_\d+:', line):
                blocks.append(cur)
                cur = []
                continue
            m = _SASS_INSN.match(line)
            if m is None:
                continue
            cur.append(m.group(2))
            if m.group(2).startswith('BRA'):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        loops.append((name, max(blocks, key=lambda b: b.count('MUFU.EX2'))))
    return loops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--precision', choices=('f32', 'bf16'), default='f32',
                    help='time K2 (or with --bwd K5\'s backward) in bf16 '
                    'beside the f32 kernel')
    ap.add_argument('--term-rate', action='store_true',
                    help="the bf16 kernel's term code's own rate")
    ap.add_argument('--bwd', action='store_true',
                    help="time K5's backward kernel instead of K2")
    ap.add_argument('--sweep', action='store_true',
                    help='with --bwd, also every launch override; with '
                    '--precision bf16, every tile of rows')
    ap.add_argument('--sass', action='store_true',
                    help="count the SCDM kernels' term-loop instructions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('measure_scdm needs an NVIDIA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    if args.sass:
        for name, ops in sass_loops(_kernels.build()[0]):
            ex2 = ops.count('MUFU.EX2')
            top = collections.Counter(ops).most_common(12)
            print(f'[sass] {name} instructions={len(ops)} ex2={ex2} '
                  f'per_term={len(ops) / max(ex2, 1):.2f} '
                  + ' '.join(f'{op}={n}' for op, n in top), flush=True)
        return 0
    if args.bwd:
        bf16 = args.precision == 'bf16'
        for B, T, N, Dh, Ds in BWD_CASES:
            ops = bwd_operands(B, T, N, Dh, Ds, 'cuda')
            overrides = [{}] + ([dict(cols=c, spans=n)
                                 for c in (32, 64, 128, 256)
                                 for n in (1, 2, 4)] if args.sweep else [])
            for override in overrides:
                fields = time_scdm_bwd(*ops, args.reps, args.precision,
                                       **override)
                print(f'[K5 bwd{" bf16" if bf16 else ""}] B={B} T={T} N={N} '
                      f'Dh={Dh} override={bool(override)} '
                      + ' '.join(f'{k}={v}' for k, v in fields.items()),
                      flush=True)
            del ops
        return 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = sms * SFU_OPS_PER_SM_CLOCK * BOOST_HZ / TANH_SFU_OPS
    if args.term_rate:
        rates = term_rates(sms)
        for mode, (rate, clock) in rates.items():
            name = ('term_code', 'ex2_rcp_only', 'bwd_term_code')[mode]
            print(f'[term rate] {name} terms_per_s={rate:.4e} '
                  f'of_published_sfu_floor={rate / floor:.3f} '
                  f'sm_clock={clock!r}', flush=True)
        for B, T, N, Dh, Ds, _ in BF16_CASES:
            terms = B * T * -(-N // 16) * 16 * Dh
            print(f'[term rate] B={B} T={T} N={N} Dh={Dh} '
                  f'term_code_ms={terms / rates[0][0] * 1e3:.4f}', flush=True)
        for B, T, N, Dh, _ in BWD_CASES:
            print(f'[term rate] bwd B={B} T={T} N={N} Dh={Dh} '
                  f'bwd_term_code_ms={B * T * N * Dh / rates[2][0] * 1e3:.4f}',
                  flush=True)
        return 0
    if args.precision == 'bf16':
        for B, T, N, Dh, Ds, keep_p in BF16_CASES:
            ops = operands(B, T, N, Dh, Ds, 'cuda')
            reps = args.reps if B * T <= 8192 else 3
            for rows in [None] + ([8, 16, 32] if args.sweep else []):
                fields = time_scdm_bf16(ops, keep_p, reps, rows)
                print(f'[K2 bf16] B={B} T={T} N={N} Dh={Dh} Ds={Ds} '
                      f'keep_p={keep_p} override={rows is not None} '
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
