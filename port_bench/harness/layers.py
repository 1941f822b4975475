"""What the per-layer metric readers share: a traced window's units of
work, rooflines, model FLOP utilisation, idle share and per-unit device
time. Each reader returns None where the run has nothing to read."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from . import flops, trace

# device kernels by what implements them (the port's CUDA kernels by
# their names in csrc/, cuBLAS's products, NCCL's collectives)
LSTM_KERNELS = ('lstm_fwd_kernel', 'lstm_bwd_kernel',
                'lstm_weight_grad_kernel')
SCDM_KERNELS = ('scdm_fwd_kernel', 'scdm_bwd_kernel')
GEMM_KERNELS = ('gemm', 'Gemm', 'gemv', 'cutlass', 'xmma', 'nvjet',
                'dot_kernel', 'splitKreduce')
NCCL_KERNELS = ('nccl', 'AllReduce')


def units(ctx: Dict) -> Optional[float]:
    """Units of work in the traced window: train steps and eval ticks as
    the harness counted them; served batches from K2's launches (two a
    batch)."""
    if ctx.get('trace') is None:
        return None
    if ctx.get('units'):
        return float(ctx['units'])
    n, _ = trace.matching(ctx['trace']['kernels'], ('scdm_fwd_kernel',))
    per = len(flops.launches(ctx['params'], ctx['kind'],
                             ctx['unit_rows'])['scdm'])
    return n / per if n else None


def roofline(ctx: Dict, which: str, patterns: Sequence[str]
             ) -> Optional[float]:
    """100 x the least seconds of the window's ``which`` ('lstm' or
    'scdm') launches over the device seconds of the kernels that ran them."""
    u = units(ctx)
    if not u:
        return None
    _, secs = trace.matching(ctx['trace']['kernels'], patterns)
    if secs <= 0:
        return None
    least = flops.least_seconds(ctx['params'], ctx['kind'],
                                ctx['unit_rows'])[which]
    return 100.0 * u * least / secs


def mfu(ctx: Dict) -> Optional[float]:
    """100 x the window's model operations (a unit's :func:`flops.
    model_flops` times the units) over the window's seconds times the f32
    peak. On P ranks each rank does a P-th of the global step, so a rank's
    share over its own card is the whole's over P cards."""
    u = units(ctx)
    if not u:
        return None
    work = u * flops.model_flops(ctx['params'], ctx['kind'],
                                 ctx['unit_rows'])
    return 100.0 * work / (ctx['trace']['window_s'] * flops.PEAK_F32_FLOPS)


def idle(ctx: Dict) -> Optional[float]:
    """100 x (1 - the union of device activity over the window), the mean
    over the ranks."""
    if ctx.get('trace') is None:
        return None
    shares = [t['busy_s'] / t['window_s'] for t in ctx.get('traces',
                                                         [ctx['trace']])]
    return 100.0 * (1.0 - float(np.mean(shares)))


def unit_ms(ctx: Dict, patterns: Sequence[str]) -> Optional[float]:
    """Device milliseconds a unit of the kernels ``patterns`` name."""
    u = units(ctx)
    if not u:
        return None
    n, secs = trace.matching(ctx['trace']['kernels'], patterns)
    return 1e3 * secs / u if n else None
