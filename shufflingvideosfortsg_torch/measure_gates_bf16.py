"""Measure bf16 gate nonlinearities in the stacked recurrence kernel (K6a).

    python -m shufflingvideosfortsg_torch.measure_gates_bf16 \\
        [--t 128 --b 512 --h 256 --iters 30 --warmup 5 --dtype bf16|f32] \\
        [--device cuda|cpu]

Counterpart of ``tools/measure_gates_bf16.py``: runs
:func:`~shufflingvideosfortsg_torch.ops.lstm_scan.lstm_scan_stacked` at the
eval shape with bf16 (or f32) activations, gates in f32 against gates in
bf16, and prints the milliseconds per layer of each and their divergence,
so the option can be accepted or rejected with numbers. The inputs are the
tool's: ``np.random.RandomState(0)``, ``xw = randn * 0.5`` in the dtype,
``w_hh = randn / sqrt(H)`` in f32. On the card the times come from CUDA
events and the lines are headed by the card's name and power limit; with
``--device cpu`` the plain version runs and the times are the host's.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import List

import numpy as np
import torch

from .ops.lstm_scan import lstm_scan_stacked

_DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32}


def _inputs(T: int, B: int, H: int, dtype: torch.dtype,
            device: torch.device):
    rng = np.random.RandomState(0)
    xw = torch.from_numpy(rng.randn(T, 2, B, 4 * H) * 0.5).to(device, dtype)
    w_hh = torch.from_numpy(rng.randn(2, H, 4 * H) / np.sqrt(H)).to(
        device, torch.float32)
    return xw.contiguous(), w_hh.contiguous()


def run(T: int, B: int, H: int, dtype: torch.dtype, gates_bf16: bool,
        iters: int, warmup: int, device: torch.device):
    """(ms per layer, out) of ``iters`` calls after ``warmup`` ones."""
    xw, w_hh = _inputs(T, B, H, dtype, device)

    def call():
        return lstm_scan_stacked(xw, w_hh, gates_bf16=gates_bf16)[0]

    with torch.no_grad():
        out = call()
        for _ in range(warmup):
            call()
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms, out


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the host's device."""
    if device.type != 'cuda':
        return 'device: cpu (plain version, host clock)'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i',
                          str(device.index or 0)], check=True,
                         capture_output=True, text=True, timeout=60)
    return f'device: {smi.stdout.strip()} (CUDA events)'


def measure(T: int = 128, B: int = 512, H: int = 256, dtype: str = 'bf16',
            iters: int = 30, warmup: int = 5, device: str = 'cuda'
            ) -> List[str]:
    """The tool's lines: the device, the shape, then ``gates f32``,
    ``gates bf16`` and ``divergence``."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run on the CPU)')
    dt_f32, out_f32 = run(T, B, H, _DTYPES[dtype], False, iters, warmup, dev)
    dt_bf16, out_bf16 = run(T, B, H, _DTYPES[dtype], True, iters, warmup, dev)
    a, b = out_f32.float(), out_bf16.float()
    diff = (a - b).abs()
    max_abs = diff.max().item()
    max_rel = (diff / a.abs().clamp_min(1e-3)).max().item()
    return [device_line(dev),
            f'shape T={T} B={B} H={H} dtype={dtype}',
            f'gates f32 : {dt_f32:8.3f} ms/layer',
            f'gates bf16: {dt_bf16:8.3f} ms/layer ({dt_f32 / dt_bf16:.3f}x)',
            f'divergence: max_abs={max_abs:.3e} max_rel={max_rel:.3e}']


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--t', type=int, default=128)
    ap.add_argument('--b', type=int, default=512)
    ap.add_argument('--h', type=int, default=256)
    ap.add_argument('--iters', type=int, default=30)
    ap.add_argument('--warmup', type=int, default=5)
    ap.add_argument('--dtype', default='bf16', choices=sorted(_DTYPES))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    for line in measure(args.t, args.b, args.h, args.dtype, args.iters,
                        args.warmup, args.device):
        print(line)


if __name__ == '__main__':
    main()
