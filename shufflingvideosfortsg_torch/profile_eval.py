"""Where one GMD evaluation batch spends its time on the card.

    python -m shufflingvideosfortsg_torch.profile_eval [--batch 32] [--iters 20]

Builds GMD at the width of ``cfgs/charades_cd_i3d.yml`` from seeded random
weights and times the evaluation step (``eval_forward`` plus the span
decode) on one seeded batch: milliseconds per batch from CUDA events, then
one ``torch.profiler`` window that sums device time by kernel and gives the
device's busy share of the window. Needs a CUDA device; prints one JSON
line last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .models.build import build_model
from .train.steps import make_gmd_test_step


def _batch(params, B: int, device, seed: int = 0):
    rng = np.random.RandomState(seed)
    T, D, N = params['video_len'], params['video_feature_dim'], params['sent_len']
    nfeats = rng.randint(16, T, size=B)
    stamps = np.sort(rng.randint(0, T, (B, 2)), axis=1)
    arrays = {
        'video_feat': rng.randn(B, T, D).astype(np.float32),
        'sent_feat': rng.randn(B, N, 300).astype(np.float32),
        'video_mask': (np.arange(T)[None] <= nfeats[:, None]).astype(np.int32),
        'sent_mask': np.ones((B, N), np.int32),
        'framestps': stamps.astype(np.int32),
        'timestps': stamps.astype(np.float32),
        'nfeats': nfeats.astype(np.int32),
        'duration': np.full(B, 30.0, np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def profile_window(step, n: int):
    """Run ``step()`` n times under ``torch.profiler``: (device time in us
    by kernel name, the window's wall ms, the device's busy ms)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}  # device-side events only: the ops' totals would count twice
    for evt in prof.key_averages():
        # a user annotation (Optimizer.step#Adam.step) spans kernels
        # already counted
        if getattr(evt, 'is_user_annotation', False):
            continue
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total
    return kernels, wall_ms, sum(kernels.values()) / 1e3


def card_line() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def print_kernels(kernels, n: int, busy_ms: float, top: int = 15) -> None:
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f'  {us / 1e3 / n:9.4f} ms/step '
              f'{100 * us / 1e3 / busy_ms:5.1f}%  {name[:100]}')


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_eval needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    params = load_config('charades_cd_i3d.yml')
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(params, 'gmd', device=dev).eval()
    step = make_gmd_test_step(model)
    batch = _batch(params, args.batch, dev)

    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.iters):
        step(batch)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / args.iters

    n_prof = 5
    kernels, wall_ms, busy_ms = profile_window(lambda: step(batch), n_prof)
    smi = card_line()
    print(f'card: {smi}')
    print(f'step: {ms:.4f} ms per batch of {args.batch} '
          f'({args.batch / ms * 1e3:.1f} sentences/s, CUDA events, '
          f'{args.iters} iterations)')
    print(f'profile window: {n_prof} steps, wall {wall_ms:.3f} ms, device '
          f'busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)')
    print_kernels(kernels, n_prof, busy_ms)
    print(json.dumps({
        'card': smi, 'batch': args.batch, 'step_ms': ms,
        'window_wall_ms': wall_ms, 'window_device_busy_ms': busy_ms,
        'kernels_ms_per_step': {k[:100]: v / 1e3 / n_prof
                                for k, v in kernels.items()}}))


if __name__ == '__main__':
    main()
