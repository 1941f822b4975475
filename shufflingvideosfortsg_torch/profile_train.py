"""Where one GMD train step spends its time on the card.

    python -m shufflingvideosfortsg_torch.profile_train [--batch 32] [--iters 10]

Builds GMD at the width of ``cfgs/charades_cd_i3d.yml`` from seeded random
weights, with the config's optimizer (Adam, weight decay 1e-4) and dropout,
and times ``make_gmd_train_step`` (on-device pseudo videos, the four-term
loss, backward, one Adam update) on one seeded batch of pairs: milliseconds
per step from CUDA events, then one ``torch.profiler`` window that sums
device time by kernel and by group (the port's kernels, cuBLAS products,
the optimizer, the rest) and gives the device's busy share of the window,
and the peak device memory of the first steps.
Needs a CUDA device; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .config import load_config
from .models.build import build_model
from .ops.augment_device import device_masks
from .profile_eval import card_line, print_kernels, profile_window
from .train.state import TrainState
from .train.steps import make_gmd_train_step

# kernel-name patterns of the groups a step's device time is split into
GROUPS = (('K3 lstm_fwd_kernel', ('lstm_fwd_kernel',)),
          ('K4 lstm_bwd_kernel', ('lstm_bwd_kernel',)),
          ('K4 lstm_weight_grad_kernel', ('lstm_weight_grad_kernel',)),
          ('K2 scdm_fwd_kernel', ('scdm_fwd_kernel',)),
          ('K5 scdm_bwd_kernel', ('scdm_bwd_kernel',)),
          ('GEMMs', ('gemm', 'Gemm', 'gemv', 'cutlass', 'sm90_xmma',
                     'dot_kernel')),
          ('optimizer', ('multi_tensor_apply',)))


def train_batch(params, B: int, device, seed: int = 0):
    """One seeded batch of B raw videos at the config's shape, with the
    reference's masks, as the train step reads it."""
    rng = np.random.RandomState(seed)
    T, D, N = params['video_len'], params['video_feature_dim'], params['sent_len']
    nfeats = rng.randint(T // 4, T + 1, size=B)
    s = np.array([rng.randint(0, n) for n in nfeats])
    e = np.array([rng.randint(a, n) for a, n in zip(s, nfeats)])
    video = rng.randn(B, T, D).astype(np.float32)
    video[np.arange(T)[None] >= nfeats[:, None]] = 0.0
    framestps = np.stack([s, e], -1).astype(np.int32)
    arrays = {
        'video_feat': video,
        'sent_feat': rng.randn(B, N, 300).astype(np.float32),
        'sent_mask': np.ones((B, N), np.int32),
        'framestps': framestps,
        'timestps': framestps.astype(np.float32),
        'nfeats': nfeats.astype(np.int32),
        'duration': np.full(B, 30.0, np.float32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    batch.update(device_masks(batch['framestps'][:, 0],
                              batch['framestps'][:, 1], batch['nfeats'], T))
    return batch


def group_times(kernels):
    """Device us by group; what no pattern names is 'other'."""
    out = {name: 0.0 for name, _ in GROUPS}
    out['other'] = 0.0
    for key, us in kernels.items():
        group = next((name for name, pats in GROUPS
                      if any(p in key for p in pats)), 'other')
        out[group] += us
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--iters', type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_train needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    params = load_config('charades_cd_i3d.yml')
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(params, 'gmd', device='cpu').to(dev)
    state = TrainState(model, params, steps_per_epoch=1000)
    step = make_gmd_train_step(model, state, params)
    batch = train_batch(params, args.batch, dev)
    gen = torch.Generator(dev).manual_seed(0)

    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        step(batch, gen)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.iters):
        step(batch, gen)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / args.iters

    n_prof = 3
    kernels, wall_ms, busy_ms = profile_window(lambda: step(batch, gen), n_prof)
    groups = group_times(kernels)
    smi = card_line()
    print(f'card: {smi}')
    print(f'step: {ms:.4f} ms per train step of {args.batch} pairs '
          f'({args.batch / ms * 1e3:.1f} pairs/s, CUDA events, '
          f'{args.iters} iterations)')
    print(f'peak device memory: {peak_gib:.3f} GiB allocated by torch')
    print(f'profile window: {n_prof} steps, wall {wall_ms:.3f} ms, device '
          f'busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)')
    for name, us in groups.items():
        print(f'  group {name:27s} {us / 1e3 / n_prof:9.4f} ms/step '
              f'{100 * us / 1e3 / busy_ms:5.1f}%')
    print_kernels(kernels, n_prof, busy_ms, top=20)
    print(json.dumps({
        'card': smi, 'batch': args.batch, 'step_ms': ms,
        'peak_memory_gib': peak_gib,
        'window_wall_ms': wall_ms, 'window_device_busy_ms': busy_ms,
        'groups_ms_per_step': {k: v / 1e3 / n_prof for k, v in groups.items()},
        'kernels_ms_per_step': {k[:100]: v / 1e3 / n_prof
                                for k, v in kernels.items()}}))


if __name__ == '__main__':
    main()
