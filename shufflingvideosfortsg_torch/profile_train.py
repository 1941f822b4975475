"""Where one GMD train step spends its time on the card.

    python -m shufflingvideosfortsg_torch.profile_train [--batch 32] [--iters 10]
    python -m shufflingvideosfortsg_torch.profile_train --banked [--iters 3]
    ... [--precision bf16]

Builds GMD at the width of ``cfgs/charades_cd_i3d.yml`` from seeded random
weights, with the config's optimizer (Adam, weight decay 1e-4) and dropout,
and times ``make_gmd_train_step`` (on-device pseudo videos, the four-term
loss, backward, one Adam update) on one seeded batch of pairs: milliseconds
per step from CUDA events, then one ``torch.profiler`` window that sums
device time by kernel and by group (the port's kernels, cuBLAS products,
the optimizer, the rest) and gives the device's busy share of the window,
the peak device memory of the first steps, and a window with the
operators' input shapes: the matrix products (``aten::addmm``, ``mm``,
``bmm``) by shape, with their device time and rate against the peak of
the precision.

``--precision`` (f32 by default, or bf16) is the model's compute dtype
(the weights and Adam's state stay f32); at bf16 cuBLAS sums its bf16
products in f32 (``utils/device.exact_bf16_products``), as the drivers
have it. Every line names the precision; device time is grouped into the
GEMMs (cuBLAS's and cuBLASLt's ``nvjet_*`` kernels), K3, K4's recurrence,
K4's weight gradient, K2, K5's backward, the optimizer and the rest.

``--banked`` writes a synthetic f16 pack of 1,024 videos (T=128, D=1024)
with ``tools/make_synth_pack.py``, uploads it as a device bank and trains
an epoch of 64 steps of ``--batch`` pairs on it two ways: eager, step by
step with the assembly on the device (``train_scan_chunk`` 1); and in
chunks of 16 (``cli._banked_train_chunks_factory``), each step a replay of
one CUDA graph. One epoch first (builds, warm-up, capture), then
``--iters`` epochs timed: wall ms a step and pairs/s, and one epoch under
``torch.profiler``: device ms a step, the device's busy share and the
groups.

Needs a CUDA device; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .data import device_bank
from .data.featpack import PackedFeatureSource
from .models.build import build_model
from .ops.augment_device import device_masks
from .profile_eval import (BANK_VIDEOS, card_line, print_kernels,
                           profile_window, write_pack)
from .train.state import TrainState
from .train.steps import make_gmd_train_step, to_device
from .utils.device import exact_bf16_products

# H100 SXM at 700 W: f32 outside the tensor cores, bf16 dense tensor cores
PEAK_FLOPS = {'f32': 67e12, 'bf16': 989e12}
BANK_STEPS = 64  # the --banked epoch
BANK_CHUNK = 16  # train_scan_chunk of its graphed mode

# kernel-name patterns of the groups a step's device time is split into
# (at bf16 the forward, K4's recurrence, the weight gradient and K2 run
# their *_mma_kernel, K5's backward scdm_bwd_bf16x2_kernel)
GROUPS = (('K3 lstm_fwd_kernel', ('lstm_fwd_kernel', 'lstm_fwd_mma_kernel')),
          ('K4 lstm_bwd_kernel', ('lstm_bwd_kernel', 'lstm_bwd_mma_kernel')),
          ('K4 lstm_weight_grad_kernel', ('lstm_weight_grad_kernel',
                                          'lstm_weight_grad_mma_kernel')),
          ('K2 scdm_fwd_kernel', ('scdm_fwd_kernel', 'scdm_fwd_mma_kernel')),
          ('K5 scdm_bwd_kernel', ('scdm_bwd_kernel',
                                  'scdm_bwd_bf16x2_kernel')),
          ('GEMMs', ('gemm', 'Gemm', 'gemv', 'cutlass', 'xmma', 'nvjet',
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


_GEMMS = {'aten::addmm': lambda s: (s[1], s[2]), 'aten::mm': lambda s: s[:2],
          'aten::bmm': lambda s: s[:2]}


def gemm_shapes(step, n: int):
    """Run ``step()`` n times under ``torch.profiler`` with the operators'
    input shapes: per (product, shapes), the count a step, the device ms
    a step and the rate in TFLOP/s (2·M·K·N a product, times the batch of
    a ``bmm``), sorted by device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key not in _GEMMS or evt.device_time_total <= 0:
            continue
        a, b = _GEMMS[evt.key](evt.input_shapes)
        flops = 2.0 * float(np.prod(a)) * b[-1]
        ms = evt.device_time_total / 1e3 / n
        rows.append({'op': evt.key, 'shapes': [a, b],
                     'per_step': evt.count / n, 'ms_per_step': ms,
                     'tflops': flops * evt.count / n / (ms * 1e-3) / 1e12})
    return sorted(rows, key=lambda r: -r['ms_per_step'])


def seeded_gmd(params, dev, assembler=None):
    """A GMD train step of seeded weights (on ``assembler``'s bank)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(params, 'gmd', device='cpu').to(dev)
    state = TrainState(model, params, steps_per_epoch=1000)
    return make_gmd_train_step(model, state, params, assembler=assembler)


def bank_batches(params, nfeats, B: int, n: int, seed: int = 0):
    """n index-only batches of B pairs over a bank of videos with clip
    counts ``nfeats``, each moment inside its video."""
    rng = np.random.RandomState(seed)
    T, N = params['video_len'], params['sent_len']
    out = []
    for _ in range(n):
        rows = rng.randint(0, len(nfeats), B)
        n_clips = nfeats[rows].astype(np.int32)
        s = (rng.rand(B) * n_clips).astype(np.int32)
        e = s + (rng.rand(B) * (n_clips - s)).astype(np.int32)
        framestps = np.stack([s, e], -1).astype(np.int32)
        out.append({'pack_row': rows.astype(np.int64),
                    'token_ids': rng.randint(0, 400, (B, N)).astype(np.int64),
                    'sent_len': rng.randint(3, N, B).astype(np.int64),
                    'framestps': framestps, 'nfeats': n_clips,
                    'timestps': framestps.astype(np.float32),
                    'duration': np.full(B, float(T), np.float32)})
    return out


def banked(params, args, dev) -> dict:
    """The --banked measurement; returns its JSON fields."""
    from .cli import _banked_train_chunks_factory
    T, D = params['video_len'], params['video_feature_dim']
    with tempfile.TemporaryDirectory(prefix='svtsg_profile_') as root:
        pack = PackedFeatureSource(write_pack(root, BANK_VIDEOS, T, D))
        vocab = types.SimpleNamespace(embeddings=np.random.RandomState(1)
                                      .uniform(-1, 1, (400, 300))
                                      .astype(np.float32))
        bank = device_bank.DeviceFeatureBank(pack, vocab, dev)
        nfeats = np.asarray(pack.nfeats)
        pack.close()
    batches = bank_batches(params, nfeats, args.batch, BANK_STEPS)
    modes = {}
    step = seeded_gmd(params, dev, bank.assemble)
    step_gen = torch.Generator(dev).manual_seed(0)

    def eager():
        for b in batches:
            step(bank.attach(to_device(b, dev, device_bank.INDEX_KEYS)),
                 step_gen)
    modes['eager'] = eager
    chunked = seeded_gmd(params, dev, bank.assemble)
    run = _banked_train_chunks_factory(chunked, bank, dev)
    chunk_gen = torch.Generator(dev).manual_seed(0)

    def graphed():
        for i in range(0, len(batches), BANK_CHUNK):
            run(batches[i:i + BANK_CHUNK], chunk_gen)
    modes[f'graphed_chunks_of_{BANK_CHUNK}'] = graphed
    n, out = len(batches), {}
    for name, fn in modes.items():
        fn()  # builds, plans, warms up and captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (args.iters * n)
        kernels, win_ms, busy_ms = profile_window(fn, 1)
        groups = group_times(kernels)
        out[name] = {'wall_ms_per_step': wall,
                     'pairs_per_s': args.batch / wall * 1e3,
                     'device_ms_per_step': busy_ms / n,
                     'busy_share': busy_ms / win_ms,
                     'groups_ms_per_step': {k: v / 1e3 / n
                                            for k, v in groups.items()}}
        tag = f'[{args.precision}]'
        print(f'{name} {tag}: {wall:.4f} ms a step of {args.batch} pairs '
              f'wall ({args.batch / wall * 1e3:.1f} pairs/s), device busy '
              f'{busy_ms / n:.4f} ms a step, {100 * busy_ms / win_ms:.1f}% '
              f'of a profiled epoch of {n} steps ({win_ms:.3f} ms)')
        print_groups(groups, n, busy_ms, tag)
        print_kernels(kernels, n, busy_ms, top=6, tag=f'{tag} ')
    return {'steps': n, 'chunk': BANK_CHUNK, 'bank_bytes': bank.nbytes,
            'modes': out}


def print_groups(groups, n: int, busy_ms: float, tag: str) -> None:
    """Each group's device ms a step and share of the busy time."""
    for name, us in groups.items():
        print(f'  {tag} group {name:27s} {us / 1e3 / n:9.4f} ms/step '
              f'{100 * us / 1e3 / busy_ms:5.1f}%')


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--precision', choices=('f32', 'bf16'), default='f32')
    ap.add_argument('--iters', type=int, default=None,
                    help='timed steps (default 10), with --banked epochs '
                    '(default 3)')
    ap.add_argument('--banked', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_train needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exact_bf16_products()
    dev = torch.device('cuda', 0)
    params = load_config('charades_cd_i3d.yml')
    params['precision'] = args.precision
    tag = f'[{args.precision}]'
    if args.banked:
        args.iters = args.iters or 3
        smi = card_line()
        print(f'card: {smi} {tag}')
        fields = banked(params, args, dev)
        print(json.dumps({'card': smi, 'precision': args.precision,
                          'batch': args.batch, **fields}))
        return
    args.iters = args.iters or 10
    step = seeded_gmd(params, dev)
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
    peak = PEAK_FLOPS[args.precision]
    print(f'card: {smi} {tag}')
    print(f'step {tag}: {ms:.4f} ms per train step of {args.batch} pairs '
          f'({args.batch / ms * 1e3:.1f} pairs/s, CUDA events, '
          f'{args.iters} iterations)')
    print(f'peak device memory {tag}: {peak_gib:.3f} GiB allocated by torch')
    print(f'profile window {tag}: {n_prof} steps, wall {wall_ms:.3f} ms, '
          f'device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)')
    print_groups(groups, n_prof, busy_ms, tag)
    print_kernels(kernels, n_prof, busy_ms, top=20, tag=f'{tag} ')
    gemms = gemm_shapes(lambda: step(batch, gen), n_prof)
    total = sum(r['ms_per_step'] for r in gemms)
    print(f'matrix products by shape {tag} ({total:.4f} ms/step; rate '
          f'against {peak / 1e12:.0f} TFLOP/s {args.precision}):')
    for r in gemms[:12]:
        print(f'  {tag} {r["ms_per_step"]:9.4f} ms/step '
              f'{r["per_step"]:4.0f}x {r["op"]:12s} {r["shapes"]} '
              f'{r["tflops"]:7.2f} TFLOP/s '
              f'({100 * r["tflops"] * 1e12 / peak:4.1f}%)')
    print(json.dumps({
        'card': smi, 'precision': args.precision, 'batch': args.batch,
        'step_ms': ms,
        'peak_memory_gib': peak_gib,
        'window_wall_ms': wall_ms, 'window_device_busy_ms': busy_ms,
        'groups_ms_per_step': {k: v / 1e3 / n_prof for k, v in groups.items()},
        'kernels_ms_per_step': {k[:100]: v / 1e3 / n_prof
                                for k, v in kernels.items()},
        'gemms': gemms}))


if __name__ == '__main__':
    main()
