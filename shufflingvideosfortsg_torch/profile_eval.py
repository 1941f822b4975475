"""Where one GMD evaluation batch spends its time on the card.

    python -m shufflingvideosfortsg_torch.profile_eval [--batch 32] [--iters 20]
    python -m shufflingvideosfortsg_torch.profile_eval --banked [--group 8]
    ... [--precision bf16]

Builds GMD at the width of ``cfgs/charades_cd_i3d.yml`` from seeded random
weights and times the evaluation step (``eval_forward`` plus the span
decode) on one seeded batch: milliseconds per batch from CUDA events, then
one ``torch.profiler`` window that sums device time by kernel and gives the
device's busy share of the window.

``--banked`` writes a synthetic f16 pack of 1,024 videos (T=128, D=1024)
with ``tools/make_synth_pack.py`` to a temporary directory, uploads it as
a device bank (its upload seconds and bytes), and runs one evaluation
epoch of ``--group`` x 8 index batches of ``--batch`` three ways: eager,
batch by batch with the assembly on the device; and the graphed epoch of
``cli._banked_eval_epoch`` at G=1 and at G=``--group``. For each: wall ms
and device-busy ms per batch, sentences/s, and the device's busy share of
an epoch under ``torch.profiler``, with the device time of the matrix
products (cuBLAS), K1 and K2 a batch.

``--precision`` (f32 by default, or bf16) is the model's compute dtype,
printed on every line; bf16 products sum in f32
(``utils/device.exact_bf16_products``).

Needs a CUDA device; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import load_config
from .data import device_bank
from .data.featpack import PackedFeatureSource
from .models.build import build_model
from .train.steps import make_gmd_test_step, to_device
from .utils.device import exact_bf16_products


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


# device kernels by group: cuBLAS's matrix products (its f32 kernels are
# sm80_xmma_gemm_*, its bf16 ones on an H100 nvjet_*), K1 (at bf16 W_hh and
# H=256 lstm_fwd_mma_kernel), K2 (at bf16 scdm_fwd_mma_kernel)
GROUPS = (('gemm', ('gemm', 'cutlass', 'xmma', 'cublas', 'nvjet')),
          ('K1', ('lstm_fwd_kernel', 'lstm_fwd_mma_kernel')),
          ('K2', ('scdm_fwd_kernel', 'scdm_fwd_mma_kernel')))


def grouped_ms(kernels, n: int) -> dict:
    """Device ms a step of each group of :data:`GROUPS` and of the rest."""
    out = {name: 0.0 for name, _ in GROUPS}
    out['other'] = 0.0
    for key, us in kernels.items():
        name = next((g for g, keys in GROUPS
                     if any(k in key.lower() for k in keys)), 'other')
        out[name] += us / 1e3 / n
    return out


def print_kernels(kernels, n: int, busy_ms: float, top: int = 15,
                  tag: str = '') -> None:
    """The ``top`` kernels by device time, each line led by ``tag``."""
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f'  {tag}{us / 1e3 / n:9.4f} ms/step '
              f'{100 * us / 1e3 / busy_ms:5.1f}%  {name[:100]}')


BANK_VIDEOS = 1024  # the --banked pack: 256 MiB of f16 at T=128, D=1024
BANK_TICKS = 8  # ticks of --group batches in the --banked epoch


def write_pack(root: str, V: int, T: int, D: int) -> str:
    """A FEATPAK1 pack of V videos v0.. of random f16 features (zero past
    each video's clip count), written under root by running
    ``tools/make_synth_pack.py``; returns its directory."""
    vids = os.path.join(root, 'videos.json')
    with open(vids, 'w') as f:
        json.dump({f'v{i}': {} for i in range(V)}, f)
    out = os.path.join(root, 'pack')
    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools', 'make_synth_pack.py')
    subprocess.run([sys.executable, tool, '--annotations', vids, '--out', out,
                    '--t', str(T), '--d', str(D), '--dtype', 'f16'],
                   check=True, capture_output=True, timeout=900)
    return out


def index_batches(params, V: int, B: int, n: int, seed: int = 0):
    """n index-only host batches of B sentences over a bank of V videos."""
    rng = np.random.RandomState(seed)
    T, N = params['video_len'], params['sent_len']
    out = []
    for _ in range(n):
        s = np.sort(rng.randint(0, T, (B, 2)), axis=1)
        out.append({
            'pack_row': rng.randint(0, V, B).astype(np.int64),
            'token_ids': rng.randint(0, 400, (B, N)).astype(np.int64),
            'sent_len': rng.randint(3, N, B).astype(np.int64),
            'framestps': s.astype(np.int32),
            'nfeats': rng.randint(16, T, B).astype(np.int32),
            'timestps': s.astype(np.float32),
            'duration': np.full(B, 30.0, np.float32)})
    return out


def banked(model, params, args, dev) -> dict:
    """The --banked measurement; returns its JSON fields."""
    from .cli import _banked_eval_epoch
    T, D = params['video_len'], params['video_feature_dim']
    with tempfile.TemporaryDirectory(prefix='svtsg_profile_') as root:
        pack = PackedFeatureSource(write_pack(root, BANK_VIDEOS, T, D))
        vocab = types.SimpleNamespace(embeddings=np.random.RandomState(1)
                                      .uniform(-1, 1, (400, 300))
                                      .astype(np.float32))
        t0 = time.perf_counter()
        bank = device_bank.DeviceFeatureBank(pack, vocab, dev)
        upload_s = time.perf_counter() - t0
        pack.close()
    print(f'bank [{args.precision}]: {BANK_VIDEOS} videos, {bank.nbytes} '
          f'bytes resident, uploaded in {upload_s:.3f} s')
    step = make_gmd_test_step(model, assembler=bank.assemble)
    batches = index_batches(params, BANK_VIDEOS, args.batch,
                            args.group * BANK_TICKS)

    def eager():
        return [step(bank.attach(to_device(b, dev, device_bank.INDEX_KEYS)))
                for b in batches]

    modes = {'eager': eager}
    for g in sorted({1, args.group}):
        modes[f'graphed_g{g}'] = (
            lambda g=g: _banked_eval_epoch(step, batches, bank, dev,
                                           group=g))
    n, out = len(batches), {}
    for name, fn in modes.items():
        fn()  # builds, plans, captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (args.iters * n)
        kernels, win_ms, busy_ms = profile_window(fn, 1)
        groups = grouped_ms(kernels, n)
        out[name] = {'wall_ms_per_batch': wall,
                     'sentences_per_s': args.batch / wall * 1e3,
                     'device_ms_per_batch': busy_ms / n,
                     'busy_share': busy_ms / win_ms,
                     'kernels_seen': len(kernels),
                     'group_ms_per_batch': groups}
        print(f'{name} [{args.precision}]: {wall:.4f} ms a batch of '
              f'{args.batch} wall ({args.batch / wall * 1e3:.1f} '
              f'sentences/s), device busy {busy_ms / n:.4f} ms a batch, '
              f'{100 * busy_ms / win_ms:.1f}% of a profiled epoch of {n} '
              f'batches ({win_ms:.3f} ms); ms a batch: '
              + ', '.join(f'{k} {v:.4f}' for k, v in groups.items()))
        print_kernels(kernels, n, busy_ms, top=6, tag=f'[{args.precision}] ')
    return {'bank_bytes': bank.nbytes, 'upload_s': upload_s,
            'batches': n, 'group': args.group, 'modes': out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=32)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--banked', action='store_true')
    ap.add_argument('--group', type=int, default=8)
    ap.add_argument('--precision', choices=('f32', 'bf16'), default='f32')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_eval needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exact_bf16_products()
    dev = torch.device('cuda', 0)
    params = dict(load_config('charades_cd_i3d.yml'),
                  precision=args.precision)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(params, 'gmd', device=dev).eval()
    if args.banked:
        smi = card_line()
        print(f'card: {smi} [{args.precision}]')
        fields = banked(model, params, args, dev)
        print(json.dumps({'card': smi, 'precision': args.precision,
                          'batch': args.batch, **fields}))
        return
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
    print(f'card: {smi} [{args.precision}]')
    print(f'step [{args.precision}]: {ms:.4f} ms per batch of {args.batch} '
          f'({args.batch / ms * 1e3:.1f} sentences/s, CUDA events, '
          f'{args.iters} iterations)')
    print(f'profile window [{args.precision}]: {n_prof} steps, wall '
          f'{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms '
          f'({100 * busy_ms / wall_ms:.1f}%)')
    print_kernels(kernels, n_prof, busy_ms, tag=f'[{args.precision}] ')
    print(json.dumps({
        'card': smi, 'precision': args.precision, 'batch': args.batch,
        'step_ms': ms, 'group_ms_per_step': grouped_ms(kernels, n_prof),
        'window_wall_ms': wall_ms, 'window_device_busy_ms': busy_ms,
        'kernels_ms_per_step': {k[:100]: v / 1e3 / n_prof
                                for k, v in kernels.items()}}))


if __name__ == '__main__':
    main()
