"""What calling K1 and K2 costs the host, and served batches around it.

    python -m shufflingvideosfortsg_torch.measure_dispatch [--calls 2000]

K1 (``ops/lstm_scan.lstm_recurrence``) and K2
(``ops/scdm_fused.scdm_attention_fused``) without gradients are the custom
ops ``svtsg::lstm_recurrence`` and ``svtsg::scdm_attention``, which
``torch.export`` traces as nodes (``utils/aot.py``). On a card, at shapes
so small that the host decides the time (K1 at T=1, B=1, H=64; K2 at
B=1, T=4, N=2, Dh=Ds=8), this prints the microseconds of a call of each
wrapper and of its launch alone (``_launch_forward``, which the wrapper
reaches through the op), as wall time over ``--calls`` calls, and a C
entry point that does no device work (``svtsg_scdm_smem_bytes``) through
the kernel library and through the bare ``ctypes`` library under it:
what setting the caller's current card back costs a call. Then
``profile_serve.measure`` of one video of 1,024 clips against 4 batches
of 512 queries as f32 features (its ``video_f32`` mode) in f32 and in
bf16: wall and device ms a batch, the busy share.

Copied into another checkout's package (a tree from before the ops, whose
wrappers launch through ``ctypes`` directly), it times that checkout on
the same inputs; ``profile_eval`` (an eager batch of 32) is run in each
tree as it is. Needs a CUDA device; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import _kernels
from .config import load_config
from .models.build import build_model
from .ops import lstm_scan, scdm_fused
from .profile_eval import card_line
from .profile_serve import VIDEO_LEN, VOCAB_WORDS, BATCHES, _timed, measure
from .serving import MultiQueryGrounder, bank_nbytes
from .utils.device import exact_bf16_products


def call_us(fn, calls: int) -> float:
    """Microseconds a call of fn() over ``calls`` calls, waited for."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def dispatch(calls: int, dev: torch.device) -> dict:
    gen = torch.Generator().manual_seed(0)
    H = 64
    xw = torch.randn(1, 1, 8 * H, generator=gen).to(dev)
    w_hh = (torch.randn(2, H, 4 * H, generator=gen) * 0.1).to(dev)
    args = [torch.randn(*s, generator=gen).to(dev)
            for s in ((1, 4, 8), (1, 2, 8), (8,), (1, 2, 8))]
    lib = _kernels.library()
    entry = lib.svtsg_scdm_smem_bytes
    entry_raw = getattr(lib, '_lib', lib).svtsg_scdm_smem_bytes
    with torch.no_grad():
        return {
            'K1_wrapper_us': call_us(
                lambda: lstm_scan.lstm_recurrence(xw, w_hh), calls),
            'K1_launch_us': call_us(lambda: lstm_scan._launch_forward(
                'lstm_recurrence', xw, w_hh, lstm_scan.FLAT, False), calls),
            'K2_wrapper_us': call_us(
                lambda: scdm_fused.scdm_attention_fused(*args), calls),
            'K2_launch_us': call_us(
                lambda: scdm_fused._launch_forward(tuple(args), False), calls),
            'entry_us': call_us(lambda: entry(32, 15, 4), calls),
            'entry_raw_us': call_us(lambda: entry_raw(32, 15, 4), calls)}


def serve_video(precision: str, batch: int) -> dict:
    params = dict(load_config('charades_cd_i3d.yml'), precision=precision)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        state = build_model(params, 'gmd', device='cpu').state_dict()
    rng = np.random.RandomState(0)
    Q = batch * BATCHES
    emb = rng.uniform(-1, 1, (VOCAB_WORDS, 300)).astype(np.float32)
    feats = emb[rng.randint(1, VOCAB_WORDS, (Q, params['sent_len']))]
    g = MultiQueryGrounder(params, state, query_batch=batch)
    video = rng.randn(VIDEO_LEN, params['video_feature_dim']).astype(
        np.float32)
    setup = _timed(lambda: g.set_video(video))
    return measure('video_f32', lambda: g.ground(None, feats), Q, batch,
                   setup, bank_nbytes(g._resident_rnn0), precision)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--calls', type=int, default=2000)
    ap.add_argument('--batch', type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('measure_dispatch needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    exact_bf16_products()
    smi = card_line()
    print(f'card: {smi}', flush=True)
    out = dict(card=smi, op=hasattr(lstm_scan, 'lstm_recurrence_op'),
               **dispatch(args.calls, torch.device('cuda', 0)))
    print(' '.join(f'{k}={v:.2f}' for k, v in out.items()
                   if k.endswith('_us')), flush=True)
    for precision in ('f32', 'bf16'):
        out[f'serve_{precision}'] = serve_video(precision, args.batch)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
