"""Where a served query batch spends its time on the card.

    python -m shufflingvideosfortsg_torch.profile_serve [--batch 512]
        [--precision bf16]

Builds ``serving.MultiQueryGrounder`` at the width of
``cfgs/charades_cd_i3d.yml`` (I3D D=1024, N=15 words, H=256 BiLSTMs, 2
QAVE blocks) in ``--precision`` (f32 by default, or bf16: the compute
dtype, printed on every line) from seeded random weights and serves
BATCHES (4) batches of ``--batch`` (512) queries in each mode:

- ``video_f32``, ``video_f16``, ``video_tokens``, ``video_topk``: one
  resident video of VIDEO_LEN (1024) clips, queries as f32 sentence
  features, as f16 (``serve_query_dtype: f16``), as token ids against a
  resident vocabulary, and as f32 features decoded to the top TOPK (5)
  NMS proposals;
- ``corpus_raw``, ``corpus_int8``: a pack of CORPUS_VIDEOS (6,350, the
  Charades-CD size) f16 videos at T=128 written by
  ``tools/make_synth_pack.py``, set up with ``set_corpus`` in chunks of
  CORPUS_CHUNK (256) videos, raw (in the compute dtype) or int8, and
  token-id queries against random videos of it.

For each mode: the seconds of its setup (the block-0 recurrences, waited
for), wall ms a batch and queries/s (host clock around whole calls, the
fetch included, after one warm-up call), device ms a batch and the
device's busy share of one ``torch.profiler`` call with the device time of
the matrix products, K1 and K2 a batch, the resident bank's bytes, the
peak device memory of a call, and K1 and K2 launches a batch.
Needs a CUDA device; prints the card and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from .config import load_config
from .data.featpack import PackedFeatureSource
from .models.build import build_model
from .ops.lstm_scan import lstm_recurrence
from .ops.scdm_fused import scdm_attention_fused
from .profile_eval import (card_line, grouped_ms, print_kernels,
                           profile_window, write_pack)
from .serving import MultiQueryGrounder, bank_nbytes

VOCAB_WORDS = 8000  # a GloVe vocabulary of the datasets' order
BATCHES = 4  # query batches a measured call
VIDEO_LEN = 1024  # the single video's clips (bench.py --serve-video-len)
CORPUS_VIDEOS = 6350  # the Charades-CD pack
CORPUS_CHUNK = 256  # videos a set_corpus chunk
TOPK = 5


def _timed(fn) -> float:
    """Seconds of fn(), its device work waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def measure(name: str, serve, n_queries: int, batch: int, setup_s: float,
            bank: int, tag: str) -> dict:
    """One mode: serve() grounds n_queries in batches of ``batch``;
    ``tag`` (the compute dtype) leads every line."""
    n = -(-n_queries // batch)
    serve()  # warm-up: kernels, plans, the allocator
    for fn in (lstm_recurrence, scdm_attention_fused):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    wall = _timed(serve) * 1e3 / n
    launches = {'K1': lstm_recurrence.launches / n,
                'K2': scdm_attention_fused.launches / n}
    peak = torch.cuda.max_memory_allocated()
    kernels, win_ms, busy_ms = profile_window(serve, 1)
    groups = grouped_ms(kernels, n)
    out = {'setup_s': setup_s, 'wall_ms_per_batch': wall,
           'queries_per_s': batch / wall * 1e3,
           'device_ms_per_batch': busy_ms / n, 'busy_share': busy_ms / win_ms,
           'group_ms_per_batch': groups, 'bank_bytes': bank,
           'peak_bytes': peak, 'launches_per_batch': launches}
    print(f'{name} [{tag}]: setup {setup_s:.3f} s; {wall:.4f} ms wall a '
          f'batch of {batch} ({out["queries_per_s"]:.1f} queries/s), device '
          f'{busy_ms / n:.4f} ms a batch, busy {100 * busy_ms / win_ms:.1f}% '
          f'of a profiled call (' + ', '.join(f'{k} {v:.3f}' for k, v in
                                              groups.items())
          + f' ms); bank {bank} bytes; peak {peak / 2**30:.3f} GiB; '
          f'launches a batch {launches}', flush=True)
    print_kernels(kernels, n, busy_ms, top=8, tag=f'[{tag}] ')
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--precision', choices=('f32', 'bf16'), default='f32')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_serve needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = args.precision
    smi = card_line()
    print(f'card: {smi} [{tag}]', flush=True)
    params = dict(load_config('charades_cd_i3d.yml'), precision=tag)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        state = build_model(params, 'gmd', device='cpu').state_dict()
    rng = np.random.RandomState(0)
    Q, N, D = args.batch * BATCHES, params['sent_len'], \
        params['video_feature_dim']
    emb = rng.uniform(-1, 1, (VOCAB_WORDS, 300)).astype(np.float32)
    tokens = rng.randint(1, VOCAB_WORDS, (Q, N)).astype(np.int32)
    feats = emb[tokens]
    out = {}
    grounders = {}
    for ship in ('f32', 'f16'):
        g = MultiQueryGrounder(dict(params, serve_query_dtype=ship), state,
                               query_batch=args.batch)
        video = rng.randn(VIDEO_LEN, D).astype(np.float32)
        setup = _timed(lambda: g.set_video(video))
        g.set_vocab(emb)
        grounders[ship] = (g, setup)
    video_modes = {
        'video_f32': ('f32', lambda g: g.ground(None, feats)),
        'video_f16': ('f16', lambda g: g.ground(None, feats)),
        'video_tokens': ('f32', lambda g: g.ground_tokens_video(tokens)),
        'video_topk': ('f32', lambda g: g.ground_topk(feats, k=TOPK)),
    }
    for name, (ship, fn) in video_modes.items():
        g, setup = grounders[ship]
        out[name] = measure(name, lambda: fn(g), Q, args.batch, setup,
                            bank_nbytes(g._resident_rnn0), tag)
    grounders.clear()
    with tempfile.TemporaryDirectory(prefix='svtsg_serve_') as root:
        pack = PackedFeatureSource(write_pack(root, CORPUS_VIDEOS, 128, D))
        g = MultiQueryGrounder(params, state, query_batch=args.batch)
        g.set_vocab(emb)
        ids = rng.randint(0, CORPUS_VIDEOS, Q).astype(np.int32)
        for tier in ('raw', 'int8'):
            g._resident_bank = None
            torch.cuda.empty_cache()
            setup = _timed(lambda: g.set_corpus(
                pack, chunk_videos=CORPUS_CHUNK, dtype=tier))
            out[f'corpus_{tier}'] = measure(
                f'corpus_{tier}', lambda: g.ground_tokens(tokens, ids), Q,
                args.batch, setup, bank_nbytes(g._resident_bank), tag)
        pack.close()
    print(json.dumps({'card': smi, 'precision': tag, 'batch': args.batch,
                      'batches': BATCHES,
                      'video_len': VIDEO_LEN, 'videos': CORPUS_VIDEOS,
                      'chunk': CORPUS_CHUNK, 'topk': TOPK, 'modes': out}))


if __name__ == '__main__':
    main()
