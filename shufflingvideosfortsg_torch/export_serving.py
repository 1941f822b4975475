"""Build an AOT serving artifact from a checkpoint: the deployable form of
the multi-query grounding service (the port of ``tools/export_serving.py``).

    python -m shufflingvideosfortsg_torch.export_serving \\
        --cfg charades_cd_i3d.yml --ckpt runs/<alias>/model/<alias>_00029.ckp \\
        --out /tmp/gmd_artifact [--video_len 1024] [--query_batch 256] \\
        [--platforms cpu,cuda] [--vocab word_glove_fts_init.npy] \\
        [--corpus <pack dir> --bank_dtype raw|int8] [--precision bf16] \\
        [--device cuda]

``--cfg`` is a config yml or the run's ``params.json`` (its exact
dimensions); ``--ckpt`` a reference ``.ckp`` (the port's trainers write
them; ``tools/export_reference_ckp.py`` turns a JAX msgpack checkpoint
into one). The grounder is built on ``--device`` (``cuda`` by default: a
missing card raises), and one program a serving function is exported for
each of ``--platforms`` (default: ``--device``); a ``cuda`` program needs
a card. ``utils/aot.load_grounder_artifact`` serves the directory.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from .config import load_config
from .serving import MultiQueryGrounder
from .utils.aot import export_grounder
from .utils.interop import load_reference_ckp


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg', required=True,
                    help="config yml, or the run's params.json (exact "
                         'trained dims, recommended)')
    ap.add_argument('--ckpt', required=True, help='a reference .ckp')
    ap.add_argument('--out', required=True)
    ap.add_argument('--video_len', type=int, default=None,
                    help='resident video length T (default: cfg video_len)')
    ap.add_argument('--query_batch', type=int, default=256)
    ap.add_argument('--platforms', type=str, default=None,
                    help='comma-separated devices to export a program for, '
                         'of cpu,cuda (default: --device)')
    ap.add_argument('--vocab', type=str, default=None,
                    help='GloVe matrix .npy to bundle for token-id serving '
                         '(default: cfg word_fts_path if readable)')
    ap.add_argument('--corpus', type=str, default=None,
                    help='featpack dir: pin the whole corpus bank and '
                         'export the (query, vid) serving tier too')
    ap.add_argument('--bank_dtype', type=str, default='raw',
                    choices=['raw', 'int8'])
    ap.add_argument('--precision', type=str, default=None,
                    choices=['f32', 'bf16'],
                    help='compute dtype (default: the config\'s)')
    ap.add_argument('--device', type=str, default='cuda')
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.cfg.endswith('.json'):
        with open(args.cfg) as f:
            params = json.load(f)
    else:
        params = load_config(args.cfg,
                             data_root=os.environ.get('SVTSG_DATA_ROOT'))
    if args.precision:
        params['precision'] = args.precision
    state = load_reference_ckp(args.ckpt)
    print(f'checkpoint: {args.ckpt} ({len(state)} tensors)')
    g = MultiQueryGrounder(params, state, device=args.device,
                           query_batch=args.query_batch)
    T = args.video_len or int(params['video_len'])
    Dv = int(params['video_feature_dim'])
    # the resident video fixes the exported T; its contents are irrelevant
    g.set_video(np.zeros((T, Dv), np.float32))
    vocab = args.vocab or params.get('word_fts_path')
    if vocab and os.path.isfile(vocab):
        emb = np.load(vocab).astype(np.float32)
        g.set_vocab(emb)
        print(f'vocab: {vocab} {emb.shape}')
    else:
        print('no vocab bundled (feature-query serving only)')
    if args.corpus:
        from .data.featpack import PackedFeatureSource
        pack = PackedFeatureSource(args.corpus)
        g.set_corpus(pack, dtype=args.bank_dtype)
        print(f'corpus bank: {pack.num_videos} videos ({args.bank_dtype}) '
              f'from {args.corpus}')
    platforms = args.platforms.split(',') if args.platforms else None
    manifest = export_grounder(g, args.out, platforms=platforms)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(f'exported {manifest["functions"]} for T={manifest["video_len"]}, '
          f'Q={manifest["query_batch"]}, platforms={manifest["platforms"]}, '
          f'precision={manifest["precision"]} -> {args.out} '
          f'({size} bytes, {size / 2**20:.1f} MiB)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
