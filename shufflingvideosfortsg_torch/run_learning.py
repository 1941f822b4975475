"""The learning and debiasing experiment through the port's own drivers.

The port's counterpart of ``tools/run_learning.py`` (the protocol of
``LEARNING.json``): build a signal-bearing, temporally biased corpus
(``tools/make_signal_corpus.py``, run as a subprocess: it imports numpy
alone), train GMD and the QAVE baseline through ``cli.main_train`` and
``cli.main_train_baseline``, evaluate each final-epoch checkpoint through
``cli.main_test`` / ``cli.main_test_baseline`` on ``val``, the iid split
and the position-shifted ood split, read each driver's own
``<submit>.metrics.json`` (nothing is scored again here), measure chance
as a fresh-init GMD through the same test driver, and write
``learning.json`` in ``LEARNING.json``'s results schema, with the card's
name and power limit and each phase's wall time::

    python -m shufflingvideosfortsg_torch.run_learning --out <dir> \\
        [--seed 1 --bias-frac 0.5 --ood-frac 0.35 --signal 1.0]

The defaults are the CD-like main experiment at full width (T=128,
D=1024, 24 epochs, ``cfgs/charades_cd_i3d.yml``'s model, the resident
bank and graphed chunks); ``--seed 0 --bias-frac 0.25 --ood-frac 0.6
--signal 0.5`` is the disjoint stress variant; ``--multi-seed S`` trains
S seeds a model in one run each and reports the paired GMD - QAVE margins
on the ood split as mean and sample std. ``--smoke`` is the tiny corpus
and model of ``tools/run_learning.py`` (``--device cpu`` runs it here);
``--split-sizes`` cuts the corpus.

The vocabulary: ``--words-dir``, or by default one written from the seed
under ``<out>/data/Charades/words`` (``data/vocab.write_synthetic_vocab``),
the place the config's ``../data/Charades/words`` resolves to with
``data_root`` ``<out>/data``. Runs on the CUDA card unless ``--device
cpu``; without a card the default raises before any work.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGNAL_CORPUS = os.path.join(REPO, 'tools', 'make_signal_corpus.py')

SMOKE_CORPUS = dict(t=32, d=64, concepts=12, word_pool=40, train=256,
                    val=64, iid=64, ood=64, len_min=4, len_max=10)
SMOKE_MODEL = dict(video_len=32, video_feature_dim=64, sent_len=15,
                   sent_rnn_hiddendim=32, video_rnn_hiddendim=32,
                   mlp_hidden_dim=32, span_hidden_dim=16, m_pred_hidden=32,
                   batch_size=[64, 64, 64])
VOCAB_WORDS = 400  # make_signal_corpus.py's --word-pool is 200 by default


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', required=True,
                    help='fresh workdir (corpus/, runs/, learning.json)')
    ap.add_argument('--seed', type=int, default=1,
                    help='corpus generator seed (independent draw per seed)')
    ap.add_argument('--signal', type=float, default=1.0)
    ap.add_argument('--bias-frac', type=float, default=0.5)
    ap.add_argument('--ood-frac', type=float, default=0.35)
    ap.add_argument('--epochs', type=int, default=24)
    ap.add_argument('--t', type=int, default=128,
                    help='video_len for corpus AND model (240 = ANet dims)')
    ap.add_argument('--sent-len', type=int, default=15,
                    help='model sent_len (25 = ANet dims)')
    ap.add_argument('--lr-step', type=int, nargs='*', default=None,
                    help='override lr decay epochs (anet_cd_i3d.yml: 15)')
    ap.add_argument('--lambda-kl', type=float, default=None,
                    help='override lambda_KL')
    ap.add_argument('--lambda-pseudo-ground', type=float, default=None,
                    help='add a 5th loss term: lambda * span grounding '
                         'NLL on the pseudo stream\'s translated labels')
    ap.add_argument('--lambda-disc', type=float, default=None,
                    help='override lambda_disc')
    ap.add_argument('--multi-seed', type=int, default=0,
                    help='S>1: train S seeds per model in one run and '
                         'report paired ood margins with mean and std')
    ap.add_argument('--models', default='gmd,qave,chance',
                    help='comma subset of gmd,qave,chance')
    ap.add_argument('--smoke', action='store_true',
                    help='tiny corpus + tiny model dims (the whole '
                         'orchestration at a size the CPU takes)')
    ap.add_argument('--split-sizes', type=int, nargs=4, default=None,
                    metavar=('TRAIN', 'VAL', 'IID', 'OOD'),
                    help='videos in each split of the corpus (default: '
                         'the generator\'s 6000 800 800 2000, or the '
                         'smoke corpus\'s)')
    ap.add_argument('--words-dir', default=None,
                    help='vocabulary directory (wordtoix.npy, '
                         'ixtoword.npy, word_glove_fts_init.npy); default '
                         'a synthetic one written under <out>/data')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.smoke:
        args.t = SMOKE_CORPUS['t']
    return args


def default_words_dir(out: str) -> str:
    return os.path.join(out, 'data', 'Charades', 'words')


def corpus_args(a) -> Dict[str, Any]:
    """The generator flags this invocation asks for, keyed as
    make_signal_corpus.py stores them in meta.json['args']."""
    want = dict(seed=a.seed, signal=a.signal, bias_frac=a.bias_frac,
                ood_frac=a.ood_frac, t=a.t, words_dir=a.words_dir)
    if a.smoke:
        want.update(SMOKE_CORPUS)
    if a.split_sizes:
        want.update(zip(('train', 'val', 'iid', 'ood'), a.split_sizes))
    return want


def build_corpus(out: str, a) -> str:
    """The corpus under ``<out>/corpus``: made by the generator, or, if
    there, checked to have been made with the same arguments."""
    corpus = os.path.join(out, 'corpus')
    meta_path = os.path.join(corpus, 'meta.json')
    want = corpus_args(a)
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            got = json.load(f).get('args', {})
        stale = {k: (got.get(k), v) for k, v in want.items()
                 if got.get(k) != v}
        if stale:
            sys.exit(f'[run_learning] corpus {corpus} exists but was '
                     f'generated with different parameters '
                     f'{{k: (have, want)}} = {stale}; delete it or pick '
                     f'a fresh --out')
        print(f'[run_learning] corpus exists (parameters match): {corpus}')
        return corpus
    cmd = [sys.executable, SIGNAL_CORPUS, '--out', corpus]
    for k, v in want.items():
        cmd += [f'--{k.replace("_", "-")}', str(v)]
    print('[run_learning]', ' '.join(cmd), flush=True)
    subprocess.run(cmd, check=True)
    return corpus


def corpus_params(corpus: str, out: str, alias: str, a,
                  **over) -> Dict[str, Any]:
    """``charades_cd_i3d.yml`` re-pointed at the synthetic corpus and its
    vocabulary, on ``a.device``."""
    from .config import load_config

    def anno(split):
        return os.path.join(corpus, 'annotations', f'charades_{split}.json')

    pack = os.path.join(corpus, 'pack')
    overrides = dict(
        train_data=anno('train'), val_data=anno('val'),
        test_data=anno('test_ood'),
        train_featpath=pack, valid_featpath=pack, test_featpath=pack,
        epoch=a.epochs, alias=alias, runs=os.path.join(out, 'runs'),
        start_from=None, batch_log_interval=-1,
        video_len=a.t, sent_len=a.sent_len, device=a.device,
        # only the final checkpoint is evaluated (eval_split, through the
        # test drivers): no per-epoch validation or checkpoint
        test_interval=a.epochs, save_model_interval=a.epochs)
    if os.path.abspath(a.words_dir) != default_words_dir(out):
        overrides.update({
            f'{name}_path': os.path.join(a.words_dir, f'{file}.npy')
            for name, file in (('wordtoix', 'wordtoix'),
                               ('ixtoword', 'ixtoword'),
                               ('word_fts', 'word_glove_fts_init'))})
    if a.lr_step:
        overrides['lr_step'] = list(a.lr_step)
    if a.lambda_kl is not None:
        overrides['loss_m2_lambda'] = a.lambda_kl
    if a.lambda_disc is not None:
        overrides['loss_disc_lambda'] = a.lambda_disc
    if a.lambda_pseudo_ground is not None:
        overrides['loss_pseudo_ground_lambda'] = a.lambda_pseudo_ground
    if a.smoke:
        overrides.update(SMOKE_MODEL)
    overrides.update(over)
    return load_config(os.path.join(REPO, 'cfgs', 'charades_cd_i3d.yml'),
                       overrides=overrides,
                       data_root=os.path.join(out, 'data'))


def eval_split(corpus: str, out: str, a, kind: str, split: str,
               start_from: Optional[str]) -> Dict[str, Any]:
    """The test driver on one split; the metrics the driver itself scored
    (``<submit>.metrics.json``)."""
    from . import cli
    tag = (os.path.basename(start_from).replace('.ckp', '')
           if start_from else 'fresh')
    params = corpus_params(
        corpus, out, f'test_{kind}_{split}_{tag}', a,
        test_data=os.path.join(corpus, 'annotations',
                               f'charades_{split}.json'),
        start_from=start_from)
    main = cli.main_test if kind == 'gmd' else cli.main_test_baseline
    submit = main(params)
    with open(submit + '.metrics.json') as f:
        return json.load(f)


def final_ckpt(out: str, alias: str, a, seed_idx: Optional[int] = None
               ) -> str:
    """The final-epoch checkpoint; refuses a partial run (a crashed run
    dir would otherwise be reused at an intermediate epoch)."""
    model_dir = os.path.join(out, 'runs', alias, 'model')
    suffix = '' if seed_idx is None else f'_s{seed_idx}'
    path = os.path.join(model_dir, f'{alias}_{a.epochs - 1:05d}{suffix}.ckp')
    if not os.path.isfile(path):
        have = sorted(os.path.basename(p)
                      for p in glob.glob(os.path.join(model_dir, '*.ckp')))
        sys.exit(f'[run_learning] final-epoch checkpoint missing: {path}\n'
                 f'  run dir holds {have or "nothing"} - a partial/crashed '
                 f'run; delete {os.path.dirname(model_dir)} to retrain')
    return path


def row(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return dict(mIoU=metrics['mIoU'],
                r1=[metrics[k] for k in sorted(metrics)
                    if k.startswith('R1@')])


def mean_std(xs: List[float]):
    m = sum(xs) / len(xs)
    var = (sum((x - m) ** 2 for x in xs) / (len(xs) - 1)
           if len(xs) > 1 else 0.0)
    return round(m, 3), round(math.sqrt(var), 3)


def train_model(corpus: str, out: str, a, kind: str, trainer,
                timing: Dict[str, float]) -> Dict[str, Any]:
    """Train (or reuse) one model; return its results block. ``timing``
    receives the training's and the evaluations' wall seconds."""
    alias = f'{kind}_s{a.seed}'
    run_dir = os.path.join(out, 'runs', alias)
    S = a.multi_seed
    t0 = time.time()
    if os.path.isdir(run_dir):
        print(f'[run_learning] reusing run dir {run_dir} (checkpoint '
              f'completeness checked below)')
    else:
        trainer(corpus_params(corpus, out, alias, a,
                              multi_seed=(S if S > 1 else 0)))
    timing[f'{kind}_train_s'] = round(time.time() - t0, 3)
    t0 = time.time()
    if S <= 1:
        ckpt = final_ckpt(out, alias, a)
        iid = eval_split(corpus, out, a, kind, 'test_iid', ckpt)
        ood = eval_split(corpus, out, a, kind, 'test_ood', ckpt)
        val = eval_split(corpus, out, a, kind, 'val', ckpt)
        timing[f'{kind}_eval_s'] = round(time.time() - t0, 3)
        return dict(val=val['mIoU'], test_iid=iid['mIoU'],
                    test_ood=ood['mIoU'], r1_ood=row(ood)['r1'],
                    ckpt_epoch=a.epochs - 1)
    per_seed = []
    for i in range(S):
        ckpt = final_ckpt(out, alias, a, seed_idx=i)
        iid = eval_split(corpus, out, a, kind, 'test_iid', ckpt)
        ood = eval_split(corpus, out, a, kind, 'test_ood', ckpt)
        per_seed.append(dict(train_seed=i, test_iid=iid['mIoU'],
                             test_ood=ood['mIoU']))
        print(f'[run_learning] {kind} seed {i}: {json.dumps(per_seed[-1])}')
    timing[f'{kind}_eval_s'] = round(time.time() - t0, 3)
    iid_m, iid_s = mean_std([p['test_iid'] for p in per_seed])
    ood_m, ood_s = mean_std([p['test_ood'] for p in per_seed])
    return dict(per_seed=per_seed, test_iid_mean=iid_m, test_iid_std=iid_s,
                test_ood_mean=ood_m, test_ood_std=ood_s,
                ckpt_epoch=a.epochs - 1)


def device_block(device: str) -> Dict[str, Any]:
    """The device the run used: on a card its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them."""
    if not device.startswith('cuda'):
        return {'platform': 'cpu'}
    import torch
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(index),
            'nvidia_smi': smi[index] if index < len(smi) else smi[0]}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.device.startswith('cuda'):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError('--device cuda needs an NVIDIA GPU; pass '
                               '--device cpu to run on the CPU')
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    t_start = time.time()
    if args.words_dir is None:
        from .data.vocab import write_synthetic_vocab
        args.words_dir = default_words_dir(out)
        if not os.path.isfile(os.path.join(args.words_dir, 'wordtoix.npy')):
            write_synthetic_vocab(args.words_dir, VOCAB_WORDS, args.seed)
    args.words_dir = os.path.abspath(args.words_dir)
    timing: Dict[str, float] = {}
    t0 = time.time()
    corpus = build_corpus(out, args)
    timing['corpus_s'] = round(time.time() - t0, 3)
    models = args.models.split(',')

    from . import cli

    results: Dict[str, Any] = {}
    for kind, trainer in (('gmd', cli.main_train),
                          ('qave', cli.main_train_baseline)):
        if kind in models:
            results[kind] = train_model(corpus, out, args, kind, trainer,
                                        timing)
            print(f'[run_learning] {kind}: {json.dumps(results[kind])}')
    if 'chance' in models:
        t0 = time.time()
        ood = eval_split(corpus, out, args, 'gmd', 'test_ood', None)
        timing['chance_s'] = round(time.time() - t0, 3)
        results['chance'] = dict(test_ood=ood['mIoU'])
        print(f'[run_learning] chance: {json.dumps(results["chance"])}')

    if args.multi_seed > 1 and 'gmd' in results and 'qave' in results:
        margins = [round(g['test_ood'] - q['test_ood'], 3)
                   for g, q in zip(results['gmd']['per_seed'],
                                   results['qave']['per_seed'])]
        m, s = mean_std(margins)
        results['paired_ood_margins'] = dict(
            per_seed=margins, mean=m, std=s,
            positive=sum(x > 0 for x in margins), n=len(margins))
        print(f'[run_learning] paired ood margins (gmd-qave): '
              f'{json.dumps(results["paired_ood_margins"])}')
    timing['total_s'] = round(time.time() - t_start, 3)

    block = dict(
        corpus=dict(seed=args.seed, signal=args.signal,
                    bias_frac=args.bias_frac, ood_frac=args.ood_frac,
                    epochs=args.epochs, t=args.t, sent_len=args.sent_len,
                    lr_step=args.lr_step, multi_seed=args.multi_seed,
                    lambda_kl=args.lambda_kl, lambda_disc=args.lambda_disc,
                    lambda_pseudo_ground=args.lambda_pseudo_ground,
                    split_sizes=args.split_sizes, smoke=args.smoke,
                    vocabulary=args.words_dir),
        results=results, device=device_block(args.device), timing=timing)
    path = os.path.join(out, 'learning.json')
    with open(path, 'w') as f:
        json.dump(block, f, indent=1)
    print(f'[run_learning] wrote {path}')
    print(json.dumps(block))
    return block


if __name__ == '__main__':
    main()
