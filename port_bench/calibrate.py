"""The readings that a cell's correctness limits are set from.

    python3 port_bench/calibrate.py --workload <name> --seeds <n> [--first <seed>]
        [--control <m>] [--seconds <s>] [--out <file>]

On the card, in one process, at the cell's own sizes:

- ``program``: the numbers of sound runs of the cell (its driver, a short
  window of ``--seconds``) on ``--seeds`` seeds;
- ``control``: the plain reference computed with TF32 products (the
  nearest precision below the configuration's f32) against the f32
  reference, on ``--control`` seeds: training's first three steps, or the
  answers of the batches (requests) a run checks;
- ``fault_half`` (training): the reference on half of each batch,
  meaned over it, against the whole batch; and, for a cell on P chips,
  ``fault_exchange``: rank 0's rows alone (no all-reduce) against the
  global batch. A state left unchanged reads 1 and needs no run.

Prints one JSON line, also written to ``--out``. The benchmark's runs do
not run this; the limits in ``limits/<workload>.json`` name the readings
they were set from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import (check, common, evaluate, reference, seeded,  # noqa: E402
                     traffic)
from harness import train as train_cell  # noqa: E402

SEED0 = 2 ** 31 + 1000


def program_reading(cell, seed: int, seconds: float, device) -> dict:
    import importlib
    driver = importlib.import_module(
        {'train': 'harness.train', 'eval': 'harness.evaluate',
         'serve': 'harness.serve'}[cell.mix['kind']])
    run = common.Run(seed, seconds, False, device)
    driver.run_cell(cell, run)
    common.free(device)
    return run.ctx['numbers']


def _cfg(params) -> dict:
    return evaluate._ref_cfg(params)


def train_control(cell, seed: int, device, rows_of=None) -> dict:
    """Numbers of the TF32 reference (or, with ``rows_of``, of the f32
    reference on a subset of each batch's rows) against the f32 reference."""
    params = common.port_params(cell.config)
    T, D = params['video_len'], params['video_feature_dim']
    B = int(params['batch_size'][0])
    corpus = traffic.build_corpus(cell.config, common.ROOT)
    words = seeded.words(seed, corpus.vocab_size,
                         params['sent_embedding_dim'], device)
    w0 = seeded.weights(common.shapes(params), seed, device)
    batches = train_cell._reference_batches(corpus, words, seed, T, D, B,
                                            device)
    lr, wd = float(params['lr']), float(params['weight_decay'])

    def steps(tf32, bs):
        with reference.precision(tf32):
            return reference.train_steps(
                w0, _cfg(params), bs, seeded.generator(seed, 'train', 0,
                                                       device), lr, wd)
    ref = steps(False, batches)
    if rows_of is None:
        got = steps(True, batches)
    else:
        got = steps(False, [{k: v[rows_of(B)] for k, v in b.items()}
                            for b in batches])
    return check.train_numbers(got[0], ref[0], got[1], ref[1], ref[2],
                               got[3], ref[3], got[4], ref[4])


def answers_control(cell, seed: int, device) -> dict:
    """The TF32 reference's answers against the f32 reference's, on the
    pairs a run of the cell checks (batches of the eval epoch, or
    requests of the serve mix, drawn as the run draws them)."""
    params = common.port_params(cell.config)
    T, D = params['video_len'], params['video_feature_dim']
    corpus = traffic.build_corpus(cell.config, common.ROOT)
    words = seeded.words(seed, corpus.vocab_size,
                         params['sent_embedding_dim'], device)
    w = seeded.weights(common.shapes(params), seed, device)
    rng = np.random.RandomState(seed % 2 ** 32)
    if cell.mix['kind'] == 'eval':
        B = int(params['batch_size'][0])
        picked = rng.choice(-(-corpus.num_pairs // B),
                            int(cell.mix['checked_batches']), replace=False)
        rows = np.concatenate([np.arange(i * B, (i + 1) * B)
                               % corpus.num_pairs for i in picked])
        cat = traffic.index_batch(corpus, rows, T)
    else:
        n = int(cell.mix['checked_requests'])
        cat = {'pack_row': rng.randint(0, corpus.num_videos, n),
               'token_ids': corpus.token_ids[rng.randint(
                   0, corpus.num_pairs, n)]}
    model = reference.Model(w, _cfg(params))
    out = {}
    for tf32 in (False, True):
        with reference.precision(tf32), torch.no_grad():
            out[tf32] = evaluate.ground(model, cat, words, corpus.nfeats,
                                        seed, T, D, device)
    st, en = out[True]
    spans, scores = reference.decode(st, en)
    numbers = check.answer_numbers(spans.cpu().numpy(),
                                   scores.cpu().numpy(), *out[False])
    if cell.mix['kind'] == 'eval':
        se = torch.as_tensor(cat['framestps'], device=device)
        a = reference.nll(*out[True], se).view(-1, B).mean(1)
        b = reference.nll(*out[False], se).view(-1, B).mean(1)
        numbers['loss_gap'] = float(((a - b).abs() / b.abs()).max())
    return numbers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--first', type=int, default=SEED0)
    ap.add_argument('--control', type=int, default=3)
    ap.add_argument('--seconds', type=float, default=1.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('calibrate needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    cell = common.Cell.load(args.workload)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    out = {'workload': args.workload, 'card': torch.cuda.get_device_name(0),
           'program': {}, 'control': {}}
    t0 = time.time()
    for s in seeds:
        out['program'][s] = program_reading(cell, s, args.seconds, device)
        print(s, out['program'][s], f'{time.time() - t0:.1f}s', flush=True)
    for s in [args.first + 7919 * i for i in range(args.control)]:
        if cell.mix['kind'] == 'train':
            out['control'][s] = train_control(cell, s, device)
            out.setdefault('fault_half', {})[s] = train_control(
                cell, s, device, rows_of=lambda B: slice(0, B // 2))
            if int(cell.workload['chips']) > 1:
                P = int(cell.workload['chips'])
                out.setdefault('fault_exchange', {})[s] = train_control(
                    cell, s, device, rows_of=lambda B: slice(0, B, P))
        else:
            out['control'][s] = answers_control(cell, s, device)
        common.free(device)
        print(s, 'control', out['control'][s], f'{time.time() - t0:.1f}s',
              flush=True)
    for part in ('program', 'control', 'fault_half', 'fault_exchange'):
        if out.get(part):
            names = next(iter(out[part].values())).keys()
            out[part + '_max'] = {k: max(v[k] for v in out[part].values())
                                  for k in names}
            out[part + '_min'] = {k: min(v[k] for v in out[part].values())
                                  for k in names}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')


if __name__ == '__main__':
    main()
