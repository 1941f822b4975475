"""The serving knee: the highest offered rate a serve cell's gateway
sustains, found once by a sweep on the card.

    python3 port_bench/sweep.py --workload anet_cd_i3d.serve --rates 4000 8000 ... [--seconds 6]

Sets the cell up once (as a run does), then offers each rate in turn for
``--seconds`` with the cell's mix (its arrival process and pool, at that
rate) and prints, a line a rate: the rate offered, the rate completed,
the p50 and p95 request times, the failed requests and the gateway's
mean batch. A rate is sustained when it completes what it is offered
within the window and its p95 stays within a few batch times; the knee
is the highest such rate, and the serve mix's ``rate_qps`` is 0.8 of it.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import common, serve, traffic  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', default='anet_cd_i3d.serve')
    ap.add_argument('--rates', type=float, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=6.0)
    ap.add_argument('--seed', type=int, default=2 ** 31 + 4242)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('sweep needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    cell = common.Cell.load(args.workload)
    run = common.Run(args.seed, args.seconds, False, device)
    params, corpus, words, w, g, gw = serve.setup(cell, run)
    rows = []
    for rate in args.rates:
        mix = dict(cell.mix, rate_qps=rate)
        plan = traffic.schedule(traffic.request_pool(corpus, mix,
                                                     args.seconds), args.seed)
        before = gw.stats()
        res = serve.serve_window(gw, corpus, plan, args.seconds)
        after = gw.stats()
        ok = ~res['failed']
        last = float(np.nanmax(np.where(ok, res['latency_s']
                                        + plan['due'], np.nan)))
        batches = after['batches'] - before['batches']
        row = {'offered_qps': rate, 'requests': int(len(ok)),
               'completed_qps': float(ok.sum() / max(last, args.seconds)),
               'p50_ms': float(np.percentile(res['latency_s'], 50) * 1e3),
               'p95_ms': float(np.percentile(res['latency_s'], 95) * 1e3),
               'failed': int((~ok).sum()),
               'mean_batch': float((after['mean_batch'] * after['batches']
                                    - before['mean_batch']
                                    * before['batches']) / max(batches, 1)),
               'sender_late_p99_ms': float(np.percentile(
                   res['sent_late_s'], 99) * 1e3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    gw.close()
    print(json.dumps({'workload': args.workload,
                      'card': torch.cuda.get_device_name(0), 'sweep': rows}))


if __name__ == '__main__':
    main()
