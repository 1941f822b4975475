"""One run of one cell of the PyTorch/CUDA port's benchmark.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``port_bench/configs/``), a
traffic mix (``port_bench/traffic/<mix>.json``, whose ``kind`` picks the
driver: ``train``, ``eval`` or ``serve``) and its chips; its correctness
limits are ``port_bench/limits/<workload>.json`` and its per-layer
metrics ``port_bench/metrics/<metric>.py``. The run makes its inputs and
weights from ``--seed``, sets up and warms up (``setup_s``), measures for
``--seconds``, checks the timed path's results against the plain
reference (``harness/reference.py``) and prints one JSON line last on
standard output. With ``--trace 1`` the metrics are the cell's per-layer
ones, read from a ``torch.profiler`` window of the run. A cell on P
chips runs P ranks of one NCCL process group on this machine: this
process is rank 0 and starts the others.

Exits non-zero, with no result, without enough CUDA devices, or when a
module of JAX or of the JAX package is loaded once the window has
closed. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import importlib.util
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '_cache')
os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                      os.path.join(CACHE, 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(CACHE, 'triton'))
sys.path[:0] = [HERE, ROOT]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--rank', type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument('--port', type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """A rank started by rank 0 is killed when rank 0 dies."""
    ctypes.CDLL('libc.so.6', use_errno=True).prctl(1, signal.SIGKILL)


def _spawn(args, world: int, port: int):
    """Ranks 1..world-1: this script again, their output dropped (only
    rank 0 prints a result), their errors on this one's standard error."""
    base = [sys.executable, os.path.abspath(__file__),
            '--workload', args.workload, '--seed', str(args.seed),
            '--seconds', str(args.seconds), '--trace', str(args.trace),
            '--port', str(port)]
    return [subprocess.Popen(base + ['--rank', str(r)],
                             stdout=subprocess.DEVNULL,
                             preexec_fn=_die_with_parent)
            for r in range(1, world)]


def _stop(children, timeout: float = 120.0) -> None:
    deadline = time.time() + timeout
    for p in children:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        'port_bench_metric_' + name.replace('.', '_'),
        os.path.join(HERE, 'metrics', name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi unreadable'


DRIVERS = {'train': 'harness.train', 'eval': 'harness.evaluate',
           'serve': 'harness.serve'}


def run_rank(cell, args, world: int, device):
    """Sets up this rank (its card, the process group), runs the cell's
    driver and gathers what every rank measured onto rank 0."""
    import torch
    from harness import common
    run = common.Run(args.seed, args.seconds, bool(args.trace), device,
                     args.rank, world)
    if world > 1:
        import torch.distributed as dist
        from shufflingvideosfortsg_torch.parallel.mesh import create_mesh
        dist.init_process_group(
            'nccl', init_method=f'tcp://127.0.0.1:{args.port}',
            rank=args.rank, world_size=world, device_id=device,
            timeout=datetime.timedelta(seconds=240))
        run.mesh = create_mesh(device=str(device))
    try:
        driver = importlib.import_module(DRIVERS[cell.mix['kind']])
        driver.run_cell(cell, run)
        if world > 1:
            mine = {'memory_peak': run.memory_peak,
                    'trace': run.ctx.get('trace')}
            every = [None] * world
            dist.all_gather_object(every, mine)
            run.memory_peak = max(e['memory_peak'] for e in every)
            if run.trace:
                run.ctx['traces'] = [e['trace'] for e in every]
    finally:
        if world > 1:
            common.free(device)
            dist.destroy_process_group()
    return run


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def result(cell, run, chips: int, card: str):
    """The result line's object; ``checks`` comes last."""
    import numpy as np
    import torch
    from harness import check
    correct, checks = check.judge(run.ctx.get('numbers', {}), cell.limits)
    metrics = {}
    if run.trace:
        ctx = dict(run.ctx, chips=chips)
        for m in cell.per_layer:
            value = load_metric(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = {'value': float(value),
                                      'unit': m['unit']}
    else:
        for m in cell.end_to_end:
            value = (run.window_wall - run.start if m['name'] == 'setup_s'
                     else run.metrics[m['name']])
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': chips, 'memory_peak_bytes': run.memory_peak,
              'card': card}
    out = {'correct': bool(correct), 'attempted': int(run.attempted),
           'failed': int(run.failed), 'metrics': metrics, 'device': device}
    if run.trace:
        traces = run.ctx.get('traces', [run.ctx['trace']])
        device['busy_s'] = float(np.mean([t['busy_s'] for t in traces]))
        device['window_s'] = float(run.ctx['trace']['window_s'])
        out['breakdown'] = {'device_ops': run.ctx['trace']['device_ops'],
                            'idle_gaps': run.ctx['trace']['idle_gaps']}
    out['checks'] = {k: {'value': _number(v['value']), 'limit': v['limit']}
                     for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from harness import common
    cell = common.Cell.load(args.workload)
    chips = int(cell.workload['chips'])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); this machine '
              f'has {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', args.rank)
    torch.cuda.set_device(device)
    children = []
    if chips > 1 and args.rank == 0:
        args.port = _free_port()
        children = _spawn(args, chips, args.port)
    try:
        run = run_rank(cell, args, chips, device)
    except BaseException:
        traceback.print_exc()
        for p in children:
            p.kill()
        _stop(children)
        return 1
    _stop(children)
    if any(p.returncode for p in children):
        print(f'ranks exited with {[p.returncode for p in children]}',
              file=sys.stderr)
        return 1
    found = common.forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        return 3
    if args.rank != 0:
        return 0
    out = result(cell, run, chips, card_line())
    notes = {'window_s': run.window_s, 'setup_s': run.window_wall - run.start,
             **{k: v for k, v in run.ctx.items() if k.startswith('note_')}}
    print(json.dumps(out), flush=True)
    print('notes ' + json.dumps(notes), file=sys.stderr)
    for name, c in out['checks'].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
