"""BENCHMARK.json against the benchmark's contract, the files it names,
the result line's schema and the import rule (by whole top-level name)."""

import json
import os
import re
import subprocess
import sys

import pytest

from harness import common

BENCH = common.load_json(common.ROOT, 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_manifest_keys_and_names():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'port_bench/run.py']
    assert BENCH['paths'] == ['port_bench']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_and_cells_have_their_files():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        cfg = common.load_json(common.ROOT, c['file'])
        assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
    fours = 0
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert len(w['why']) <= 200 and w['chips'] in (1, 4)
        fours += w['chips'] == 4
        cell = common.Cell.load(w['name'])
        assert cell.mix['kind'] in ('train', 'eval', 'serve')
        assert cell.limits['numbers']
        e2e = [m['name'] for m in cell.end_to_end]
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert cell.per_layer
    assert fours <= max(1, len(BENCH['workloads']) // 4)
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


def test_metrics_match_their_reader_files():
    import run
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['end_to_end']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert e2e['setup_s']['bound'] == 0.25
    layers = {}
    for m in BENCH['per_layer']:
        reader = run.load_metric(m['name'])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == \
            (m['unit'], m['layer'], m['moves'], m['source'])
        layers.setdefault(m['layer'], set()).add(m['name'])
        for w in m['workloads']:
            moved = e2e[m['moves']]
            assert w in moved.get('workloads', [w])


def test_forbidden_modules_by_whole_top_level_name():
    names = ['shufflingvideosfortsg_torch', 'shufflingvideosfortsg_torch.ops',
             'jaxtyping', 'flaxen', 'optax_like', 'numpy']
    assert common.forbidden_modules(names) == []
    bad = names + ['jax.numpy', 'jaxlib', 'shufflingvideosfortsg_tpu.models',
                   'flax', 'optax']
    assert common.forbidden_modules(bad) == [
        'flax', 'jax.numpy', 'jaxlib', 'optax',
        'shufflingvideosfortsg_tpu.models']


def _sources():
    for root, _, files in os.walk(common.BENCH):
        for f in files:
            path = os.path.join(root, f)
            # this file holds the patterns themselves
            if f.endswith('.py') and '_cache' not in root and \
                    path != os.path.abspath(__file__):
                yield path


def test_no_source_imports_jax_or_reads_the_jax_benchmark():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|optax|'
                         r'shufflingvideosfortsg_tpu)\b', re.M)
    reads = re.compile(r"bench\.py|BENCH_|'tools/|\"tools/|tools\.bench")
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert not pattern.search(text), path
        assert not reads.search(text), path


def test_a_run_loads_no_jax():
    """A tiny training cell run through the harness, in a fresh process,
    leaves no module of JAX or of the JAX package in ``sys.modules``."""
    code = (
        'import sys, torch\n'
        f'sys.path[:0] = {[common.BENCH, common.ROOT]!r}\n'
        'from conftest import TINY, SEED\n'
        'from harness import common, train\n'
        "cell = common.Cell({'name': 't', 'chips': 1}, TINY, "
        "{'kind': 'train'}, {'numbers': {}})\n"
        "train.run_cell(cell, common.Run(SEED, 0.5, False, "
        "torch.device('cpu')))\n"
        'print(common.forbidden_modules())\n')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.path.dirname(__file__)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_result_line_schema(monkeypatch):
    import torch
    import run
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda *a: 'NVIDIA H100 80GB HBM3')
    cell = common.Cell.load('anet_cd_i3d.eval')
    r = common.Run(1, 10.0, False, 'cpu')
    r.start, r.window_wall = 100.0, 130.5
    r.metrics['eval_sentences_per_s'] = 6000.0
    r.attempted, r.memory_peak = 60000, 123
    r.ctx['numbers'] = {'loss_gap': 1e-7, 'score_gap': 1e-7,
                        'span_gap': 0.0}
    out = run.result(cell, r, 1, 'card')
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'checks']
    assert out['correct'] is True
    assert out['metrics']['setup_s'] == {'value': 30.5, 'unit': 's'}
    assert out['device']['platform'] == 'gpu' and out['device']['count'] == 1
    assert set(out['checks']) == set(cell.limits['numbers'])
    r.ctx['numbers']['score_gap'] = float('nan')
    out = run.result(cell, r, 1, 'card')
    assert out['correct'] is False and out['checks']['score_gap']['value'] == 'nan'
    json.loads(json.dumps(out))


def test_no_cuda_no_result(capsys):
    import torch
    import run
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    assert run.main(['--workload', 'anet_cd_i3d.eval', '--seed', '1',
                     '--seconds', '1', '--trace', '0']) != 0
    assert capsys.readouterr().out == ''
