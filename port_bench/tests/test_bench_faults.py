"""Each fault a cell can have, planted in the timed path under a run of
the harness (its look for a card skipped, tiny widths on the CPU, the
cell's own limits): ``correct`` comes out false; the sound run true."""

import multiprocessing
import socket

import pytest
import torch

from conftest import SEED, TINY
from harness import check, common, evaluate, serve, train

MIXES = {'train': {'kind': 'train'},
         'eval': {'kind': 'eval', 'segment_batches': 4, 'checked_batches': 6},
         'serve': {'kind': 'serve', 'rate_qps': 3000.0,
                   'pool_seed': 0, 'query_batch': 16, 'pipeline_depth': 2,
                   'queue_capacity': 4096, 'warmup_batches': 2,
                   'checked_requests': 96}}
LIMITS = {'train': 'charades_cd_i3d.train', 'eval': 'anet_cd_i3d.eval',
          'serve': 'anet_cd_i3d.serve', 'train_dp': 'charades_cd_i3d.train_dp4'}
DRIVERS = {'train': train, 'eval': evaluate, 'serve': serve}
# the serve mix offers more than the CPU serves, so that the gateway's
# batches fill: a fault within a batch then meets distinct requests


def _correct(kind: str, seconds: float = 1.0) -> bool:
    limits = common.Cell.load(LIMITS[kind]).limits
    cell = common.Cell({'name': kind, 'chips': 1}, TINY, MIXES[kind], limits)
    run = common.Run(SEED, seconds, False, torch.device('cpu'))
    DRIVERS[kind].run_cell(cell, run)
    return check.judge(run.ctx['numbers'], limits)[0]


def _swap_rows(decode):
    def swapped(start, end):
        spans, scores = decode(start, end)
        return spans[[1, 0] + list(range(2, len(spans)))], \
            scores[[1, 0] + list(range(2, len(scores)))]
    return swapped


def _half_rows(decode):
    def halved(start, end):
        spans, scores = decode(start, end)
        h = len(spans) // 2
        return torch.cat([spans[:h], spans[:h]]), torch.cat([scores[:h],
                                                             scores[:h]])
    return halved


@pytest.mark.parametrize('kind', ['train', 'eval', 'serve'])
def test_sound_run_is_correct(kind):
    assert _correct(kind)


def test_train_state_left_unchanged(monkeypatch):
    from shufflingvideosfortsg_torch.train import state
    monkeypatch.setattr(state.TrainState, 'update', lambda self: None)
    assert not _correct('train')


def test_train_half_the_batch(monkeypatch):
    """The loss and its gradient over the first half of the rows alone."""
    from shufflingvideosfortsg_torch.train import steps
    backward = steps._backward

    def half(loss_fn, params, batch, pseudo, gen, accum, keys):
        B = pseudo['video_feat'].shape[0]

        def cut(d):
            return {k: v[:B // 2] if torch.is_tensor(v) and v.dim()
                    and v.shape[0] == B else v for k, v in d.items()}
        aux = backward(loss_fn, params, cut(batch), cut(pseudo), gen, accum,
                       keys)
        for k in ('start_prob', 'end_prob'):
            aux[k] = torch.cat([aux[k], aux[k]])
        return aux
    monkeypatch.setattr(steps, '_backward', half)
    assert not _correct('train')


def test_eval_answer_altered(monkeypatch):
    from shufflingvideosfortsg_torch.train import steps
    monkeypatch.setattr(steps, 'span_decode', _swap_rows(steps.span_decode))
    assert not _correct('eval')


def test_eval_half_the_batch(monkeypatch):
    """Each batch's loss the mean over its first half of rows."""
    from shufflingvideosfortsg_torch.train import steps
    nll = steps.span_ground_nll

    def halved(start, end, framestps):
        x = nll(start, end, framestps)
        h = len(x) // 2
        return torch.cat([x[:h], x[:h]])
    monkeypatch.setattr(steps, 'span_ground_nll', halved)
    assert not _correct('eval')


def test_serve_answer_altered(monkeypatch):
    """Two requests of a batch get each other's result."""
    from shufflingvideosfortsg_torch import serving
    monkeypatch.setattr(serving, 'span_decode',
                        _swap_rows(serving.span_decode))
    assert not _correct('serve')


def test_serve_half_the_batch(monkeypatch):
    from shufflingvideosfortsg_torch import serving
    monkeypatch.setattr(serving, 'span_decode',
                        _half_rows(serving.span_decode))
    assert not _correct('serve')


def _rank(rank: int, world: int, port: int, fault: bool, out) -> None:
    import sys
    sys.path[:0] = [common.BENCH, common.ROOT]
    import torch.distributed as dist
    from shufflingvideosfortsg_torch.parallel import mesh as pmesh
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=world)
    try:
        if fault:
            pmesh.DataMesh.sync_grads = lambda self, params: None
        limits = common.Cell.load(LIMITS['train_dp']).limits
        cell = common.Cell({'name': 'dp', 'chips': world}, TINY,
                           MIXES['train'], limits)
        run = common.Run(SEED, 1.0, False, torch.device('cpu'), rank, world,
                         pmesh.create_mesh(device='cpu'))
        train.run_cell(cell, run)
        if rank == 0:
            out.put(check.judge(run.ctx['numbers'], limits)[0])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('fault', [False, True], ids=['sound', 'exchange'])
def test_train_ranks_exchange_left_out(fault):
    """Two gloo ranks at the global batch: sound, and with the gradients'
    all-reduce left out (each rank updates from its own rows)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        correct = out.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    assert correct is (not fault)
