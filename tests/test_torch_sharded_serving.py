"""The port's grounder over several shards on the CPU, against the JAX
package's grounder over its 8-device mesh (``tests/conftest.py``) and
against the port's own one-shard grounder, on ``tests/test_serving.py``'s
tiny GMD (T=20, N=6, DV=16, hidden 8) with ``mesh_shape: [8]``:

- ``set_corpus(shard=True)`` of V=10 videos, padded to 16 (two a shard),
  raw and int8: the padded first axis, zero padding (int8: zero values
  and zero scales), ``ground_bank``, ``ground_vids`` and
  ``ground_tokens`` against JAX's sharded bank and the port's replicated
  one: spans exact, scores rtol 1e-4 atol 1e-6; video ids checked
  against the real V;
- every ``ground*`` method query-sharded (each batch of 8 cut into 8
  parts) against one shard, and against JAX where it has the method on
  the mesh: spans exact, scores rtol 1e-4 atol 1e-6;
- a ``query_batch`` that the shards do not divide raises, as JAX's
  ``batch_sharding`` refuses it;
- the gateway over 8 CPU shards (bank, sharded bank and video modes)
  against the grounder;
- an explicit ``devices=`` list, a sharded grounder's AOT export refused,
  a first card other than ``cuda:0`` under ``mesh_shape`` refused, the
  kernel library's entry points restoring the caller's current card, and
  (on a card, skipped here) more shards than visible cards refused and,
  on two cards or more, the current card unchanged by a grounder over
  them.
"""

import types

import numpy as np
import pytest
import torch

from torch_one_thread import one_torch_thread  # noqa: F401
from test_torch_serving import (N, T, J, _write_pack, grounders,  # noqa: F401
                                port_params, weights)

from shufflingvideosfortsg_torch.data.featpack import PackedFeatureSource
from shufflingvideosfortsg_torch.serving import (MultiQueryGrounder,
                                                 ShardedBank, bank_nbytes,
                                                 shard_devices)

SHARDS = 8
V = 10  # pads to 16 over 8 shards
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _hold(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].dtype == np.int32
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=rtol,
                               atol=atol)


def _sharded(weights, **cfg):
    """(JAX grounder over 8 devices, the port's over 8 CPU shards, the
    port's on one)."""
    jg, one = grounders(weights, **cfg)
    _, params, sd, _ = weights
    pg = MultiQueryGrounder(port_params(mesh_shape=[SHARDS], **cfg), sd,
                            device='cpu', query_batch=8)
    assert [str(r.device) for r in pg.replicas] == ['cpu'] * SHARDS
    return jg, pg, one


@pytest.fixture(scope='module')
def pack_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('shard_pack') / 'pack'
    return _write_pack(np.random.RandomState(31), str(root), V=V)


@pytest.mark.parametrize('tier', ['raw', 'int8'])
def test_sharded_corpus_equals_jax_and_the_replicated_bank(weights,
                                                           pack_root, tier):
    jg, pg, one = _sharded(weights)
    jg.set_corpus(weights[3].Pack(pack_root, use_native=False),
                  chunk_videos=4, shard=True, dtype=tier)
    pg.set_corpus(PackedFeatureSource(pack_root), chunk_videos=4,
                  shard=True, dtype=tier)
    one.set_corpus(PackedFeatureSource(pack_root), chunk_videos=4,
                   dtype=tier)
    bank = pg._resident_bank
    assert isinstance(bank, ShardedBank) and bank.rows == 2
    jbank = jg._resident_bank
    assert bank.shape[0] == 16 == (jbank[0] if tier == 'int8'
                                   else jbank).shape[0]
    assert bank_nbytes(bank) == 16 * bank_nbytes(one._resident_bank) // V
    # the padding (rows 10-15, shards 5-7) is zero; the real rows are the
    # replicated bank's, shard by shard
    rep = one._resident_bank
    for k, part in enumerate(bank.parts):
        for j, (a, b) in enumerate(zip(
                part if tier == 'int8' else (part,),
                rep if tier == 'int8' else (rep,))):
            lo, hi = 2 * k, min(2 * k + 2, V)
            real = max(hi - lo, 0)
            torch.testing.assert_close(a[:real], b[lo:hi], rtol=0, atol=0)
            assert not a[real:].any(), (k, j)
    rng = np.random.RandomState(32)
    queries = rng.randn(19, N, 300).astype(np.float32)
    ids = rng.randint(0, V, 19).astype(np.int32)
    got = pg.ground_bank(queries, ids)
    _hold(got, jg.ground_bank(queries, ids))
    _hold(got, one.ground_bank(queries, ids))
    vids = [f'v{i:03d}' for i in ids]
    _hold(pg.ground_vids(queries, vids), got, rtol=0, atol=0)
    emb = rng.randn(40, 300).astype(np.float32)
    tokens = rng.randint(0, 40, (19, N)).astype(np.int32)
    for g in (jg, pg, one):
        g.set_vocab(emb)
    got = pg.ground_tokens(tokens, ids)
    _hold(got, jg.ground_tokens(tokens, ids))
    _hold(got, one.ground_tokens(tokens, ids))
    # ids are checked against the real V, not the padded 16
    with pytest.raises(IndexError, match=r'video ids outside \[0, 10\)'):
        pg.ground_bank(queries[:2], np.array([3, V], np.int32))


@pytest.mark.parametrize('method', ['ground', 'ground_topk',
                                    'ground_tokens_video', 'ground_bank',
                                    'ground_tokens'])
def test_query_sharding_equals_one_shard(weights, method):
    jg, pg, one = _sharded(weights)
    rng = np.random.RandomState(33)
    video = rng.randn(T, 16).astype(np.float32)
    videos = rng.randn(3, T, 16).astype(np.float32)
    queries = rng.randn(19, N, 300).astype(np.float32)
    emb = rng.randn(40, 300).astype(np.float32)
    tokens = rng.randint(0, 40, (19, N)).astype(np.int32)
    ids = (np.arange(19) % 3).astype(np.int32)
    for g in (jg, pg, one):
        g.set_video(video)
        g.set_videos(videos)
        g.set_vocab(emb)
    args = {'ground': (None, queries), 'ground_topk': (queries, 4),
            'ground_tokens_video': (tokens,),
            'ground_bank': (queries, ids),
            'ground_tokens': (tokens, ids)}[method]
    got = getattr(pg, method)(*args)
    _hold(got, getattr(one, method)(*args))
    _hold(got, getattr(jg, method)(*args))


def test_query_batch_must_divide_over_the_shards(weights):
    _, params, sd, _ = weights
    with pytest.raises(ValueError, match='multiple of the 8 shards'):
        MultiQueryGrounder(port_params(mesh_shape=[SHARDS]), sd,
                           device='cpu', query_batch=12)
    # JAX refuses the same batch when it shards it over the data axis
    jg, _ = grounders(weights, query_batch=12)
    with pytest.raises(ValueError):
        jg.ground(np.zeros((T, 16), np.float32),
                  np.zeros((3, N, 300), np.float32))


def _gateway_results(g, mode, tokens, vids):
    from shufflingvideosfortsg_torch import gateway as gwmod
    gw = gwmod.ServingGateway(g, mode=mode, max_tokens=N, flush_us=2_000,
                              pipeline_depth=2)
    try:
        tickets = [gw.submit(tokens[i], int(vids[i]))
                   for i in range(len(tokens))]
        out = [gw.result(t, timeout_s=60.0) for t in tickets]
    finally:
        gw.close(timeout_s=60.0)
    return (np.asarray([o[:2] for o in out], np.int32),
            np.asarray([o[2] for o in out], np.float32))


@pytest.mark.parametrize('mode', ['bank', 'sharded_bank', 'video'])
def test_gateway_over_shards_equals_the_grounder(weights, pack_root, mode):
    _, pg, _ = _sharded(weights)
    rng = np.random.RandomState(34)
    emb = rng.randn(40, 300).astype(np.float32)
    tokens = rng.randint(1, 40, (21, N)).astype(np.int32)
    pg.set_vocab(emb)
    if mode == 'video':
        pg.set_video(rng.randn(T, 16).astype(np.float32))
        vids = np.zeros(21, np.int32)
        direct = pg.ground_tokens_video(tokens)
    else:
        pg.set_corpus(PackedFeatureSource(pack_root), chunk_videos=4,
                      shard=mode == 'sharded_bank')
        vids = rng.randint(0, V, 21).astype(np.int32)
        direct = pg.ground_tokens(tokens, vids)
    got = _gateway_results(pg, 'video' if mode == 'video' else 'bank',
                           tokens, vids)
    # a request's batch mates differ from the direct call's
    _hold(got, direct, rtol=0, atol=1e-6)


def test_devices_list_and_refusals(weights, tmp_path):
    from shufflingvideosfortsg_torch.utils.aot import export_grounder
    _, params, sd, _ = weights
    g = MultiQueryGrounder(port_params(), sd, device='cpu', query_batch=8,
                           devices=['cpu', 'cpu'])
    assert len(g.replicas) == 2 and g.replicas[0].model is \
        g.replicas[1].model  # one device: one replica shared
    with pytest.raises(ValueError, match=r'mesh_shape \[4\] against 2'):
        MultiQueryGrounder(port_params(mesh_shape=[4]), sd, device='cpu',
                           query_batch=8, devices=['cpu', 'cpu'])
    g.set_video(np.zeros((T, 16), np.float32))
    with pytest.raises(ValueError, match='one-card grounder'):
        export_grounder(g, str(tmp_path / 'aot'), platforms=['cpu'])


@pytest.mark.requires_cuda
def test_more_shards_than_cards_raise_on_cuda():
    """(No JAX here: the card's machine has none.)"""
    from shufflingvideosfortsg_torch.models.build import build_model
    sd = build_model(port_params(), 'gmd', device='cpu').state_dict()
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f'over {n} cards'):
        MultiQueryGrounder(port_params(mesh_shape=[n]), sd, device='cuda',
                           query_batch=8 * n)


def test_a_mesh_from_another_first_card_raises():
    """``mesh_shape`` [n] lays the shards on cuda:0..n-1; a device that
    names another first card is refused, not dropped (no card needed: the
    check comes before the count of cards)."""
    with pytest.raises(ValueError, match=r'cuda:0\.\.1, not from cuda:2'):
        shard_devices([2], torch.device('cuda', 2))
    assert shard_devices([1], torch.device('cpu')) == [torch.device('cpu')]


def test_kernel_entry_points_restore_the_current_card(monkeypatch):
    """The C side makes its card current and leaves it so; the library's
    wrapper sets the caller's card back, also when the call raises."""
    from shufflingvideosfortsg_torch import _kernels
    current = [0]
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: current[0])
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: current.__setitem__(0, d))

    def launch(device):  # what cudaSetDevice(device) does to the caller
        current[0] = device
        if device < 0:
            raise OSError('launch failed')
        return 0
    lib = _kernels._KeepingDevice(types.SimpleNamespace(svtsg_x=launch))
    assert lib.svtsg_x(3) == 0 and current == [0]
    with pytest.raises(OSError):
        lib.svtsg_x(-1)
    assert current == [0]


@pytest.mark.requires_cuda
def test_shards_on_cards_leave_the_current_card(tmp_path):
    """A grounder over cuda:0 and cuda:1, and one on cuda:1 alone, leave
    the caller's current card where it was through set_corpus(shard=True),
    set_video and their ground* calls. (No JAX here.)"""
    from shufflingvideosfortsg_torch.models.build import build_model
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two NVIDIA GPUs')
    torch.manual_seed(0)
    sd = build_model(port_params(), 'gmd', device='cpu').state_dict()
    rng = np.random.RandomState(35)
    root = _write_pack(rng, str(tmp_path / 'pack'), V=V)
    queries = rng.randn(19, N, 300).astype(np.float32)
    ids = rng.randint(0, V, 19).astype(np.int32)
    torch.cuda.set_device(0)
    two = MultiQueryGrounder(port_params(), sd, device='cuda',
                             query_batch=8, devices=['cuda:0', 'cuda:1'])
    two.set_corpus(PackedFeatureSource(root), chunk_videos=4, shard=True)
    assert torch.cuda.current_device() == 0
    two.ground_vids(queries, [f'v{i:03d}' for i in ids])
    assert torch.cuda.current_device() == 0
    one = MultiQueryGrounder(port_params(), sd, device='cuda:1',
                             query_batch=8)
    one.set_video(rng.randn(T, 16).astype(np.float32))
    one.ground(None, queries)
    assert torch.cuda.current_device() == 0
