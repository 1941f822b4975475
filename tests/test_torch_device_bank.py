"""The port's device feature bank against the JAX package's: the resident
bytes of each tier (raw, bf16, int8 with its scales) and the batches
``assemble`` builds from the same index batch are equal; the chunked upload
equals one upload; the bf16 tier rounds as ``ml_dtypes`` does; the budget,
``device_bank`` and ``if_aug`` gates and the cache behave as the JAX
``maybe_device_bank``; and an index-only loader's assembled batch equals
the host-gathered one. Packs from ``tools/make_synth_pack.py``
(``chip_smoke.write_pack``) at T=24, D=32; all on the CPU."""

import os
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.data import device_bank
from shufflingvideosfortsg_torch.data.featpack import PackedFeatureSource
from shufflingvideosfortsg_torch.data.pipeline import (
    BatchLoader, SentenceGroundingDataset)
from shufflingvideosfortsg_torch.train.steps import to_device
from shufflingvideosfortsg_tpu.data import device_bank as jax_bank
from shufflingvideosfortsg_tpu.data.featpack import \
    PackedFeatureSource as JaxPackedFeatureSource
from shufflingvideosfortsg_tpu.parallel.mesh import create_mesh
from torch_one_thread import one_torch_thread  # noqa: F401

B, N, V = 6, 8, 40
TIERS = [('f16', 'raw'), ('f32', 'raw'), ('f32', 'bf16'), ('f16', 'bf16'),
         ('f16', 'int8'), ('f32', 'int8')]


@pytest.fixture(scope='module')
def packs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_bank'))
    return {dt: chip_smoke.write_pack(root, dt, 11, 24, 32)
            for dt in ('f16', 'f32')}


@pytest.fixture(scope='module')
def vocab():
    rng = np.random.RandomState(1)
    return types.SimpleNamespace(
        embeddings=rng.uniform(-1, 1, (V, 300)).astype(np.float32))


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.setattr(device_bank, '_BANK_CACHE', {})


def index_batch(n_videos: int, T: int = 24, seed: int = 0):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, T, B)
    return {
        'pack_row': rng.randint(0, n_videos, B).astype(np.int64),
        'token_ids': rng.randint(0, V, (B, N)).astype(np.int64),
        'sent_len': rng.randint(1, N, B).astype(np.int64),
        'framestps': np.stack([s, np.minimum(T - 1, s + rng.randint(
            0, 8, B))], 1).astype(np.int32),
        'nfeats': rng.randint(4, T + 1, B).astype(np.int32),
    }


def raw_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def port_assembled(bank, batch):
    out = bank.assemble(bank.attach(
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    return {k: v.numpy() for k, v in out.items()}


def jax_assembled(bank, batch):
    out = jax_bank.assemble(bank.attach(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize('pack_dtype,tier', TIERS)
def test_bank_bytes_and_assemble_match_jax(packs, vocab, pack_dtype, tier):
    pack = PackedFeatureSource(packs[pack_dtype])
    ref_pack = JaxPackedFeatureSource(packs[pack_dtype], use_native=False)
    bank = device_bank.DeviceFeatureBank(pack, vocab, 'cpu', dtype=tier)
    ref = jax_bank.DeviceFeatureBank(ref_pack, vocab, create_mesh(),
                                     dtype=tier)
    want = np.asarray(ref.feats)
    assert str(bank.feats.dtype) == f'torch.{want.dtype}'
    assert raw_bytes(bank.feats) == want.tobytes()
    if tier == 'int8':
        assert bank.scales.numpy().tobytes() == \
            np.asarray(ref.scales).tobytes()
    else:
        assert bank.scales is None and ref.scales is None
    assert bank.embeddings.numpy().tobytes() == \
        np.asarray(ref.embeddings).tobytes()
    assert bank.nbytes == ref.nbytes

    batch = index_batch(pack.num_videos)
    got, exp = port_assembled(bank, batch), jax_assembled(ref, batch)
    assert set(got) == set(exp)
    for k in device_bank.ASSEMBLED_KEYS:  # the rest pass through
        # the port widens f16 to f32 where JAX keeps it: exact either way
        w = exp[k].astype(np.float32) if exp[k].dtype == np.float16 \
            else exp[k]
        assert got[k].dtype == w.dtype, k
        assert got[k].tobytes() == w.tobytes(), k
    assert got['video_feat'].dtype == np.float32


@pytest.mark.parametrize('pack_dtype,tier', TIERS)
def test_chunked_upload_equals_one_upload(packs, vocab, pack_dtype, tier):
    pack = PackedFeatureSource(packs[pack_dtype])
    whole = device_bank.DeviceFeatureBank(pack, vocab, 'cpu', dtype=tier)
    # a chunk of 3 rows of the pack (11 videos: 4 chunks, the last short)
    row = pack.T * pack.D * 4
    chunked = device_bank.DeviceFeatureBank(pack, vocab, 'cpu',
                                            chunk_bytes=3 * row, dtype=tier)
    for a, b in ((whole.feats, chunked.feats), (whole.scales, chunked.scales),
                 (whole.embeddings, chunked.embeddings)):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_tier_rounds_to_nearest_even_as_ml_dtypes():
    rng = np.random.RandomState(2)
    x = rng.randn(4096).astype(np.float32) * 10 ** rng.uniform(-8, 8, 4096)
    # halfway cases: the low 16 bits exactly 0x8000 below an odd or an
    # even finite upper half; and the largest floats, which round to inf
    bits = (rng.randint(0, 0x7f80, 512).astype(np.uint32) << 16) | 0x8000
    ties = bits.view(np.float32)
    x = np.concatenate([x, ties, -ties, [np.float32(3.4e38), 0.0, -0.0]]
                       ).astype(np.float32)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    want = x.astype(ml_dtypes.bfloat16).view(np.int16)
    assert got.tobytes() == want.tobytes()
    # the bank's upload path gives the same
    up = device_bank._upload(x[:, None], torch.device('cpu'), 1 << 10,
                             torch.bfloat16)
    assert up.view(torch.int16).numpy()[:, 0].tobytes() == want.tobytes()


def _dataset(pack_dir, is_train=False, if_aug=False):
    return types.SimpleNamespace(pack=PackedFeatureSource(pack_dir),
                                 vocab=types.SimpleNamespace(
                                     embeddings=np.zeros((V, 300),
                                                         np.float32)),
                                 is_train=is_train)


def test_gates_off_no_pack_and_if_aug(packs):
    ds = _dataset(packs['f16'])
    assert device_bank.maybe_device_bank({'device_bank': False}, ds,
                                         'cpu') is None
    assert device_bank.maybe_device_bank(
        {}, types.SimpleNamespace(pack=None, is_train=False), 'cpu') is None
    train = _dataset(packs['f16'], is_train=True)
    assert device_bank.maybe_device_bank({'if_aug': True}, train,
                                         'cpu') is None
    # if_aug mutates only train features: a valid set keeps its bank
    assert device_bank.maybe_device_bank({'if_aug': True}, ds,
                                         'cpu') is not None
    assert device_bank.maybe_device_bank({}, train, 'cpu') is not None
    with pytest.raises(ValueError, match='device_bank_dtype'):
        device_bank.maybe_device_bank({'device_bank_dtype': 'fp8'}, ds,
                                      'cpu')


def test_budget_counts_every_resident_bank(packs):
    f16, f32 = _dataset(packs['f16']), _dataset(packs['f32'])
    n16 = device_bank.bank_nbytes(f16.pack, 'raw')
    n32 = device_bank.bank_nbytes(f32.pack, 'raw')
    assert n32 == 2 * n16 == f32.pack.num_videos * 24 * 32 * 4
    assert device_bank.bank_nbytes(f32.pack, 'bf16') == n16
    assert device_bank.bank_nbytes(f16.pack, 'bf16') == n16
    assert device_bank.bank_nbytes(f32.pack, 'int8') == \
        n32 // 4 + f32.pack.num_videos * 24 * 4
    emb = V * 300 * 4
    gib = 2 ** 30
    # under the budget alone
    first = device_bank.maybe_device_bank(
        {'device_bank_max_gb': (n16 + emb) / gib}, f16, 'cpu')
    assert first is not None and first.nbytes == n16 + emb
    # cached by (pack, tier, device): the same bank, not counted twice
    assert device_bank.maybe_device_bank(
        {'device_bank_max_gb': (n16 + emb) / gib}, f16, 'cpu') is first
    assert len(device_bank._BANK_CACHE) == 1
    # the second pack fits alone, not beside the first
    assert device_bank.maybe_device_bank(
        {'device_bank_max_gb': (n32 + emb) / gib}, f32, 'cpu') is None
    both = device_bank.maybe_device_bank(
        {'device_bank_max_gb': (n16 + n32 + emb) / gib}, f32, 'cpu')
    assert both is not None and len(device_bank._BANK_CACHE) == 2
    # another tier of a resident pack is a bank of its own
    i8 = device_bank.maybe_device_bank(
        {'device_bank_max_gb': 1.0, 'device_bank_dtype': 'int8'}, f16,
        'cpu')
    assert i8 is not first and i8.scales is not None


def test_index_only_loader_assembles_the_host_batch(tmp_path, packs):
    """A loader over a pack: the index-only batch assembled by the bank
    equals the host-gathered batch (features widened on the device,
    GloVe rows, the five masks of ``data/masks.py``)."""
    params = port_cli.parse_params(
        ['--cfg', 'charades_cd_i3d.yml', '--video_feature_dim', '32',
         '--video_len', '24', '--sent_len', '8'], default_model='GMD')
    anno, _, vocab_paths, n = chip_smoke.write_corpus(str(tmp_path), params,
                                                      n_videos=6)
    pack = chip_smoke.write_pack(str(tmp_path), 'f16', 6, 24, 32)
    params.update(wordtoix_path=vocab_paths['wordtoix'],
                  ixtoword_path=vocab_paths['ixtoword'],
                  word_fts_path=vocab_paths['word_glove_fts_init'])
    ds = SentenceGroundingDataset(anno, pack, params, 'charades')
    bank = device_bank.maybe_device_bank(params, ds, 'cpu')
    host = list(BatchLoader(ds, 8, shuffle=False, prefetch=0))
    index = list(BatchLoader(ds, 8, shuffle=False, prefetch=0,
                             device_assemble=True))
    assert len(host) == len(index) == -(-n // 8)
    keys = device_bank.ASSEMBLED_KEYS
    for h, i in zip(host, index):
        assert not set(keys) & set(i) and 'pack_row' in i
        assert h['video_feat'].dtype == np.float16  # shipped raw
        got = bank.assemble(bank.attach(
            to_device(i, torch.device('cpu'), device_bank.INDEX_KEYS)))
        want = to_device(h, torch.device('cpu'), keys)
        for k in keys:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match='device_assemble'):
        BatchLoader(ds, 8, shuffle=False, host_pair_aug=True,
                    device_assemble=True)
    assert os.path.isdir(pack)
