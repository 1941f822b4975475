"""The traffic generator: deterministic by seed, sizes fixed by the
configuration, and the ActivityNet file's statistics."""

import numpy as np
import pytest

from harness import common, traffic

ANET = common.load_json(common.BENCH, 'configs', 'anet_cd_i3d.json')
CHARADES = common.load_json(common.BENCH, 'configs', 'charades_cd_i3d.json')


@pytest.fixture(scope='module')
def anet():
    return traffic.build_corpus(ANET, common.ROOT)


def test_anet_file_statistics(anet):
    assert anet.num_videos == 10984
    assert anet.num_pairs == 51415
    assert abs(float(np.median(anet.duration)) - 111) < 2
    assert abs(float((anet.duration > 240).mean()) - 0.0017) < 0.001
    assert float(np.median(anet.n_words)) == 12
    assert abs(float(np.percentile(anet.n_words, 95)) - 24) <= 1
    assert abs(float((anet.n_words > 25).mean()) - 0.041) < 0.005
    assert anet.nfeats.min() >= 1 and anet.nfeats.max() == 240
    assert (anet.sent_len <= 25).all() and (anet.token_ids < anet.vocab_size).all()
    f = anet.framestps(240)
    assert f.max() == 239 and (f >= 0).all()


def test_charades_sizes_fixed_by_configuration():
    a = traffic.build_corpus(CHARADES, common.ROOT)
    b = traffic.build_corpus(CHARADES, common.ROOT)
    assert a.num_videos == 6672 and a.num_pairs == 11071
    assert len(np.unique(a.pair_row)) == 4564
    for k in ('nfeats', 'duration', 'token_ids', 'timestps'):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert abs(float(a.duration.mean()) - 30.6) < 0.5
    assert abs(float(np.diff(a.timestps).mean()) - 8.2) < 0.3
    assert abs(float(a.n_words.mean()) - 7.2) < 0.1
    assert (a.timestps[:, 1] <= a.duration[a.pair_row] + 1e-3).all()


def test_epoch_order_is_the_samplers_and_the_seeds():
    o1 = traffic.epoch_order(100, 2 ** 31 + 5, 0)
    assert np.array_equal(o1, traffic.epoch_order(100, 2 ** 31 + 5, 0))
    assert not np.array_equal(o1, traffic.epoch_order(100, 2 ** 31 + 6, 0))
    assert sorted(o1) == list(range(100))
    idx = np.arange(100)
    np.random.RandomState(7 + 2).shuffle(idx)
    assert np.array_equal(traffic.epoch_order(100, 7, 2), idx)


def test_four_stripes_deal_out_the_single_process_batch():
    """Rank r's batch k at 8 rows is global rows 4i + r of batch k at 32."""
    order = traffic.epoch_order(11071, 3, 0)
    one = traffic.stripe_batches(order, 32)
    ranks = [traffic.stripe_batches(order, 8, r, 4) for r in range(4)]
    for k in range(3):
        merged = np.empty(32, np.int64)
        for r in range(4):
            merged[r::4] = ranks[r][k]
        assert np.array_equal(merged, one[k])


def test_schedule_same_sizes_other_order(anet):
    mix = {'rate_qps': 1000.0, 'pool_seed': 0}
    pool = traffic.request_pool(anet, mix, 2.0)
    a = traffic.schedule(pool, 2 ** 31 + 1)
    b = traffic.schedule(pool, 2 ** 31 + 2)
    assert len(a['due']) == len(b['due']) == 2000
    assert np.array_equal(np.sort(a['pair']), np.sort(b['pair']))
    assert not np.array_equal(a['pair'], b['pair'])
    assert np.all(np.diff(a['due']) >= 0)
    c = traffic.schedule(pool, 2 ** 31 + 1)
    assert np.array_equal(a['due'], c['due'])
    assert abs(a['due'][-1] - 2.0) < 0.2


def test_index_batch_keys(anet):
    b = traffic.index_batch(anet, np.arange(4), 240)
    assert tuple(b) == traffic.INDEX_KEYS
    assert b['token_ids'].shape == (4, 25) and b['framestps'].dtype == np.int32
