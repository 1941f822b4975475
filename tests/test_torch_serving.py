"""The port's serving tier against the JAX package's, at shared weights
carried by ``state_dict_from_jax``: GMD's serve methods, every mode of
``MultiQueryGrounder`` (chunking and padding, a bank, a corpus from a pack
in raw and int8, token ids, f16 shipping, top-k), ``main_test`` with
``eval_topk`` 5, and the options one card does not take. The model is
JAX ``tests/test_serving.py``'s tiny GMD (T=20, N=6, DV=16, hidden 8).
Probabilities are held at atol 1e-5, rtol 1e-4 (that test's tolerances),
scores at 2e-5 (two probabilities), spans exactly.

On a card (skipped here): the grounder with the kernels against the same
grounder on the CPU. JAX is imported by the comparisons only (the ``J``
fixture), so that case also runs on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_serving.py
"""

import json
import os
import struct
import types

import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_torch import cli as port_cli
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.data.featpack import PackedFeatureSource
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.serving import (MultiQueryGrounder,
                                                 bank_nbytes)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

T, N, DV = 20, 6, 16
PROB_ATOL, PROB_RTOL = 1e-5, 1e-4
SCORE_TOL = 2e-5
JAX_CFG = dict(sent_rnn_hiddendim=8, sent_rnn_layers=1,
               video_encoder='query_aware_encoder', video_rnn_hiddendim=8,
               video_rnn_layers=1, crossmodal='vs', predictor='mlp',
               mlp_hidden_dim=8, span_hidden_dim=8, mask=False, dropout=0.0,
               m_temp='none', m_pred_hidden=16, m_pred_activ='relu',
               precision='f32', mesh_shape=[8], sent_len=N)


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


@pytest.fixture(scope='module')
def J():
    """The JAX package's pieces the comparisons use."""
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu import cli
    from shufflingvideosfortsg_tpu.data.featpack import PackedFeatureSource
    from shufflingvideosfortsg_tpu.models import GMD, build_model
    from shufflingvideosfortsg_tpu.serving import MultiQueryGrounder
    from shufflingvideosfortsg_tpu.utils.torch_interop import \
        save_reference_ckp
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cli=cli, Pack=PackedFeatureSource, GMD=GMD,
        build_model=build_model, Grounder=MultiQueryGrounder,
        save_reference_ckp=save_reference_ckp)


def _jax_model(J):
    return J.GMD(sent_hidden=8, sent_layers=1, video_hidden=8,
                  video_layers=1, nblocks=2, cross_name='vs',
                  predictor_name='mlp', mlp_hidden_dim=8, span_hidden_dim=8,
                  video_if_mask=False, dropout=0.0, m_temp='none',
                  m_pred_hidden=16, m_pred_activ='relu')


def port_params(**kw):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=DV, sent_embedding_dim=300,
                  sent_rnn_hiddendim=8, sent_rnn_layers=1,
                  video_rnn_hiddendim=8, video_rnn_layers=1,
                  mlp_hidden_dim=8, m_pred_hidden=16, m_pred_activ='relu',
                  m_temp='none', dropout=0.0, mask=False, sent_len=N, **kw)
    return params


@pytest.fixture(scope='module')
def weights(J):
    """(JAX model, its parameters, the port's state dict of them, J)."""
    jnp = J.jnp
    model = _jax_model(J)
    mt = jnp.ones((2, T), jnp.int32)
    mn = jnp.ones((2, N), jnp.int32)
    v = J.jax.jit(model.init)(J.jax.random.PRNGKey(0),
                              jnp.zeros((2, N, 300)), mn,
                              jnp.zeros((2, T, DV)), mt,
                              jnp.zeros((2, T, DV)), mt, mt, mt, mt, mt, mt,
                              mt)
    params = J.jax.tree.map(np.asarray, v['params'])
    return model, params, state_dict_from_jax(params, sent_layers=1,
                                              video_layers=1), J


def grounders(weights, query_batch=8, **cfg):
    """(JAX grounder, port grounder on the CPU) at the same weights."""
    _, params, sd, J = weights
    return (J.Grounder(dict(JAX_CFG, **cfg), params,
                       query_batch=query_batch),
            MultiQueryGrounder(port_params(**cfg), sd, device='cpu',
                               query_batch=query_batch))


def _assert_grounding(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].dtype == np.int32
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                               atol=SCORE_TOL)


def _assert_probs(got, want):
    for k in ('start_prob', 'end_prob', 'match_prob'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=PROB_ATOL, rtol=PROB_RTOL, err_msg=k)


def _port_model(weights):
    model = build_model(port_params(), 'gmd', device='cpu')
    model.load_state_dict(weights[2], strict=True)
    return model.eval()


def _write_pack(rng, root, V=7):
    feats = rng.randn(V, T, DV).astype(np.float16)
    os.makedirs(root)
    with open(os.path.join(root, 'pack.bin'), 'wb') as f:
        f.write(struct.pack('<8sIIIIQ', b'FEATPAK1', V, T, DV, 1, 0))
        f.write(feats.tobytes())
    with open(os.path.join(root, 'index.json'), 'w') as f:
        json.dump({'vids': {f'v{i:03d}': i for i in range(V)},
                   'nfeats': [T] * V, 't': T, 'd': DV, 'dtype': 'f16',
                   'mode': 'raw'}, f)
    return root


# --- GMD's serve methods -----------------------------------------------------

@pytest.mark.parametrize('method', ['serve_multi_query', 'serve_cached',
                                    'serve_cached_multi'])
def test_serve_methods_match_jax(weights, method):
    jm, params, _, J = weights
    jax, jnp = J.jax, J.jnp
    port = _port_model(weights)
    rng = np.random.RandomState(1)
    queries = rng.randn(9, N, 300).astype(np.float32)
    V = 1 if method != 'serve_cached_multi' else 3
    videos = rng.randn(V, T, DV).astype(np.float32)
    ids = np.asarray([0, 1, 2, 2, 1, 0, 1, 0, 2], np.int32) % V

    def run(apply, video, query, vid):
        if method == 'serve_multi_query':
            return apply(video, query, method='serve_multi_query')
        rnn0 = apply(video, method='precompute_video')
        if method == 'serve_cached':
            return apply(rnn0, query, method='serve_cached')
        return apply(rnn0, query, vid, method='serve_cached_multi')

    def jax_apply(*args, method):
        fn = jax.jit(lambda p, *a: jm.apply({'params': p}, *a,
                                            method=getattr(jm, method)))
        return fn(params, *map(jnp.asarray, args))

    def port_apply(*args, method):
        return getattr(port, method)(*map(torch.as_tensor, args))

    want = run(jax_apply, videos, queries, ids)
    with torch.no_grad():
        got = run(port_apply, videos, queries, ids.astype(np.int64))
        rnn0 = port.precompute_video(torch.from_numpy(videos))
    _assert_probs(got, want)
    np.testing.assert_allclose(
        rnn0.numpy(), np.asarray(jax_apply(videos, method='precompute_video')),
        atol=PROB_ATOL, rtol=PROB_RTOL)


def test_shared_video_equals_eval_forward_on_the_tiled_video(weights):
    port = _port_model(weights)
    rng = np.random.RandomState(2)
    video = torch.from_numpy(rng.randn(1, T, DV).astype(np.float32))
    queries = torch.from_numpy(rng.randn(5, N, 300).astype(np.float32))
    with torch.no_grad():
        got = port.serve_multi_query(video, queries)
        want = port.eval_forward(video.repeat(5, 1, 1), queries)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=PROB_ATOL,
                                   rtol=PROB_RTOL)


# --- MultiQueryGrounder ------------------------------------------------------

def test_grounder_chunks_and_pads_as_jax(weights):
    """19 queries in batches of 8: 2 full and 1 padded; the resident video
    is reused without being passed again."""
    jg, pg = grounders(weights)
    rng = np.random.RandomState(3)
    video = rng.randn(T, DV).astype(np.float32)
    queries = rng.randn(19, N, 300).astype(np.float32)
    got = pg.ground(video, queries)
    assert got[0].shape == (19, 2) and got[1].shape == (19,)
    _assert_grounding(got, jg.ground(video, queries))
    again = pg.ground(None, queries)
    np.testing.assert_array_equal(again[0], got[0])
    np.testing.assert_array_equal(again[1], got[1])


def test_grounder_bank_and_tokens_match_jax(weights):
    jg, pg = grounders(weights)
    rng = np.random.RandomState(4)
    videos = rng.randn(3, T, DV).astype(np.float32)
    queries = rng.randn(11, N, 300).astype(np.float32)
    ids = (np.arange(11) % 3).astype(np.int32)
    emb = rng.randn(50, 300).astype(np.float32)
    token_ids = rng.randint(0, 50, (11, N)).astype(np.int32)
    for g in (jg, pg):
        g.set_videos(videos)
        g.set_vocab(emb)
    _assert_grounding(pg.ground_bank(queries, ids),
                      jg.ground_bank(queries, ids))
    got = pg.ground_tokens(token_ids, ids)
    _assert_grounding(got, jg.ground_tokens(token_ids, ids))
    # token ids are the vocabulary's rows as features, bit for bit
    feats = pg.ground_bank(emb[token_ids], ids)
    np.testing.assert_array_equal(got[0], feats[0])
    np.testing.assert_array_equal(got[1], feats[1])
    for g in (jg, pg):
        g.set_video(videos[1])
    _assert_grounding(pg.ground_tokens_video(token_ids),
                      jg.ground_tokens_video(token_ids))
    with pytest.raises(IndexError, match='video ids'):
        pg.ground_bank(queries[:2], np.asarray([0, 3]))
    with pytest.raises(IndexError, match='token ids'):
        pg.ground_tokens(token_ids[:1] + 50, ids[:1])


@pytest.mark.parametrize('tier', ['raw', 'int8'])
def test_grounder_corpus_from_pack_matches_jax(weights, tmp_path, tier):
    """set_corpus over a 7-video f16 pack in chunks of 4 (a full chunk and
    a tail): the bank (its bytes those of JAX's bank) and ground_vids."""
    rng = np.random.RandomState(5)
    root = _write_pack(rng, str(tmp_path / 'pack'))
    jg, pg = grounders(weights)
    jg.set_corpus(weights[3].Pack(root, use_native=False), chunk_videos=4,
                  dtype=tier)
    pg.set_corpus(PackedFeatureSource(root, use_native=False),
                  chunk_videos=4, dtype=tier)
    jbank = jg._resident_bank
    jparts = jbank if isinstance(jbank, tuple) else (jbank,)
    assert bank_nbytes(pg._resident_bank) == sum(p.nbytes for p in jparts)
    if tier == 'int8':
        q, s = pg._resident_bank
        assert q.dtype == torch.int8 and s.shape == q.shape[:2]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jparts[0]))
        np.testing.assert_allclose(s.numpy(), np.asarray(jparts[1]),
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(pg._resident_bank.numpy(),
                                   np.asarray(jbank), atol=PROB_ATOL,
                                   rtol=PROB_RTOL)
    queries = rng.randn(10, N, 300).astype(np.float32)
    names = [f'v{i % 7:03d}' for i in range(10)]
    got = pg.ground_vids(queries, names)
    _assert_grounding(got, jg.ground_vids(queries, names))
    # the same answer as pinning each video alone (raw tier)
    if tier == 'raw':
        pack = PackedFeatureSource(root, use_native=False)
        for v in range(3):
            sel = [i for i, n in enumerate(names) if n == f'v{v:03d}']
            alone = pg.ground(pack.gather(np.asarray([v]))[0], queries[sel])
            np.testing.assert_array_equal(got[0][sel], alone[0])
            np.testing.assert_allclose(got[1][sel], alone[1], rtol=0,
                                       atol=1e-6)


def test_int8_corpus_within_its_bound_of_raw(weights, tmp_path):
    rng = np.random.RandomState(6)
    root = _write_pack(rng, str(tmp_path / 'pack'))
    _, raw = grounders(weights)
    _, i8 = grounders(weights)
    raw.set_corpus(PackedFeatureSource(root), chunk_videos=3)
    i8.set_corpus(PackedFeatureSource(root), chunk_videos=3, dtype='int8')
    q, s = i8._resident_bank
    bank = raw._resident_bank
    # half a step, amax/254, and the f32 roundings of the scale and its
    # product, 2^-22 of amax (chip_smoke.INT8_BOUND)
    bound = bank.abs().amax(-1, keepdim=True) * chip_smoke.INT8_BOUND
    assert ((q.float() * s[..., None] - bank).abs() <= bound).all()
    V, T_, H2 = bank.shape
    assert bank_nbytes(bank) == V * T_ * H2 * 4
    assert bank_nbytes(i8._resident_bank) == V * T_ * (H2 + 4)


def test_f16_shipping_matches_jax(weights):
    jg, pg = grounders(weights, serve_query_dtype='f16')
    _, p32 = grounders(weights)
    rng = np.random.RandomState(7)
    video = rng.randn(T, DV).astype(np.float32)
    queries = (rng.randn(19, N, 300) * 2).astype(np.float32)
    got = pg.ground(video, queries)
    _assert_grounding(got, jg.ground(video, queries))
    # the features rounded to f16 once, nothing else
    np.testing.assert_array_equal(
        got[1], p32.ground(video, queries.astype(np.float16)
                           .astype(np.float32))[1])


def test_ground_topk_matches_jax(weights):
    jg, pg = grounders(weights)
    rng = np.random.RandomState(8)
    video = rng.randn(T, DV).astype(np.float32)
    queries = rng.randn(11, N, 300).astype(np.float32)
    for g in (jg, pg):
        g.set_video(video)
    spans, scores = pg.ground_topk(queries, k=4, nms_iou=0.5)
    assert spans.shape == (11, 4, 2) and spans.dtype == np.int32
    w_spans, w_scores = jg.ground_topk(queries, k=4, nms_iou=0.5)
    np.testing.assert_array_equal(spans, np.asarray(w_spans))
    np.testing.assert_allclose(scores, np.asarray(w_scores), rtol=0,
                               atol=SCORE_TOL)
    pred1, score1 = pg.ground(None, queries)
    np.testing.assert_array_equal(spans[:, 0], pred1)
    np.testing.assert_allclose(scores[:, 0], score1, rtol=0, atol=1e-6)


def test_mesh_options_raise_on_one_card(weights, tmp_path):
    _, pg = grounders(weights)
    root = _write_pack(np.random.RandomState(9), str(tmp_path / 'pack'))
    with pytest.raises(NotImplementedError, match='ROADMAP.md §1, the parallel surfaces'):
        pg.set_corpus(PackedFeatureSource(root), shard=True)
    with pytest.raises(NotImplementedError, match='ROADMAP.md §1, the parallel surfaces'):
        pg.set_video_sharded(np.zeros((T, DV), np.float32))
    with pytest.raises(ValueError, match='raw or int8'):
        pg.set_corpus(PackedFeatureSource(root), dtype='bf16')
    with pytest.raises(RuntimeError, match='no video set'):
        pg.ground(None, np.zeros((2, N, 300), np.float32))
    # precision bf16 builds the grounder (tests/test_torch_bf16.py holds
    # it against JAX's): bf16 recurrences cached, f32 weights
    g16 = MultiQueryGrounder(port_params(precision='bf16'), weights[2],
                             device='cpu')
    g16.set_video(np.zeros((T, DV), np.float32))
    assert g16._resident_rnn0.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in g16.model.parameters())


# --- main_test with eval_topk ------------------------------------------------

def test_main_test_topk_submit_matches_jax(J, tmp_path, capsys):
    """Both drivers at eval_topk 5 on one corpus and one reference .ckp:
    every sentence's ``timestamps_topk`` equal, the R@k rows printed."""
    tiny = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len',
            '8', '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
            '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
            '--batch_size', '8', '8', '8', '--eval_topk', '5']
    root = str(tmp_path)
    params = J.cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + tiny,
                                default_model='GMD')
    anno, feats, vocab, n = chip_smoke.write_corpus(root, params, n_videos=6)
    model = J.build_model(params, 'gmd', inference=True)
    w = J.cli.init_model_params(model, params, J.jax.random.PRNGKey(3),
                                'gmd')
    ckp = os.path.join(root, 'seeded.ckp')
    J.save_reference_ckp(J.jax.tree.map(np.asarray, w), ckp, kind='gmd')
    argv = ['--cfg', 'charades_cd_i3d.yml', *tiny,
            '--runs', os.path.join(root, 'runs'), '--test_data', anno,
            '--test_featpath', feats, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init'],
            '--start_from', ckp]
    out = {}
    for name, cli, extra in (('jax', J.cli, []),
                             ('port', port_cli, ['--device', 'cpu'])):
        submit = cli.main_test(cli.parse_params(
            argv + ['--alias', f'topk_{name}'] + extra, default_model='GMD'))
        with open(submit) as f:
            out[name] = (json.load(f)['results'],
                         capsys.readouterr().out.splitlines()[1:])
    (got, got_table), (want, want_table) = out['port'], out['jax']
    rows = [(g, w) for vid in want for g, w in zip(got[vid], want[vid])]
    assert len(rows) == n
    for g, w in rows:
        assert g['timestamp'] == w['timestamp']
        assert g['timestamps_topk'] == w['timestamps_topk']
        assert g['timestamps_topk'][0] == g['timestamp']
        np.testing.assert_allclose(g['scores_topk'], w['scores_topk'],
                                   rtol=0, atol=SCORE_TOL)
    assert got_table == want_table
    assert [ln.split()[0] for ln in got_table[2:-1]] == \
        ['=>', '1', '2', '3', '4', '5']


# --- top-k on the resident bank ----------------------------------------------

@pytest.fixture(scope='module')
def topk_pack(tmp_path_factory):
    """argv of main_test at eval_topk 5 over a 16-video f16 pack (ticks of
    2 batches of 8: the graph is captured at the third tick), the root and
    the sentence count."""
    root = str(tmp_path_factory.mktemp('torch_topk_pack'))
    tiny = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len',
            '8', '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
            '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
            '--batch_size', '8', '8', '8', '--eval_topk', '5',
            '--eval_scan_group', '2']
    params = port_cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + tiny,
                                   default_model='GMD')
    anno, _, vocab, n = chip_smoke.write_corpus(root, params, n_videos=16,
                                                features=False)
    pack = chip_smoke.write_pack(root, 'f16', 16, 24, 32)
    model = port_cli._seeded_model(params, torch.device('cpu'), 'gmd')
    ckp = os.path.join(root, 'seeded.ckp')
    torch.save(model.state_dict(), ckp)
    argv = ['--cfg', 'charades_cd_i3d.yml', *tiny,
            '--runs', os.path.join(root, 'runs'), '--test_data', anno,
            '--test_featpath', pack, '--wordtoix_path', vocab['wordtoix'],
            '--ixtoword_path', vocab['ixtoword'],
            '--word_fts_path', vocab['word_glove_fts_init'],
            '--start_from', ckp]
    return argv, n


def _topk_submit(argv, alias, device, bank=True, graphed=True):
    params = port_cli.parse_params(argv + ['--alias', alias, '--device',
                                           device], default_model='GMD')
    params['device_bank'] = bank
    with open(port_cli.main_test(params, _graphed=graphed)) as f:
        results = json.load(f)['results']
    return [r for v in results.values() for r in v]


def _assert_same_topk(got, want, n, tol=SCORE_TOL):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g['sentence'] == w['sentence']
        assert g['timestamp'] == w['timestamp']
        assert g['timestamps_topk'] == w['timestamps_topk']
        np.testing.assert_allclose(g['scores_topk'], w['scores_topk'],
                                   rtol=0, atol=tol)


def test_banked_epoch_carries_top_k(topk_pack):
    """The grouped [G*B] pass on the bank gives each sentence the top-k
    proposals the host-gathered batch-by-batch pass gives it."""
    argv, n = topk_pack
    banked = _topk_submit(argv, 'topk_bank', 'cpu')
    host = _topk_submit(argv, 'topk_host', 'cpu', bank=False)
    _assert_same_topk(banked, host, n, tol=1e-6)
    assert max(len(r['timestamps_topk']) for r in banked) == 5


# --- on a card ---------------------------------------------------------------

@pytest.mark.requires_cuda
def test_graphed_epoch_carries_top_k_on_the_card(topk_pack):
    """The graphed banked epoch at eval_topk 5 against the eager one on
    the card (bit for bit) and the CPU's."""
    argv, n = topk_pack
    graphed = _topk_submit(argv, 'topk_graphed', 'cuda')
    eager = _topk_submit(argv, 'topk_eager', 'cuda', graphed=False)
    cpu = _topk_submit(argv, 'topk_cpu', 'cpu')
    _assert_same_topk(graphed, eager, n, tol=0.0)
    _assert_same_topk(graphed, cpu, n)


@pytest.mark.requires_cuda
def test_grounder_on_the_card_matches_the_cpu(tmp_path):
    """Kernels against plain versions through every grounding mode, at
    seeded torch weights."""
    torch.manual_seed(0)
    state = build_model(port_params(), 'gmd', device='cpu').state_dict()
    rng = np.random.RandomState(10)
    root = _write_pack(rng, str(tmp_path / 'pack'), V=9)
    video = rng.randn(T, DV).astype(np.float32)
    queries = rng.randn(21, N, 300).astype(np.float32)
    emb = rng.randn(50, 300).astype(np.float32)
    tokens = rng.randint(0, 50, (21, N)).astype(np.int32)
    ids = (np.arange(21) % 9).astype(np.int32)
    results = []
    for device in ('cpu', 'cuda'):
        g = MultiQueryGrounder(port_params(), state, device=device,
                               query_batch=8)
        g.set_vocab(emb)
        g.set_video(video)
        res = [g.ground(None, queries), g.ground_tokens_video(tokens),
               g.ground_topk(queries, k=3)]
        for tier in ('raw', 'int8'):
            g.set_corpus(PackedFeatureSource(root), chunk_videos=4,
                         dtype=tier)
            res += [g.ground_bank(queries, ids), g.ground_tokens(tokens, ids)]
        results.append(res)
    for got, want in zip(*results[::-1]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SCORE_TOL)
