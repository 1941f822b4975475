"""The port's AOT serving artifacts (``utils/aot.py``) against its live
grounder and the JAX package's, mirroring ``tests/test_aot.py`` at its
tiny GMD (T=20, N=6, DV=16, hidden 8): a live ``MultiQueryGrounder`` on
the CPU exported with ``torch.export``, reloaded from the directory alone
and required to give the live grounder's spans and scores bit for bit
(19 queries: two full batches of 8 and a partial one), and JAX's live
grounder's at its serving bounds (spans exact, scores atol 1e-5, rtol
1e-4); the corpus tiers (raw, bf16 and int8 banks); another checkpoint's
weights in the same artifact; JAX's errors; the kernels as custom ops in
the programs' graphs (``torch.library.opcheck`` on both); a loader that
imports no model code; and ``python -m
shufflingvideosfortsg_torch.export_serving`` on a ``.ckp`` the port's
trainer wrote. On a card (skipped here) the artifact against the live
grounder on the card, bit for bit, through the kernels.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
from shufflingvideosfortsg_torch import cli
from shufflingvideosfortsg_torch.config import load_config
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.ops.lstm_scan import lstm_recurrence_op
from shufflingvideosfortsg_torch.ops.scdm_fused import scdm_attention_op
from shufflingvideosfortsg_torch.serving import MultiQueryGrounder
from shufflingvideosfortsg_torch.utils import aot
from shufflingvideosfortsg_torch.utils.aot import (ExportedGrounder,
                                                   export_grounder,
                                                   load_grounder_artifact)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N, DV, QB = 20, 6, 16, 8
SCORE_ATOL, SCORE_RTOL = 1e-5, 1e-4
# tests/test_aot.py's CFG
JAX_CFG = dict(sent_rnn_hiddendim=8, sent_rnn_layers=1,
               video_encoder='query_aware_encoder', video_rnn_hiddendim=8,
               video_rnn_layers=1, crossmodal='vs', predictor='mlp',
               mlp_hidden_dim=8, span_hidden_dim=8, mask=False, dropout=0.0,
               m_temp='none', m_pred_hidden=16, m_pred_activ='relu',
               precision='f32', mesh_shape=[8], sent_len=N,
               video_feature_dim=DV)


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def port_params(**kw):
    params = load_config('charades_cd_i3d.yml')
    params.update(video_feature_dim=DV, sent_embedding_dim=300,
                  sent_rnn_hiddendim=8, sent_rnn_layers=1,
                  video_rnn_hiddendim=8, video_rnn_layers=1,
                  mlp_hidden_dim=8, m_pred_hidden=16, m_pred_activ='relu',
                  m_temp='none', dropout=0.0, mask=False, sent_len=N, **kw)
    return params


def _jax_weights(seed):
    """tests/test_aot.py's GMD, initialised from ``seed``: (its JAX
    parameters, the port's state dict of them)."""
    import jax
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.models import GMD
    model = GMD(sent_hidden=8, sent_layers=1, video_hidden=8, video_layers=1,
                nblocks=2, cross_name='vs', predictor_name='mlp',
                mlp_hidden_dim=8, span_hidden_dim=8, video_if_mask=False,
                dropout=0.0, m_temp='none', m_pred_hidden=16,
                m_pred_activ='relu')
    mt = jnp.ones((2, T), jnp.int32)
    mn = jnp.ones((2, N), jnp.int32)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((2, N, 300)),
                            mn, jnp.zeros((2, T, DV)), mt,
                            jnp.zeros((2, T, DV)), mt, mt, mt, mt, mt, mt, mt)
    params = jax.tree.map(np.asarray, v['params'])
    return params, state_dict_from_jax(params, sent_layers=1, video_layers=1)


@pytest.fixture(scope='module')
def artifact_env(tmp_path_factory):
    """A live port grounder (a video and a vocabulary resident) exported on
    the CPU."""
    jax_params, state = _jax_weights(0)
    rng = np.random.RandomState(3)
    emb = rng.randn(50, 300).astype(np.float32)
    emb[0] = 0.0  # pad id
    video = rng.randn(T, DV).astype(np.float32)
    g = MultiQueryGrounder(port_params(), state, device='cpu',
                           query_batch=QB)
    g.set_video(video)
    g.set_vocab(emb)
    out = str(tmp_path_factory.mktemp('aot'))
    manifest = export_grounder(g, out)
    return types.SimpleNamespace(g=g, out=out, manifest=manifest, video=video,
                                 emb=emb, jax_params=jax_params, state=state)


@pytest.fixture(scope='module')
def loaded(artifact_env):
    e = load_grounder_artifact(artifact_env.out, device='cpu')
    e.set_video(artifact_env.video)
    return e


def _equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32


def test_manifest_and_files(artifact_env):
    m, out = artifact_env.manifest, artifact_env.out
    assert m['format'] == 'svtsg-aot-torch-v1'
    assert m['functions'] == ['precompute', 'serve_features', 'serve_tokens']
    assert (m['video_len'], m['video_feature_dim'], m['sent_len'],
            m['query_batch']) == (T, DV, N, QB)
    assert m['platforms'] == ['cpu'] and m['precision'] == 'f32'
    assert m['torch_version'] == torch.__version__
    assert m['num_videos'] is None and m['bank_dtype'] is None
    for f in ('manifest.json', 'weights.ckp', 'vocab.npy',
              'precompute.cpu.pt2', 'serve_features.cpu.pt2',
              'serve_tokens.cpu.pt2'):
        assert os.path.isfile(os.path.join(out, f)), f


def test_manifest_keys_are_jax_keys(artifact_env):
    """JAX's manifest keys (``utils/aot.py:190-202``), with
    ``torch_version`` for ``jax_version``, ``precision`` beside them, and
    no ``tpu_native`` (ROADMAP.md §3)."""
    jax_keys = {'format', 'functions', 'video_len', 'video_feature_dim',
                'sent_len', 'query_batch', 'num_videos', 'bank_dtype',
                'platforms', 'tpu_native', 'jax_version'}
    assert set(artifact_env.manifest) == \
        jax_keys - {'tpu_native', 'jax_version'} | {'torch_version',
                                                     'precision'}


def test_exported_equals_live_features(artifact_env, loaded):
    q = np.random.RandomState(4).randn(19, N, 300).astype(np.float32)
    _equal(loaded.ground(q), artifact_env.g.ground(None, q))


def test_exported_equals_live_tokens(artifact_env, loaded):
    tok = np.random.RandomState(5).randint(0, 50, (11, N)).astype(np.int32)
    _equal(loaded.ground_tokens_video(tok),
           artifact_env.g.ground_tokens_video(tok))


def test_exported_equals_jax_live_grounder(artifact_env, loaded):
    """JAX's ``MultiQueryGrounder`` at the same weights: spans exact,
    scores at the serving bounds."""
    from shufflingvideosfortsg_tpu.serving import MultiQueryGrounder as JaxG
    jg = JaxG(JAX_CFG, artifact_env.jax_params, query_batch=QB)
    jg.set_video(artifact_env.video)
    jg.set_vocab(artifact_env.emb)
    rng = np.random.RandomState(6)
    q = rng.randn(19, N, 300).astype(np.float32)
    tok = rng.randint(0, 50, (11, N)).astype(np.int32)
    for got, want in ((loaded.ground(q), jg.ground(None, q)),
                      (loaded.ground_tokens_video(tok),
                       jg.ground_tokens_video(tok))):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]),
                                   atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_loader_commits_weights_to_device(loaded):
    """The weights, the vocabulary and the video's block 0 are tensors on
    the loader's device, put there once."""
    assert all(isinstance(t, torch.Tensor) and t.device.type == 'cpu'
               for t in loaded.weights.values())
    assert list(loaded.weights) == sorted(loaded.weights)
    assert isinstance(loaded._emb, torch.Tensor)
    assert isinstance(loaded._rnn0, torch.Tensor)


def test_wrong_video_shape_rejected(artifact_env, loaded):
    with pytest.raises(ValueError, match='exported for video shape'):
        loaded.set_video(np.zeros((T + 1, DV), np.float32))


def test_export_requires_resident_video(artifact_env, tmp_path):
    g = MultiQueryGrounder(port_params(), artifact_env.state, device='cpu',
                           query_batch=4)
    with pytest.raises(ValueError, match='set_video'):
        export_grounder(g, str(tmp_path / 'never'))
    assert not (tmp_path / 'never').exists()


def test_programs_call_the_kernel_ops(artifact_env):
    """K1 and K2 are nodes of the exported graphs (``svtsg::*`` custom
    ops), not their plain versions inlined; precompute runs K1 only."""
    for name in artifact_env.manifest['functions']:
        program = torch.export.load(os.path.join(
            artifact_env.out, aot.program_file(name, 'cpu')))
        ops = {str(n.target) for n in program.graph.nodes
               if n.op == 'call_function'}
        assert 'svtsg.lstm_recurrence.default' in ops, name
        assert ('svtsg.scdm_attention.default' in ops) == \
            (name != 'precompute'), name
    # block 0's recurrence alone: no gate of a plain recurrence inlined
    program = torch.export.load(os.path.join(
        artifact_env.out, aot.program_file('precompute', 'cpu')))
    assert not {'aten.sigmoid.default', 'aten.tanh.default'} & {
        str(n.target) for n in program.graph.nodes}


def test_programs_hold_no_weights(artifact_env):
    """The weights are the programs' first argument, never their
    constants, and the archives keep no example inputs."""
    weights = os.path.getsize(os.path.join(artifact_env.out, 'weights.ckp'))
    for name in artifact_env.manifest['functions']:
        path = os.path.join(artifact_env.out, aot.program_file(name, 'cpu'))
        program = torch.export.load(path)
        assert not program.state_dict and not program.constants, name
        assert program.example_inputs is None, name
        assert os.path.getsize(path) < weights, name


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('op', ['lstm_recurrence', 'scdm_attention'])
def test_opcheck_passes(op, dtype):
    rng = np.random.RandomState(7)
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(dt)
    if op == 'lstm_recurrence':
        fn, args = lstm_recurrence_op, (t(5, 3, 64), t(2, 8, 32, scale=0.2))
    else:
        fn, args = scdm_attention_op, (t(2, 6, 8), t(2, 5, 8), t(8),
                                       t(2, 5, 4))
    torch.library.opcheck(fn, args)


def test_another_checkpoints_weights(artifact_env, tmp_path):
    """One artifact serves any checkpoint of the architecture: another
    checkpoint's reference ``.ckp`` in place of ``weights.ckp`` gives that
    checkpoint's live answers."""
    _, other = _jax_weights(1)
    live = MultiQueryGrounder(port_params(), other, device='cpu',
                              query_batch=QB)
    live.set_video(artifact_env.video)
    q = np.random.RandomState(8).randn(13, N, 300).astype(np.float32)
    want = live.ground(None, q)
    copy = str(tmp_path / 'other')
    shutil.copytree(artifact_env.out, copy)
    torch.save(other, os.path.join(copy, 'weights.ckp'))
    e = load_grounder_artifact(copy, device='cpu')
    e.set_video(artifact_env.video)
    _equal(e.ground(q), want)
    assert not np.array_equal(want[1], artifact_env.g.ground(None, q)[1])


def test_export_bf16_equals_live(artifact_env, tmp_path):
    g = MultiQueryGrounder(port_params(precision='bf16'), artifact_env.state,
                           device='cpu', query_batch=QB)
    g.set_video(artifact_env.video)
    manifest = export_grounder(g, str(tmp_path))
    assert manifest['precision'] == 'bf16'
    e = load_grounder_artifact(str(tmp_path), device='cpu')
    e.set_video(artifact_env.video)
    q = np.random.RandomState(9).randn(11, N, 300).astype(np.float32)
    _equal(e.ground(q), g.ground(None, q))
    with pytest.raises(ValueError, match='without a vocab'):
        e.ground_tokens_video(np.zeros((2, N), np.int32))


def test_loader_needs_its_devices_program(artifact_env, tmp_path,
                                          monkeypatch):
    """The loader runs the program of its own device or raises: never
    another device's program nor the plain versions."""
    copy = str(tmp_path / 'copy')
    shutil.copytree(artifact_env.out, copy)
    with open(os.path.join(copy, 'manifest.json')) as f:
        manifest = json.load(f)
    with open(os.path.join(copy, 'manifest.json'), 'w') as f:
        json.dump(dict(manifest, platforms=['cuda']), f)
    with pytest.raises(ValueError, match='holds no cpu program'):
        ExportedGrounder(copy, device='cpu')
    with open(os.path.join(copy, 'manifest.json'), 'w') as f:
        json.dump(manifest, f)
    os.remove(os.path.join(copy, 'serve_tokens.cpu.pt2'))
    with pytest.raises(FileNotFoundError, match='serve_tokens'):
        ExportedGrounder(copy, device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ExportedGrounder(artifact_env.out)  # device defaults to cuda
    with pytest.raises(RuntimeError, match='machine with the card'):
        export_grounder(artifact_env.g, str(tmp_path / 'cuda'),
                        platforms=['cuda'])


def test_loader_imports_no_model_code(artifact_env):
    """A process that loads the artifact and serves from it imports no
    ``shufflingvideosfortsg_torch.models``."""
    code = (
        'import sys, numpy as np\n'
        'from shufflingvideosfortsg_torch.utils.aot import '
        'load_grounder_artifact\n'
        f'e = load_grounder_artifact({artifact_env.out!r}, device="cpu")\n'
        f'e.set_video(np.zeros(({T}, {DV}), np.float32))\n'
        f'spans, _ = e.ground(np.zeros((3, {N}, 300), np.float32))\n'
        'assert spans.shape == (3, 2)\n'
        'bad = [m for m in sys.modules\n'
        '       if m.startswith("shufflingvideosfortsg_torch.models")]\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('ok')


# --- the corpus tiers ----------------------------------------------------------

class _FakePack:
    """The feature-pack surface ``set_corpus`` reads."""

    def __init__(self, feats):
        self._f = feats
        self.num_videos = feats.shape[0]
        self.vid_to_row = {f'v{i}': i for i in range(self.num_videos)}
        self.raw_dtype = np.float32

    def gather_raw(self, rows):
        return self._f[np.asarray(rows)]


@pytest.fixture(scope='module')
def corpus_env(tmp_path_factory, artifact_env):
    """A bank of 6 videos (``set_videos``), the vocabulary resident."""
    videos = np.random.RandomState(11).randn(6, T, DV).astype(np.float32)
    g = MultiQueryGrounder(port_params(), artifact_env.state, device='cpu',
                           query_batch=QB)
    g.set_videos(videos)
    g.set_vocab(artifact_env.emb)
    out = str(tmp_path_factory.mktemp('aot_corpus'))
    return g, out, export_grounder(g, out), videos


def test_corpus_manifest(corpus_env):
    _, out, manifest, videos = corpus_env
    assert manifest['functions'] == ['serve_bank', 'serve_bank_tokens']
    assert manifest['num_videos'] == videos.shape[0]
    assert manifest['bank_dtype'] == 'float32'
    assert os.path.isfile(os.path.join(out, 'bank.npz'))


def test_exported_equals_live_bank(corpus_env):
    g, out, _, videos = corpus_env
    e = load_grounder_artifact(out, device='cpu')
    rng = np.random.RandomState(12)
    q = rng.randn(13, N, 300).astype(np.float32)
    ids = rng.randint(0, videos.shape[0], 13).astype(np.int32)
    _equal(e.ground_bank(q, ids), g.ground_bank(q, ids))
    with pytest.raises(ValueError, match='one video id per query'):
        e.ground_bank(q, ids[:3])
    with pytest.raises(IndexError, match='video ids'):
        e.ground_bank(q[:1], np.asarray([videos.shape[0]], np.int32))


def test_exported_equals_live_bank_tokens(corpus_env, artifact_env):
    g, out, _, videos = corpus_env
    e = load_grounder_artifact(out, device='cpu')
    rng = np.random.RandomState(13)
    tok = rng.randint(1, 50, (13, N)).astype(np.int32)
    ids = rng.randint(0, videos.shape[0], 13).astype(np.int32)
    _equal(e.ground_tokens(tok, ids), g.ground_tokens(tok, ids))
    with pytest.raises(ValueError, match='single-video tier'):
        e.set_video(artifact_env.video)


@pytest.mark.parametrize('tier,precision', [('int8', 'f32'),
                                            ('raw', 'bf16')])
def test_exported_corpus_tiers(tier, precision, artifact_env, tmp_path):
    """The int8 corpus exports as (values, scales) and the bf16 one as
    its values widened to f32 with the dtype recorded; each reloaded
    artifact gives the live grounder's answers bit for bit."""
    rng = np.random.RandomState(17)
    pack = _FakePack(rng.randn(5, T, DV).astype(np.float32))
    g = MultiQueryGrounder(port_params(precision=precision),
                           artifact_env.state, device='cpu', query_batch=QB)
    g.set_vocab(artifact_env.emb)
    g.set_corpus(pack, chunk_videos=2, dtype=tier)
    manifest = export_grounder(g, str(tmp_path))
    assert manifest['bank_dtype'] == ('int8' if tier == 'int8'
                                      else 'bfloat16')
    with np.load(os.path.join(str(tmp_path), 'bank.npz')) as z:
        assert sorted(z) == (['bank_q', 'bank_s'] if tier == 'int8'
                             else ['bank'])
    e = load_grounder_artifact(str(tmp_path), device='cpu')
    tok = rng.randint(1, 50, (9, N)).astype(np.int32)
    ids = rng.randint(0, 5, 9).astype(np.int32)
    _equal(e.ground_tokens(tok, ids), g.ground_tokens(tok, ids))


def test_bank_tier_missing_raises(loaded):
    with pytest.raises(ValueError, match='corpus bank'):
        loaded.ground_bank(np.zeros((2, N, 300), np.float32),
                           np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match='token corpus tier'):
        loaded.ground_tokens(np.zeros((2, N), np.int32),
                             np.zeros((2,), np.int32))


# --- the command line ------------------------------------------------------------

TINY = ['--video_feature_dim', '32', '--video_len', '24', '--sent_len', '8',
        '--sent_rnn_hiddendim', '8', '--video_rnn_hiddendim', '8',
        '--mlp_hidden_dim', '8', '--m_pred_hidden', '16',
        '--batch_size', '8', '8', '8', '--batch_log_interval', '-1']


def test_export_serving_on_a_trained_ckp(tmp_path):
    """``python -m shufflingvideosfortsg_torch.export_serving`` (the port
    of ``tools/export_serving.py``) on the ``.ckp`` and ``params.json``
    of a tiny ``main_train`` run: the artifact serves, and equals a live
    grounder of that checkpoint."""
    root = str(tmp_path)
    params = cli.parse_params(['--cfg', 'charades_cd_i3d.yml'] + TINY,
                              default_model='GMD')
    anno, feats, vocab, _ = chip_smoke.write_corpus(
        root, params, n_videos=4, name='charades_train.json')
    argv = ['--cfg', 'charades_cd_i3d.yml', *TINY, '--runs',
            os.path.join(root, 'runs'), '--train_data', anno, '--val_data',
            anno, '--train_featpath', feats, '--valid_featpath', feats,
            '--wordtoix_path', vocab['wordtoix'], '--ixtoword_path',
            vocab['ixtoword'], '--word_fts_path',
            vocab['word_glove_fts_init'], '--alias', 'aot_tool', '--epoch',
            '1', '--device', 'cpu']
    cli.main_train(cli.parse_params(argv, default_model='GMD'))
    run = os.path.join(root, 'runs', 'aot_tool')
    ckp = os.path.join(run, 'model', 'aot_tool_00000.ckp')
    out = os.path.join(root, 'artifact')
    res = subprocess.run(
        [sys.executable, '-m', 'shufflingvideosfortsg_torch.export_serving',
         '--cfg', os.path.join(run, 'params.json'), '--ckpt', ckp, '--out',
         out, '--query_batch', '4', '--device', 'cpu', '--platforms', 'cpu'],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "exported ['precompute', 'serve_features', 'serve_tokens']" in \
        res.stdout and 'bytes' in res.stdout
    e = load_grounder_artifact(out, device='cpu')
    rng = np.random.RandomState(0)
    video = rng.randn(24, 32).astype(np.float32)
    q = rng.randn(6, 8, 300).astype(np.float32)
    e.set_video(video)
    got = e.ground(q)
    with open(os.path.join(run, 'params.json')) as f:
        trained = json.load(f)
    live = MultiQueryGrounder(trained, torch.load(ckp, weights_only=True),
                              device='cpu', query_batch=4)
    _equal(got, live.ground(video, q))
    assert (got[0][:, 1] >= got[0][:, 0]).all()


# --- on a card ---------------------------------------------------------------------

@pytest.mark.requires_cuda
def test_exported_equals_live_on_cuda(tmp_path):
    """The CUDA program through K1 and K2 (their counters rise) equals the
    live grounder on the card bit for bit (weights from a torch seed: the
    card's machine has no JAX)."""
    from shufflingvideosfortsg_torch.ops import lstm_scan, scdm_fused
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        state = build_model(port_params(), 'gmd', device='cpu').state_dict()
    video = np.random.RandomState(15).randn(T, DV).astype(np.float32)
    g = MultiQueryGrounder(port_params(), state, device='cuda',
                           query_batch=QB)
    g.set_video(video)
    export_grounder(g, str(tmp_path), platforms=['cuda'])
    e = load_grounder_artifact(str(tmp_path), device='cuda')
    e.set_video(video)
    q = np.random.RandomState(14).randn(19, N, 300).astype(np.float32)
    k1, k2 = (lstm_scan.lstm_recurrence.launches,
              scdm_fused.scdm_attention_fused.launches)
    got = e.ground(q)
    # 3 batches, each a K1 for the one-layer sentence encoder and one for
    # block 1's one-layer BiLSTM, and a K2 a block
    assert (lstm_scan.lstm_recurrence.launches - k1,
            scdm_fused.scdm_attention_fused.launches - k2) == (6, 6)
    _equal(got, g.ground(None, q))
