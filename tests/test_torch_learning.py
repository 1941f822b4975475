"""The learning and debiasing experiment on the port
(``shufflingvideosfortsg_torch/run_learning.py``), at sizes the CPU takes.

- The synthetic vocabulary (``data/vocab.write_synthetic_vocab``): every
  word alphabetic, read by both packages' ``Vocab.load``, taken by
  ``tools/make_signal_corpus.py``.
- ``python -m shufflingvideosfortsg_torch.run_learning --smoke --device
  cpu --epochs 2`` end to end: ``learning.json`` in ``LEARNING.json``'s
  results schema, every number finite; a corpus made with other
  arguments is refused; ``--device cuda`` raises without a card.
- The learning check, on ``tests/test_learning.py``'s seed-0 corpus and
  dims (8 epochs, validation at epochs 3 and 7) with the synthetic
  vocabulary: the port's QAVE baseline reaches a validation mIoU above
  45 (that test's bar of 0.45 read as a fraction: the drivers'
  statistics are percentages), the port's GMD above 30 (more than twice
  the corpus's chance of about 12), and JAX's baseline, trained through
  the JAX package's driver on the same corpus and vocabulary in a child
  process (``tests/learning_refs.py``), above 45 too.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import learning_refs
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_BAR = 45.0  # tests/test_learning.py:340, as a percentage
GMD_BAR = 30.0
# tests/test_learning.py:306-313 and :326-335
CORPUS_FLAGS = ['--t', '32', '--d', '64', '--concepts', '12',
                '--phrase-len', '3', '--word-pool', '40', '--train', '256',
                '--val', '64', '--iid', '8', '--ood', '8', '--len-min', '4',
                '--len-max', '10', '--signal', '1.0', '--seed', '0']
DIMS = dict(video_len=32, video_feature_dim=64, sent_len=15,
            sent_rnn_hiddendim=32, video_rnn_hiddendim=32, mlp_hidden_dim=32,
            span_hidden_dim=16, m_pred_hidden=32, epoch=8, test_interval=4,
            save_model_interval=99, batch_log_interval=-1,
            batch_size=[64, 64, 64], start_from=None)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A synthetic vocabulary and the seed-0 signal corpus over it."""
    from shufflingvideosfortsg_torch.data.vocab import write_synthetic_vocab
    root = tmp_path_factory.mktemp('torch_learning')
    vocab = write_synthetic_vocab(str(root / 'words'), 400, seed=0)
    out = str(root / 'corpus')
    subprocess.run([sys.executable,
                    os.path.join(REPO, 'tools', 'make_signal_corpus.py'),
                    '--out', out, '--words-dir', str(root / 'words'),
                    *CORPUS_FLAGS], check=True, capture_output=True)
    return root, out, vocab


def overrides(root, corpus, vocab, alias):
    anno = os.path.join(corpus, 'annotations')
    return dict(DIMS, alias=alias, runs=str(root / 'runs'),
                train_data=os.path.join(anno, 'charades_train.json'),
                val_data=os.path.join(anno, 'charades_val.json'),
                train_featpath=os.path.join(corpus, 'pack'),
                valid_featpath=os.path.join(corpus, 'pack'),
                wordtoix_path=vocab['wordtoix'],
                ixtoword_path=vocab['ixtoword'],
                word_fts_path=vocab['word_glove_fts_init'])


@pytest.fixture(scope='module')
def jax_baseline(corpus):
    """JAX's baseline on the corpus, started in a child process now and
    waited for by the test that asks for its result."""
    root, out, vocab = corpus
    return learning_refs.start(root, overrides(root, out, vocab,
                                               'learn_jax_base'))


def test_synthetic_vocab_is_alphabetic_and_both_packages_read_it(
        corpus, jax_baseline):
    from shufflingvideosfortsg_torch.data.vocab import Vocab
    from shufflingvideosfortsg_tpu.data.vocab import Vocab as JaxVocab
    root, out, vocab = corpus
    args = (vocab['wordtoix'], vocab['ixtoword'], vocab['word_glove_fts_init'])
    port, jax_vocab = Vocab.load(*args), JaxVocab.load(*args)
    words = [w for w in port.wordtoix if w != '#START#']
    assert len(words) == 400 and all(w.isalpha() for w in words)
    assert port.wordtoix == jax_vocab.wordtoix
    assert port.ixtoword == jax_vocab.ixtoword
    assert port.ixtoword[0] == '.' and port.wordtoix['#START#'] == 0
    assert port.embeddings.shape == (401, 300)
    np.testing.assert_array_equal(port.embeddings, jax_vocab.embeddings)
    # the generator took it: every phrase is three of its words
    with open(os.path.join(out, 'meta.json')) as f:
        phrases = json.load(f)['phrases']
    assert len(phrases) == 12
    assert all(len(p.split()) == 3 and all(w in port.wordtoix
                                           for w in p.split())
               for p in phrases)


def test_synthetic_vocab_is_made_from_its_seed(tmp_path):
    from shufflingvideosfortsg_torch.data.vocab import write_synthetic_vocab
    a = write_synthetic_vocab(str(tmp_path / 'a'), 50, seed=3)
    b = write_synthetic_vocab(str(tmp_path / 'b'), 50, seed=3)
    c = write_synthetic_vocab(str(tmp_path / 'c'), 50, seed=4)
    for name in a:
        x, y = np.load(a[name], allow_pickle=True), np.load(
            b[name], allow_pickle=True)
        assert (x == y).all() if x.dtype != object else x.item() == y.item()
    assert np.load(a['wordtoix'], allow_pickle=True).item() != \
        np.load(c['wordtoix'], allow_pickle=True).item()


def _finite_numbers(obj):
    if isinstance(obj, dict):
        return all(_finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite_numbers(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return math.isfinite(obj)
    return True


def test_run_learning_smoke_end_to_end(tmp_path):
    """``run_learning --smoke --device cpu --epochs 2`` as a user runs it:
    both final checkpoints, ``learning.json`` in the results schema."""
    out = str(tmp_path / 'rl')
    proc = subprocess.run(
        [sys.executable, '-m', 'shufflingvideosfortsg_torch.run_learning',
         '--out', out, '--smoke', '--device', 'cpu', '--epochs', '2'],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out, 'learning.json')) as f:
        block = json.load(f)
    res = block['results']
    assert set(res) == {'gmd', 'qave', 'chance'}
    for kind in ('gmd', 'qave'):
        assert set(res[kind]) == {'val', 'test_iid', 'test_ood', 'r1_ood',
                                  'ckpt_epoch'}
        assert res[kind]['ckpt_epoch'] == 1 and len(res[kind]['r1_ood']) == 5
        assert os.path.isfile(os.path.join(
            out, 'runs', f'{kind}_s1', 'model', f'{kind}_s1_00001.ckp'))
    assert set(res['chance']) == {'test_ood'}
    assert block['corpus']['epochs'] == 2 and block['corpus']['smoke']
    assert block['device'] == {'platform': 'cpu'}
    assert block['timing']['total_s'] > 0
    assert _finite_numbers(block)
    with open(os.path.join(out, 'corpus', 'meta.json')) as f:
        assert json.load(f)['args']['words_dir'] == os.path.join(
            out, 'data', 'Charades', 'words')


def test_run_learning_refuses_a_corpus_of_other_arguments(tmp_path):
    from shufflingvideosfortsg_torch import run_learning
    corpus = tmp_path / 'corpus'
    corpus.mkdir()
    args = run_learning.parse_args(['--out', str(tmp_path), '--smoke',
                                    '--device', 'cpu'])
    args.words_dir = str(tmp_path / 'words')
    meta = dict(run_learning.corpus_args(args), seed=2)
    (corpus / 'meta.json').write_text(json.dumps({'args': meta}))
    with pytest.raises(SystemExit, match='different parameters'):
        run_learning.build_corpus(str(tmp_path), args)


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_run_learning_on_cuda_raises_without_a_card(tmp_path):
    from shufflingvideosfortsg_torch import run_learning
    with pytest.raises(RuntimeError, match='needs an NVIDIA GPU'):
        run_learning.main(['--out', str(tmp_path / 'x'), '--smoke'])
    assert not os.path.exists(tmp_path / 'x')


def _train(corpus, kind, alias):
    from shufflingvideosfortsg_torch import cli
    from shufflingvideosfortsg_torch.config import load_config
    root, out, vocab = corpus
    params = load_config(os.path.join(REPO, 'cfgs', 'charades_cd_i3d.yml'),
                         overrides=dict(overrides(root, out, vocab, alias),
                                        device='cpu'))
    trainer = cli.main_train_baseline if kind == 'qave' else cli.main_train
    return trainer(params)['mIoU']


def test_port_baseline_learns_the_signal_corpus(corpus):
    mious = _train(corpus, 'qave', 'learn_port_base')
    assert len(mious) == 2 and max(mious.values()) > BASELINE_BAR, mious


def test_port_gmd_learns_the_signal_corpus(corpus):
    mious = _train(corpus, 'gmd', 'learn_port_gmd')
    assert len(mious) == 2 and max(mious.values()) > GMD_BAR, mious


def test_jax_baseline_learns_the_same_corpus(jax_baseline):
    mious = jax_baseline.result()['mIoU']
    assert len(mious) == 2 and max(mious.values()) > BASELINE_BAR, mious
