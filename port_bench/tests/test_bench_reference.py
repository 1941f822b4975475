"""The plain reference against the port's plain path (its kernels' CPU
versions) at tiny widths: the same weights, batches and draws give the
same losses, gradients, updates and answers to f32 rounding."""

import numpy as np
import torch

from conftest import SEED, TINY
from harness import check, common, reference, seeded, traffic
from harness.train import _reference_batches


def _setup():
    params = common.port_params(TINY)
    corpus = traffic.build_corpus(TINY, common.ROOT)
    T, D = params['video_len'], params['video_feature_dim']
    words = seeded.words(SEED, corpus.vocab_size, 300, 'cpu')
    bank = common.bank(corpus, words, SEED, T, D, 'cpu')
    w0 = seeded.weights(common.shapes(params), SEED, 'cpu')
    cfg = {'sent_layers': 2, 'video_layers': 2, 'nblocks': 2,
           'dropout': 0.5, 'disc_dropout': 0.5}
    return params, corpus, T, D, words, bank, w0, cfg


def test_three_train_steps_agree():
    from shufflingvideosfortsg_torch.data.device_bank import INDEX_KEYS
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import (make_gmd_train_step,
                                                          to_device)
    params, corpus, T, D, words, bank, w0, cfg = _setup()
    B = params['batch_size'][0]
    model = common.port_model(params, w0, 'cpu').train()
    state = TrainState(model, params, steps_per_epoch=100)
    step = make_gmd_train_step(model, state, params, False, bank.assemble)
    gen = seeded.generator(SEED, 'train', 0, 'cpu')
    order = traffic.epoch_order(corpus.num_pairs, SEED, 0)
    names = {p: n for n, p in model.named_parameters()}
    losses, first = [], None
    for k in range(3):
        b = traffic.index_batch(corpus, order[k * B:(k + 1) * B], T)
        out = step(bank.attach(to_device(b, 'cpu', INDEX_KEYS)), gen)
        losses.append(float(out['loss']))
        if k == 0:
            parts = {t: float(out[t]) for t in reference.TERMS}
            first = {names[p]: s['exp_avg'] / 0.1
                     for p, s in state.optimizer.state.items()}
    change = {n: p.detach() - w0[n] for n, p in model.named_parameters()}
    ref = reference.train_steps(
        w0, cfg, _reference_batches(corpus, words, SEED, T, D, B, 'cpu'),
        seeded.generator(SEED, 'train', 0, 'cpu'), 1e-3, 1e-4)
    numbers = check.train_numbers(losses, ref[0], first, ref[1], ref[2],
                                  change, ref[3], parts, ref[4])
    assert numbers['first_loss_gap'] < 1e-6
    assert numbers['loss_gap'] < 1e-6
    assert numbers['first_grad_gap'] < 1e-4
    assert numbers['change_gap'] < 1e-4


def test_answers_agree():
    from shufflingvideosfortsg_torch.data.device_bank import INDEX_KEYS
    from shufflingvideosfortsg_torch.train.steps import (make_gmd_test_step,
                                                          to_device)
    params, corpus, T, D, words, bank, w0, cfg = _setup()
    model = common.port_model(params, w0, 'cpu').eval()
    b = traffic.index_batch(corpus, np.arange(16), T)
    out = make_gmd_test_step(model, False, bank.assemble)(
        bank.attach(to_device(b, 'cpu', INDEX_KEYS)))
    video = seeded.rows_features(SEED, corpus.nfeats, b['pack_row'], T, D,
                                 'cpu').float()
    start, end = reference.Model(w0, cfg).ground(
        video, words[torch.as_tensor(b['token_ids'])])
    numbers = check.answer_numbers(out['pred_time'].numpy().round(),
                                   out['score'].numpy(), start, end)
    assert numbers['score_gap'] < 1e-5 and numbers['span_gap'] < 1e-5
    se = torch.as_tensor(b['framestps'])
    assert abs(float(out['loss']) - float(reference.nll(start, end, se)
                                          .mean())) < 1e-5
    spans, scores = reference.decode(start, end)
    assert np.array_equal(spans.numpy(), out['pred_time'].numpy().round())


def test_block0_bank_is_the_recurrence():
    """Serving's cached rows: the reference's block 0 against the port's
    ``precompute_video``."""
    params, corpus, T, D, words, bank, w0, cfg = _setup()
    model = common.port_model(params, w0, 'cpu').eval()
    video = seeded.rows_features(SEED, corpus.nfeats, range(5), T, D,
                                 'cpu').float()
    with torch.no_grad():
        got = model.precompute_video(video)
    want = reference.Model(w0, cfg).block0(video)
    assert (got - want).abs().max() < 1e-5


def test_features_made_again_from_the_seed():
    corpus = traffic.build_corpus(TINY, common.ROOT)
    whole = seeded.features(SEED, corpus.nfeats, 12, 16, 'cpu')
    rows = [3, 69, 64, 0]
    again = seeded.rows_features(SEED, corpus.nfeats, rows, 12, 16, 'cpu')
    assert torch.equal(whole[rows], again)
    n = int(corpus.nfeats[3])
    assert whole[3, n:].abs().sum() == 0 and whole[3, :n].abs().sum() > 0
    other = seeded.features(SEED + 1, corpus.nfeats, 12, 16, 'cpu')
    assert not torch.equal(whole, other)
