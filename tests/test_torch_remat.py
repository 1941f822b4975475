"""``remat`` (JAX ``models/components.py:211-239``: ``nn.remat`` of each
QAVE block) in the port: ``torch.utils.checkpoint`` around each block,
its dropout masks drawn before the call. With dropout on and an explicit
generator, ``remat: True`` gives the loss, the gradients, the weights
after three updates and the generator's state of ``remat: False``, bit
for bit, for GMD and the baseline, in f32 and bf16, and the backward does
recompute each block. Then the GMD train steps of the chip's V1 (remat
on) and V2 configurations against the JAX package's at dropout 0: loss
terms and gradients at ``tests/test_grad_parity.py``'s tolerances, the
JAX references computed in child processes side by side
(``tests/variant_refs.py``).
"""

import numpy as np
import pytest
import torch

import variant_refs
from shufflingvideosfortsg_torch.models import components as C
from shufflingvideosfortsg_torch.models.build import build_model
from shufflingvideosfortsg_torch.profile_train import train_batch
from shufflingvideosfortsg_torch.train.state import TrainState
from shufflingvideosfortsg_torch.train.steps import (HOST_PAIR_KEYS,
                                                     make_baseline_train_step,
                                                     make_gmd_train_step)
from shufflingvideosfortsg_torch.utils.interop import state_dict_from_jax
from test_torch_train import _batch, _params, _t
from torch_one_thread import one_torch_thread  # noqa: F401

STEPS = 3
MAKE_STEP = {'gmd': make_gmd_train_step, 'baseline': make_baseline_train_step}


@pytest.fixture(scope='module', autouse=True)
def children(tmp_path_factory):
    """JAX's V1 and V2 train-step references, one child process each,
    computed while the remat tests run."""
    kids = variant_refs.Children(
        [[f'train:{c}'] for c in variant_refs.TRAIN_CONFIGS],
        tmp_path_factory.mktemp('variant_refs'))
    yield kids
    kids.close()


def _steps(kind, params, weights, remat, calls):
    """``STEPS`` train steps of a model with ``weights`` and ``remat``, the
    on-device pseudo videos and dropout drawn from one seeded generator:
    (metrics, gradients and weights after each step, the generator's
    state)."""
    params = dict(params, remat=remat)
    model = build_model(params, kind, device='cpu').train()
    model.load_state_dict(weights)
    assert model.video_encoder.remat == remat
    step = MAKE_STEP[kind](model, TrainState(model, params,
                                             steps_per_epoch=10), params)
    batch = train_batch(params, 4, 'cpu', seed=1)
    gen = torch.Generator().manual_seed(7)
    runs = []
    for _ in range(STEPS):
        calls.clear()
        metrics = step(batch, gen)
        runs.append((calls.copy(), {k: v.clone() for k, v in metrics.items()},
                     {k: p.grad.clone() for k, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    return runs, gen.get_state()


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['gmd', 'baseline'])
def test_remat_changes_no_bit(kind, precision, monkeypatch):
    params = _params(precision=precision, dropout=0.5, disc_dropout=0.5,
                     on_device_aug=True, video_rnn_hiddendim=8)
    calls = []
    forward = C.RNNRecalibrationLayer.forward

    def counted(self, *args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(C.RNNRecalibrationLayer, 'forward', counted)
    torch.manual_seed(3)
    weights = build_model(params, kind, device='cpu').state_dict()
    off, off_gen = _steps(kind, params, weights, False, calls)
    on, on_gen = _steps(kind, params, weights, True, calls)
    for n, ((calls_on, *got), (calls_off, *want)) in enumerate(zip(on, off)):
        # without remat each of the 2 blocks runs once a step; with it,
        # once in the forward and once more in the backward
        assert (len(calls_off), len(calls_on)) == (2, 4), n
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), f'step {n + 1}: {k}'
    assert torch.equal(on_gen, off_gen)
    assert on[0][1]['loss'].item() > 0


def test_remat_draws_the_masks_of_a_run_without_it():
    """The masks a checkpointed block applies are the uniform draws of
    ``BiLSTM.dropout_draws``, which are the draws its forward makes."""
    lstm = C.BiLSTM(6, 4, 3, 0.5).train()
    x = torch.randn(2, 5, 6)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    want = lstm(x, g1)
    draws = lstm.dropout_draws(2, 5, x.device, g2)
    assert [tuple(d.shape) for d in draws] == [(2, 5, 8)] * 2
    got = lstm(x, torch.Generator().manual_seed(99), draws)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert lstm.eval().dropout_draws(2, 5, x.device, g2) is None


# --- V1 and V2 train steps against JAX ---------------------------------------

@pytest.fixture(scope='module')
def train_refs(children):
    return children.wait()


@pytest.mark.parametrize('config', list(variant_refs.TRAIN_CONFIGS))
def test_gmd_train_step_matches_jax(config, train_refs):
    """Dropout 0, the host-made pseudo stream of tests/test_torch_train.py:
    the loss within rtol 2e-4, its terms within 5e-4, each gradient within
    atol 1e-6, rtol 2e-3 (tests/test_grad_parity.py)."""
    weights, jaux, jgrads = train_refs[f'train:{config}']
    params = _params(**variant_refs.TRAIN_CONFIGS[config])
    b = _batch(n_words=params['sent_len'])
    model = build_model(params, 'gmd', device='cpu').train()
    model.load_state_dict(state_dict_from_jax(weights), strict=True)
    assert model.video_encoder.__class__ is (
        C.QueryAwareEncoder if config == 'V1' else C.VideoRNNEncoder)
    step = make_gmd_train_step(model, TrainState(model, params,
                                                 steps_per_epoch=2), params)
    tb = {k: _t(b[k]) for k in HOST_PAIR_KEYS}
    pseudo = {k[len('pseudo_'):]: v for k, v in tb.items()
              if k.startswith('pseudo_')}
    loss, aux = step.loss_fn(tb, pseudo, None)
    loss.backward()
    for k in ('loss', 'loss_g', 'loss_intra', 'loss_inter', 'loss_d'):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=2e-4 if k == 'loss' else 5e-4,
                                   atol=1e-5, err_msg=k)
    want = state_dict_from_jax(jgrads)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-6,
                                   rtol=2e-3, err_msg=k)
