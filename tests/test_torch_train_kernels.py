"""The port's training kernels: the plain versions of K3 (train forward),
K4 (backward) and K5 (trainable SCDM attention) against the JAX package's
Pallas kernels run in interpret mode, the autograd Function that joins K3
and K4 against ``jax.grad`` of ``lstm_flat_fused``, and each CUDA kernel
against its plain version where a card exists.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_train_kernels.py
"""

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch.ops.lstm_scan import (
    LSTMRecurrence, lstm_recurrence, lstm_recurrence_bwd,
    lstm_recurrence_bwd_plain, lstm_recurrence_plain, lstm_recurrence_train,
    lstm_recurrence_train_plain)
from shufflingvideosfortsg_torch.ops.scdm_fused import (
    scdm_attention_fused, scdm_attention_fused_trainable,
    scdm_attention_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-5        # f32, sums in another order than XLA's
GRAD_ATOL, GRAD_RTOL = 5e-6, 1e-4  # tests/test_pallas_lstm.py's VJP test


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _lstm_inputs(seed, T, B, H):
    rng = np.random.RandomState(seed)
    xw = rng.randn(T, B, 8 * H).astype(np.float32)
    w_hh = (rng.randn(2, H, 4 * H) * 0.1).astype(np.float32)
    return xw, w_hh


def _cotangents(seed, T, B, H):
    rng = np.random.RandomState(seed + 1)
    return (rng.randn(T, B, 2 * H).astype(np.float32),
            rng.randn(2, B, H).astype(np.float32),
            rng.randn(2, B, H).astype(np.float32))


def _scdm_inputs(seed, B, T, N, Dh, Ds):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, Dh).astype(np.float32),
            rng.randn(B, N, Dh).astype(np.float32),
            (rng.randn(Dh) / np.sqrt(Dh)).astype(np.float32),
            rng.randn(B, N, Ds).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize('T,B,H', [(12, 4, 8), (7, 2, 8), (16, 8, 16),
                                   (33, 3, 8)])
def test_k3_plain_matches_pallas_train_kernel(T, B, H):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (
        lstm_scan_pallas_train_flat)
    xw, w_hh = _lstm_inputs(T * 100 + B, T, B, H)
    want = lstm_scan_pallas_train_flat(jnp.asarray(xw), jnp.asarray(w_hh),
                                       interpret=True)
    got = lstm_recurrence_train_plain(*_t((xw, w_hh)))
    for name, g, w in zip(('out', 'c_seq', 'h_T', 'c_T'), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize('T,B,H', [(9, 3, 8), (12, 4, 16), (7, 2, 8)])
def test_k4_plain_matches_pallas_bwd_kernel(T, B, H):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (
        lstm_scan_pallas_bwd_flat, lstm_scan_pallas_train_flat)
    xw, w_hh = _lstm_inputs(T + B, T, B, H)
    out, c_seq, _, _ = (np.asarray(a) for a in lstm_scan_pallas_train_flat(
        jnp.asarray(xw), jnp.asarray(w_hh), interpret=True))
    d_out, d_hT, d_cT = _cotangents(T + B, T, B, H)
    args = (xw, w_hh, out, c_seq, d_out, d_hT, d_cT)
    want = lstm_scan_pallas_bwd_flat(*map(jnp.asarray, args), interpret=True)
    got = lstm_recurrence_bwd_plain(*_t(args))
    for name, g, w in zip(('d_xw', 'd_w_hh'), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize('T,B,H', [(9, 3, 8), (12, 4, 16), (7, 2, 8)])
def test_lstm_function_grads_match_jax_lstm_flat_fused(T, B, H):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import lstm_flat_fused
    xw, w_hh = _lstm_inputs(T * 7 + B, T, B, H)
    co, co_h, co_c = _cotangents(T * 7 + B, T, B, H)

    def jax_loss(x, w):
        o, h, c = lstm_flat_fused(x, w)
        return jnp.sum(o * co) + jnp.sum(h * co_h) + jnp.sum(c * co_c)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(xw),
                                                  jnp.asarray(w_hh))
    x, w = (a.requires_grad_() for a in _t((xw, w_hh)))
    o, h, c = lstm_recurrence(x, w)
    assert o.grad_fn is not None and 'LSTMRecurrence' in type(o.grad_fn).__name__
    ((o * torch.from_numpy(co)).sum() + (h * torch.from_numpy(co_h)).sum()
     + (c * torch.from_numpy(co_c)).sum()).backward()
    for name, g, ww in zip(('xw', 'w_hh'), (x.grad, w.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize('unused', ['h_T', 'c_T'])
def test_lstm_function_takes_outputs_without_a_gradient(unused):
    """An output that reaches no loss gets a zero cotangent; the gradient
    equals autograd through the plain forward (the third oracle)."""
    T, B, H = 6, 2, 8
    xw, w_hh = _lstm_inputs(5, T, B, H)
    grads = []
    for fn in (LSTMRecurrence.apply, lstm_recurrence_plain):
        x, w = (a.requires_grad_() for a in _t((xw, w_hh)))
        o, h, c = fn(x, w)
        kept = c if unused == 'h_T' else h
        (o.square().sum() + kept.sum()).backward()
        grads.append((x.grad, w.grad))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('N', [7, 25])
def test_k5_backward_matches_jax_vjp(N):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from shufflingvideosfortsg_tpu.ops.pallas.scdm_fused import (
        scdm_attention_fused_trainable as jax_trainable)
    arrays = _scdm_inputs(N + 3, 8, 20, N, 24, 16)
    g_out = np.random.RandomState(N).randn(8, 20, 16).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out_j, vjp = jax.vjp(jax_trainable, *map(jnp.asarray, arrays))
        want = vjp(jnp.asarray(g_out))
    inputs = [a.requires_grad_() for a in _t(arrays)]
    out = scdm_attention_fused_trainable(*inputs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=TOL, rtol=0)
    out.backward(torch.from_numpy(g_out))
    for name, t, w in zip(('video_proj', 'sent_proj', 'w', 'sent_feat'),
                          inputs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=1e-4, err_msg=name)


def test_wrappers_route_by_gradient_need_on_cpu():
    """Without gradients the K1 wrapper gives the plain recurrence; with
    them it goes through the K3/K4 Function; the plain versions count no
    launch."""
    xw, w_hh = _t(_lstm_inputs(1, 5, 2, 8))
    before = (lstm_recurrence.launches, lstm_recurrence_train.launches,
              lstm_recurrence_bwd.launches)
    with torch.no_grad():
        assert lstm_recurrence(xw, w_hh)[0].grad_fn is None
    o, _, _ = lstm_recurrence(xw, w_hh.requires_grad_())
    o.sum().backward()
    assert w_hh.grad is not None
    assert (lstm_recurrence.launches, lstm_recurrence_train.launches,
            lstm_recurrence_bwd.launches) == before


def test_k4_wrapper_checks_shapes():
    T, B, H = 4, 2, 8
    xw, w_hh = _t(_lstm_inputs(2, T, B, H))
    out, c_seq, _, _ = lstm_recurrence_train(xw, w_hh)
    d_out, d_hT, d_cT = _t(_cotangents(2, T, B, H))
    with pytest.raises(ValueError, match='c_seq'):
        lstm_recurrence_bwd(xw, w_hh, out, c_seq[:, :1], d_out, d_hT, d_cT)
    with pytest.raises(TypeError, match='float32'):
        lstm_recurrence_bwd(xw, w_hh, out, c_seq, d_out.double(), d_hT, d_cT)
    meta = [torch.empty(a.shape, device='meta')
            for a in (xw, w_hh, out, c_seq, d_out, d_hT, d_cT)]
    with pytest.raises(ValueError, match='CUDA'):
        lstm_recurrence_bwd(*meta)
    with pytest.raises(ValueError, match='CUDA'):
        lstm_recurrence_train(*meta[:2])


# --- on the card -----------------------------------------------------------

K3_CUDA_TOL = 1e-4  # as K1: f32 sums over H in another order, T dependent steps
K4_CUDA_RTOL, K4_CUDA_ATOL = 1e-3, 1e-4  # d_w_hh sums T*B terms per element
K5_CUDA_TOL = 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 64, 256), (15, 32, 256), (33, 5, 256),
                                   (1, 3, 64), (9, 2, 8), (64, 16, 512),
                                   (20, 3, 304)])
def test_k3_k4_kernels_match_plain_on_cuda(T, B, H):
    xw, w_hh = (torch.from_numpy(a).cuda() for a in _lstm_inputs(T + B, T, B, H))
    cot = [torch.from_numpy(a).cuda() for a in _cotangents(T + B, T, B, H)]
    before = lstm_recurrence_train.launches, lstm_recurrence_bwd.launches
    got = lstm_recurrence_train(xw, w_hh)
    want = lstm_recurrence_train_plain(xw, w_hh)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert (g - w).abs().max().item() <= K3_CUDA_TOL
    args = (xw, w_hh, want[0], want[1], *cot)
    for g, w in zip(lstm_recurrence_bwd(*args), lstm_recurrence_bwd_plain(*args)):
        torch.cuda.synchronize()
        torch.testing.assert_close(g, w, rtol=K4_CUDA_RTOL, atol=K4_CUDA_ATOL)
    assert (lstm_recurrence_train.launches, lstm_recurrence_bwd.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N', [(64, 128, 15), (3, 20, 7)])
def test_k5_matches_plain_autograd_on_cuda(B, T, N):
    arrays = _scdm_inputs(N, B, T, N, 64, 32)
    g_out = torch.from_numpy(
        np.random.RandomState(1).randn(B, T, 32).astype(np.float32)).cuda()
    grads = []
    before = scdm_attention_fused.launches, scdm_attention_fused_trainable.launches
    for fn in (scdm_attention_fused_trainable, scdm_attention_plain):
        inputs = [torch.from_numpy(a).cuda().requires_grad_() for a in arrays]
        fn(*inputs).backward(g_out)
        grads.append([t.grad for t in inputs])
    torch.cuda.synchronize()
    assert (scdm_attention_fused.launches,
            scdm_attention_fused_trainable.launches) == \
        (before[0] + 1, before[1] + 1)
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=K5_CUDA_TOL)


@pytest.mark.requires_cuda
def test_gmd_train_step_at_the_wide_widths_matches_the_cpu_on_cuda():
    """A GMD train step's loss and gradients at ``video_rnn_hiddendim=512``
    (the recurrences read W_hh from device memory) and ``sent_len=40`` (the
    attention past 32 words) on the kernels, against the same step on the
    CPU's plain versions from the same weights, batch and pseudo videos.
    ``chip_smoke.py`` ``[wide]`` holds it against the plain versions on the
    card at the full width."""
    from shufflingvideosfortsg_torch.config import load_config
    from shufflingvideosfortsg_torch.models.build import build_model
    from shufflingvideosfortsg_torch.profile_train import train_batch
    from shufflingvideosfortsg_torch.train.state import TrainState
    from shufflingvideosfortsg_torch.train.steps import (_device_pseudo,
                                                         make_gmd_train_step)
    params = load_config('charades_cd_i3d.yml')
    params.update(video_rnn_hiddendim=512, sent_len=40, video_len=32,
                  dropout=0.0, disc_dropout=0.0)
    torch.manual_seed(0)
    batch = train_batch(params, 8, 'cpu', seed=0)
    pseudo = _device_pseudo(batch, torch.Generator().manual_seed(0))
    results = []
    for dev in ('cpu', 'cuda'):
        torch.manual_seed(0)
        model = build_model(params, 'gmd', device='cpu').to(dev).train()
        step = make_gmd_train_step(model, TrainState(model, params, 10),
                                   params)
        before = (lstm_recurrence_train.launches,
                  lstm_recurrence_bwd.launches,
                  scdm_attention_fused_trainable.launches)
        loss, aux = step.loss_fn({k: v.to(dev) for k, v in batch.items()},
                                 {k: v.to(dev) for k, v in pseudo.items()},
                                 None)
        loss.backward()
        launched = [a - b for a, b in zip(
            (lstm_recurrence_train.launches, lstm_recurrence_bwd.launches,
             scdm_attention_fused_trainable.launches), before)]
        results.append(({k: float(aux[k].detach()) for k in
                         ('loss', 'loss_g', 'loss_intra', 'loss_inter',
                          'loss_d')},
                        {k: p.grad.cpu() for k, p in model.named_parameters()},
                        launched))
    (want, want_g, _), (got, got_g, launched) = results
    assert launched == [6, 6, 2]
    # the CPU's plain versions sum in other orders than the card's kernels
    # and cuBLAS: the loss tolerances of tests/test_grad_parity.py (the
    # matching KL term is a difference of near-equal distributions, 1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4 if k == 'loss'
                                   else 5e-4, atol=1e-5, err_msg=k)
    for k, g in got_g.items():
        torch.testing.assert_close(g, want_g[k], rtol=K4_CUDA_RTOL,
                                   atol=K4_CUDA_ATOL, msg=k)
