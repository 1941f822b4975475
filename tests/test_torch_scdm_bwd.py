"""K5's backward: the plain gradients of the SCDM attention, written out
without autograd, against ``jax.vjp`` of the JAX package's
``scdm_attention_fused_trainable`` (its Pallas forward run in interpret
mode), the trainable Function's CPU route, and on a card the backward
kernel and the forward at widths past the old caps against the plain
versions.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_scdm_bwd.py
"""

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch.ops.scdm_fused import (
    _launch_backward, _scdm_bwd_launch, _ScdmAttentionTrainable,
    forward_tanh, scdm_attention_bwd,
    scdm_attention_bwd_core, scdm_attention_bwd_core_plain,
    scdm_attention_bwd_plain, scdm_attention_fused,
    scdm_attention_fused_trainable, scdm_attention_plain)

TOL = 1e-5  # f32, sums in another order than XLA's
NAMES = ('video_proj', 'sent_proj', 'w', 'sent_feat')


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _inputs(seed, B, T, N, Dh, Ds):
    """The attention's inputs at the model's scale (projections ~0.5, w
    ~1/sqrt(Dh)) and a cotangent of the context."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(B, T, Dh) * 0.5).astype(np.float32),
            (rng.randn(B, N, Dh) * 0.5).astype(np.float32),
            (rng.randn(Dh) / np.sqrt(Dh)).astype(np.float32),
            rng.randn(B, N, Ds).astype(np.float32),
            rng.randn(B, T, Ds).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize('B,T,N,Dh,Ds', [(8, 20, 7, 24, 16),
                                         (8, 20, 25, 24, 16),
                                         (8, 16, 40, 32, 24),
                                         (8, 8, 5, 1056, 1056)])
def test_bwd_plain_matches_jax_vjp(B, T, N, Dh, Ds):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from shufflingvideosfortsg_tpu.ops.pallas.scdm_fused import (
        scdm_attention_fused_trainable as jax_trainable)
    *arrays, g_out = _inputs(N + Dh, B, T, N, Dh, Ds)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_trainable, *map(jnp.asarray, arrays))
        want = vjp(jnp.asarray(g_out))
    got = scdm_attention_bwd_plain(*_t(arrays), torch.from_numpy(g_out))
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize('N', [7, 40])
def test_bwd_plain_matches_autograd_of_the_plain_forward(N):
    *arrays, g_out = _t(_inputs(N, 3, 11, N, 20, 12))
    inputs = [a.clone().requires_grad_() for a in arrays]
    want = torch.autograd.grad(scdm_attention_plain(*inputs), inputs, g_out)
    got = scdm_attention_bwd_plain(*arrays, g_out)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=1e-4, msg=name)


def test_trainable_on_cpu_takes_the_plain_backward_and_counts_nothing():
    *arrays, g_out = _t(_inputs(3, 4, 9, 6, 16, 8))
    before = (scdm_attention_fused.launches,
              scdm_attention_fused_trainable.launches)
    inputs = [a.clone().requires_grad_() for a in arrays]
    out = scdm_attention_fused_trainable(*inputs)
    assert 'ScdmAttentionTrainable' in type(out.grad_fn).__name__
    out.backward(g_out)
    want = scdm_attention_bwd_plain(*arrays, g_out)
    for name, t, w in zip(NAMES, inputs, want):
        assert torch.equal(t.grad, w), name
    assert (scdm_attention_fused.launches,
            scdm_attention_fused_trainable.launches) == before


def test_trainable_gives_gradients_only_where_asked():
    *arrays, g_out = _t(_inputs(4, 2, 5, 3, 8, 8))
    inputs = [a.clone() for a in arrays]
    inputs[2].requires_grad_()
    _ScdmAttentionTrainable.apply(*inputs).backward(g_out)
    assert inputs[2].grad is not None
    assert all(inputs[i].grad is None for i in (0, 1, 3))


def test_bwd_wrappers_check_shapes():
    *arrays, g_out = _t(_inputs(5, 2, 4, 3, 8, 8))
    with pytest.raises(ValueError, match='grad_out'):
        scdm_attention_bwd(*arrays, None, g_out[:, :2])
    P = torch.softmax(torch.randn(2, 4, 3), -1)
    with pytest.raises(ValueError, match='dP'):
        scdm_attention_bwd_core(arrays[0], arrays[1], arrays[2], P, P[:, :2])
    meta = [torch.empty(a.shape, device='meta') for a in (*arrays, g_out)]
    with pytest.raises(ValueError, match='CUDA'):
        scdm_attention_bwd(*meta[:4], torch.empty(2, 4, 3, device='meta'),
                           meta[4])


# --- on the card -----------------------------------------------------------

K2_CUDA_TOL = 1e-5
K5_CUDA_RTOL, K5_CUDA_ATOL = 1e-4, 1e-5
# d_w: each element sums B*T*N terms, whose f32 rounding scales with the
# terms, not the element; held to a share of its largest element
K5_DW_SHARE = 1e-5


def _assert_grads_close(got, want, what=''):
    for name, g, w in zip(NAMES, got, want):
        if name == 'w':
            assert (g - w).abs().max().item() <= \
                K5_DW_SHARE * w.abs().max().item(), f'd_w {what}'
        else:
            torch.testing.assert_close(g, w, rtol=K5_CUDA_RTOL,
                                       atol=K5_CUDA_ATOL, msg=f'{name} {what}')


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(8, 128, 40, 2048, 2048),
                                         (4, 33, 40, 512, 512),
                                         (3, 20, 7, 2048, 64),
                                         (2, 9, 70, 100, 1100)])
def test_k2_takes_any_n_and_width_on_cuda(B, T, N, Dh, Ds):
    *arrays, _ = _inputs(N, B, T, N, Dh, Ds)
    args = [torch.from_numpy(a).cuda() for a in arrays]
    before = scdm_attention_fused.launches
    with torch.no_grad():
        got = scdm_attention_fused(*args)
        want = scdm_attention_plain(*args)
    torch.cuda.synchronize()
    assert scdm_attention_fused.launches == before + 1
    assert (got - want).abs().max().item() <= K2_CUDA_TOL


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(64, 128, 15, 512, 512),
                                         (64, 128, 25, 512, 512),
                                         (8, 128, 40, 2048, 2048),
                                         (3, 37, 70, 100, 48)])
def test_k5_backward_kernel_matches_plain_autograd_on_cuda(B, T, N, Dh, Ds):
    *arrays, g_out = (torch.from_numpy(a).cuda()
                      for a in _inputs(N, B, T, N, Dh, Ds))
    grads = []
    before = scdm_attention_fused_trainable.launches
    for fn in (scdm_attention_fused_trainable, scdm_attention_plain):
        inputs = [a.clone().requires_grad_() for a in arrays]
        fn(*inputs).backward(g_out)
        grads.append([t.grad for t in inputs])
    torch.cuda.synchronize()
    assert scdm_attention_fused_trainable.launches == before + 1
    _assert_grads_close(*grads)


@pytest.mark.requires_cuda
def test_k5_backward_kernel_is_deterministic_and_matches_its_core():
    B, T, N, Dh, Ds = 16, 128, 15, 512, 512
    *arrays, g_out = (torch.from_numpy(a).cuda()
                      for a in _inputs(1, B, T, N, Dh, Ds))
    vp, sp, w, sf = arrays
    P = torch.softmax(torch.einsum(
        'btnh,h->btn', torch.tanh(vp[:, :, None] + sp[:, None]), w), -1)
    runs = [scdm_attention_bwd(vp, sp, w, sf, P, g_out) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    dP = torch.bmm(g_out, sf.transpose(1, 2))
    default = scdm_attention_bwd_core(vp, sp, w, P, dP)
    want = scdm_attention_bwd_core_plain(vp, sp, w, P, dP)
    # the core's outputs are the first three: d_video_proj, d_sent_proj, d_w
    _assert_grads_close(default, want, 'at the plan')
    for cols in (32, 64, 128, 256):
        for spans in (1, 2, 4):
            got = _launch_backward((vp, sp, w, P, dP), _scdm_bwd_launch(
                B, T, N, Dh, 0, cols=cols, spans=spans))
            what = f'cols={cols} spans={spans}'
            _assert_grads_close(got, default, what)
            _assert_grads_close(got, want, what)


def _core_inputs(seed, B, T, N, Dh):
    """(video_proj, sent_proj, w, P, dP) on the card: P the plain softmax,
    dP from a cotangent of a 64-wide context."""
    *arrays, g_out = (torch.from_numpy(a).cuda()
                      for a in _inputs(seed, B, T, N, Dh, 64))
    vp, sp, w, sf = arrays
    P = torch.softmax(torch.einsum(
        'btnh,h->btn', torch.tanh(vp[:, :, None] + sp[:, None]), w), -1)
    return vp, sp, w, P, torch.bmm(g_out, sf.transpose(1, 2))


@pytest.mark.requires_cuda
@pytest.mark.parametrize('Dh', [300, 301, 2048])
@pytest.mark.parametrize('N', [1, 15, 16, 17, 25, 32, 33, 40, 70])
def test_k5_backward_kernel_matches_its_core_at_any_n_and_width_on_cuda(
        N, Dh):
    """Words in one pass (N <= 32, dead slots up to the next multiple of
    4) or in equal passes (33, 40, 70), 4-byte copies (Dh = 301), a
    ragged last tile (T = 37)."""
    args = _core_inputs(N + Dh, 3, 37, N, Dh)
    got = scdm_attention_bwd_core(*args)
    want = scdm_attention_bwd_core_plain(*args)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, f'N={N} Dh={Dh}')


def _fwd_tanh(x):
    return forward_tanh(x.contiguous())


@pytest.mark.requires_cuda
def test_k5_backward_kernel_differentiates_the_forward_tanh_on_cuda():
    """The kernel recomputes a with the forward's tanh (tanh_fwd): the
    plain formulas over a from :func:`forward_tanh` agree with it within
    1e-5 of each output's largest element. At the points of [-1.5, -0.6]
    where it differs most from :func:`torch.tanh` (there |a| < 0.91 keeps
    the rounding of dl - dl a² small), as sent_proj, with video_proj 0 and
    few terms a sum, each output lies at most half as far from the plain
    formulas over :func:`forward_tanh` as from those over
    :func:`torch.tanh`."""
    args = _core_inputs(7, 8, 128, 15, 512)
    got = scdm_attention_bwd_core(*args)
    want = scdm_attention_bwd_core_plain(*args, tanh=_fwd_tanh)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        assert (g - w).abs().max().item() <= \
            1e-5 * w.abs().max().item(), name
    B, T, N, Dh = 2, 4, 4, 512
    vp, sp, w, P, dP = _core_inputs(8, B, T, N, Dh)
    x = torch.linspace(-1.5, -0.6, 1 << 20, device='cuda')
    gap = (forward_tanh(x) - torch.tanh(x)).abs()
    x = x[gap.topk(B * N * Dh).indices]
    order = np.random.RandomState(9).permutation(x.numel())
    sp = x[torch.from_numpy(order).cuda()].reshape(B, N, Dh)
    args = (torch.zeros_like(vp), sp, w, P, dP)
    got = scdm_attention_bwd_core(*args)
    own = scdm_attention_bwd_core_plain(*args, tanh=_fwd_tanh)
    lib = scdm_attention_bwd_core_plain(*args, tanh=torch.tanh)
    torch.cuda.synchronize()
    for name, g, o, lb in zip(NAMES, got, own, lib):
        assert (g - o).abs().sum().item() <= \
            0.5 * (g - lb).abs().sum().item(), name
