"""The port's kernels: each plain version against the JAX package's Pallas
kernel run in interpret mode (and its plain JAX formulation), at small
widths; each CUDA kernel against its plain version where a card exists.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch.ops.lstm_scan import (lstm_recurrence,
                                                       lstm_recurrence_plain)
from shufflingvideosfortsg_torch.ops.scdm_fused import (scdm_attention_fused,
                                                        scdm_attention_plain)

TOL = 1e-5  # f32, sums in another order than XLA's


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


def _scdm_inputs(seed, B, T, N, Dh, Ds):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, Dh).astype(np.float32),
            rng.randn(B, N, Dh).astype(np.float32),
            (rng.randn(Dh) / np.sqrt(Dh)).astype(np.float32),
            rng.randn(B, N, Ds).astype(np.float32))


@pytest.mark.parametrize('T,B,H', [(12, 4, 8), (7, 2, 8), (16, 8, 16),
                                   (33, 3, 8)])
def test_lstm_plain_matches_pallas_flat_kernel(T, B, H):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (
        lstm_scan_pallas_flat)
    xw, w_hh = _lstm_inputs(T * 100 + B, T, B, H)
    want = lstm_scan_pallas_flat(jnp.asarray(xw), jnp.asarray(w_hh),
                                 interpret=True)
    got = lstm_recurrence_plain(torch.from_numpy(xw), torch.from_numpy(w_hh))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize('N', [7, 25])
def test_scdm_plain_matches_pallas_kernel_and_jax(N):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.attention import scdm_attention
    from shufflingvideosfortsg_tpu.ops.pallas.scdm_fused import (
        scdm_attention_fused as jax_fused)
    arrays = _scdm_inputs(N, 8, 20, N, 24, 16)
    got = scdm_attention_plain(*map(torch.from_numpy, arrays)).numpy()
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(got, np.asarray(scdm_attention(*j)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jax_fused(*j, block_b=8, interpret=True)),
        atol=TOL, rtol=0)


# --- on the card -----------------------------------------------------------

K1_CUDA_TOL = 1e-4  # f32 sums over H in another order, across T dependent steps
K2_CUDA_TOL = 1e-5


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 32, 256), (15, 32, 256), (1, 3, 256),
                                   (33, 5, 64), (9, 2, 8), (64, 16, 512),
                                   (20, 3, 304)])
def test_lstm_kernel_matches_plain_on_cuda(T, B, H):
    xw, w_hh = (torch.from_numpy(a).cuda() for a in _lstm_inputs(T + B, T, B, H))
    before = lstm_recurrence.launches
    with torch.no_grad():
        got = lstm_recurrence(xw, w_hh)
        want = lstm_recurrence_plain(xw, w_hh)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert (g - w).abs().max().item() <= K1_CUDA_TOL


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(32, 128, 15, 512, 512),
                                         (32, 128, 25, 512, 512),
                                         (3, 20, 7, 64, 32),
                                         (8, 128, 40, 2048, 2048)])
def test_scdm_kernel_matches_plain_on_cuda(B, T, N, Dh, Ds):
    args = [torch.from_numpy(a).cuda()
            for a in _scdm_inputs(N, B, T, N, Dh, Ds)]
    before = scdm_attention_fused.launches
    with torch.no_grad():
        got = scdm_attention_fused(*args)
        want = scdm_attention_plain(*args)
    torch.cuda.synchronize()
    assert scdm_attention_fused.launches == before + 1
    assert (got - want).abs().max().item() <= K2_CUDA_TOL


@pytest.mark.requires_cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    xw, w_hh = (torch.from_numpy(a).cuda() for a in _lstm_inputs(0, 4, 2, 8))
    with torch.no_grad(), pytest.raises(ValueError, match='contiguous'):
        lstm_recurrence(xw.transpose(0, 1).contiguous().transpose(0, 1), w_hh)
    # K2 takes any N and width; what it refuses is another dtype, shapes
    # that disagree, strided inputs and inputs spread over devices
    args = [torch.from_numpy(a).cuda() for a in _scdm_inputs(0, 2, 4, 33, 32, 32)]
    with torch.no_grad():
        with pytest.raises(TypeError, match='float32'):
            scdm_attention_fused(args[0].double(), *args[1:])
        with pytest.raises(ValueError, match='shapes disagree'):
            scdm_attention_fused(args[0], args[1][:, :5], *args[2:])
        with pytest.raises(ValueError, match='contiguous'):
            scdm_attention_fused(
                args[0].transpose(0, 1).contiguous().transpose(0, 1),
                *args[1:])
        with pytest.raises(ValueError, match='one CUDA device'):
            scdm_attention_fused(args[0], args[1].cpu(), *args[2:])
    # K2 has no backward of its own: with gradients it refuses (K5 has one)
    args = [torch.from_numpy(a).cuda() for a in _scdm_inputs(0, 2, 4, 7, 32, 32)]
    with pytest.raises(RuntimeError, match='no_grad'):
        scdm_attention_fused(*(a.requires_grad_() for a in args))
