"""The port's kernels: each plain version against the JAX package's Pallas
kernel run in interpret mode (and its plain JAX formulation), at small
widths; K2's launch plan against its contract; each CUDA kernel against
its plain version where a card exists.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch import _kernels
from shufflingvideosfortsg_torch.ops import scdm_fused as S
from shufflingvideosfortsg_torch.ops.lstm_scan import (lstm_recurrence,
                                                       lstm_recurrence_plain)
from shufflingvideosfortsg_torch.ops.scdm_fused import (scdm_attention_fused,
                                                        scdm_attention_plain)
from torch_one_thread import one_torch_thread  # noqa: F401

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


# the edge shapes of K2's tiles: one word, a whole and a ragged group of
# words, a second pass over the words, and Dh = 300 (not a multiple of the
# 64 columns a stage streams)
@pytest.mark.parametrize('N,Dh', [
    pytest.param(7, 24, id='7'), pytest.param(25, 24, id='25'),
    pytest.param(1, 24, id='1'), pytest.param(16, 24, id='16'),
    pytest.param(17, 24, id='17'), pytest.param(33, 24, id='33'),
    pytest.param(1, 300, id='1-Dh300'), pytest.param(17, 300, id='17-Dh300'),
    pytest.param(33, 300, id='33-Dh300')])
def test_scdm_plain_matches_pallas_kernel_and_jax(N, Dh):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.attention import scdm_attention
    from shufflingvideosfortsg_tpu.ops.pallas.scdm_fused import (
        scdm_attention_fused as jax_fused)
    arrays = _scdm_inputs(N, 8, 20, N, Dh, 16)
    got = scdm_attention_plain(*map(torch.from_numpy, arrays)).numpy()
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(got, np.asarray(scdm_attention(*j)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jax_fused(*j, block_b=8, interpret=True)),
        atol=TOL, rtol=0)




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


# K1 at bf16 (xw, W_hh and out bf16): the kernel and its plain version
# round at the same points, so an f32 sum in another order moves at most a
# rounding here and there by one bf16 ulp: 2^-8 for values in [0.5, 1),
# which bounds |h| < 1 (chip_smoke.py's K6A_BF16_TOL)
K1_BF16_CUDA_TOL = 4e-3


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 32, 256), (15, 32, 256), (1, 3, 256),
                                   (33, 5, 64), (9, 2, 8), (64, 16, 512),
                                   (20, 3, 304)])
def test_lstm_kernel_bf16_matches_plain_on_cuda(T, B, H):
    xw, w_hh = (torch.from_numpy(a).cuda().bfloat16()
                for a in _lstm_inputs(T + B, T, B, H))
    before = lstm_recurrence.launches
    with torch.no_grad():
        got = lstm_recurrence(xw, w_hh)
        again = lstm_recurrence(xw, w_hh)
        want = lstm_recurrence_plain(xw, w_hh)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 2
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    for g, a, w in zip(got, again, want):
        assert g.is_cuda and g.shape == w.shape and torch.equal(g, a)
        assert (g.float() - w.float()).abs().max().item() <= K1_BF16_CUDA_TOL


# --- the plan of K2's launch (CPU) --------------------------------------------

H100_SMS = 132
PLAN_SHAPES = [(32, 128, 15), (64, 128, 15), (32, 128, 25), (32, 128, 40),
               (8, 128, 40), (3, 20, 7), (1, 1, 1), (32, 15, 15), (5, 37, 17),
               (2, 21, 70), (1000, 1, 3), (4, 200, 300)]


def _stand_in_smem(N):
    """A block's shared memory for the plan's tests on the CPU: it grows
    with the rows and the words as the kernel's layout does (that layout,
    ``svtsg_scdm_smem_bytes``, is held by the CUDA test below)."""
    return lambda rows: 30_000 + 1_100 * rows + 4 * rows * N


@pytest.mark.parametrize('sms', [132, 114, 1])
@pytest.mark.parametrize('B,T,N', PLAN_SHAPES)
def test_scdm_plan_covers_t_and_fits_shared_memory(B, T, N, sms):
    smem = _stand_in_smem(N)
    plan = S._scdm_plan(B, T, N, sms, smem)
    assert plan.rows in S._FWD_ROWS and plan.rows % 4 == 0
    tiles = -(-T // plan.rows)
    assert tiles * plan.rows >= T > (tiles - 1) * plan.rows
    assert plan.blocks == tiles * B
    assert plan.smem_bytes == smem(plan.rows)
    assert plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
    # the largest tile that fills the card, or the smallest that fits
    larger = [r for r in S._FWD_ROWS if r > plan.rows
              and smem(r) <= _kernels.MAX_SMEM_BYTES]
    for r in larger:
        assert -(-T // r) * B < 2 * sms or r >= 2 * T
    if plan.rows != min(S._FWD_ROWS):
        assert plan.blocks >= 2 * sms


@pytest.mark.parametrize('B,T,N', [(32, 128, 15), (64, 128, 15),
                                   (32, 128, 25), (32, 128, 40)])
def test_scdm_plan_gives_the_main_shapes_two_waves(B, T, N):
    """Evaluation (B=32) and K5's forward (B=64) at T=128: at least two
    blocks an SM of an H100."""
    plan = S._scdm_plan(B, T, N, H100_SMS, _stand_in_smem(N))
    assert plan.blocks >= 2 * H100_SMS
    assert plan.rows <= 16


def test_scdm_plan_shrinks_the_tile_to_fit_shared_memory():
    # the [rows, N] logits outgrow the shared memory for long sentences
    N = 1500
    smem = _stand_in_smem(N)
    assert smem(32) > _kernels.MAX_SMEM_BYTES
    plan = S._scdm_plan(1000, 128, N, H100_SMS, smem)
    assert plan.rows < 32 and plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
    # a tile the kernel does not take (-1) is never planned
    plan = S._scdm_plan(1000, 128, 15, H100_SMS,
                        lambda rows: -1 if rows == 32 else 40_000)
    assert plan.rows == 16
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_plan(8, 128, 100000, H100_SMS, _stand_in_smem(100000))
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_plan(8, 128, 15, H100_SMS, _stand_in_smem(15), smem_cap=1024)


@pytest.mark.requires_cuda
def test_scdm_smem_bytes_and_plan_on_cuda():
    """The kernel's own layout (``svtsg_scdm_smem_bytes``): it grows with
    the rows and the words, takes only multiples of 4 up to 32 rows, lets
    four blocks share an SM at the main shapes, and the plan keeps it
    within the card's shared memory at every shape."""
    rows_taken = range(4, 33, 4)
    for N in (1, 15, 17, 33, 70, 1500):
        sizes = [S._scdm_smem_bytes(r, N) for r in rows_taken]
        assert all(0 < a < b for a, b in zip(sizes, sizes[1:]))
    for rows, N in ((0, 15), (2, 15), (6, 15), (36, 15), (64, 15), (8, 0)):
        assert S._scdm_smem_bytes(rows, N) == -1
    assert S._scdm_smem_bytes(16, 15) < S._scdm_smem_bytes(16, 40)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, T, N in PLAN_SHAPES + [(1000, 128, 1500)]:
        plan = S._scdm_plan(B, T, N, sms,
                            lambda rows: S._scdm_smem_bytes(rows, N))
        assert 0 < plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
        if (B, T) in ((32, 128), (64, 128)) and N <= 25:
            # 228 KB an SM, 1 KB of it reserved a block
            assert 4 * (plan.smem_bytes + 1024) <= 228 * 1024


BWD_PLAN_SHAPES = [(64, 128, 15, 512), (64, 128, 25, 512),
                   (8, 128, 40, 2048), (32, 128, 15, 512), (3, 37, 17, 301),
                   (1, 1, 1, 1), (2, 9, 70, 100), (1000, 1, 3, 8),
                   (4, 200, 33, 300), (128, 128, 15, 512)]


def _stand_in_bwd_smem(N):
    """A backward block's shared memory for the plan's tests on the CPU:
    a ring of three stages of rows x (cols + 4) floats and the rows of P
    and dP, as the kernel's layout grows (that layout,
    ``svtsg_scdm_bwd_smem_bytes``, is held by the CUDA test below)."""
    return lambda rows, cols: 12 * (rows * (cols + 4) + 2 * rows * N) + 9_000


@pytest.mark.parametrize('sms', [132, 114, 1])
@pytest.mark.parametrize('B,T,N,Dh', BWD_PLAN_SHAPES)
def test_scdm_bwd_plan_covers_t_and_fits_shared_memory(B, T, N, Dh, sms):
    smem = _stand_in_bwd_smem(N)
    plan = S._scdm_bwd_plan(B, T, N, Dh, sms, smem)
    assert plan.cols in S._BWD_COLS and plan.rows in S._BWD_ROWS
    # the spans are whole tiles and cover T, none of them empty
    assert plan.t_len % plan.rows == 0
    assert plan.spans * plan.t_len >= T > (plan.spans - 1) * plan.t_len
    assert plan.blocks == plan.spans * B * -(-Dh // plan.cols)
    assert plan.smem_bytes == smem(plan.rows, plan.cols)
    assert plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
    target = sms
    chunks = B * -(-Dh // plan.cols)
    # the largest columns that fill the card, or the smallest
    for c in S._BWD_COLS:
        if c > plan.cols:
            assert B * -(-Dh // c) < target or c >= 2 * Dh
    # one span where the columns fill the card, else at most one a tile
    if chunks >= target:
        assert plan.spans == 1
    else:
        assert plan.blocks >= target or plan.t_len == plan.rows


@pytest.mark.parametrize('B,T,N,Dh', [(64, 128, 15, 512), (64, 128, 25, 512),
                                      (8, 128, 40, 2048),
                                      (32, 128, 15, 512)])
def test_scdm_bwd_plan_fills_the_card_at_the_main_shapes(B, T, N, Dh):
    """The GMD train step (B=64 at N=15, 25), B=32 and N=40 at Dh=2048:
    blocks of 64 or more columns, about two an SM of an H100 (256 blocks
    on 132 SMs), tiles of 32 rows, and one span, so that d_sent_proj needs
    no sum across blocks."""
    plan = S._scdm_bwd_plan(B, T, N, Dh, H100_SMS, _stand_in_bwd_smem(N))
    assert plan.blocks == 256 >= H100_SMS
    assert plan.cols >= 64 and plan.rows == 32 and plan.spans == 1
    if B == 64 and Dh == 512:
        assert plan.cols == 128


@pytest.mark.parametrize('cols,spans', [(32, 1), (64, 2), (256, 4),
                                        (128, 100), (None, 3), (64, None)])
def test_scdm_bwd_plan_takes_the_overrides(cols, spans):
    plan = S._scdm_bwd_plan(64, 128, 15, 512, H100_SMS,
                            _stand_in_bwd_smem(15), cols=cols, spans=spans)
    if cols is not None:
        assert plan.cols == cols
    if spans is not None:
        # spans of equal whole tiles: 3 spans of 4 tiles are 2 of 2
        tiles = 128 // plan.rows
        assert plan.spans == -(-tiles // -(-tiles // min(spans, tiles)))
    assert plan.spans * plan.t_len >= 128


def test_scdm_bwd_plan_shrinks_the_tile_to_fit_shared_memory():
    # the tile's rows of P and dP outgrow the shared memory for long
    # sentences: fewer rows a tile, then fewer columns
    N = 600
    smem = _stand_in_bwd_smem(N)
    assert smem(32, 32) > _kernels.MAX_SMEM_BYTES
    plan = S._scdm_bwd_plan(64, 128, N, 512, H100_SMS, smem)
    assert plan.rows < 32 and plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
    # a block the kernel does not take (-1) is never planned
    plan = S._scdm_bwd_plan(
        64, 128, 15, 512, H100_SMS,
        lambda rows, cols: -1 if cols == 128 or rows == 32 else 40_000)
    assert plan.cols == 64 and plan.rows == 16
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_bwd_plan(8, 128, 100000, 512, H100_SMS,
                         _stand_in_bwd_smem(100000))
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_bwd_plan(8, 128, 15, 512, H100_SMS, _stand_in_bwd_smem(15),
                         smem_cap=1024)
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_bwd_plan(8, 128, 15, 512, H100_SMS, _stand_in_bwd_smem(15),
                         cols=48)


@pytest.mark.requires_cuda
def test_scdm_bwd_smem_bytes_and_plan_on_cuda():
    """The backward kernel's own layout (``svtsg_scdm_bwd_smem_bytes``): it
    grows with the rows, the columns and the words, takes 1 to 32 rows and
    32, 64, 128 or 256 columns, lets three blocks share an SM at the main
    shapes, and the plan keeps it within the card's shared memory."""
    for N in (1, 15, 17, 33, 70, 600):
        for cols in S._BWD_COLS:
            sizes = [S._scdm_bwd_smem_bytes(r, cols, N) for r in range(1, 33)]
            assert all(0 < a < b for a, b in zip(sizes, sizes[1:]))
        assert S._scdm_bwd_smem_bytes(32, 64, N) < \
            S._scdm_bwd_smem_bytes(32, 128, N)
    for rows, cols, N in ((0, 32, 15), (33, 32, 15), (32, 48, 15),
                          (32, 512, 15), (32, 16, 15), (32, 32, 0)):
        assert S._scdm_bwd_smem_bytes(rows, cols, N) == -1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, T, N, Dh in BWD_PLAN_SHAPES + [(64, 128, 600, 512)]:
        plan = S._scdm_bwd_plan(
            B, T, N, Dh, sms, lambda r, c: S._scdm_bwd_smem_bytes(r, c, N))
        assert 0 < plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
        if (B, T) == (64, 128) and N <= 25:
            # 228 KB an SM, 1 KB of it reserved a block
            assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024


# --- on the card -----------------------------------------------------------

K1_CUDA_TOL = 1e-4  # f32 sums over H in another order, across T dependent steps
K2_CUDA_TOL = 1e-5
P_CUDA_TOL = 1e-6  # K2's softmax P against the plain one


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(32, 128, 15, 512, 512),
                                         (32, 128, 25, 512, 512),
                                         (3, 20, 7, 64, 32),
                                         (8, 128, 40, 2048, 2048),
                                         (3, 37, 1, 300, 256),
                                         (5, 37, 17, 300, 256),
                                         (4, 33, 16, 64, 64),
                                         (2, 21, 70, 128, 96),
                                         (3, 37, 17, 301, 255)])
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
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(64, 128, 15, 512, 512),
                                         (5, 37, 17, 300, 256),
                                         (2, 21, 70, 128, 96)])
def test_scdm_kernel_keeps_p_and_gives_equal_bits_on_cuda(B, T, N, Dh, Ds):
    args = [torch.from_numpy(a).cuda()
            for a in _scdm_inputs(N, B, T, N, Dh, Ds)]
    with torch.no_grad():
        out, P = S._launch_forward(args, want_p=True)
        again, P_again = S._launch_forward(args, want_p=True)
        alone, no_p = S._launch_forward(args, want_p=False)
        vp, sp, w, _ = args
        act = torch.tanh(vp[:, :, None] + sp[:, None])
        want_p = torch.softmax(torch.einsum('btnh,h->btn', act, w), -1)
    torch.cuda.synchronize()
    assert no_p is None and P.shape == (B, T, N)
    assert torch.equal(out, again) and torch.equal(P, P_again)
    assert torch.equal(out, alone)
    assert (P - want_p).abs().max().item() <= P_CUDA_TOL


def test_forward_tanh_on_the_cpu_is_torch_tanh():
    x = torch.linspace(-12, 12, 1001)
    assert torch.equal(S.forward_tanh(x), torch.tanh(x))


@pytest.mark.requires_cuda
def test_forward_tanh_is_within_its_stated_error_on_cuda():
    """The kernel's branch-free tanh: within a few ulps of torch.tanh,
    absolute (3e-7) and relative (1e-6), also as x -> 0 where its
    polynomial takes over; odd, exact at 0 and saturating to +-1."""
    small = torch.cat([torch.logspace(-30, math.log10(0.05), 1 << 20),
                       torch.linspace(1e-4, 0.05, 1 << 20)])
    x = torch.cat([torch.linspace(-12, 12, 1 << 22), small, -small,
                   torch.tensor([0.0, 50.0, -50.0, 1e30, -1e30])]).cuda()
    got, want = S.forward_tanh(x), torch.tanh(x)
    assert (got - want).abs().max().item() <= 3e-7
    nz = want != 0
    rel = ((got - want)[nz] / want[nz]).abs()
    assert rel.max().item() <= 1e-6
    n = small.numel()
    assert torch.equal(got[-5 - n:-5], -got[-5 - 2 * n:-5 - n])
    assert got[-5].item() == 0.0
    assert got[-4].item() == got[-2].item() == 1.0
    assert got[-3].item() == got[-1].item() == -1.0


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


# K2 at bf16: the kernel's tanh_fwd lies within 4.4e-7 relative of
# torch.tanh, so at a rounding tie `a` can round to the neighbouring bf16,
# as can a logit whose f32 sum runs in another order; each such flip moves
# C by less than one bf16 ulp of its largest element, and C itself rounds
# to bf16 (one ulp of a value is at most 2^-7 of it): held to 4 ulps of
# the largest |C|
K2_BF16_CUDA_SHARE = 2.0 ** -6


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(32, 128, 15, 512, 512),
                                         (3, 20, 7, 64, 32),
                                         (8, 128, 40, 2048, 2048),
                                         (5, 37, 17, 300, 256),
                                         (3, 37, 17, 301, 255),
                                         (2, 21, 70, 128, 96)])
def test_scdm_kernel_bf16_matches_plain_on_cuda(B, T, N, Dh, Ds):
    args = [torch.from_numpy(a).cuda().bfloat16()
            for a in _scdm_inputs(N, B, T, N, Dh, Ds)]
    before = scdm_attention_fused.launches
    with torch.no_grad():
        got = scdm_attention_fused(*args)
        again = scdm_attention_fused(*args)
        want = scdm_attention_plain(*args)
    torch.cuda.synchronize()
    assert scdm_attention_fused.launches == before + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K2_BF16_CUDA_SHARE * want.float().abs().max().item()
    # keeping P (K5's forward at bf16): the f32 softmax, before C's rounding
    out, P = S._launch_forward(tuple(args), want_p=True)
    assert torch.equal(out, got) and P.dtype == torch.float32
    act = torch.tanh(args[0][:, :, None] + args[1][:, None])
    want_p = torch.softmax(torch.einsum('btnh,h->btn', act.float(),
                                        args[2].float()).bfloat16().float(),
                           -1)
    assert (P - want_p).abs().max().item() <= K2_BF16_CUDA_SHARE


# K3 and K4 at bf16 (xw, W_hh, out and d_out bf16): as K1, a sum in another
# order moves a bf16 rounding of h by one ulp now and then, and the flip is
# carried on: out within K1_BF16_CUDA_TOL, each f32 state within one bf16
# rounding of its largest |value| (chip_smoke.py's K3_BF16_STATE_SHARE: on
# an NVIDIA H100 c_seq lay 3.2e-4 from the plain version at (128, 64, 256)
# and 2.0e-3 with these larger weights); K4's dgates round to bf16 at such
# points too: d_xw and d_w_hh within 4 bf16 ulps of their largest |value|
# (chip_smoke.py's K4_BF16_SHARE)
K3_BF16_STATE_CUDA_SHARE = 2.0 ** -8
K4_BF16_CUDA_SHARE = 2.0 ** -6


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 64, 256), (15, 32, 256),
                                   (33, 5, 256), (40, 37, 128), (9, 3, 304)])
def test_k3_k4_kernels_bf16_match_plain_on_cuda(T, B, H):
    from shufflingvideosfortsg_torch.ops.lstm_scan import (
        FLAT, lstm_recurrence_bwd, lstm_recurrence_bwd_plain,
        lstm_recurrence_train, lstm_recurrence_train_plain, lstm_weight_grad,
        lstm_weight_grad_plain)
    bf16 = torch.bfloat16
    xw, w_hh = (torch.from_numpy(a).cuda().to(bf16)
                for a in _lstm_inputs(T + 3 * B, T, B, H))
    rng = np.random.RandomState(T)
    cot = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
           for shape in ((T, B, 2 * H), (2, B, H), (2, B, H))]
    cot[0] = cot[0].to(bf16)
    before = lstm_recurrence_train.launches, lstm_recurrence_bwd.launches
    got = [lstm_recurrence_train(xw, w_hh) for _ in range(2)]
    want = lstm_recurrence_train_plain(xw, w_hh)
    args = (xw, w_hh, want[0], want[1], *cot)
    got4 = [lstm_recurrence_bwd(*args) for _ in range(2)]
    want4 = lstm_recurrence_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (lstm_recurrence_train.launches, lstm_recurrence_bwd.launches) \
        == (before[0] + 2, before[1] + 2)
    assert [g.dtype for g in got[0]] == [bf16] + [torch.float32] * 3
    for runs, ref in ((got, want), (got4, want4)):
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert (got[0][0].float() - want[0].float()).abs().max().item() \
        <= K1_BF16_CUDA_TOL
    for g, w in zip(got[0][1:], want[1:]):
        assert (g - w).abs().max().item() \
            <= K3_BF16_STATE_CUDA_SHARE * w.abs().max().item()
    for g, w in zip(got4[0], want4):
        assert g.dtype == torch.float32
        assert (g - w).abs().max().item() \
            <= K4_BF16_CUDA_SHARE * w.abs().max().item()
    # the weight-gradient kernel alone on the flat bf16 layout
    d_w = lstm_weight_grad(want[0], want4[0], bf16, FLAT)
    ref = lstm_weight_grad_plain(want[0], want4[0], bf16, FLAT)
    torch.cuda.synchronize()
    assert torch.allclose(d_w, ref, rtol=1e-3, atol=1e-4)


# K5 at bf16: dl and each term of the backward round to bf16 at JAX's
# points, from f32 values that a sum in another order (and the kernel's
# tanh_fwd against torch.tanh) can move across a rounding boundary; each
# flip moves one term by a bf16 ulp: the three gradients within 4 ulps of
# their largest |value| (chip_smoke.py's K5_BF16_SHARE)
K5_BF16_CUDA_SHARE = 2.0 ** -6


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(64, 128, 15, 512, 512),
                                         (8, 128, 40, 2048, 2048),
                                         (5, 37, 17, 300, 256),
                                         (3, 37, 17, 301, 255),
                                         (2, 21, 70, 128, 96)])
def test_k5_bf16_matches_plain_on_cuda(B, T, N, Dh, Ds):
    from shufflingvideosfortsg_torch.ops.scdm_fused import (
        scdm_attention_bwd_plain, scdm_attention_fused_trainable)
    bf16 = torch.bfloat16
    args = [torch.from_numpy(a).cuda().to(bf16)
            for a in _scdm_inputs(B + N, B, T, N, Dh, Ds)]
    g_out = torch.from_numpy(np.random.RandomState(B).randn(B, T, Ds)
                             .astype(np.float32)).cuda().to(bf16)
    before = S.scdm_attention_fused_trainable.launches
    runs = []
    for _ in range(2):
        inputs = [a.clone().requires_grad_() for a in args]
        out = scdm_attention_fused_trainable(*inputs)
        runs.append((out, *torch.autograd.grad(out, inputs, g_out)))
    want = scdm_attention_bwd_plain(*args, g_out)
    torch.cuda.synchronize()
    assert S.scdm_attention_fused_trainable.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(g.dtype == bf16 for g in runs[0])
    for g, w in zip(runs[0][1:], want):
        w = w.float()
        assert (g.float() - w).abs().max().item() \
            <= K5_BF16_CUDA_SHARE * w.abs().max().item()
