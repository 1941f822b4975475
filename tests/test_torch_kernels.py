"""The port's kernels: each plain version against the JAX package's Pallas
kernel run in interpret mode (and its plain JAX formulation), at small
widths; K2's launch plan against its contract; each CUDA kernel against
its plain version where a card exists.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py
"""

import collections
import math
import re

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


# at H=256 the tensor-core kernel, at 1, 5, 9, 17 and 24 rows a cluster on
# an H100 (ragged against its 16-row chunks; B=1 and B=37 among them)
@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 32, 256), (15, 32, 256), (1, 3, 256),
                                   (33, 5, 64), (9, 2, 8), (64, 16, 512),
                                   (20, 3, 304), (12, 1, 256), (20, 37, 256),
                                   (20, 63, 256), (20, 119, 256),
                                   (20, 168, 256)])
def test_lstm_kernel_bf16_matches_plain_on_cuda(T, B, H):
    _check_bf16_kernel(T, B, H)


@pytest.mark.requires_cuda
def test_lstm_kernel_bf16_at_the_most_rows_a_cluster_holds_on_cuda():
    """A batch that gives every cluster of a wave the most rows one holds
    (the tensor-core kernel's shared memory: 127 at bf16 xw)."""
    from shufflingvideosfortsg_torch.ops import lstm_scan as L
    cap, a_wave, _ = L._cluster_plan('test', 'svtsg_lstm', 256, 2,
                                     torch.cuda.current_device(), 2)
    B = cap * a_wave
    assert max(b1 - b0 for b0, b1 in L._row_slices(B, cap, a_wave)) == cap
    _check_bf16_kernel(6, B, 256)


def _check_bf16_kernel(T, B, H):
    """K1 with bf16 xw and W_hh against its plain version within
    K1_BF16_CUDA_TOL, two launches bit for bit."""
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


def _stand_in_mma_smem(N):
    """A bf16 tensor-core block's shared memory for the plan's tests on the
    CPU: it grows with the rows and the words as the kernel's layout does
    (``svtsg_scdm_smem_bytes`` at 2 bytes, held by the CUDA test below),
    and the kernel takes no tile but 8, 16 and 32 rows."""
    return lambda rows: (20_000 + 500 * rows + 6 * rows * N
                         if rows in (8, 16, 32) else -1)


@pytest.mark.parametrize('sms', [132, 114, 1])
@pytest.mark.parametrize('B,T,N', PLAN_SHAPES + [(512, 1024, 15)])
def test_scdm_mma_plan_covers_t_with_whole_row_groups(B, T, N, sms):
    """At bf16 the tiles are whole row groups of 4 rows for each of the
    kernel's 8 warps (8, 16 or 32 rows; each row's words in whole m16
    tiles), cover T, and fit the reported shared memory."""
    smem = _stand_in_mma_smem(N)
    plan = S._scdm_plan(B, T, N, sms, smem, elem_bytes=2)
    assert S._MMA_ROWS == (32, 16, 8) and plan.rows in S._MMA_ROWS
    assert plan.rows % 4 == 0 and 8 % (plan.rows // 4) == 0
    tiles = -(-T // plan.rows)
    assert tiles * plan.rows >= T > (tiles - 1) * plan.rows
    assert plan.blocks == tiles * B
    assert plan.smem_bytes == smem(plan.rows) <= _kernels.MAX_SMEM_BYTES
    larger = [r for r in S._MMA_ROWS if r > plan.rows]
    for r in larger:
        assert -(-T // r) * B < sms or r >= 2 * T
    if plan.rows != min(S._MMA_ROWS):
        assert plan.blocks >= sms


@pytest.mark.parametrize('B,T,N,rows', [(32, 128, 15, 16), (64, 128, 15, 32),
                                        (32, 128, 25, 16), (32, 128, 33, 16),
                                        (256, 128, 15, 32),
                                        (512, 1024, 15, 32)])
def test_scdm_mma_plan_gives_the_main_shapes_two_blocks_an_sm(B, T, N, rows):
    """Evaluation (B=32), K5's forward (B=64), the graphed tick (B=256)
    and the served batch (B=512, T=1024) at bf16: the largest tile whose
    grid still gives each of an H100's SMs a block. The kernel holds two
    blocks an SM, so at B=32 and 64 the grid (256 blocks) is one wave of
    them and every SM but 8 takes two; at B=256 and the served batch the
    grid spans 4 and 62 such waves. (On an H100 the tiles of half the
    rows, which give two waves at B=32 and 64, ran slower: PERF.md §6,
    ``measure_scdm --precision bf16 --sweep``.)"""
    plan = S._scdm_plan(B, T, N, H100_SMS, _stand_in_mma_smem(N),
                        elem_bytes=2)
    assert plan.blocks >= H100_SMS
    assert -(-plan.blocks // H100_SMS) >= 2
    assert plan.rows == rows


def test_scdm_mma_plan_raises_where_nothing_fits():
    N = 3000  # the [rows, N] logits and P outgrow the shared memory
    smem = _stand_in_mma_smem(N)
    assert smem(32) > _kernels.MAX_SMEM_BYTES >= smem(8)
    assert S._scdm_plan(1000, 128, N, H100_SMS, smem, elem_bytes=2).rows == 8
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_plan(8, 128, 100000, H100_SMS, _stand_in_mma_smem(100000),
                     elem_bytes=2)
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_plan(8, 128, 15, H100_SMS, _stand_in_mma_smem(15),
                     smem_cap=1024, elem_bytes=2)
    # a tile of 4 rows, which the f32 kernel takes, is never planned at bf16
    with pytest.raises(ValueError, match='shared memory'):
        S._scdm_plan(8, 4, 15, H100_SMS,
                     lambda rows: 40_000 if rows == 4 else -1, elem_bytes=2)


@pytest.mark.requires_cuda
def test_scdm_mma_smem_bytes_and_plan_on_cuda():
    """The tensor-core kernel's own layout (``svtsg_scdm_smem_bytes`` at 2
    bytes): tiles of 8, 16 and 32 rows only, growing with the rows and the
    words, two blocks an SM at the main shapes, and the plan within the
    card's shared memory at every shape."""
    for N in (1, 15, 17, 33, 70, 1500):
        sizes = [S._scdm_smem_bytes(r, N, 2) for r in (8, 16, 32)]
        assert all(0 < a < b for a, b in zip(sizes, sizes[1:]))
    for rows in (0, 4, 12, 24, 64):
        assert S._scdm_smem_bytes(rows, 15, 2) == -1
    assert S._scdm_smem_bytes(16, 15, 2) < S._scdm_smem_bytes(16, 40, 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, T, N in PLAN_SHAPES + [(512, 1024, 15)]:
        plan = S._scdm_plan(B, T, N, sms,
                            lambda rows: S._scdm_smem_bytes(rows, N, 2),
                            elem_bytes=2)
        assert 0 < plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
        if N <= 33:
            assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.requires_cuda
def test_scdm_term_roundings_are_the_contracts_at_every_input_on_cuda():
    """The bf16 kernel's own packed sum and packed a over every input: the
    sum equals bf16(f32(vp) + f32(sp)) for all pairs of finite bf16, and a
    equals bf16(tanh_fwd(s)) for all 65,536 bf16 s (K5's backward
    recomputes a with tanh_fwd); a lies within one bf16 ulp of
    bf16(torch.tanh(s)) wherever tanh_fwd's few f32 ulps allow."""
    check = S.term_check('cuda')
    assert check.pairs_checked == 65280 ** 2
    assert check.values_checked == 2 * 65536
    assert check.sum_mismatches == 0
    assert check.tanh_mismatches == 0
    assert check.off_torch_tanh == 0


@pytest.mark.requires_cuda
def test_scdm_bwd_term_roundings_are_the_contracts_at_every_input_on_cuda():
    """The bf16 backward kernel's own packed operations over every input:
    the product equals bf16(f32(x) f32(y)) and the sum bf16(f32(x) +
    f32(y)) for all pairs of finite bf16, and 1 - a equals bf16(1 -
    f32(a)) for all 65,536 bf16 a, bit for bit."""
    check = S.bwd_term_check('cuda')
    assert check.mul_pairs_checked == check.add_pairs_checked == 65280 ** 2
    assert check.one_minus_checked == 2 * 65536
    assert check.mul_mismatches == 0
    assert check.add_mismatches == 0
    assert check.one_minus_mismatches == 0


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


def _stand_in_bwd2_smem(N):
    """A bf16 backward block's shared memory for the plan's tests on the
    CPU: the larger of a ring of three stages (rows x cols bf16 of
    video_proj, the rows of P in f32 and of dP in bf16) and the groups'
    partial sums (2 KB a word of a pass of up to 16), then dl twice, as the
    kernel's own layout grows (held on the card below)."""
    words = -(-N // -(-N // 16))
    return lambda rows, cols: (max(3 * (2 * rows * cols + 6 * rows * N),
                                   2048 * words) + 8 * rows * words)


@pytest.mark.parametrize('sms', [132, 114, 1])
@pytest.mark.parametrize('B,T,N,Dh', BWD_PLAN_SHAPES)
def test_scdm_bwd_bf16_plan_covers_t_and_fits_shared_memory(B, T, N, Dh,
                                                            sms):
    """The bf16 kernel's plan: its own columns (up to 512), tiles of 4 to
    32 rows, spans of whole tiles that cover T, its layout within the
    card's shared memory, and every SM a block where the shape has the
    work for it."""
    smem = _stand_in_bwd2_smem(N)
    plan = S._scdm_bwd_plan(B, T, N, Dh, sms, smem, elem_bytes=2)
    assert plan.cols in S._BWD_COLS and plan.rows in S._BWD_ROWS
    assert plan.t_len % plan.rows == 0
    assert plan.spans * plan.t_len >= T > (plan.spans - 1) * plan.t_len
    assert plan.blocks == plan.spans * B * -(-Dh // plan.cols)
    assert plan.smem_bytes == smem(plan.rows, plan.cols)
    assert plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
    tiles = -(-T // plan.rows)
    if plan.cols == S._BWD_COLS[-1] and plan.spans == tiles:
        return  # no more blocks to be had
    assert plan.blocks >= sms
    # the widest columns up to 128 that fill the card over at most two spans
    assert plan.cols <= S._BWD2_WIDEST
    for c in S._BWD_COLS:
        if plan.cols < c <= S._BWD2_WIDEST:
            assert 2 * B * -(-Dh // c) < sms or c >= 2 * Dh


@pytest.mark.parametrize('B,T,N,Dh,cols,spans', [(64, 128, 15, 512, 128, 1),
                                                 (64, 128, 25, 512, 128, 1),
                                                 (8, 128, 40, 2048, 128, 2)])
def test_scdm_bwd_bf16_plan_fills_the_card_at_the_main_shapes(B, T, N, Dh,
                                                              cols, spans):
    """The GMD train step (B=64 at N=15, 25) and N=40 at Dh=2048: about
    two blocks an SM of an H100 (256 on 132 SMs), tiles of 32 rows, 128
    columns over one or two spans."""
    plan = S._scdm_bwd_plan(B, T, N, Dh, H100_SMS, _stand_in_bwd2_smem(N),
                            elem_bytes=2)
    assert (plan.cols, plan.spans, plan.rows) == (cols, spans, 32)
    assert plan.blocks == 256 >= H100_SMS


@pytest.mark.parametrize('Dh', [301, 300, 33, 1, 2048])
def test_scdm_bwd_bf16_pairs_of_columns_cover_every_column(Dh):
    """A bf16 block's thread owns columns k0 + 2 p and k0 + 2 p + 1: over
    the planned chunks of columns every k < Dh has one owner, and only an
    odd Dh leaves the last pair's second column past the end."""
    plan = S._scdm_bwd_plan(3, 37, 17, Dh, H100_SMS, _stand_in_bwd2_smem(17),
                            elem_bytes=2)
    assert plan.cols % 2 == 0
    owned, past = collections.Counter(), 0
    for chunk in range(-(-Dh // plan.cols)):
        for pair in range(plan.cols // 2):
            k = chunk * plan.cols + 2 * pair
            if k < Dh:
                owned.update(c for c in (k, k + 1) if c < Dh)
                past += k + 1 >= Dh
    assert sorted(owned) == list(range(Dh))
    assert set(owned.values()) == {1}
    assert past == Dh % 2


@pytest.mark.parametrize('cols,spans', [(32, 1), (256, 1), (256, 2),
                                        (64, 4), (128, 100), (None, 3),
                                        (128, None)])
def test_scdm_bwd_bf16_plan_takes_the_overrides(cols, spans):
    plan = S._scdm_bwd_plan(64, 128, 15, 512, H100_SMS,
                            _stand_in_bwd2_smem(15), cols=cols, spans=spans,
                            elem_bytes=2)
    if cols is not None:
        assert plan.cols == cols
    if spans is not None:
        tiles = 128 // plan.rows
        assert plan.spans == -(-tiles // -(-tiles // min(spans, tiles)))
    assert plan.spans * plan.t_len >= 128


@pytest.mark.requires_cuda
def test_scdm_bwd_bf16_smem_bytes_and_plan_on_cuda():
    """The bf16 kernel's own layout (``svtsg_scdm_bwd_smem_bytes`` at 2
    bytes): it grows with the rows, the columns and the words, takes a
    multiple of 4 rows up to 32 and 32 to 256 columns, lets two blocks
    share an SM at the main shapes, and the plan keeps it within the
    card's shared memory."""
    for N in (1, 15, 17, 33, 70, 600):
        for cols in S._BWD_COLS:
            sizes = [S._scdm_bwd_smem_bytes(r, cols, N, 2)
                     for r in S._BWD_ROWS[::-1]]
            assert all(0 < a <= b for a, b in zip(sizes, sizes[1:]))
        assert S._scdm_bwd_smem_bytes(32, 128, N, 2) < \
            S._scdm_bwd_smem_bytes(32, 256, N, 2)
    assert S._scdm_bwd_smem_bytes(32, 128, 15, 2) < \
        S._scdm_bwd_smem_bytes(32, 128, 600, 2)
    for rows, cols, N in ((0, 32, 15), (2, 32, 15), (6, 64, 15),
                          (36, 64, 15), (32, 48, 15), (32, 512, 15),
                          (32, 16, 15), (32, 64, 0)):
        assert S._scdm_bwd_smem_bytes(rows, cols, N, 2) == -1
    assert S._scdm_bwd_smem_bytes(32, 128, 15, 3) == -1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, T, N, Dh in BWD_PLAN_SHAPES + [(64, 128, 600, 512)]:
        plan = S._scdm_bwd_plan(
            B, T, N, Dh, sms, lambda r, c: S._scdm_bwd_smem_bytes(r, c, N, 2),
            elem_bytes=2)
        assert 0 < plan.smem_bytes <= _kernels.MAX_SMEM_BYTES
        if (B, T) == (64, 128) and N <= 25:
            assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024


# (B, T, N, Dh, elem_bytes, ms, by): in f32 10 operations a term at the
# f32 peak; in bf16 six packed bf16 roundings a term at the bf16x2 peak
# and five f32 operations at the f32 peak, their times added; bytes where
# a term does little
@pytest.mark.parametrize('B,T,N,Dh,elem,ms,by', [
    (8, 128, 40, 2048, 4, 10 * 8 * 128 * 40 * 2048 / 67e9, 'operations'),
    (64, 128, 15, 512, 2,
     64 * 128 * 15 * 512 * (6 / 133.8e9 + 5 / 67e9), 'operations'),
    (8, 128, 40, 2048, 2,
     8 * 128 * 40 * 2048 * (6 / 133.8e9 + 5 / 67e9), 'operations'),
    (64, 128, 1, 512, 2,
     (2 * (2 * (64 * 128 * 512 + 64 * 512 + 512) + 64 * 128)
      + 4 * 64 * 128) / 3.35e9, 'bytes')])
def test_scdm_bwd_bound_counts_bf16_roundings_at_the_packed_rate(
        B, T, N, Dh, elem, ms, by):
    from shufflingvideosfortsg_torch.measure_scdm import scdm_bwd_bound
    got_ms, got_by = scdm_bwd_bound(B, T, N, Dh, elem_bytes=elem)
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-12)


def test_kernel_build_reports_the_saved_compiler_output(tmp_path,
                                                        monkeypatch):
    """A library already built is not rebuilt, and ``build`` hands back the
    compiler output saved beside it (ptxas's spill lines, which
    chip_smoke.py's [build] reads), or nothing where none was saved."""
    monkeypatch.setattr(_kernels, 'BUILD_DIR', str(tmp_path))
    lib = tmp_path / f'libsvtsg_kernels_{_kernels._digest()}.so'
    lib.write_bytes(b'')
    assert _kernels.build() == (str(lib), 0.0, '')
    (tmp_path / f'{lib.name}.log').write_text('ptxas info : 0 bytes spill')
    assert _kernels.build() == (str(lib), 0.0, 'ptxas info : 0 bytes spill')


@pytest.mark.requires_cuda
def test_scdm_bwd_bf16_rejects_spans_of_odd_rows_on_cuda():
    """At bf16 the C entry point takes spans of whole tiles only (t_len a
    multiple of rows, so that every tile of dP starts on a 4-byte
    boundary); other t_len return cudaErrorInvalidValue before a launch."""
    B, T, N, Dh = 2, 37, 15, 64
    bf16 = dict(device='cuda', dtype=torch.bfloat16)
    f32 = dict(device='cuda', dtype=torch.float32)
    ins = (torch.zeros(B, T, Dh, **bf16), torch.zeros(B, N, Dh, **bf16),
           torch.zeros(Dh, **bf16), torch.zeros(B, T, N, **f32),
           torch.zeros(B, T, N, **bf16))
    lib = _kernels.library()
    for spans, t_len, want in ((2, 19, 1), (2, 21, 1), (1, 37, 1),
                               (2, 20, 0), (1, 40, 0)):
        outs = (torch.zeros(B, T, Dh, **f32),
                torch.zeros(spans, B, N, Dh, **f32),
                torch.zeros(spans * B, Dh, **f32))
        err = lib.svtsg_scdm_bwd(
            *(a.data_ptr() for a in ins), *(o.data_ptr() for o in outs), B,
            T, N, Dh, 32, 4, spans, t_len, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == want, (spans, t_len)


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
# the kept P is the f32 softmax: a P rounded to bf16 is a bf16 value at
# every entry, an f32 softmax at about one entry in 2^16 (chip_smoke.py's
# P_BF16_VALUES_SHARE)
P_BF16_VALUES_SHARE = 2.0 ** -7


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(32, 128, 15, 512, 512),
                                         (3, 20, 7, 64, 32),
                                         (8, 128, 40, 2048, 2048),
                                         (5, 37, 17, 300, 256),
                                         (3, 37, 17, 301, 255),
                                         (2, 21, 70, 128, 96),
                                         (4, 40, 25, 512, 512),
                                         (3, 37, 33, 256, 129),
                                         (3, 20, 15, 64, 65)])
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
    bf16_values = (P.view(torch.int32) & 0xffff) == 0
    assert bf16_values.float().mean().item() <= P_BF16_VALUES_SHARE


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


# at H=256 K4's recurrence is the tensor-core kernel; on an H100 (7 row
# slices a direction) B=5 and 7 give it 1 row a cluster, B=35 5 rows and
# B=119 17, ragged against its n8 tiles and 16-row chunks
@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 64, 256), (15, 32, 256),
                                   (33, 5, 256), (40, 37, 128), (9, 3, 304),
                                   (20, 7, 256), (20, 35, 256),
                                   (11, 119, 256)])
def test_k3_k4_kernels_bf16_match_plain_on_cuda(T, B, H):
    _check_k3_k4_bf16(T, B, H)


@pytest.mark.requires_cuda
def test_k4_kernel_bf16_at_the_most_rows_a_cluster_holds_on_cuda():
    """A batch that gives every cluster of a wave the most rows one of K4's
    tensor-core kernel holds (its shared memory, BwdMmaLayout)."""
    from shufflingvideosfortsg_torch.ops import lstm_scan as L
    cap, a_wave, _ = L._cluster_plan('test', 'svtsg_lstm_bwd', 256, 2,
                                     torch.cuda.current_device(), 2)
    B = cap * a_wave
    assert max(b1 - b0 for b0, b1 in L._row_slices(B, cap, a_wave)) == cap
    _check_k3_k4_bf16(6, B, 256)


def _check_k3_k4_bf16(T, B, H):
    """K3 and K4 with bf16 xw, W_hh, out and d_out against their plain
    versions, two launches of each bit for bit, and K4's weight-gradient
    kernel alone."""
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


# The span predictors' BiLSTMs (H = span_hidden_dim = 128, W_hh in shared
# memory at either dtype) at the Charades width, T=128 and B=32, over the
# 2,048-wide features of the 'tall' interaction and the 256-wide output of
# ConditionalLSTMPredictor's start_lstm that its end_lstm reads: K1 in
# eval, K3 and K4 under autograd, against the plain versions. f32: out
# within K1_CUDA_TOL, each gradient within rtol 1e-3, atol 1e-4
# (chip_smoke.py's K4 tolerances); bf16: out within K1_BF16_CUDA_TOL, each
# gradient within K4_BF16_CUDA_SHARE of its largest |value|.
@pytest.mark.requires_cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('width', [2048, 256])
def test_predictor_bilstm_kernels_match_plain_on_cuda(width, dtype,
                                                      monkeypatch):
    from shufflingvideosfortsg_torch.ops import lstm_scan as L
    from shufflingvideosfortsg_torch.ops import rnn
    T, B, H = 128, 32, 128
    torch.manual_seed(width)
    lstm = rnn.BiLSTM(width, H, 1, 0.0, dtype).cuda()
    x = torch.randn(B, T, width, device='cuda')
    g = torch.randn(B, T, 2 * H, device='cuda')

    def run():
        with torch.no_grad():
            out = lstm(x)[0]
        xg = x.clone().requires_grad_()
        y = lstm(xg)[0]
        return out, torch.autograd.grad((y.float() * g).sum(),
                                        [xg, *lstm.parameters()])

    def counts():
        return (L.lstm_recurrence.launches, L.lstm_recurrence_train.launches,
                L.lstm_recurrence_bwd.launches)

    before = counts()
    out, grads = run()
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    monkeypatch.setattr(rnn, 'lstm_recurrence', lambda xw, w: (
        L.LSTMRecurrence.apply(xw, w) if torch.is_grad_enabled()
        else L.lstm_recurrence_plain(xw, w)))
    monkeypatch.setattr(L, 'lstm_recurrence_train',
                        L.lstm_recurrence_train_plain)
    monkeypatch.setattr(L, 'lstm_recurrence_bwd', L.lstm_recurrence_bwd_plain)
    want_out, want_grads = run()
    assert out.dtype == dtype
    tol = K1_CUDA_TOL if dtype == torch.float32 else K1_BF16_CUDA_TOL
    assert (out.float() - want_out.float()).abs().max().item() <= tol
    for got, want in zip(grads, want_grads):
        assert torch.isfinite(got).all()
        if dtype == torch.float32:
            assert torch.allclose(got, want, rtol=1e-3, atol=1e-4)
        else:
            assert (got - want).abs().max().item() \
                <= K4_BF16_CUDA_SHARE * want.abs().max().item()


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
                                         (2, 21, 70, 128, 96),
                                         (3, 21, 1, 128, 96),
                                         (2, 21, 33, 128, 96),
                                         (1, 37, 17, 301, 255)])
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize('B,T,N,Dh,Ds', [(64, 128, 15, 512, 512),
                                         (5, 37, 17, 300, 256)])
def test_k5_bf16_takes_a_misaligned_video_proj_on_cuda(B, T, N, Dh, Ds):
    """video_proj a view one element into its storage: 2-byte aligned, so
    the backward stages it by plain loads."""
    bf16 = torch.bfloat16
    args = [torch.from_numpy(a).cuda().to(bf16)
            for a in _scdm_inputs(B + N, B, T, N, Dh, Ds)]
    vp = torch.cat([args[0].new_zeros(1), args[0].flatten()])[1:]
    args[0] = vp.view(B, T, Dh)
    assert args[0].is_contiguous() and args[0].data_ptr() % 4 == 2
    got = S.scdm_attention_bwd_core(*args[:3], *_k5_p_dp(args, B, T, Ds))
    want = S.scdm_attention_bwd_core(*[a.clone() for a in args[:3]],
                                     *_k5_p_dp(args, B, T, Ds))
    ref = S.scdm_attention_bwd_core_plain(*args[:3], *_k5_p_dp(args, B, T, Ds))
    torch.cuda.synchronize()
    for g, a, w in zip(got, want, ref):
        assert torch.equal(g, a)  # the aligned copy's kernel, bit for bit
        w = w.float()
        assert (g.float() - w).abs().max().item() \
            <= K5_BF16_CUDA_SHARE * w.abs().max().item()


def _k5_p_dp(args, B, T, Ds):
    """The forward's f32 softmax P and dP = G sent_feat^T (a seeded G)
    for K5's backward core at bf16."""
    g_out = torch.from_numpy(np.random.RandomState(B).randn(B, T, Ds)
                             .astype(np.float32)).cuda().to(torch.bfloat16)
    with torch.no_grad():
        _, P = S._launch_forward(args, want_p=True)
        return P, torch.bmm(g_out, args[3].transpose(1, 2))


@pytest.mark.requires_cuda
def test_k5_backward_launches_the_kernel_of_its_dtype_on_cuda():
    """A profiler trace of the backward core: bf16 inputs launch
    scdm_bwd_bf16x2_kernel, f32 ones scdm_bwd_kernel, once each."""
    from torch.profiler import ProfilerActivity, profile
    for dt, want in ((torch.bfloat16, 'scdm_bwd_bf16x2_kernel'),
                     (torch.float32, 'scdm_bwd_kernel')):
        zeros = lambda *shape, dtype=dt: torch.zeros(*shape, device='cuda',
                                                     dtype=dtype)
        args = (zeros(4, 37, 300), zeros(4, 17, 300), zeros(300),
                zeros(4, 37, 17, dtype=torch.float32), zeros(4, 37, 17))
        S.scdm_attention_bwd_core(*args)  # built and planned before tracing
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            S.scdm_attention_bwd_core(*args)
            torch.cuda.synchronize()
        names = collections.Counter()
        for evt in prof.key_averages():
            hit = re.search(r'(\w*scdm_bwd\w*)', evt.key)
            if hit and evt.device_type == torch.autograd.DeviceType.CUDA:
                names[hit.group(1)] += evt.count
        assert names == {want: 1}, names


@pytest.mark.requires_cuda
@pytest.mark.parametrize('cols', [32, 64, 128, 256])
def test_k5_bf16_backward_kernel_takes_every_launch_on_cuda(cols):
    """Every column width and span count of the bf16 kernel at a ragged
    shape (T=37 over tiles of the plan's rows, N=17 in two passes, Dh=300)
    against the plain core; d_video_proj, which one thread sums over the
    words in order whatever the launch, in the planned launch's bits."""
    B, T, N, Dh, Ds = 5, 37, 17, 300, 256
    args = [torch.from_numpy(a).cuda().to(torch.bfloat16)
            for a in _scdm_inputs(B + N, B, T, N, Dh, Ds)]
    core = (*args[:3], *_k5_p_dp(args, B, T, Ds))
    want = S.scdm_attention_bwd_core_plain(*core)
    planned = S.scdm_attention_bwd_core(*core)
    for spans in (1, 2, 4):
        plan = S._scdm_bwd_launch(B, T, N, Dh, 0, cols=cols, spans=spans,
                                  elem_bytes=2)
        got = S._launch_backward(core, plan)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            w = w.float()
            assert (g.float() - w).abs().max().item() \
                <= K5_BF16_CUDA_SHARE * w.abs().max().item(), (cols, spans)
        assert torch.equal(got[0], planned[0])

