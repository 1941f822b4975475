"""The recurrent weights' gradient outside the step loop, the plan of its
kernel's launch, and the row slices the recurrence kernels' clusters take.

``lstm_weight_grad_plain`` (the plain version of the weight-gradient
kernel of ``csrc/lstm_bwd.cu``) is held against the ``d_w_hh`` of the
backward recurrences' plain versions, flat and stacked, in f32 and with
bf16 weights, and against the JAX package's Pallas backward kernel run in
interpret mode; the slice planner and the weight-gradient kernel's split
planner against their contracts; the kernel against the plain version,
and two of its runs against each other, where a card exists. Inputs come
from a numpy seed.

JAX is imported inside the JAX comparison only, so the CUDA cases also run
on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_weight_grad.py
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch.ops import lstm_scan as L
from torch_one_thread import one_torch_thread  # noqa: F401

F32_ATOL = 1e-5   # f32 sums over the T*B pairs in another order
BF16_TOL = 2e-2   # a few bf16 ulps of the rounded operands, summed in f32
WGRAD_CUDA_RTOL, WGRAD_CUDA_ATOL = 1e-3, 1e-4  # as K4: sums of T*B terms
SHAPES = [(1, 3, 8), (2, 4, 8), (7, 5, 16), (33, 3, 8)]  # T=1, T=2, ragged


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _backward_case(layout, T, B, H, x_dtype, w_dtype, seed):
    """(out, d_xw, d_w_hh) of the layout's plain forward and backward."""
    rng = np.random.RandomState(seed)
    if layout == L.FLAT:
        xw = torch.from_numpy(rng.randn(T, B, 8 * H).astype(np.float32))
        out_shape = (T, B, 2 * H)
        fwd, bwd = L.lstm_recurrence_train_plain, L.lstm_recurrence_bwd_plain
    else:
        xw = torch.from_numpy(rng.randn(T, 2, B, 4 * H).astype(np.float32))
        out_shape = (T, 2, B, H)
        fwd = L.lstm_scan_stacked_train_plain
        bwd = L.lstm_scan_stacked_bwd_plain
    w_hh = torch.from_numpy((rng.randn(2, H, 4 * H) * 0.3).astype(np.float32))
    xw, w_hh = xw.to(x_dtype), w_hh.to(w_dtype)
    out, c_seq, _, _ = fwd(xw, w_hh)
    cot = [torch.from_numpy(rng.randn(*s).astype(np.float32))
           for s in (out_shape, (2, B, H), (2, B, H))]
    cot[0] = cot[0].to(x_dtype)
    d_xw, d_w = bwd(xw, w_hh, out, c_seq, *cot)
    return out, d_xw, d_w


@pytest.mark.parametrize('T,B,H', SHAPES)
@pytest.mark.parametrize('layout,x_dtype,w_dtype', [
    (L.FLAT, torch.float32, torch.float32),
    (L.STACKED, torch.float32, torch.float32),
    (L.STACKED, torch.float32, torch.bfloat16),
    (L.STACKED, torch.bfloat16, torch.bfloat16)])
def test_weight_grad_plain_matches_the_backward_plain(layout, x_dtype, w_dtype,
                                                      T, B, H):
    out, d_xw, want = _backward_case(layout, T, B, H, x_dtype, w_dtype,
                                     seed=T * 10 + B)
    got = L.lstm_weight_grad_plain(out, d_xw, w_dtype, layout)
    assert got.shape == want.shape == (2, H, 4 * H)
    assert got.dtype == torch.float32
    if T == 1:  # no step has an h_prev
        assert not got.any() and not want.any()
    tol = BF16_TOL if w_dtype == torch.bfloat16 else F32_ATOL
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    # the wrapper takes the plain version on the CPU, and counts nothing
    before = L.lstm_weight_grad.launches
    torch.testing.assert_close(L.lstm_weight_grad(out, d_xw, w_dtype, layout),
                               got, atol=0, rtol=0)
    assert L.lstm_weight_grad.launches == before


@pytest.mark.parametrize('T,B,H', [(12, 4, 8), (7, 2, 8), (16, 8, 16),
                                   (33, 3, 8)])  # tests/test_pallas_lstm.py's
def test_weight_grad_plain_matches_pallas_bwd_kernel(T, B, H):
    import jax.numpy as jnp
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (
        lstm_scan_pallas_bwd_flat, lstm_scan_pallas_train_flat)
    rng = np.random.RandomState(T + B)
    xw = rng.randn(T, B, 8 * H).astype(np.float32)
    w_hh = (rng.randn(2, H, 4 * H) * 0.1).astype(np.float32)
    out, c_seq, _, _ = (np.array(a) for a in lstm_scan_pallas_train_flat(
        jnp.asarray(xw), jnp.asarray(w_hh), interpret=True))
    cot = [rng.randn(*s).astype(np.float32)
           for s in ((T, B, 2 * H), (2, B, H), (2, B, H))]
    d_xw, want = lstm_scan_pallas_bwd_flat(
        *map(jnp.asarray, (xw, w_hh, out, c_seq, *cot)), interpret=True)
    got = L.lstm_weight_grad_plain(torch.from_numpy(out),
                                   torch.from_numpy(np.array(d_xw)),
                                   torch.float32, L.FLAT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=1e-4)


def test_weight_grad_refuses_what_it_does_not_take():
    out = torch.zeros(3, 2, 16)
    d_xw = torch.zeros(3, 2, 64)
    with pytest.raises(ValueError, match='d_xw'):
        L.lstm_weight_grad(out, d_xw[:, :1], torch.float32, L.FLAT)
    with pytest.raises(ValueError, match='d_xw'):
        L.lstm_weight_grad(out, d_xw.bfloat16(), torch.float32, L.FLAT)
    # the flat layout takes out and the weights in one type, f32 or bf16
    with pytest.raises(TypeError, match='w_dtype'):
        L.lstm_weight_grad(out, d_xw, torch.bfloat16, L.FLAT)
    assert L.lstm_weight_grad(out.bfloat16(), d_xw, torch.bfloat16,
                              L.FLAT).dtype == torch.float32
    with pytest.raises(ValueError, match='layout'):
        L.lstm_weight_grad(out, d_xw, torch.float32, 2)
    with pytest.raises(ValueError, match='shape'):
        L.lstm_weight_grad(out, d_xw, torch.float32, L.STACKED)
    with pytest.raises(ValueError, match='CUDA'):
        L.lstm_weight_grad(out.to('meta'), d_xw.to('meta'), torch.float32,
                           L.FLAT)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_exchange_floor_runs_on_a_card_only(dtype):
    """The floor takes K1's inputs, f32 or bf16, and runs on a card only."""
    xw, w_hh = torch.zeros(2, 1, 64, dtype=dtype), torch.zeros(2, 8, 32,
                                                               dtype=dtype)
    with pytest.raises(ValueError, match='CUDA'):
        L.lstm_exchange_floor(xw, w_hh)
    with pytest.raises(TypeError, match='w_hh'):
        L.lstm_exchange_floor(xw, w_hh.double())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bwd_exchange_floor_runs_on_a_card_only(dtype):
    """The backward's floor takes K4's inputs and runs on a card only."""
    T, B, H = 2, 1, 256
    f32 = torch.float32
    args = [torch.zeros(T, B, 8 * H, dtype=dtype),
            torch.zeros(2, H, 4 * H, dtype=dtype),
            torch.zeros(T, B, 2 * H, dtype=dtype),
            torch.zeros(T, 2, B, H, dtype=f32),
            torch.zeros(T, B, 2 * H, dtype=dtype),
            torch.zeros(2, B, H, dtype=f32), torch.zeros(2, B, H, dtype=f32)]
    with pytest.raises(ValueError, match='CUDA'):
        L.lstm_bwd_exchange_floor(*args)
    with pytest.raises(TypeError, match='w_hh'):
        L.lstm_bwd_exchange_floor(args[0], args[1].double(), *args[2:])


class _FakeLibrary:
    """The C side's row and cluster queries of the recurrences, recorded:
    127 rows a cluster, 15 clusters at once."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def query(*args):
            self.calls.append((name, args))
            return 127 if name.endswith('_max_rows') else 15
        return query


@pytest.mark.parametrize('kernel,x_bytes,w_bytes,sizes', [
    ('svtsg_lstm', 2, 2, (2, 2)), ('svtsg_lstm', 4, 4, (4, 4)),
    ('svtsg_lstm', 2, 4, (2, 4)), ('svtsg_lstm', 4, 2, (4, 2)),
    ('svtsg_lstm_bwd', 2, 2, (2, 2)), ('svtsg_lstm_bwd', 4, 4, (4, 4)),
    ('svtsg_lstm_bwd', 2, 4, (2, 4)), ('svtsg_lstm_bwd', 4, 2, (4, 2))])
def test_cluster_plan_asks_the_forward_with_the_weights_bytes(
        monkeypatch, kernel, x_bytes, w_bytes, sizes):
    """The rows a cluster of either recurrence holds depend on W_hh's
    dtype as well as xw's (at H=256 bf16 W_hh runs the tensor-core
    kernels, forward and backward, whose rows take other shared memory),
    so the plan passes both sizes to the C queries of both. Half the
    clusters the card holds run the slices of one direction."""
    fake = _FakeLibrary()
    monkeypatch.setattr(L._kernels, 'library', lambda: fake)
    L._cluster_plan.cache_clear()
    try:
        plan = L._cluster_plan('test', kernel, 256, x_bytes, 0, w_bytes)
    finally:
        L._cluster_plan.cache_clear()
    assert plan == (127, 7, False)
    assert fake.calls == [
        (kernel + '_max_rows', (256, L._kernels.MAX_SMEM_BYTES, *sizes, 0)),
        (kernel + '_active_clusters', (256, 127, *sizes, 0, 0))]


# --- the row slices -------------------------------------------------------------

@pytest.mark.parametrize('a_wave', [7, 1, 66])
@pytest.mark.parametrize('cap', [1, 8, 32])
def test_row_slices_cover_every_row_once(cap, a_wave):
    """For B from 1 to 600, on cards that run 7, 1 or 66 slices a direction
    at once: contiguous near-equal ranges from 0 to B, none above the cap,
    and the ranges the kernels derive from their count."""
    for B in range(1, 601):
        slices = L._row_slices(B, cap, a_wave)
        n = len(slices)
        assert slices[0][0] == 0 and slices[-1][1] == B
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        sizes = [b1 - b0 for b0, b1 in slices]
        assert min(sizes) >= 1 and max(sizes) <= cap
        assert max(sizes) - min(sizes) <= 1
        # slice_rows of csrc/common.cuh, from the count alone
        base, extra = divmod(B, n)
        derived = [(i * base + min(i, extra),
                    i * base + min(i, extra) + base + (i < extra))
                   for i in range(n)]
        assert derived == slices


@pytest.mark.parametrize('B,cap,n,rows', [
    (32, 23, 7, 5), (64, 23, 7, 10), (64, 13, 7, 10), (128, 13, 13, 10),
    (512, 23, 27, 19), (256, 23, 14, 19), (5, 23, 5, 1), (1, 1, 1, 1)])
def test_row_slices_fill_the_card(B, cap, n, rows):
    """On a card that runs 7 slices a direction at once (an H100 SXM holds
    15 clusters), a small batch is spread over 7 slices, a large one over
    about a multiple of 7."""
    slices = L._row_slices(B, cap, 7)
    assert len(slices) == n and max(b1 - b0 for b0, b1 in slices) == rows


def test_row_slices_refuse_an_empty_cap():
    with pytest.raises(ValueError, match='cap'):
        L._row_slices(4, 0, 7)
    with pytest.raises(ValueError, match='a_wave'):
        L._row_slices(4, 2, 0)


# --- the weight-gradient kernel's split planner --------------------------------

def _card(sms, per_sm=2):
    """The clusters of 1..8 blocks a card of ``sms`` SMs holds at once with
    ``per_sm`` blocks an SM, where no GPC leaves an SM over."""
    return [sms * per_sm // s for s in range(1, L.WG_MAX_SPLITS + 1)]


# what an NVIDIA H100 80GB HBM3 holds of the kernel (chip_smoke.py's [K4w]
# active_clusters): its GPCs leave SMs over, so 30 clusters of 8 two-block
# SMs, not 33
GPC_LIMITED = [264, 132, 79, 62, 47, 39, 32, 30]
PLAN_SHAPES = [(128, 64, 256), (128, 128, 256), (15, 32, 256),
               (128, 64, 512), (128, 8, 512), (40, 37, 128), (2, 1, 8),
               (1, 3, 8), (18, 3, 64), (33, 5, 256)]


def _fill(plan, active):
    return Fraction(plan.tiles * plan.splits, plan.waves * active[0])


def _pair_splits(pairs, splits):
    """The pairs [q0, q1) each rank of a weight-gradient cluster takes:
    ``slice_rows(pairs, splits, rank)`` of ``csrc/common.cuh``."""
    base, extra = divmod(pairs, splits)
    return [(r * base + min(r, extra), (r + 1) * base + min(r + 1, extra))
            for r in range(splits)]


@pytest.mark.parametrize('splits', range(1, L.WG_MAX_SPLITS + 1))
def test_pair_splits_cover_every_pair_once_in_order(splits):
    for pairs in range(0, 300):
        ranges = _pair_splits(pairs, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == pairs
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [q1 - q0 for q0, q1 in ranges]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)  # the longer ones first


@pytest.mark.parametrize('active', [_card(132), _card(114), _card(1),
                                    GPC_LIMITED],
                         ids=['132sm', '114sm', '1sm', 'gpc_limited'])
@pytest.mark.parametrize('T,B,H', PLAN_SHAPES)
def test_weight_grad_plan_keeps_its_limits(T, B, H, active):
    """S <= 8, S <= P and at least WG_MIN_PAIRS pairs a split where S > 1;
    every tile gets a cluster; the tiles cover d_w_hh [2, H, 4H]."""
    plan = L._weight_grad_plan(T, B, H, active)
    pairs = max(T - 1, 0) * B
    assert 1 <= plan.splits <= L.WG_MAX_SPLITS
    assert plan.splits == 1 or (plan.splits <= pairs
                                and pairs // plan.splits >= L.WG_MIN_PAIRS)
    assert plan.waves * active[plan.splits - 1] >= plan.tiles
    assert (plan.waves - 1) * active[plan.splits - 1] < plan.tiles
    tiles = 2 * -(-H // L.WG_TILE) * -(-4 * H // L.WG_TILE)
    assert plan.tiles == tiles
    # no other S the limits allow fills more of the waves' blocks
    most = min(L.WG_MAX_SPLITS, max(1, pairs // L.WG_MIN_PAIRS))
    for s in (s for s in range(1, most + 1) if active[s - 1] >= 1):
        other = L.WeightGradPlan(s, tiles, -(-tiles // active[s - 1]))
        assert _fill(other, active) <= _fill(plan, active)


@pytest.mark.parametrize('sms,want', [
    (132, {(128, 64, 256): 8, (128, 128, 256): 8, (15, 32, 256): 8,
           (128, 64, 512): 2}),
    (114, {(128, 64, 256): 7, (128, 128, 256): 7, (15, 32, 256): 7,
           (128, 64, 512): 7}),
    (1, {(128, 64, 256): 1, (128, 128, 256): 1, (15, 32, 256): 1,
         (128, 64, 512): 1})])
def test_weight_grad_plan_fills_whole_waves(sms, want):
    """At the main path's shapes the grid fills at least 96% of the blocks
    its waves could hold, on cards of 132, 114 and 1 SMs."""
    active = _card(sms)
    for shape, splits in want.items():
        plan = L._weight_grad_plan(*shape, active)
        assert plan.splits == splits, (shape, plan)
        assert _fill(plan, active) >= Fraction(96, 100), (shape, plan)


def test_weight_grad_plan_follows_the_clusters_the_card_holds():
    """Where the GPCs hold 30 clusters of 8, not the 32 that 32 tiles need,
    the plan takes 7 blocks a tile in one wave, not 8 in two."""
    plan = L._weight_grad_plan(128, 64, 256, GPC_LIMITED)
    assert plan == L.WeightGradPlan(7, 32, 1)
    assert L._weight_grad_plan(128, 64, 256, _card(132)).splits == 8


@pytest.mark.parametrize('T,B,want', [(1, 64, 1), (2, 1, 1), (2, 31, 1),
                                      (2, 64, 2), (3, 100, 6), (5, 1, 1)])
def test_weight_grad_plan_for_few_pairs(T, B, want):
    """T=1 has no pair (one split of none: the kernel writes zeros); fewer
    pairs than 8 splits of WG_MIN_PAIRS take fewer splits."""
    plan = L._weight_grad_plan(T, B, 256, _card(132))
    assert plan.splits == want
    pairs = max(T - 1, 0) * B
    assert _pair_splits(pairs, plan.splits)[-1][1] == pairs


def test_weight_grad_plan_refuses_an_empty_card():
    with pytest.raises(ValueError, match='clusters'):
        L._weight_grad_plan(128, 64, 256, [0] * 8)
    with pytest.raises(ValueError, match='clusters'):
        L._weight_grad_plan(128, 64, 256, [264, 132])


@pytest.mark.parametrize('T,B,H,x_bytes,w_dtype,ms,by', [
    (128, 64, 256, 4, torch.float32, 2 * 2 * 127 * 64 * 256 * 1024 / 67e9,
     'operations'),
    (15, 32, 256, 4, torch.float32, 2 * 2 * 14 * 32 * 256 * 1024 / 67e9,
     'operations'),
    (128, 64, 256, 2, torch.bfloat16,
     (2 * 127 * 64 * (256 * 2 + 1024 * 4) + 2 * 256 * 1024 * 4) / 3.35e9,
     'bytes'),
    (1, 3, 8, 4, torch.float32, 2 * 8 * 32 * 4 / 3.35e9, 'bytes')])
def test_weight_grad_bound_counts_the_pairs_the_kernel_reads(
        T, B, H, x_bytes, w_dtype, ms, by):
    """The bound counts the (T-1)*B pairs a direction that have an h_prev,
    not T*B: at T=1 only d_w_hh's write is left."""
    from shufflingvideosfortsg_torch.measure_weight_grad import (
        weight_grad_bound)
    got_ms, got_by = weight_grad_bound(T, B, H, x_bytes, w_dtype)
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-12)


# --- on the card ---------------------------------------------------------------

# out and the weights bf16 (flat or stacked): the tensor-core kernel
ALL_COMBOS = [(L.FLAT, torch.float32, torch.float32),
              (L.FLAT, torch.bfloat16, torch.bfloat16),
              (L.STACKED, torch.float32, torch.float32),
              (L.STACKED, torch.float32, torch.bfloat16),
              (L.STACKED, torch.bfloat16, torch.float32),
              (L.STACKED, torch.bfloat16, torch.bfloat16)]


def _cuda_operands(layout, x_dtype, T, B, H):
    rng = np.random.RandomState(T + B)
    shapes = ((T, B, 2 * H), (T, B, 8 * H)) if layout == L.FLAT \
        else ((T, 2, B, H), (T, 2, B, 4 * H))
    out = torch.from_numpy(np.tanh(rng.randn(*shapes[0])).astype(np.float32)
                           ).to('cuda', x_dtype)
    d_xw = torch.from_numpy((rng.randn(*shapes[1]) * 0.1).astype(np.float32)
                            ).cuda()
    return out, d_xw


# the main path's shapes (video and sentence layers, B=128 chunks, the
# [wide] width), H=128, T=2, T=1, and P = 51, 160 and 952 pairs, which are
# not a multiple of a stage's 16 or 32
@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 64, 256), (33, 5, 256), (9, 2, 8),
                                   (1, 3, 8), (128, 128, 256), (15, 32, 256),
                                   (40, 37, 128), (128, 8, 512), (2, 1, 8),
                                   (18, 3, 64), (2, 1, 256), (9, 119, 256)])
@pytest.mark.parametrize('layout,x_dtype,w_dtype', ALL_COMBOS)
def test_weight_grad_kernel_matches_plain_on_cuda(layout, x_dtype, w_dtype,
                                                  T, B, H):
    out, d_xw = _cuda_operands(layout, x_dtype, T, B, H)
    before = L.lstm_weight_grad.launches
    got = L.lstm_weight_grad(out, d_xw, w_dtype, layout)
    torch.cuda.synchronize()
    assert L.lstm_weight_grad.launches == before + 1
    want = L.lstm_weight_grad_plain(out, d_xw, w_dtype, layout)
    torch.testing.assert_close(got, want, rtol=WGRAD_CUDA_RTOL,
                               atol=WGRAD_CUDA_ATOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize('T,B,H', [(128, 64, 256), (15, 32, 256)])
@pytest.mark.parametrize('layout,x_dtype,w_dtype', ALL_COMBOS)
def test_weight_grad_kernel_is_the_same_bits_twice_on_cuda(layout, x_dtype,
                                                           w_dtype, T, B, H):
    """The partial tiles are added in rank order, with no atomics."""
    out, d_xw = _cuda_operands(layout, x_dtype, T, B, H)
    first = L.lstm_weight_grad(out, d_xw, w_dtype, layout)
    second = L.lstm_weight_grad(out, d_xw, w_dtype, layout)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
