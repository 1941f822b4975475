"""The stacked-layout recurrence kernels K6a-d and the row slices of
every recurrence kernel.

The plain versions of K6a (``lstm_scan_stacked``), K6b
(``lstm_scan_stacked_train``) and K6c (``lstm_scan_stacked_bwd``) are held
against the JAX package's Pallas kernels run in interpret mode, in f32 and
with bf16 activations, weights and gates; ``StackedLSTMRecurrence`` (K6d)
against ``jax.vjp`` of ``lstm_scan_fused``; the chunk planner and the
chunked plain path against one unchunked call; and each CUDA kernel against
its plain version where a card exists. Inputs come from a numpy seed.

JAX is imported inside the JAX comparisons only, so the CUDA cases also
run on a machine without JAX:
    python -m pytest --noconftest -m requires_cuda tests/test_torch_stacked_lstm.py
"""

import numpy as np
import pytest
import torch

from shufflingvideosfortsg_torch import measure_gates_bf16
from shufflingvideosfortsg_torch.ops import lstm_scan as L
from torch_one_thread import one_torch_thread  # noqa: F401

F32_TOL = 1e-6  # f32, sums over H in another order than XLA's
GRAD_ATOL, GRAD_RTOL = 5e-6, 1e-4  # tests/test_pallas_lstm.py's VJP test
# bf16 cases: one bf16 rounding is 2^-8 (3.9e-3) relative. The plain
# version rounds after every bf16 operation, where XLA on the CPU may keep
# excess precision between them, and a sum taken in another order can
# round a value to a neighbouring bf16; differences of a few bf16 ulps of
# values near 1 are expected, and 2e-2 allows five.
BF16_TOL = 2e-2
# K6a's bf16 cases run the Pallas kernel with XLA's excess precision off,
# so both sides round at the same points and differ only by f32 sums in
# another order, which can move the rounding of a bf16 value by one ulp.
# 2e-3 admits such a move for any value below 0.5 (ulp 2^-9), and the
# test asserts that the other gate mode lies farther away, so a plain
# version that ignored gates_bf16 or always applied it would fail.
K6A_BF16_TOL = 2e-3
SHAPES = [(12, 4, 8), (7, 2, 8), (16, 8, 16), (33, 3, 8)]  # test_pallas_lstm.py
DTYPE_CASES = [  # (xw dtype, w_hh dtype, gates_bf16)
    ('bfloat16', 'float32', False), ('bfloat16', 'float32', True),
    ('float32', 'float32', True), ('float32', 'bfloat16', False),
    ('bfloat16', 'bfloat16', False), ('bfloat16', 'bfloat16', True)]


@pytest.fixture(autouse=True)
def _skip_without_cuda(request):
    if request.node.get_closest_marker('requires_cuda') and \
            not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _inputs(seed, T, B, H, scale=1.0, w_scale=0.1):
    rng = np.random.RandomState(seed)
    xw = (rng.randn(T, 2, B, 4 * H) * scale).astype(np.float32)
    w_hh = (rng.randn(2, H, 4 * H) * w_scale).astype(np.float32)
    return xw, w_hh


def _cotangents(seed, T, B, H):
    rng = np.random.RandomState(seed + 1)
    return (rng.randn(T, 2, B, H).astype(np.float32),
            rng.randn(2, B, H).astype(np.float32),
            rng.randn(2, B, H).astype(np.float32))


def _jax(a, dtype='float32'):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype='float32'):
    """A numpy array (or JAX array) as a torch tensor of ``dtype``: the
    same values the JAX side sees after its cast."""
    import jax.numpy as jnp
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(getattr(torch, dtype))


def _close(got, want, atol, rtol=0.0, name=''):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=atol, rtol=rtol, err_msg=name)


# --- K6a ----------------------------------------------------------------------

@pytest.mark.parametrize('T,B,H', SHAPES)
def test_k6a_plain_matches_pallas_kernel_f32(T, B, H):
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import lstm_scan_pallas
    xw, w_hh = _inputs(T * 10 + B, T, B, H)
    want = lstm_scan_pallas(_jax(xw), _jax(w_hh), interpret=True)
    got = L.lstm_scan_stacked_plain(_torch(xw), _torch(w_hh))
    for name, g, w in zip(('out', 'h_T', 'c_T'), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        _close(g, w, F32_TOL, name=name)


def _pallas_k6a_rounding_as_written(jx, jw, gates):
    """``lstm_scan_pallas`` in interpret mode, compiled with XLA's excess
    precision off: on the CPU, XLA otherwise drops the bf16 roundings
    between elementwise operations that the kernel spells out, and its
    gates_bf16 output lies as near the f32 gates' as the plain version's."""
    import jax
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import lstm_scan_pallas
    fn = jax.jit(lambda x, w: lstm_scan_pallas(x, w, interpret=True,
                                               gates_bf16=gates))
    return fn.lower(jx, jw).compile(
        compiler_options={'xla_allow_excess_precision': False})(jx, jw)


@pytest.mark.parametrize('xdt,wdt,gates', DTYPE_CASES)
@pytest.mark.parametrize('T,B,H', [(12, 4, 16), (33, 3, 8)])
def test_k6a_plain_matches_pallas_kernel_bf16(T, B, H, xdt, wdt, gates):
    xw, w_hh = _inputs(T + B, T, B, H, scale=0.5, w_scale=1 / np.sqrt(H))
    jx, jw = _jax(xw, xdt), _jax(w_hh, wdt)
    want = _pallas_k6a_rounding_as_written(jx, jw, gates)
    other_mode = _pallas_k6a_rounding_as_written(jx, jw, not gates)
    got = L.lstm_scan_stacked_plain(_torch(jx, xdt), _torch(jw, wdt), gates)
    assert got[0].dtype == getattr(torch, xdt)
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(('out', 'h_T', 'c_T'), got, want):
        _close(g, w, K6A_BF16_TOL, name=name)
    # the tolerance tells the gate modes apart
    assert max(np.abs(g.float().numpy() - np.asarray(w).astype(np.float32)
                      ).max() for g, w in zip(got, other_mode)) > K6A_BF16_TOL


# --- K6b, K6c -----------------------------------------------------------------

@pytest.mark.parametrize('xdt,wdt', [('float32', 'float32'),
                                     ('bfloat16', 'float32'),
                                     ('bfloat16', 'bfloat16')])
@pytest.mark.parametrize('T,B,H', [(12, 4, 8), (16, 8, 16), (33, 3, 8)])
def test_k6b_plain_matches_pallas_train_kernel(T, B, H, xdt, wdt):
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (
        lstm_scan_pallas_train)
    xw, w_hh = _inputs(T * 3 + B, T, B, H)
    jx, jw = _jax(xw, xdt), _jax(w_hh, wdt)
    want = lstm_scan_pallas_train(jx, jw, interpret=True)
    got = L.lstm_scan_stacked_train_plain(_torch(jx, xdt), _torch(jw, wdt))
    tol = F32_TOL if xdt == wdt == 'float32' else BF16_TOL
    for name, g, w in zip(('out', 'c_seq', 'h_T', 'c_T'), got, want):
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split('.')[-1] == str(w.dtype), name
        _close(g, w, tol, name=name)


@pytest.mark.parametrize('xdt,wdt', [('float32', 'float32'),
                                     ('bfloat16', 'float32'),
                                     ('float32', 'bfloat16'),
                                     ('bfloat16', 'bfloat16')])
@pytest.mark.parametrize('T,B,H', [(9, 3, 8), (12, 4, 16)])
def test_k6c_plain_matches_pallas_bwd_kernel(T, B, H, xdt, wdt):
    """The residuals are the Pallas forward's, so both backwards see the
    same out and c_seq; bf16 cases use the bf16 tolerance relative to the
    gradients' scale as well."""
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import (
        lstm_scan_pallas_bwd, lstm_scan_pallas_train)
    xw, w_hh = _inputs(T + B, T, B, H)
    jx, jw = _jax(xw, xdt), _jax(w_hh, wdt)
    out, c_seq, _, _ = lstm_scan_pallas_train(jx, jw, interpret=True)
    d_out, d_hT, d_cT = _cotangents(T + B, T, B, H)
    jd_out = _jax(d_out, xdt)
    want = lstm_scan_pallas_bwd(jx, jw, out, c_seq, jd_out, _jax(d_hT),
                                _jax(d_cT), interpret=True)
    got = L.lstm_scan_stacked_bwd_plain(
        _torch(jx, xdt), _torch(jw, wdt), _torch(out, xdt), _torch(c_seq),
        _torch(jd_out, xdt), _torch(d_hT), _torch(d_cT))
    bf16 = not xdt == wdt == 'float32'
    for name, g, w in zip(('d_xw', 'd_w_hh'), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        _close(g, w, BF16_TOL if bf16 else GRAD_ATOL,
               BF16_TOL if bf16 else GRAD_RTOL, name)


# --- K6d ----------------------------------------------------------------------

@pytest.mark.parametrize('xdt,wdt', [('float32', 'float32'),
                                     ('bfloat16', 'bfloat16')])
@pytest.mark.parametrize('T,B,H', [(9, 3, 8), (12, 4, 16)])
def test_k6d_grads_match_jax_lstm_scan_fused(T, B, H, xdt, wdt):
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from shufflingvideosfortsg_tpu.ops.pallas.lstm_scan import lstm_scan_fused
    xw, w_hh = _inputs(T * 7 + B, T, B, H)
    co, co_h, co_c = _cotangents(T * 7 + B, T, B, H)
    jx, jw = _jax(xw, xdt), _jax(w_hh, wdt)
    with pltpu.force_tpu_interpret_mode():
        (o_j, h_j, c_j), vjp = jax.vjp(lstm_scan_fused, jx, jw)
        want = vjp((_jax(co, o_j.dtype), _jax(co_h), _jax(co_c)))
    x = _torch(jx, xdt).requires_grad_()
    w = _torch(jw, wdt).requires_grad_()
    o, h, c = L.lstm_scan_stacked(x, w)
    assert 'StackedLSTMRecurrence' in type(o.grad_fn).__name__
    torch.autograd.backward((o, h, c), (_torch(co, xdt), _torch(co_h),
                                        _torch(co_c)))
    bf16 = xdt == 'bfloat16'
    _close(o.detach(), o_j, BF16_TOL if bf16 else F32_TOL, name='out')
    for name, g, ww, t in zip(('xw', 'w_hh'), (x.grad, w.grad), want,
                              (x, w)):
        assert g.dtype == t.dtype, name
        _close(g, ww, BF16_TOL if bf16 else GRAD_ATOL,
               BF16_TOL if bf16 else GRAD_RTOL, name)


@pytest.mark.parametrize('unused', ['h_T', 'c_T'])
def test_k6d_takes_outputs_without_a_gradient(unused):
    """An output that reaches no loss gets a zero cotangent; the gradient
    equals autograd through the plain forward."""
    T, B, H = 6, 2, 8
    xw, w_hh = _inputs(5, T, B, H)
    grads = []
    for fn in (L.StackedLSTMRecurrence.apply, L.lstm_scan_stacked_plain):
        x, w = (torch.from_numpy(a).requires_grad_() for a in (xw, w_hh))
        o, h, c = fn(x, w)
        kept = c if unused == 'h_T' else h
        (o.square().sum() + kept.sum()).backward()
        grads.append((x.grad, w.grad))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


# --- the wrappers ---------------------------------------------------------------

def test_k6_wrappers_take_the_plain_versions_on_cpu():
    xw, w_hh = (torch.from_numpy(a) for a in _inputs(1, 5, 3, 8))
    counts = (L.lstm_scan_stacked.launches, L.lstm_scan_stacked_train.launches,
              L.lstm_scan_stacked_bwd.launches)
    for gates in (False, True):
        for g, w in zip(L.lstm_scan_stacked(xw, w_hh, gates),
                        L.lstm_scan_stacked_plain(xw, w_hh, gates)):
            assert torch.equal(g, w)
    out, c_seq, h_T, c_T = L.lstm_scan_stacked_train(xw, w_hh)
    cot = [torch.from_numpy(a) for a in _cotangents(1, 5, 3, 8)]
    args = (xw, w_hh, out, c_seq, *cot)
    for g, w in zip(L.lstm_scan_stacked_bwd(*args),
                    L.lstm_scan_stacked_bwd_plain(*args)):
        assert torch.equal(g, w)
    assert (L.lstm_scan_stacked.launches, L.lstm_scan_stacked_train.launches,
            L.lstm_scan_stacked_bwd.launches) == counts


def test_k6_wrappers_check_and_refuse():
    T, B, H = 4, 2, 8
    xw, w_hh = (torch.from_numpy(a) for a in _inputs(2, T, B, H))
    with pytest.raises(ValueError, match='w_hh'):
        L.lstm_scan_stacked(xw, w_hh[:, :4])
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        L.lstm_scan_stacked(xw.double(), w_hh)
    with pytest.raises(RuntimeError, match='gates_bf16'):
        L.lstm_scan_stacked(xw.requires_grad_(), w_hh, gates_bf16=True)
    out, c_seq, _, _ = L.lstm_scan_stacked_train(xw.detach(), w_hh)
    d_out, d_hT, d_cT = (torch.from_numpy(a) for a in _cotangents(2, T, B, H))
    with pytest.raises(TypeError, match='d_out'):
        L.lstm_scan_stacked_bwd(xw.detach(), w_hh, out, c_seq,
                                d_out.bfloat16(), d_hT, d_cT)
    with pytest.raises(ValueError, match='c_seq'):
        L.lstm_scan_stacked_bwd(xw.detach(), w_hh, out, c_seq[:, :1], d_out,
                                d_hT, d_cT)
    meta = [torch.empty(a.shape, device='meta')
            for a in (xw, w_hh, out, c_seq, d_out, d_hT, d_cT)]
    for fn, args in ((L.lstm_scan_stacked, meta[:2]),
                     (L.lstm_scan_stacked_train, meta[:2]),
                     (L.lstm_scan_stacked_bwd, meta)):
        with pytest.raises(ValueError, match='CUDA'):
            fn(*args)


# --- batch chunks ---------------------------------------------------------------

@pytest.mark.parametrize('B,cap,want', [
    (32, 186, [(0, 32)]), (64, 108, [(0, 64)]), (186, 186, [(0, 186)]),
    (256, 186, [(0, 128), (128, 256)]), (128, 108, [(0, 64), (64, 128)]),
    (512, 186, [(0, 171), (171, 342), (342, 512)]),
    (7, 2, [(0, 2), (2, 4), (4, 6), (6, 7)]), (5, 1, [(i, i + 1) for i in range(5)])])
def test_batch_chunks_are_the_fewest_near_equal_ranges(B, cap, want):
    got = L._batch_chunks(B, cap)
    assert got == want
    sizes = [b1 - b0 for b0, b1 in got]
    assert len(got) == -(-B // cap) and max(sizes) <= cap
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == B


def test_batch_chunks_refuse_an_empty_cap():
    with pytest.raises(ValueError, match='cap'):
        L._batch_chunks(4, 0)


@pytest.mark.parametrize('layout', ['flat', 'stacked'])
def test_chunked_plain_path_matches_one_call(layout):
    """What the kernels' clusters do with the batch's row slices, on the
    plain versions: each slice's rows of every output in place, d_w_hh the
    sum over the slices."""
    T, B, H = 6, 7, 8
    xw, w_hh = _inputs(9, T, B, H)
    rng = np.random.RandomState(3)
    if layout == 'flat':
        xw = xw.transpose(0, 2, 1, 3).reshape(T, B, 8 * H)  # any [T, B, 8H]
        fwd, bwd = L.lstm_recurrence_train_plain, L.lstm_recurrence_bwd_plain
        out_shape = (T, B, 2 * H)
        cut = {'xw': 1, 'out': 1}
    else:
        fwd, bwd = L.lstm_scan_stacked_train_plain, L.lstm_scan_stacked_bwd_plain
        out_shape, cut = (T, 2, B, H), {'xw': 2, 'out': 2}
    xw, w_hh = torch.from_numpy(np.ascontiguousarray(xw)), torch.from_numpy(w_hh)
    cot = [torch.from_numpy(rng.randn(*s).astype(np.float32))
           for s in (out_shape, (2, B, H), (2, B, H))]
    whole_fwd = fwd(xw, w_hh)
    whole_bwd = bwd(xw, w_hh, whole_fwd[0], whole_fwd[1], *cot)

    def rows_of(t, dim, b0, b1):
        return t.narrow(dim, b0, b1 - b0).contiguous()

    parts_fwd, parts_bwd = [], []
    for b0, b1 in L._batch_chunks(B, 3):
        x = rows_of(xw, cut['xw'], b0, b1)
        f = fwd(x, w_hh)
        parts_fwd.append(f)
        parts_bwd.append(bwd(x, w_hh, f[0], f[1],
                             rows_of(cot[0], cut['out'], b0, b1),
                             rows_of(cot[1], 1, b0, b1),
                             rows_of(cot[2], 1, b0, b1)))
    dims = (cut['out'], 2, 1, 1)  # out, c_seq [T, 2, B, H], h_T, c_T
    for k, dim in enumerate(dims):
        torch.testing.assert_close(torch.cat([p[k] for p in parts_fwd], dim),
                                   whole_fwd[k], atol=0, rtol=0)
    torch.testing.assert_close(torch.cat([p[0] for p in parts_bwd],
                                         cut['xw']), whole_bwd[0],
                               atol=0, rtol=0)
    torch.testing.assert_close(sum(p[1] for p in parts_bwd), whole_bwd[1],
                               atol=1e-5, rtol=1e-5)  # a sum in another order


# --- the measurement entry point ------------------------------------------------

def test_measure_gates_bf16_on_cpu_prints_its_lines(capsys):
    measure_gates_bf16.main(['--t', '4', '--b', '3', '--h', '8', '--iters',
                             '2', '--warmup', '1', '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('device: cpu')
    assert lines[1] == 'shape T=4 B=3 H=8 dtype=bf16'
    assert lines[2].startswith('gates f32 :') and lines[2].endswith('ms/layer')
    assert lines[3].startswith('gates bf16:') and 'ms/layer' in lines[3]
    assert lines[4].startswith('divergence: max_abs=')
    max_abs = float(lines[4].split('max_abs=')[1].split()[0])
    assert 0.0 < max_abs < 0.1  # bf16 gates move the output, a little


def test_measure_gates_bf16_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        measure_gates_bf16.measure(4, 3, 8, device='cuda')


# --- on the card ---------------------------------------------------------------

K6_CUDA_TOL = 1e-4      # f32, as K1: sums over H in another order, T steps
K6_CUDA_BF16_TOL = 2e-2  # a few bf16 ulps, as BF16_TOL
# K6a: the same rounding points on both sides, so at most one bf16 ulp of
# values below 1 (2^-8), as chip_smoke.py's K6A_BF16_TOL
K6A_CUDA_BF16_TOL = 4e-3
# K6a with gates_bf16 rounds the pre-activation itself, so a sum in another
# order than the plain version's flips a gate by an ulp now and then and
# the row drifts. As chip_smoke.py's K6A_GATES_TOL, K6A_GATES_SHARE and
# K6A_GATES_MEAN_TOL, where the readings stand: the largest error of out
# and h_T is held to two bf16 ulps of values below 1 and that of c_T, which
# is not bounded by 1, to 1e-2; at most 2e-4 of an output's elements may lie
# more than K6A_CUDA_BF16_TOL off; and each output's MEAN error is held
# below what the two gate modes differ by.
K6A_CUDA_GATES_TOL = (8e-3, 8e-3, 1e-2)  # out, h_T, c_T
K6A_CUDA_GATES_SHARE = 2e-4
K6A_CUDA_GATES_MEAN_TOL = 2e-4
K6C_CUDA_RTOL, K6C_CUDA_ATOL = 1e-3, 1e-4  # as K4


@pytest.mark.requires_cuda
@pytest.mark.parametrize('xdt,wdt,gates', [('float32', 'float32', False)]
                         + DTYPE_CASES)
@pytest.mark.parametrize('T,B,H', [(128, 200, 256), (33, 5, 256), (9, 2, 8)])
def test_k6a_kernel_matches_plain_on_cuda(T, B, H, xdt, wdt, gates):
    """At (128, 200, 256) the other gate mode's plain version must differ
    from the kernel by more than the tolerance, so the flag is tested."""
    xw, w_hh = _inputs(T + B, T, B, H, scale=0.5, w_scale=1 / np.sqrt(H))
    x = torch.from_numpy(xw).to('cuda', getattr(torch, xdt))
    w = torch.from_numpy(w_hh).to('cuda', getattr(torch, wdt))
    before = L.lstm_scan_stacked.launches
    with torch.no_grad():
        got = L.lstm_scan_stacked(x, w, gates)
        want = L.lstm_scan_stacked_plain(x, w, gates)
        other_mode = L.lstm_scan_stacked_plain(x, w, not gates)
    torch.cuda.synchronize()
    assert L.lstm_scan_stacked.launches == before + 1  # any B: one launch
    tol = K6_CUDA_TOL if xdt == wdt == 'float32' else K6A_CUDA_BF16_TOL
    for g, ww, gates_tol in zip(got, want, K6A_CUDA_GATES_TOL):
        assert g.dtype == ww.dtype and g.shape == ww.shape
        diff = (g.float() - ww.float()).abs()
        assert diff.max().item() <= (gates_tol if gates else tol)
        if gates:
            assert (diff > K6A_CUDA_BF16_TOL).float().mean().item() \
                <= K6A_CUDA_GATES_SHARE
            assert diff.mean().item() <= K6A_CUDA_GATES_MEAN_TOL
    if B == 200:
        gaps = [(g.float() - o.float()).abs() for g, o in zip(got, other_mode)]
        assert max(d.max().item() for d in gaps) > K6A_CUDA_BF16_TOL
        assert min(d.mean().item() for d in gaps) > K6A_CUDA_GATES_MEAN_TOL


# with bf16 w_hh at H=256 K6c's recurrence is the tensor-core kernel, also
# with f32 xw (whose out rows it rounds to bf16 once, as they land)
@pytest.mark.requires_cuda
@pytest.mark.parametrize('xdt,wdt', [('float32', 'float32'),
                                     ('bfloat16', 'bfloat16'),
                                     ('float32', 'bfloat16')])
@pytest.mark.parametrize('T,B,H', [(128, 64, 256), (33, 120, 256), (9, 2, 8)])
def test_k6b_k6c_kernels_match_plain_on_cuda(T, B, H, xdt, wdt):
    # the scales of chip_smoke.py: xw ~ 0.5 randn, w_hh ~ randn / sqrt(H)
    xw, w_hh = _inputs(T + B, T, B, H, scale=0.5, w_scale=1 / np.sqrt(H))
    x = torch.from_numpy(xw).to('cuda', getattr(torch, xdt))
    w = torch.from_numpy(w_hh).to('cuda', getattr(torch, wdt))
    cot = [torch.from_numpy(a).cuda() for a in _cotangents(T, T, B, H)]
    cot[0] = cot[0].to(x.dtype)
    got = L.lstm_scan_stacked_train(x, w)
    want = L.lstm_scan_stacked_train_plain(x, w)
    torch.cuda.synchronize()
    bf16 = 'bfloat16' in (xdt, wdt)
    for g, ww in zip(got, want):
        assert (g.float() - ww.float()).abs().max().item() <= \
            (K6_CUDA_BF16_TOL if bf16 else K6_CUDA_TOL)
    before = L.lstm_scan_stacked_bwd.launches
    args = (x, w, want[0], want[1], *cot)
    for g, ww in zip(L.lstm_scan_stacked_bwd(*args),
                     L.lstm_scan_stacked_bwd_plain(*args)):
        torch.cuda.synchronize()
        torch.testing.assert_close(
            g, ww, rtol=K6_CUDA_BF16_TOL if bf16 else K6C_CUDA_RTOL,
            atol=K6_CUDA_BF16_TOL if bf16 else K6C_CUDA_ATOL)
    assert L.lstm_scan_stacked_bwd.launches == before + 1  # any B


@pytest.mark.requires_cuda
def test_chunked_k1_k4_match_plain_on_cuda():
    """K1 and K4 at B=256 and B=128, past the rows one cluster holds: the
    row slices go to clusters of one launch."""
    T, H = 16, 256
    rng = np.random.RandomState(4)
    for B in (256, 128):
        xw = torch.from_numpy(rng.randn(T, B, 8 * H).astype(np.float32)).cuda()
        w = torch.from_numpy((rng.randn(2, H, 4 * H) * 0.05)
                             .astype(np.float32)).cuda()
        n1, n4 = L.lstm_recurrence.launches, L.lstm_recurrence_bwd.launches
        with torch.no_grad():
            for g, ww in zip(L.lstm_recurrence(xw, w),
                             L.lstm_recurrence_plain(xw, w)):
                torch.cuda.synchronize()
                assert (g - ww).abs().max().item() <= K6_CUDA_TOL
        out, c_seq, _, _ = L.lstm_recurrence_train_plain(xw, w)
        cot = [torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
               for s in ((T, B, 2 * H), (2, B, H), (2, B, H))]
        args = (xw, w, out, c_seq, *cot)
        for g, ww in zip(L.lstm_recurrence_bwd(*args),
                         L.lstm_recurrence_bwd_plain(*args)):
            torch.cuda.synchronize()
            torch.testing.assert_close(g, ww, rtol=K6C_CUDA_RTOL,
                                       atol=K6C_CUDA_ATOL)
        assert L.lstm_recurrence.launches - n1 == 1
        assert L.lstm_recurrence_bwd.launches - n4 == 1
