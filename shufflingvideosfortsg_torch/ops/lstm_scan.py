"""The BiLSTM recurrence kernels: K1, K3, K4 (flat layout) and K6a-d
(stacked layout).

Counterparts of ``shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py``:

- flat layout: ``lstm_scan_pallas_flat`` (K1, :func:`lstm_recurrence`),
  ``lstm_scan_pallas_train_flat`` (K3, :func:`lstm_recurrence_train`),
  ``lstm_scan_pallas_bwd_flat`` (K4, :func:`lstm_recurrence_bwd`) and the
  custom VJP ``lstm_flat_fused`` that joins K3 and K4
  (:class:`LSTMRecurrence`);
- stacked layout: ``lstm_scan_pallas`` (K6a, :func:`lstm_scan_stacked`),
  ``lstm_scan_pallas_train`` (K6b, :func:`lstm_scan_stacked_train`),
  ``lstm_scan_pallas_bwd`` (K6c, :func:`lstm_scan_stacked_bwd`) and the
  custom VJP ``lstm_scan_fused`` (K6d, :class:`StackedLSTMRecurrence`).

The CUDA kernels are ``csrc/lstm_scan.cu`` (K1, K3, K6a, K6b: one template
over layout and dtypes) and ``csrc/lstm_bwd.cu`` (K4, K6c). Each
``*_plain`` function is the same function as a loop of PyTorch operations,
with the kernels' rounding points, which the wrappers take for CPU tensors
and the card's checks hold the kernels against.

The recurrence is independent across batch rows, so a batch of any size
is one launch: the rows are cut into near-equal slices (:func:`_row_slices`)
and each (direction, slice) is run by one thread-block cluster of 8 blocks
that exchanges h (forward) or the dh_prev partials (backward) through
distributed shared memory, with no barrier across the grid; clusters the
card cannot hold at once queue. A cluster holds at most as many rows as
its blocks' shared memory allows (at H=256 in f32: 59 forward, 11 backward;
with bf16 xw and W_hh, on the tensor cores: 127 forward, 32 backward),
which bounds a slice, not the batch. Each block keeps its slice of W_hh in shared
memory (registers at H=256) where that leaves room for a row; from H=304 in
f32 it reads the slice from device memory instead, laid out there once a
launch (:func:`_cluster_plan` picks; 23 forward and 15 backward rows a
cluster at H=512). With bf16 W_hh at H=256 the forward multiplies on the
bf16 tensor cores and exchanges h in bf16 (127 rows a cluster with bf16
xw), and the backward takes its gate recompute and dh_prev there too
(:func:`lstm_bwd_exchange_floor` times its chain without them). The
backward's weight gradient is a second kernel of
the same launch group, outside the step loop, whose plain version is
:func:`lstm_weight_grad_plain`: a product over the (T-1)*B (step, row)
pairs, split over them inside a thread-block cluster. A cluster owns one
128 x 128 tile of d_w_hh, each of its S blocks a contiguous 1/S of the
pairs (:func:`_weight_grad_plan` picks S from the clusters the card holds
at once, so that the grid fills whole waves), and the S partial tiles are
added through distributed shared memory in rank order: a fixed order, one
launch; with bf16 out and weights the products run on the bf16 tensor
cores. ``launches`` counts launches: one a call.

K1 without gradients is the custom op ``svtsg::lstm_recurrence``
(:data:`lstm_recurrence_op`: the plain version on the CPU, the launch on
a card, its output shapes on fake tensors), so that ``torch.export``
traces it as one node; its launches count inside the op, also when an
exported program runs it.
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _kernels

Tensor = torch.Tensor

# codes of the C entry points' layout and dtype arguments (csrc/common.cuh)
FLAT, STACKED = 0, 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# the flat kernels K1, K3 and K4 take xw and w_hh both f32 or both bf16
_FLAT_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(xw_flat: Tensor, w_hh: Tensor,
                  dtypes: Tuple[torch.dtype, ...] = _FLAT_DTYPES
                  ) -> Tuple[int, int, int]:
    if xw_flat.dtype not in dtypes or w_hh.dtype != xw_flat.dtype:
        raise TypeError(f'xw_flat and w_hh must both be one of {dtypes}, '
                        f'got {xw_flat.dtype} and {w_hh.dtype}')
    if xw_flat.dim() != 3 or xw_flat.shape[-1] % 8:
        raise ValueError(f'xw_flat must be [T, B, 8H], got {tuple(xw_flat.shape)}')
    T, B, H8 = xw_flat.shape
    H = H8 // 8
    if tuple(w_hh.shape) != (2, H, 4 * H):
        raise ValueError(f'w_hh must be [2, {H}, {4 * H}], got {tuple(w_hh.shape)}')
    if T < 1 or B < 1:
        raise ValueError(f'empty sequence or batch: T={T}, B={B}')
    return T, B, H


def _check_stacked(xw: Tensor, w_hh: Tensor) -> Tuple[int, int, int]:
    for name, t in (('xw', xw), ('w_hh', w_hh)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f'{name} must be float32 or bfloat16, got {t.dtype}')
    if xw.dim() != 4 or xw.shape[1] != 2 or xw.shape[-1] % 4:
        raise ValueError(f'xw must be [T, 2, B, 4H], got {tuple(xw.shape)}')
    T, _, B, H4 = xw.shape
    H = H4 // 4
    if tuple(w_hh.shape) != (2, H, H4):
        raise ValueError(f'w_hh must be [2, {H}, {H4}], got {tuple(w_hh.shape)}')
    if T < 1 or B < 1:
        raise ValueError(f'empty sequence or batch: T={T}, B={B}')
    return T, B, H


def _on_cpu(*tensors: Tensor) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def _cuda_checks(name: str, tensors, H: int) -> torch.device:
    """The conditions every recurrence kernel launch needs; raises."""
    dev = tensors[0].device
    if not (tensors[0].is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(f'{name} inputs must lie on one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f'{name} needs contiguous inputs')
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f'{name} needs 16-byte aligned inputs')
    if H % 8:
        raise ValueError(f'{name} needs H % 8 == 0, got H={H}')
    return dev


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _cluster_plan(name: str, kernel: str, H: int, x_bytes: int,
                  device: int, w_bytes: int = 4) -> Tuple[int, int, bool]:
    """What the card ``device`` gives one recurrence kernel (``kernel``:
    ``svtsg_lstm`` or ``svtsg_lstm_bwd``) at width H with activations of
    ``x_bytes`` bytes and W_hh of ``w_bytes`` bytes (at H=256 bf16 W_hh
    runs the tensor-core kernels, whose rows take other shared memory),
    asked of the C side once: (the most batch rows one
    cluster holds, from the shared-memory formula; the row slices a
    direction that fill one wave, half the clusters the card holds at once
    at that many rows, ``cudaOccupancyMaxActiveClusters``; whether the
    blocks read their W_hh slices from device memory). The slices stay in
    shared memory (in registers at H=256) wherever they leave room for a
    row, and go to device memory where they do not (from H=304 in f32).
    Raises when not even one row fits or the card holds no cluster."""
    lib = _kernels.library()
    max_rows = getattr(lib, f'{kernel}_max_rows')
    sizes = (x_bytes, w_bytes)
    w_global = False
    cap = max_rows(H, _kernels.MAX_SMEM_BYTES, *sizes, 0)
    if cap < 1:
        w_global = True
        cap = max_rows(H, _kernels.MAX_SMEM_BYTES, *sizes, 1)
    if cap < 1:
        raise ValueError(f'{name}: at H={H} one batch row needs more shared '
                         f'memory than the {_kernels.MAX_SMEM_BYTES} bytes a '
                         'block may use')
    clusters = getattr(lib, f'{kernel}_active_clusters')(
        H, cap, *sizes, int(w_global), device)
    if clusters < 0:
        _kernels.check(-clusters, f'{name}: cudaOccupancyMaxActiveClusters')
    if clusters < 1:
        raise RuntimeError(f'{name}: the card holds no cluster of 8 blocks '
                           f'at H={H}')
    return cap, max(1, clusters // 2), w_global


def _w_global(w_global: bool, H: int, dev: torch.device) -> Optional[Tensor]:
    """The device memory the kernels lay the W_hh slices out in where
    :func:`_cluster_plan` says so (``w_layout_kernel`` in
    ``csrc/common.cuh``: 2 directions x 8 blocks x H rows x (H/8 | 1)
    float4), else None."""
    if not w_global:
        return None
    return torch.empty(2 * 8 * H * ((H // 8) | 1) * 4, device=dev,
                       dtype=torch.float32)


def _batch_chunks(B: int, cap: int) -> List[Tuple[int, int]]:
    """The fewest near-equal row ranges [b0, b1) that cover B rows with at
    most ``cap`` rows each; the first ranges take the extra rows."""
    if B < 1 or cap < 1:
        raise ValueError(f'need B >= 1 and cap >= 1, got B={B}, cap={cap}')
    n = -(-B // cap)
    base, extra = divmod(B, n)
    ranges, b0 = [], 0
    for i in range(n):
        b1 = b0 + base + (i < extra)
        ranges.append((b0, b1))
        b0 = b1
    return ranges


def _row_slices(B: int, cap: int, a_wave: int) -> List[Tuple[int, int]]:
    """The row ranges [b0, b1) the clusters of one direction take: the
    near-equal ranges of :func:`_batch_chunks` with at most ``cap`` rows
    each, and no fewer than fill the card: a small batch is spread over
    ``a_wave`` slices (or one a row), a large one over a multiple of that,
    so that the last wave of clusters is as full as the others. ``a_wave``
    is the slices a direction that the card runs at once (7 on an H100 SXM,
    which holds 15 clusters: :func:`_cluster_plan`). The kernels receive
    ``len()`` of it and derive the same ranges (``slice_rows`` in
    ``csrc/common.cuh``)."""
    if a_wave < 1:
        raise ValueError(f'need a_wave >= 1, got {a_wave}')
    n = len(_batch_chunks(B, cap))
    n = min(B, -(-n // a_wave) * a_wave)
    return _batch_chunks(B, -(-B // n))


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launch_forward(name: str, xw: Tensor, w_hh: Tensor, layout: int,
                    with_c_seq: bool, gates_bf16: bool = False):
    """One launch of ``csrc/lstm_scan.cu`` over all the batch's row slices.
    K3 and K6b carry the c_seq residual, K1 and K6a do not. Returns (out,
    c_seq or None, h_T, c_T)."""
    if layout == FLAT:
        T, B, H = _check_inputs(xw, w_hh)
        out_shape = (T, B, 2 * H)
    else:
        T, B, H = _check_stacked(xw, w_hh)
        out_shape = (T, 2, B, H)
    dev = _cuda_checks(name, (xw, w_hh), H)
    lib = _kernels.library()
    cap, a_wave, w_global = _cluster_plan(name, 'svtsg_lstm', H,
                                          xw.dtype.itemsize,
                                          _device_index(dev),
                                          w_hh.dtype.itemsize)
    slices = _row_slices(B, cap, a_wave)
    f32 = dict(device=dev, dtype=torch.float32)
    out = torch.empty(out_shape, device=dev, dtype=xw.dtype)
    h_T, c_T = torch.empty(2, B, H, **f32), torch.empty(2, B, H, **f32)
    c_seq = torch.empty(T, 2, B, H, **f32) if with_c_seq else None
    ws = _w_global(w_global, H, dev)
    err = lib.svtsg_lstm_recurrence(
        xw.data_ptr(), w_hh.data_ptr(), out.data_ptr(), h_T.data_ptr(),
        c_T.data_ptr(), None if c_seq is None else c_seq.data_ptr(),
        None if ws is None else ws.data_ptr(),
        T, B, H, len(slices), layout, _DTYPE_CODES[xw.dtype],
        _DTYPE_CODES[w_hh.dtype], int(gates_bf16), _device_index(dev),
        _stream(dev))
    _kernels.check(err, name)
    return out, c_seq, h_T, c_T


def _launch_backward(name: str, args, layout: int, T: int, B: int, H: int):
    """One launch group of ``csrc/lstm_bwd.cu``: the backward recurrence
    over all the batch's row slices, then the weight-gradient kernel.
    ``args`` are (xw, w_hh, out, c_seq, d_out, d_hT, d_cT). Returns (d_xw
    f32, d_w_hh f32)."""
    xw, w_hh = args[:2]
    dev = _cuda_checks(name, args, H)
    lib = _kernels.library()
    cap, a_wave, w_global = _cluster_plan(name, 'svtsg_lstm_bwd', H,
                                          xw.dtype.itemsize,
                                          _device_index(dev),
                                          w_hh.dtype.itemsize)
    slices = _row_slices(B, cap, a_wave)
    splits = _weight_grad_splits(T, B, H, layout, xw.dtype, w_hh.dtype,
                                 _device_index(dev))
    d_xw = torch.empty(xw.shape, device=dev, dtype=torch.float32)
    d_w = torch.empty(2, H, 4 * H, device=dev, dtype=torch.float32)
    ws = _w_global(w_global, H, dev)
    err = lib.svtsg_lstm_bwd(
        *(a.data_ptr() for a in args), d_xw.data_ptr(), d_w.data_ptr(),
        None if ws is None else ws.data_ptr(),
        T, B, H, len(slices), splits, layout, _DTYPE_CODES[xw.dtype],
        _DTYPE_CODES[w_hh.dtype], _device_index(dev), _stream(dev))
    _kernels.check(err, name)
    return d_xw, d_w


def lstm_weight_grad_plain(out: Tensor, d_xw: Tensor, w_dtype: torch.dtype,
                           layout: int) -> Tensor:
    """The recurrent weights' gradient as PyTorch operations:
    ``d_w_hh[d] = sum_s h_prev[s]^T @ dgates[s]`` over the steps s >= 1,
    with h_prev the forward's ``out`` one step earlier and dgates the
    backward's ``d_xw`` (f32), both rounded to ``w_dtype`` and summed in
    f32, as the JAX bodies cast them (``ops/pallas/lstm_scan.py:444-489``).

    ``layout`` FLAT: out [T, B, 2H] in time order, d_xw [T, B, 8H]; the
    forward direction pairs ``out[t-1, :, :H]`` with ``d_xw[t, :, :4H]``,
    the backward direction ``out[t+1, :, H:]`` with ``d_xw[t, :, 4H:]``.
    STACKED: out [T, 2, B, H] and d_xw [T, 2, B, 4H] by step; ``out[s-1, d]``
    pairs with ``d_xw[s, d]``. Returns d_w_hh [2, H, 4H] f32 (zero at T=1).
    """
    f32 = torch.float32
    h = out.to(w_dtype).to(f32)
    g = d_xw.to(w_dtype).to(f32)
    if layout == FLAT:
        H = out.shape[-1] // 2
        pairs = ((h[:-1, :, :H], g[1:, :, :4 * H]),
                 (h[1:, :, H:], g[:-1, :, 4 * H:]))
    else:
        pairs = ((h[:-1, 0], g[1:, 0]), (h[:-1, 1], g[1:, 1]))
    return torch.stack([torch.einsum('sbk,sbc->kc', a, b) for a, b in pairs])


# the weight-gradient kernels' tiling (csrc/lstm_bwd.cu: kWgTile, kWgDepth,
# kWgMaxSplits) and the fewest (step, row) pairs a split takes: two stages
# of the f32 kernel, one of the tensor-core kernel (kWmDepth = 32)
WG_TILE, WG_DEPTH, WG_MAX_SPLITS = 128, 16, 8
WG_MIN_PAIRS = 2 * WG_DEPTH


class WeightGradPlan(NamedTuple):
    splits: int  # S: blocks a cluster, each a contiguous 1/S of the pairs
    tiles: int   # 128 x 128 output tiles, one cluster each
    waves: int   # waves of clusters the card runs them in


def _weight_grad_plan(T: int, B: int, H: int,
                      active: Sequence[int]) -> WeightGradPlan:
    """The weight-gradient launch at (T, B, H) on a card that holds
    ``active[s - 1]`` clusters of s blocks at once (``active[0]``: the
    blocks it holds; ``cudaOccupancyMaxActiveClusters``, which also counts
    what the card's GPCs leave). Of S = 1 .. 8 with at least
    ``WG_MIN_PAIRS`` pairs a split, the S whose grid fills the largest
    share of the blocks its waves could hold, the smallest on a tie. The
    kernel receives S and cuts the pairs into S near-equal contiguous
    ranges (``slice_rows`` in ``csrc/common.cuh``)."""
    if len(active) != WG_MAX_SPLITS or active[0] < 1:
        raise ValueError(f'need the clusters of 1..{WG_MAX_SPLITS} blocks '
                         f'the card holds, got {list(active)}')
    pairs = (T - 1) * B if T > 1 else 0
    tiles = 2 * -(-H // WG_TILE) * -(-4 * H // WG_TILE)
    best = WeightGradPlan(1, tiles, -(-tiles // active[0]))
    fill = Fraction(tiles, best.waves * active[0])
    for s in range(2, min(WG_MAX_SPLITS, max(1, pairs // WG_MIN_PAIRS)) + 1):
        if active[s - 1] < 1:
            continue
        waves = -(-tiles // active[s - 1])
        f = Fraction(tiles * s, waves * active[0])
        if f > fill:
            best, fill = WeightGradPlan(s, tiles, waves), f
    return best


@functools.lru_cache(maxsize=None)
def _weight_grad_active(layout: int, x_dtype: torch.dtype,
                        w_dtype: torch.dtype, device: int) -> Tuple[int, ...]:
    """The clusters of 1..8 blocks of the weight-gradient kernel's
    instantiation that the card ``device`` holds at once, asked of the C
    side once (``cudaOccupancyMaxActiveClusters``)."""
    lib = _kernels.library()
    active = tuple(lib.svtsg_lstm_weight_grad_active_clusters(
        s, layout, _DTYPE_CODES[x_dtype], _DTYPE_CODES[w_dtype], device)
        for s in range(1, WG_MAX_SPLITS + 1))
    for n in active:
        if n < 0:
            _kernels.check(-n, 'lstm_weight_grad: '
                           'cudaOccupancyMaxActiveClusters')
    return active


@functools.lru_cache(maxsize=None)
def _weight_grad_splits(T: int, B: int, H: int, layout: int,
                        x_dtype: torch.dtype, w_dtype: torch.dtype,
                        device: int) -> int:
    """S, the blocks a tile's cluster that the launch at (T, B, H) takes on
    the card ``device``."""
    active = _weight_grad_active(layout, x_dtype, w_dtype, device)
    return _weight_grad_plan(T, B, H, active).splits


def lstm_weight_grad(out: Tensor, d_xw: Tensor, w_dtype: torch.dtype,
                     layout: int) -> Tensor:
    """The weight-gradient kernel of ``csrc/lstm_bwd.cu`` alone (K4 and K6c
    launch it right after their recurrence). Same contract as
    :func:`lstm_weight_grad_plain`, which CPU tensors take; CUDA tensors
    launch the kernel or raise (on the flat layout out and w_dtype both
    f32 or both bf16, on the stacked layout each f32 or bf16; d_xw f32;
    contiguous, on one card, H a multiple of 8)."""
    if layout not in (FLAT, STACKED):
        raise ValueError(f'layout must be FLAT or STACKED, got {layout}')
    if out.dim() != 3 + layout or (layout == STACKED and out.shape[1] != 2):
        raise ValueError(f'out has shape {tuple(out.shape)} for layout '
                         f'{layout}')
    T, B = out.shape[0], out.shape[-2]
    H = out.shape[-1] // 2 if layout == FLAT else out.shape[-1]
    want = (T, B, 8 * H) if layout == FLAT else (T, 2, B, 4 * H)
    if tuple(d_xw.shape) != want or d_xw.dtype != torch.float32:
        raise ValueError(f'd_xw must be f32 {list(want)}, got {d_xw.dtype} '
                         f'{list(d_xw.shape)}')
    if (out.dtype not in _DTYPE_CODES or w_dtype not in _DTYPE_CODES
            or (layout == FLAT and out.dtype != w_dtype)):
        raise TypeError(f'lstm_weight_grad: out {out.dtype}, w_dtype '
                        f'{w_dtype} on layout {layout}')
    if _on_cpu(out, d_xw):
        return lstm_weight_grad_plain(out, d_xw, w_dtype, layout)
    dev = _cuda_checks('lstm_weight_grad', (out, d_xw), H)
    splits = _weight_grad_splits(T, B, H, layout, out.dtype, w_dtype,
                                 _device_index(dev))
    d_w = torch.empty(2, H, 4 * H, device=dev, dtype=torch.float32)
    err = _kernels.library().svtsg_lstm_weight_grad(
        out.data_ptr(), d_xw.data_ptr(), d_w.data_ptr(), T, B, H, splits,
        layout, _DTYPE_CODES[out.dtype], _DTYPE_CODES[w_dtype],
        _device_index(dev), _stream(dev))
    _kernels.check(err, 'lstm_weight_grad')
    lstm_weight_grad.launches += 1
    return d_w


lstm_weight_grad.launches = 0


def lstm_exchange_floor(xw_flat: Tensor, w_hh: Tensor) -> Tensor:
    """The latency floor of the forward recurrence, for measurements only:
    K1's kernel at xw's dtype (f32, or bf16: the tensor-core kernel at
    H=256) with the product left out, so that T dependent steps of
    prefetch, gate math, stores, exchange of h and cluster barrier remain.
    Same inputs as :func:`lstm_recurrence`, on a card only; returns ``out``
    (that of a layer whose w_hh is zero)."""
    T, B, H = _check_inputs(xw_flat, w_hh)
    dev = _cuda_checks('lstm_exchange_floor', (xw_flat, w_hh), H)
    cap, a_wave, w_global = _cluster_plan(
        'lstm_exchange_floor', 'svtsg_lstm', H, xw_flat.dtype.itemsize,
        _device_index(dev), w_hh.dtype.itemsize)
    if w_global:
        raise ValueError(f'lstm_exchange_floor: at H={H} the W slices do not '
                         'fit shared memory; the floor is measured where '
                         'they do')
    slices = _row_slices(B, cap, a_wave)
    f32 = dict(device=dev, dtype=torch.float32)
    out = torch.empty(T, B, 2 * H, device=dev, dtype=xw_flat.dtype)
    h_T, c_T = torch.empty(2, B, H, **f32), torch.empty(2, B, H, **f32)
    err = _kernels.library().svtsg_lstm_recurrence_floor(
        xw_flat.data_ptr(), w_hh.data_ptr(), out.data_ptr(), h_T.data_ptr(),
        c_T.data_ptr(), T, B, H, len(slices), _DTYPE_CODES[xw_flat.dtype],
        _device_index(dev), _stream(dev))
    _kernels.check(err, 'lstm_exchange_floor')
    return out


def lstm_bwd_exchange_floor(xw_flat: Tensor, w_hh: Tensor, out: Tensor,
                            c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                            d_cT: Tensor) -> Tensor:
    """The latency floor of the backward recurrence, for measurements only:
    K4's tensor-core kernel (bf16 inputs, H=256) with both products left
    out, so that T dependent steps of prefetch, the chain to dgates,
    stores, the exchange of (zero) dh_prev partials and the cluster
    barriers remain; no weight gradient. Same inputs as
    :func:`lstm_recurrence_bwd`, on a card only; returns ``d_xw`` (that of
    a layer whose W_hh is zero)."""
    args = (xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT)
    T, B, H = _check_bwd_inputs(*args)
    dev = _cuda_checks('lstm_bwd_exchange_floor', args, H)
    if xw_flat.dtype != torch.bfloat16 or H != 256:
        raise ValueError('lstm_bwd_exchange_floor: the floor is that of the '
                         'tensor-core kernel, bf16 at H=256; got '
                         f'{xw_flat.dtype} at H={H}')
    cap, a_wave, _ = _cluster_plan('lstm_bwd_exchange_floor', 'svtsg_lstm_bwd',
                                   H, 2, _device_index(dev), 2)
    slices = _row_slices(B, cap, a_wave)
    d_xw = torch.empty(xw_flat.shape, device=dev, dtype=torch.float32)
    err = _kernels.library().svtsg_lstm_bwd_floor(
        *(a.data_ptr() for a in args), d_xw.data_ptr(), T, B, H, len(slices),
        _device_index(dev), _stream(dev))
    _kernels.check(err, 'lstm_bwd_exchange_floor')
    return d_xw


def _cotangent(g: Optional[Tensor], shape, dtype, like: Tensor) -> Tensor:
    """An output's cotangent as a kernel takes it; an output that reached
    no loss has none, which is a zero cotangent."""
    if g is None:
        return like.new_zeros(shape, dtype=dtype)
    return g.to(dtype).contiguous()


# --- flat layout: K1, K3, K4 -------------------------------------------------

def _to_stacked(x_flat: Tensor, width: int) -> Tensor:
    """A flat [T, B, 2W] tensor (xw: W = 4H; out, d_out: W = H) in the
    stacked layout [T, 2, B, W]: direction 1 time-reversed, so that step s
    of either direction is row s."""
    return torch.stack([x_flat[..., :width], x_flat.flip(0)[..., width:]],
                       dim=1)


def _to_flat(x: Tensor) -> Tensor:
    """:func:`_to_stacked` undone: [T, 2, B, W] by step -> [T, B, 2W] in
    natural time order."""
    return torch.cat([x[:, 0], x.flip(0)[:, 1]], dim=-1)


def lstm_recurrence_train_plain(xw_flat: Tensor, w_hh: Tensor
                                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The recurrence as PyTorch operations (the JAX ``_lstm_scan`` step,
    ``ops/rnn.py:76-103``, on the flat layout), with the cell states of
    every step: the stacked loop (:func:`_stacked_forward_plain`) over the
    forward half and the time-reversed backward half, so in bf16 the
    rounding points of ``_lstm_kernel_train_flat``
    (``ops/pallas/lstm_scan.py:722-747``): h in f32, rounded to bf16 for
    the product, which sums in f32; the gates and c in f32; out rounded.
    Same contract as :func:`lstm_recurrence_train`."""
    T, B, H = _check_inputs(xw_flat, w_hh)
    out, c_seq, h_T, c_T = _stacked_forward_plain(
        _to_stacked(xw_flat, 4 * H), w_hh, gates_bf16=False)
    return _to_flat(out), c_seq, h_T, c_T


def lstm_recurrence_plain(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_recurrence`, as PyTorch operations:
    :func:`lstm_recurrence_train_plain` without the cell states."""
    out, _, h_T, c_T = lstm_recurrence_train_plain(xw_flat, w_hh)
    return out, h_T, c_T


def _one_device(name: str, tensors) -> None:
    """Inputs that are not all on the CPU must lie on one CUDA device:
    anything else (a 'meta' tensor, CPU beside CUDA) raises before the
    op is dispatched."""
    dev = tensors[0].device
    if not (dev.type in ('cpu', 'cuda')
            and all(t.device == dev for t in tensors)):
        raise ValueError(f'{name} inputs must all lie on the CPU or on one '
                         f'CUDA device, got {[str(t.device) for t in tensors]}')


def lstm_recurrence(xw_flat: Tensor, w_hh: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Run both directions of one BiLSTM layer.

    xw_flat: [T, B, 8H]; row t is [fwd projection(t) | bwd
    projection(t)] with biases added, and the backward half is NOT
    time-reversed. w_hh: [2, H, 4H], gate order i, f, g, o. Both f32, or
    both bf16 (``precision: bf16``): then h, held in f32, is rounded to
    bf16 for the product, which sums in f32, and the gates are taken in
    f32 (``ops/pallas/lstm_scan.py:223-236``). Zero initial state. Returns
    (out [T, B, 2H] in natural time order, in xw's dtype; h_T, c_T
    [2, B, H] f32).

    When autograd needs a gradient of either input, the call goes through
    :class:`LSTMRecurrence` (K3 forward, K4 backward). Otherwise it is the
    custom op ``svtsg::lstm_recurrence`` (:data:`lstm_recurrence_op`), the
    one route of eager calls and of programs that ``torch.export`` traces
    (``utils/aot.py``): CPU tensors take :func:`lstm_recurrence_plain`
    and CUDA tensors launch K1 (``csrc/lstm_scan.cu``) or raise: it takes
    contiguous inputs on one card, any T >= 1, H a multiple of 8 (a
    cluster's 8 blocks take H/8 units each) and any B, in one launch: the
    batch's row slices go to clusters that run independently.
    """
    if torch.is_grad_enabled() and (xw_flat.requires_grad
                                    or w_hh.requires_grad):
        return LSTMRecurrence.apply(xw_flat, w_hh)
    _check_inputs(xw_flat, w_hh)
    _one_device('lstm_recurrence', (xw_flat, w_hh))
    return lstm_recurrence_op(xw_flat, w_hh)


@torch.library.custom_op('svtsg::lstm_recurrence', mutates_args=(),
                         device_types='cpu',
                         schema='(Tensor xw_flat, Tensor w_hh) '
                                '-> (Tensor, Tensor, Tensor)')
def lstm_recurrence_op(xw_flat: Tensor, w_hh: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """K1 as the custom op ``svtsg::lstm_recurrence``; CPU tensors take
    :func:`lstm_recurrence_plain`."""
    return lstm_recurrence_plain(xw_flat, w_hh)


@lstm_recurrence_op.register_kernel('cuda')
def _lstm_recurrence_cuda(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    out, _, h_T, c_T = _launch_forward('lstm_recurrence', xw_flat, w_hh,
                                       FLAT, with_c_seq=False)
    lstm_recurrence.launches += 1
    return out, h_T, c_T


@lstm_recurrence_op.register_fake
def _lstm_recurrence_fake(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    T, B, H = xw_flat.shape[0], xw_flat.shape[1], w_hh.shape[1]
    f32 = torch.float32
    return (xw_flat.new_empty(T, B, 2 * H),
            xw_flat.new_empty(2, B, H, dtype=f32),
            xw_flat.new_empty(2, B, H, dtype=f32))


lstm_recurrence.launches = 0


def lstm_recurrence_train(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K3: :func:`lstm_recurrence` plus the cell-state residual.

    Returns (out [T, B, 2H] in xw's dtype, c_seq [T, 2, B, H], h_T, c_T
    f32), as JAX's ``_lstm_scan_pallas_train_flat_impl`` gives them.
    ``c_seq`` is indexed by STEP s, as the JAX kernel writes it:
    ``c_seq[s] = [c_fwd(t=s) | c_bwd(step s, time T-1-s)]``. CPU tensors
    take :func:`lstm_recurrence_train_plain`; CUDA tensors launch
    ``csrc/lstm_scan.cu`` with its c_seq stream on, or raise, on the same
    conditions as K1. Not differentiable itself: :class:`LSTMRecurrence`
    is.
    """
    _check_inputs(xw_flat, w_hh)
    if _on_cpu(xw_flat, w_hh):
        return lstm_recurrence_train_plain(xw_flat, w_hh)
    result = _launch_forward('lstm_recurrence_train', xw_flat, w_hh, FLAT,
                             with_c_seq=True)
    lstm_recurrence_train.launches += 1
    return result


lstm_recurrence_train.launches = 0


def _check_bwd_inputs(xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT):
    T, B, H = _check_inputs(xw_flat, w_hh)
    f32 = torch.float32
    want = {'out': ((T, B, 2 * H), xw_flat.dtype),
            'c_seq': ((T, 2, B, H), f32),
            'd_out': ((T, B, 2 * H), xw_flat.dtype),
            'd_hT': ((2, B, H), f32), 'd_cT': ((2, B, H), f32)}
    got = {'out': out, 'c_seq': c_seq, 'd_out': d_out, 'd_hT': d_hT,
           'd_cT': d_cT}
    for k, t in got.items():
        shape, dtype = want[k]
        if t.dtype != dtype:
            raise TypeError(f'lstm_recurrence_bwd: {k} must be {dtype}, got '
                            f'{t.dtype}')
        if tuple(t.shape) != shape:
            raise ValueError(f'{k} must be {list(shape)}, got '
                             f'{list(t.shape)}')
    return T, B, H


def lstm_recurrence_bwd_plain(xw_flat: Tensor, w_hh: Tensor, out: Tensor,
                              c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                              d_cT: Tensor) -> Tuple[Tensor, Tensor]:
    """The backward recurrence as PyTorch operations: the stacked loop
    (:func:`lstm_scan_stacked_bwd_plain`) over the flat tensors laid out
    by step, whose gate algebra and rounding points are those of the flat
    JAX body (``ops/pallas/lstm_scan.py:858-907``): in bf16 h_prev comes
    from the bf16 out, the gates are f32, and dgates is rounded to bf16
    for the dh_prev and d_w_hh products, both summed in f32. Same
    contract as :func:`lstm_recurrence_bwd`."""
    T, B, H = _check_bwd_inputs(xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT)
    d_xw, d_w = lstm_scan_stacked_bwd_plain(
        _to_stacked(xw_flat, 4 * H), w_hh, _to_stacked(out, H), c_seq,
        _to_stacked(d_out, H), d_hT, d_cT)
    return _to_flat(d_xw), d_w


def lstm_recurrence_bwd(xw_flat: Tensor, w_hh: Tensor, out: Tensor,
                        c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                        d_cT: Tensor) -> Tuple[Tensor, Tensor]:
    """K4: gradients of one BiLSTM layer's recurrence.

    Takes the forward's inputs (xw_flat [T, B, 8H], w_hh [2, H, 4H], both
    f32 or both bf16), its residuals from :func:`lstm_recurrence_train`
    (out [T, B, 2H] in xw's dtype, c_seq [T, 2, B, H] f32) and the
    cotangents of its outputs (d_out [T, B, 2H] in xw's dtype, d_hT and
    d_cT [2, B, H] f32). Returns (d_xw [T, B, 8H] in the flat layout of
    xw_flat, d_w_hh [2, H, 4H]), both f32, as
    ``lstm_scan_pallas_bwd_flat`` gives them.

    CPU tensors take :func:`lstm_recurrence_bwd_plain`. CUDA tensors launch
    ``csrc/lstm_bwd.cu`` or raise: contiguous inputs on one card, H a
    multiple of 8 and any B, in one launch group (the recurrence over all
    row slices, then the weight-gradient kernel).
    """
    args = (xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT)
    T, B, H = _check_bwd_inputs(*args)
    if _on_cpu(*args):
        return lstm_recurrence_bwd_plain(*args)
    result = _launch_backward('lstm_recurrence_bwd', args, FLAT, T, B, H)
    lstm_recurrence_bwd.launches += 1
    return result


lstm_recurrence_bwd.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """Differentiable recurrence: K3 forward, K4 backward (the port of the
    custom VJP ``lstm_flat_fused``, ``ops/pallas/lstm_scan.py:1033-1058``).
    Same contract as :func:`lstm_recurrence`; saves (xw, w_hh, out, c_seq)
    and gives d_xw in the flat layout, so the input projection's backward
    is one product too. As ``_flat_fused_bwd`` does, it casts d_out to
    out's dtype and d_hT, d_cT to f32 before K4, and returns d_xw in xw's
    dtype and d_w_hh in w_hh's (in bf16 the cast of the f32 weights then
    widens d_w_hh back to f32, as JAX's ``astype`` VJP does)."""

    @staticmethod
    def forward(ctx, xw_flat: Tensor, w_hh: Tensor):
        out, c_seq, h_T, c_T = lstm_recurrence_train(xw_flat, w_hh)
        ctx.save_for_backward(xw_flat, w_hh, out, c_seq)
        return out, h_T, c_T

    @staticmethod
    def backward(ctx, d_out, d_hT, d_cT):
        xw_flat, w_hh, out, c_seq = ctx.saved_tensors
        T, B, H = _check_inputs(xw_flat, w_hh)
        f32 = torch.float32
        d_xw, d_w = lstm_recurrence_bwd(
            xw_flat, w_hh, out, c_seq,
            _cotangent(d_out, out.shape, out.dtype, xw_flat),
            _cotangent(d_hT, (2, B, H), f32, xw_flat),
            _cotangent(d_cT, (2, B, H), f32, xw_flat))
        return d_xw.to(xw_flat.dtype), d_w.to(w_hh.dtype)


# --- stacked layout: K6a, K6b, K6c, K6d --------------------------------------

def sigmoid_bf16(v: Tensor) -> Tensor:
    """The sigmoid of a bf16 tensor as XLA takes it: 1 / (1 + exp(-v)),
    one rounded bf16 operation after another."""
    one = torch.ones((), dtype=v.dtype, device=v.device)
    return one / (one + torch.exp(-v))


def _stacked_forward_plain(xw: Tensor, w_hh: Tensor, gates_bf16: bool):
    """The stacked recurrence as PyTorch operations, with the rounding
    points of the JAX bodies (``ops/pallas/lstm_scan.py:115-140``, :356-370):
    h cast to w_hh's dtype for the product, which sums in f32; the
    pre-activation plus xw in f32; with ``gates_bf16`` the pre-activation
    rounded to bf16 and the sigmoid (as 1/(1+exp(-v))) and tanh(g) taken
    on bf16 tensors; c and h in f32; out in xw's dtype. Returns (out,
    c_seq, h_T, c_T)."""
    T, B, H = _check_stacked(xw, w_hh)
    f32, bf16 = torch.float32, torch.bfloat16
    w = w_hh.to(f32)
    h = xw.new_zeros(2, B, H, dtype=f32)
    c = xw.new_zeros(2, B, H, dtype=f32)
    out = xw.new_empty(T, 2, B, H)
    c_seq = xw.new_empty(T, 2, B, H, dtype=f32)
    for s in range(T):
        gates = torch.baddbmm(xw[s].to(f32), h.to(w_hh.dtype).to(f32), w)
        if gates_bf16:
            gates = gates.to(bf16)
            i, f, o = (sigmoid_bf16(gates[..., k * H:(k + 1) * H]).to(f32)
                       for k in (0, 1, 3))
            g = torch.tanh(gates[..., 2 * H:3 * H]).to(f32)
        else:
            i = torch.sigmoid(gates[..., :H])
            f = torch.sigmoid(gates[..., H:2 * H])
            g = torch.tanh(gates[..., 2 * H:3 * H])
            o = torch.sigmoid(gates[..., 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[s] = h.to(out.dtype)
        c_seq[s] = c
    return out, c_seq, h, c


def lstm_scan_stacked_plain(xw: Tensor, w_hh: Tensor,
                            gates_bf16: bool = False
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_scan_stacked`, as PyTorch operations."""
    out, _, h_T, c_T = _stacked_forward_plain(xw, w_hh, gates_bf16)
    return out, h_T, c_T


def lstm_scan_stacked(xw: Tensor, w_hh: Tensor, gates_bf16: bool = False
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """K6a: both directions of one BiLSTM layer on the stacked layout.

    xw: [T, 2, B, 4H] f32 or bf16, the input projections plus biases with
    direction 1 already time-reversed (step s reads ``xw[s, d]``); w_hh:
    [2, H, 4H] f32 or bf16 (then h is rounded to bf16 before the product,
    which sums in f32), gate order i, f, g, o. ``gates_bf16`` takes the
    gate nonlinearities in bf16 (``lstm_scan.py:120-137``). Zero initial
    state, f32 carries. Returns (out [T, 2, B, H] in xw's dtype, indexed by
    step, h_T [2, B, H] f32, c_T [2, B, H] f32).

    When autograd needs a gradient the call goes through
    :class:`StackedLSTMRecurrence` (which has no ``gates_bf16``, as in
    JAX). Otherwise CPU tensors take :func:`lstm_scan_stacked_plain` and
    CUDA tensors launch ``csrc/lstm_scan.cu`` or raise, on K1's conditions.
    """
    if torch.is_grad_enabled() and (xw.requires_grad or w_hh.requires_grad):
        if gates_bf16:
            raise RuntimeError('lstm_scan_stacked has no backward with '
                               'gates_bf16; call it under torch.no_grad()')
        return StackedLSTMRecurrence.apply(xw, w_hh)
    _check_stacked(xw, w_hh)
    if _on_cpu(xw, w_hh):
        return lstm_scan_stacked_plain(xw, w_hh, gates_bf16)
    out, _, h_T, c_T = _launch_forward('lstm_scan_stacked', xw, w_hh,
                                       STACKED, False, gates_bf16)
    lstm_scan_stacked.launches += 1
    return out, h_T, c_T


lstm_scan_stacked.launches = 0


def lstm_scan_stacked_train_plain(xw: Tensor, w_hh: Tensor
                                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_scan_stacked_train`, as PyTorch
    operations."""
    return _stacked_forward_plain(xw, w_hh, gates_bf16=False)


def lstm_scan_stacked_train(xw: Tensor, w_hh: Tensor
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K6b: :func:`lstm_scan_stacked` (without ``gates_bf16``) plus the
    cell states of every step. Returns (out [T, 2, B, H] in xw's dtype,
    c_seq [T, 2, B, H] f32, h_T, c_T f32). CPU tensors take
    :func:`lstm_scan_stacked_train_plain`; CUDA tensors launch
    ``csrc/lstm_scan.cu`` with its c_seq stream on, or raise. Not
    differentiable itself: :class:`StackedLSTMRecurrence` is."""
    _check_stacked(xw, w_hh)
    if _on_cpu(xw, w_hh):
        return lstm_scan_stacked_train_plain(xw, w_hh)
    result = _launch_forward('lstm_scan_stacked_train', xw, w_hh, STACKED,
                             with_c_seq=True)
    lstm_scan_stacked_train.launches += 1
    return result


lstm_scan_stacked_train.launches = 0


def _check_stacked_bwd(xw, w_hh, out, c_seq, d_out, d_hT, d_cT):
    T, B, H = _check_stacked(xw, w_hh)
    f32 = torch.float32
    want = {'out': ((T, 2, B, H), xw.dtype), 'c_seq': ((T, 2, B, H), f32),
            'd_out': ((T, 2, B, H), xw.dtype), 'd_hT': ((2, B, H), f32),
            'd_cT': ((2, B, H), f32)}
    got = {'out': out, 'c_seq': c_seq, 'd_out': d_out, 'd_hT': d_hT,
           'd_cT': d_cT}
    for k, t in got.items():
        shape, dtype = want[k]
        if t.dtype != dtype:
            raise TypeError(f'lstm_scan_stacked_bwd: {k} must be {dtype}, '
                            f'got {t.dtype}')
        if tuple(t.shape) != shape:
            raise ValueError(f'{k} must be {list(shape)}, got {list(t.shape)}')
    return T, B, H


def lstm_scan_stacked_bwd_plain(xw: Tensor, w_hh: Tensor, out: Tensor,
                                c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                                d_cT: Tensor) -> Tuple[Tensor, Tensor]:
    """The stacked backward recurrence as PyTorch operations, with the
    rounding points of the JAX body (``ops/pallas/lstm_scan.py:441-491``):
    h_prev cast to w_hh's dtype for the gate recompute and the d_w_hh
    product, dgates cast to it for the dh_prev and d_w_hh products, all
    summed in f32. Same contract as :func:`lstm_scan_stacked_bwd`."""
    T, B, H = _check_stacked_bwd(xw, w_hh, out, c_seq, d_out, d_hT, d_cT)
    f32, wt = torch.float32, w_hh.dtype
    w = w_hh.to(f32)
    dh = d_hT.clone()
    dc = d_cT.clone()
    d_xw = xw.new_empty(T, 2, B, 4 * H, dtype=f32)
    d_w = xw.new_zeros(2, H, 4 * H, dtype=f32)
    zeros = xw.new_zeros(2, B, H, dtype=f32)
    for s in range(T - 1, -1, -1):
        h_prev = out[s - 1].to(wt).to(f32) if s > 0 else zeros
        c_prev = c_seq[s - 1] if s > 0 else zeros
        gates = torch.baddbmm(xw[s].to(f32), h_prev, w)
        i = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        dh = dh + d_out[s].to(f32)
        tc = torch.tanh(c_seq[s])
        dc = dc + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            dh * tc * o * (1.0 - o)], dim=-1)  # [2, B, 4H]
        d_xw[s] = dgates
        dgates = dgates.to(wt).to(f32)
        dh = torch.bmm(dgates, w.transpose(1, 2))
        d_w += torch.bmm(h_prev.transpose(1, 2), dgates)
        dc = dc * f
    return d_xw, d_w


def lstm_scan_stacked_bwd(xw: Tensor, w_hh: Tensor, out: Tensor,
                          c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                          d_cT: Tensor) -> Tuple[Tensor, Tensor]:
    """K6c: gradients of one stacked BiLSTM layer's recurrence.

    Takes the forward's inputs (xw [T, 2, B, 4H], w_hh [2, H, 4H]), its
    residuals from :func:`lstm_scan_stacked_train` (out [T, 2, B, H] in
    xw's dtype, c_seq [T, 2, B, H] f32) and the cotangents of its outputs
    (d_out like out, d_hT and d_cT [2, B, H] f32). Returns (d_xw
    [T, 2, B, 4H] f32, d_w_hh [2, H, 4H] f32).

    CPU tensors take :func:`lstm_scan_stacked_bwd_plain`. CUDA tensors
    launch ``csrc/lstm_bwd.cu`` or raise, on K4's conditions.
    """
    args = (xw, w_hh, out, c_seq, d_out, d_hT, d_cT)
    T, B, H = _check_stacked_bwd(*args)
    if _on_cpu(*args):
        return lstm_scan_stacked_bwd_plain(*args)
    result = _launch_backward('lstm_scan_stacked_bwd', args, STACKED, T, B, H)
    lstm_scan_stacked_bwd.launches += 1
    return result


lstm_scan_stacked_bwd.launches = 0


class StackedLSTMRecurrence(torch.autograd.Function):
    """K6d, the port of the custom VJP ``lstm_scan_fused``
    (``ops/pallas/lstm_scan.py:1061-1082``): K6b forward, K6c backward. Same
    contract as :func:`lstm_scan_stacked` without ``gates_bf16``. As
    ``_fused_bwd`` does, it casts d_out to out's dtype before K6c and
    returns d_xw in xw's dtype and d_w_hh in w_hh's."""

    @staticmethod
    def forward(ctx, xw: Tensor, w_hh: Tensor):
        out, c_seq, h_T, c_T = lstm_scan_stacked_train(xw, w_hh)
        ctx.save_for_backward(xw, w_hh, out, c_seq)
        return out, h_T, c_T

    @staticmethod
    def backward(ctx, d_out, d_hT, d_cT):
        xw, w_hh, out, c_seq = ctx.saved_tensors
        _, B, H = _check_stacked(xw, w_hh)
        f32 = torch.float32
        d_xw, d_w = lstm_scan_stacked_bwd(
            xw, w_hh, out, c_seq, _cotangent(d_out, out.shape, out.dtype, xw),
            _cotangent(d_hT, (2, B, H), f32, xw),
            _cotangent(d_cT, (2, B, H), f32, xw))
        return d_xw.to(xw.dtype), d_w.to(w_hh.dtype)
