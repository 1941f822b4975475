"""K2 and K5: fused SCDM additive word attention, and its trainable form.

Counterpart of ``shufflingvideosfortsg_tpu/ops/pallas/scdm_fused.py``
``scdm_attention_fused`` (K2) and ``scdm_attention_fused_trainable`` (K5),
and of their plain formulation ``ops/attention.py::scdm_attention``. The
CUDA kernels are in ``csrc/scdm.cu``: the forward (``scdm_fwd_kernel`` in
f32, ``scdm_fwd_mma_kernel`` on the tensor cores in bf16, their tiles of
rows planned by :func:`_scdm_plan`), and K5's backward
(``scdm_bwd_kernel`` in f32, ``scdm_bwd_bf16x2_kernel`` on bf16x2 pairs
of columns in bf16, their blocks planned by :func:`_scdm_bwd_plan`).
:func:`scdm_attention_plain` is the broadcast-tanh version in PyTorch,
and :func:`scdm_attention_bwd_plain` its gradients written out; the
wrappers take them for CPU tensors, and the card's checks hold the kernels
against them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import _kernels

Tensor = torch.Tensor

# the tiles of rows t a forward block may take, largest first: the f32
# kernel takes any multiple of 4 up to 32; the bf16 tensor-core kernel
# whole row groups of 4 rows for its 8 warps (2, 4 or 8 groups, the warps
# of a group splitting k), each row's words in whole m16 tiles
_FWD_ROWS = (32, 16, 8, 4)
_MMA_ROWS = (32, 16, 8)
# the columns k a backward block may take, and its tiles of rows t, largest
# first (the bf16 kernel takes multiples of 4 rows); the plan asks for one
# block an SM at least: on an H100 the widest blocks that give every SM
# one or two ran fastest, ahead of more, narrower blocks or more spans
# (PERF.md §6)
_BWD_COLS = (256, 128, 64, 32)
_BWD_ROWS = (32, 16, 8, 4)
# bf16: 256 columns need two spans at B=64, Dh=512, and the sum of the
# spans' partials of d_sent_proj cost more than the wider blocks gained
_BWD2_WIDEST = 128


# the kernels' dtype codes (csrc/common.cuh: kF32, kBF16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_inputs(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                  sent_feat: Tensor, dtypes=tuple(_DTYPE_CODES)
                  ) -> Tuple[int, int, int, int, int]:
    args = (video_proj, sent_proj, w, sent_feat)
    if video_proj.dtype not in dtypes or any(a.dtype != video_proj.dtype
                                             for a in args):
        raise TypeError(f'the four inputs must share one of {dtypes}, got '
                        f'{[a.dtype for a in args]}')
    if video_proj.dim() != 3 or sent_proj.dim() != 3 or sent_feat.dim() != 3:
        raise ValueError('video_proj, sent_proj and sent_feat must be 3-D')
    B, T, Dh = video_proj.shape
    N, Ds = sent_proj.shape[1], sent_feat.shape[-1]
    if (tuple(sent_proj.shape) != (B, N, Dh) or tuple(w.shape) != (Dh,)
            or tuple(sent_feat.shape) != (B, N, Ds)):
        raise ValueError(
            f'shapes disagree: video_proj {tuple(video_proj.shape)}, '
            f'sent_proj {tuple(sent_proj.shape)}, w {tuple(w.shape)}, '
            f'sent_feat {tuple(sent_feat.shape)}')
    if min(B, T, N, Dh, Ds) < 1:
        raise ValueError(f'empty attention: B={B} T={T} N={N} Dh={Dh} Ds={Ds}')
    return B, T, N, Dh, Ds


def _cuda_device(name: str, tensors) -> torch.device:
    """The one card all ``tensors`` lie on, contiguous; raises."""
    dev = tensors[0].device
    if not (tensors[0].is_cuda and all(a.device == dev for a in tensors)):
        raise ValueError(f'{name} inputs must lie on one CUDA device, got '
                         f'{[str(a.device) for a in tensors]}')
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f'{name} needs contiguous inputs')
    return dev


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def scdm_attention_plain(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                         sent_feat: Tensor) -> Tensor:
    """The attention as PyTorch operations (``ops/attention.py:21-44``):
    materialises the [B, T, N, Dh] tanh activation. Same contract as
    :func:`scdm_attention_fused`: in bf16 the sum and the tanh are bf16
    operations (each rounded), the logits and the context sums of exact
    f32 products taken in f32 and rounded to bf16, the softmax in f32 and
    P rounded to bf16 (the identity casts in f32)."""
    _check_inputs(video_proj, sent_proj, w, sent_feat)
    dt, f32 = video_proj.dtype, torch.float32
    act = torch.tanh(video_proj[:, :, None, :] + sent_proj[:, None, :, :])
    logits = torch.einsum('btnh,h->btn', act.to(f32), w.to(f32)).to(dt)
    P = torch.softmax(logits.to(f32), dim=-1).to(dt)
    return torch.einsum('btn,bnd->btd', P.to(f32), sent_feat.to(f32)).to(dt)


class ScdmPlan(NamedTuple):
    """A forward launch: ``rows`` rows t a block, ``blocks`` blocks (one a
    tile of rows and batch row), ``smem_bytes`` of shared memory a block."""
    rows: int
    blocks: int
    smem_bytes: int


def _scdm_plan(B: int, T: int, N: int, sms: int,
               smem_bytes: Callable[[int], int],
               smem_cap: int = _kernels.MAX_SMEM_BYTES,
               elem_bytes: int = 4) -> ScdmPlan:
    """The forward launch at (B, T, N) with inputs of ``elem_bytes``
    bytes (f32 4: ``scdm_fwd_kernel``; bf16 2: ``scdm_fwd_mma_kernel``) on
    a card of ``sms`` SMs that gives a block ``smem_cap`` bytes of shared
    memory, where a block of ``rows`` rows at this N takes
    ``smem_bytes(rows)`` bytes (the kernel's layout,
    :func:`_scdm_smem_bytes`; negative where it takes no such tile): of the
    kernel's tiles (f32 32, 16, 8 and 4 rows; bf16 32, 16 and 8) whose
    shared memory fits, the largest whose grid gives the card at least
    ``per_sm`` blocks an SM and whose rows are less than half empty
    (rows < 2 T), else the smallest. ``per_sm`` is 2 for the f32 kernel
    and 1 for the tensor-core kernel: on an H100 its larger tiles ran
    faster down to one block an SM (16 rows at B=32, 32 at B=64; PERF.md
    §6), since a smaller tile repeats the block's fixed work (staging
    sent_proj, the softmax, the context) for fewer rows. Raises where none
    fits."""
    tiles, per_sm = (_FWD_ROWS, 2) if elem_bytes == 4 else (_MMA_ROWS, 1)
    smem = {r: smem_bytes(r) for r in tiles}
    fits = [r for r in tiles if 0 < smem[r] <= smem_cap]
    if not fits or sms < 1:
        raise ValueError(f'scdm_attention_fused: no tile of rows fits '
                         f'{smem_cap} bytes of shared memory at N={N} on '
                         f'{sms} SMs')
    rows = next((r for r in fits
                 if -(-T // r) * B >= per_sm * sms and r < 2 * T), fits[-1])
    return ScdmPlan(rows, -(-T // rows) * B, smem[rows])


def _scdm_smem_bytes(rows: int, N: int, elem_bytes: int = 4) -> int:
    """Shared memory of a forward block of ``rows`` rows at N words with
    inputs of ``elem_bytes`` bytes (f32 4, bf16 2: the tensor-core
    kernel), as ``csrc/scdm.cu`` lays it out (``svtsg_scdm_smem_bytes``);
    -1 where the kernel takes no tile of ``rows`` rows."""
    return _kernels.library().svtsg_scdm_smem_bytes(rows, N, elem_bytes)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scdm_rows(B: int, T: int, N: int, device: int,
               elem_bytes: int = 4) -> int:
    """The rows a block of the forward launch at (B, T, N) with inputs of
    ``elem_bytes`` bytes on the card ``device`` takes."""
    return _scdm_plan(B, T, N, _sm_count(device),
                      lambda rows: _scdm_smem_bytes(rows, N, elem_bytes),
                      elem_bytes=elem_bytes).rows


def _launch_forward(args, want_p: bool) -> Tuple[Tensor, Optional[Tensor]]:
    """One launch of the forward kernel (f32 ``scdm_fwd_kernel``, bf16
    ``scdm_fwd_mma_kernel``) on CUDA tensors over the planned tiles of
    rows; returns (C in the inputs' dtype, P or None). P [B, T, N] is
    allocated and written only when asked for (K5's forward): the f32
    softmax, which in bf16 the kernel rounds only for C."""
    B, T, N, Dh, Ds = _check_inputs(*args)
    dt = args[0].dtype
    dev = _cuda_device('scdm_attention_fused', args)
    index = _device_index(dev)
    rows = _scdm_rows(B, T, N, index, dt.itemsize)
    out = torch.empty(B, T, Ds, device=dev, dtype=dt)
    P = (torch.empty(B, T, N, device=dev, dtype=torch.float32)
         if want_p else None)
    err = _kernels.library().svtsg_scdm_attention(
        *(a.data_ptr() for a in args), out.data_ptr(),
        None if P is None else P.data_ptr(), B, T, N, Dh, Ds, rows,
        _DTYPE_CODES[dt], index, _stream(dev))
    _kernels.check(err, 'scdm_attention_fused')
    scdm_attention_fused.launches += 1
    return out, P


def scdm_attention_fused(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                         sent_feat: Tensor) -> Tensor:
    """Per-frame text context C [B, T, Ds].

    video_proj: [B, T, Dh] (= W_a v + b_a); sent_proj: [B, N, Dh]
    (= W_s s); w: [Dh]; sent_feat: [B, N, Ds]; all f32 or all bf16 (then
    C is bf16, with the rounding points of ``ops/attention.py:20-44`` at
    bf16: :func:`scdm_attention_plain`). The softmax runs in f32 over all
    N word slots, padded slots included (the reference's quirk).

    CPU tensors take :func:`scdm_attention_plain`. CUDA tensors launch
    one kernel of ``csrc/scdm.cu`` once or raise: contiguous inputs of one
    dtype on one card, at any N, Dh and Ds. A block takes a tile of rows t
    of one batch row (:func:`_scdm_plan`), streams k through shared memory
    and runs the softmax and the context product from shared memory. In
    f32 (``scdm_fwd_kernel``) each thread keeps 2 rows x 4 words of
    logits; in bf16 (``scdm_fwd_mma_kernel``) the terms stay packed in
    pairs and the logits and the context are ``mma.sync`` products on the
    tensor cores. The sums run in a fixed order, so two runs give equal
    bits. It has no backward: call it with gradients off, or call
    :func:`scdm_attention_fused_trainable`. Without gradients the call is
    the custom op ``svtsg::scdm_attention`` (:data:`scdm_attention_op`),
    the one route of eager calls and of programs that ``torch.export``
    traces (``utils/aot.py``).
    """
    args = (video_proj, sent_proj, w, sent_feat)
    _check_inputs(*args)
    cpu = all(a.device.type == 'cpu' for a in args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        if cpu:  # differentiable by autograd
            return scdm_attention_plain(*args)
        raise RuntimeError('scdm_attention_fused has no backward; call it '
                           'under torch.no_grad() or call '
                           'scdm_attention_fused_trainable')
    if not cpu:
        _cuda_device('scdm_attention_fused', args)
    return scdm_attention_op(*args)


@torch.library.custom_op('svtsg::scdm_attention', mutates_args=(),
                         device_types='cpu',
                         schema='(Tensor video_proj, Tensor sent_proj, '
                                'Tensor w, Tensor sent_feat) -> Tensor')
def scdm_attention_op(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                      sent_feat: Tensor) -> Tensor:
    """K2 as the custom op ``svtsg::scdm_attention``; CPU tensors take
    :func:`scdm_attention_plain`."""
    return scdm_attention_plain(video_proj, sent_proj, w, sent_feat)


@scdm_attention_op.register_kernel('cuda')
def _scdm_attention_cuda(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                         sent_feat: Tensor) -> Tensor:
    return _launch_forward((video_proj, sent_proj, w, sent_feat),
                           want_p=False)[0]


@scdm_attention_op.register_fake
def _scdm_attention_fake(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                         sent_feat: Tensor) -> Tensor:
    B, T = video_proj.shape[0], video_proj.shape[1]
    return video_proj.new_empty(B, T, sent_feat.shape[-1])


scdm_attention_fused.launches = 0


def forward_tanh(x: Tensor) -> Tensor:
    """tanh as ``scdm_fwd_kernel`` computes it (``tanh_fwd`` in
    ``csrc/scdm.cu``: tanhf's polynomial where |x| < 0.6, else
    1 - 2 / (1 + e^{2x}) on the special-function pipe, without a branch),
    elementwise, to measure its error against :func:`torch.tanh`. CPU
    tensors take :func:`torch.tanh`; CUDA tensors must be contiguous f32."""
    if x.device.type == 'cpu':
        return torch.tanh(x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f'forward_tanh takes a contiguous f32 tensor, got '
                         f'{x.dtype} {list(x.shape)}')
    y = torch.empty_like(x)
    err = _kernels.library().svtsg_scdm_tanh(
        x.data_ptr(), y.data_ptr(), x.numel(), _device_index(x.device),
        _stream(x.device))
    _kernels.check(err, 'forward_tanh')
    return y


class TermCheck(NamedTuple):
    """The exhaustive checks of the bf16 kernel's per-term roundings
    (:func:`term_check`)."""
    sum_mismatches: int
    pairs_checked: int
    tanh_mismatches: int
    values_checked: int
    off_torch_tanh: int


def term_check(device) -> TermCheck:
    """Run ``scdm_fwd_mma_kernel``'s own device code for its two per-term
    roundings over every input on the card ``device``: the packed sum
    against bf16(f32(vp) + f32(sp)) over all pairs of finite bf16, each in
    both halves of a bf16x2 (``sum_mismatches`` of ``pairs_checked``
    pairs, halves counted), and the packed a against bf16(tanh_fwd(s)) over
    all 65,536 bf16 bit patterns s (``tanh_mismatches`` of
    ``values_checked`` halves; NaN equal to NaN). ``off_torch_tanh`` counts
    the s (NaN left out) whose a lies more than one bf16 ulp from
    bf16(torch.tanh(s)) computed on the card in f32. The checks run only
    on a card: there is no plain version of a kernel's rounding."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        raise ValueError(f'term_check runs on a CUDA device, got {dev}')
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    a = torch.empty(1 << 16, dtype=torch.bfloat16, device=dev)
    err = _kernels.library().svtsg_scdm_term_check(
        counts.data_ptr(), a.data_ptr(), _device_index(dev), _stream(dev))
    _kernels.check(err, 'term_check')
    codes = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    s = torch.where(codes >= 1 << 15, codes - (1 << 16), codes).to(
        torch.int16).view(torch.bfloat16)
    ref = torch.tanh(s.float()).bfloat16()

    def ordered(x: Tensor) -> Tensor:  # bf16 bits as a monotone integer
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7fff), i)

    nan = torch.isnan(a) | torch.isnan(ref)
    off = ((ordered(a) - ordered(ref)).abs() > 1) & ~nan
    n = counts.tolist()
    return TermCheck(n[0], n[1], n[2], n[3], int(off.sum()))


class BwdTermCheck(NamedTuple):
    """The exhaustive checks of the bf16 backward kernel's packed
    operations (:func:`bwd_term_check`)."""
    mul_mismatches: int
    mul_pairs_checked: int
    add_mismatches: int
    add_pairs_checked: int
    one_minus_mismatches: int
    one_minus_checked: int


def bwd_term_check(device) -> BwdTermCheck:
    """Run ``scdm_bwd_bf16x2_kernel``'s own device code for its packed
    roundings over every input on the card ``device``: the packed product
    against bf16(f32(x) f32(y)) and the packed sum against bf16(f32(x) +
    f32(y)) over all pairs of finite bf16, each pair in both halves of a
    bf16x2 (mismatching halves of pairs checked), and the packed 1 - a
    against bf16(1 - f32(a)) over all 65,536 bf16 bit patterns a (a in one
    half, -a in the other; NaN equal to NaN). Its two other roundings are
    the forward's term code, which :func:`term_check` covers. Bits are
    compared: -0 is not +0. Runs only on a card."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        raise ValueError(f'bwd_term_check runs on a CUDA device, got {dev}')
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    err = _kernels.library().svtsg_scdm_bwd_term_check(
        counts.data_ptr(), _device_index(dev), _stream(dev))
    _kernels.check(err, 'bwd_term_check')
    return BwdTermCheck(*counts.tolist())


def scdm_attention_bwd_core_plain(video_proj: Tensor, sent_proj: Tensor,
                                  w: Tensor, P: Tensor, dP: Tensor,
                                  tanh: Callable[[Tensor], Tensor] = torch.tanh
                                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The part of the backward that the backward kernels compute
    (``scdm_bwd_kernel``, ``scdm_bwd_bf16x2_kernel``), as PyTorch
    operations: from the softmax P [B, T, N] and its cotangent dP,
    dl = P (dP - sum_n P dP), then with a = tanh(vp[b,t] + sp[b,n])
    (materialised here, [B, T, N, Dh]) d_video_proj = w sum_n dl (1 - a^2),
    d_sent_proj = w sum_t dl (1 - a^2) and d_w = sum_{b,t,n} dl a. ``tanh``
    computes a (:func:`forward_tanh` gives the kernels' own).

    In bf16 (video_proj, sent_proj, w and dP bf16, P the f32 softmax) at
    the rounding points of ``jax.vjp(scdm_attention)`` (``csrc/scdm.cu``):
    a = bf16(tanh(bf16(vp + sp))), dl rounded to bf16, each term's
    du = bf16(u + bf16(u a)) with u = bf16(bf16(dl w) bf16(1 - a)), the
    three sums in f32, each result rounded to bf16 once."""
    if video_proj.dtype == torch.float32:
        act = tanh(video_proj[:, :, None, :] + sent_proj[:, None, :, :])
        dl = P * (dP - (P * dP).sum(-1, keepdim=True))
        du = dl[..., None] * (1.0 - act * act)
        return (du.sum(2) * w, du.sum(1) * w,
                torch.einsum('btn,btnh->h', dl, act))
    dt, f32 = video_proj.dtype, torch.float32

    def rnd(x: Tensor) -> Tensor:
        return x.to(dt).to(f32)

    s = video_proj[:, :, None, :] + sent_proj[:, None, :, :]  # rounded
    act = rnd(tanh(s.to(f32)))
    dPf = dP.to(f32)
    dl = rnd(P * (dPf - (P * dPf).sum(-1, keepdim=True)))
    u = rnd(rnd(dl[..., None] * w.to(f32)) * rnd(1.0 - act))
    du = rnd(u + rnd(u * act))
    return (du.sum(2).to(dt), du.sum(1).to(dt),
            torch.einsum('btn,btnh->h', dl, act).to(dt))


def scdm_attention_bwd_plain(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                             sent_feat: Tensor, grad_out: Tensor
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The gradients of :func:`scdm_attention_plain` written out, without
    autograd: the VJP that ``_scdm_bwd`` takes with ``jax.vjp`` of
    ``ops/attention.py::scdm_attention``. grad_out is dC [B, T, Ds].
    Recomputes P (in bf16 the f32 softmax of the bf16 logits), then
    dP = dC sent_feat^T, d_sent_feat = P^T dC (in bf16 products of bf16
    operands summed in f32 and rounded, P rounded first, as JAX's VJP
    takes them), and the rest as :func:`scdm_attention_bwd_core_plain`.
    Returns (d_video_proj, d_sent_proj, d_w, d_sent_feat), in the inputs'
    dtype."""
    _check_inputs(video_proj, sent_proj, w, sent_feat)
    dt, f32 = video_proj.dtype, torch.float32
    act = torch.tanh(video_proj[:, :, None, :] + sent_proj[:, None, :, :])
    logits = torch.einsum('btnh,h->btn', act.to(f32), w.to(f32)).to(dt)
    P = torch.softmax(logits.to(f32), dim=-1)
    dP = torch.bmm(grad_out, sent_feat.transpose(1, 2))
    d_sf = torch.bmm(P.to(dt).transpose(1, 2), grad_out)
    return (*scdm_attention_bwd_core_plain(video_proj, sent_proj, w, P, dP),
            d_sf)


class ScdmBwdPlan(NamedTuple):
    """A backward launch: blocks of ``cols`` columns k of one batch row
    over one of ``spans`` spans of ``t_len`` rows t (whole tiles), taken in
    tiles of ``rows`` rows; ``blocks`` blocks of ``smem_bytes`` of shared
    memory each."""
    cols: int
    rows: int
    spans: int
    t_len: int
    blocks: int
    smem_bytes: int


def _scdm_bwd_plan(B: int, T: int, N: int, Dh: int, sms: int,
                   smem_bytes: Callable[[int, int], int],
                   smem_cap: int = _kernels.MAX_SMEM_BYTES,
                   cols: Optional[int] = None,
                   spans: Optional[int] = None,
                   elem_bytes: int = 4) -> ScdmBwdPlan:
    """The backward launch at (B, T, N, Dh) with inputs of ``elem_bytes``
    bytes (f32 4: ``scdm_bwd_kernel``; bf16 2: ``scdm_bwd_bf16x2_kernel``)
    on a card of ``sms`` SMs that gives a block ``smem_cap`` bytes of
    shared memory, where a block of ``cols`` columns over tiles of ``rows``
    rows takes ``smem_bytes(rows, cols)`` bytes at this N (the kernel's
    layout, :func:`_scdm_bwd_smem_bytes`; negative where it takes no such
    block).

    Columns: of 256 (f32 only), 128, 64 and 32, the largest whose blocks
    (one a batch row and chunk of columns; at bf16 over up to two spans of
    t) give every SM one and whose columns are less than half empty (cols
    < 2 Dh), else the smallest. Rows: the largest tile of 32, 16, 8 or 4
    rows that fits at those columns and is less than half empty (rows <
    2 T), else the smallest that fits. Spans of t (whole tiles, one a block) are added
    until the grid gives every SM a block, at most one a tile: one span
    where the columns alone get there, so that d_sent_proj needs no sum
    across blocks. Wide blocks form dl once for more columns; on an H100
    they ran fastest, and at bf16 128 columns over two spans ahead of 64
    over one (PERF.md §6). ``cols`` and ``spans`` override the
    choice (for measurements). Raises where no block fits."""
    widest = _BWD_COLS[0] if elem_bytes == 4 else _BWD2_WIDEST
    choices = [c for c in _BWD_COLS
               if c == cols or (cols is None and c <= widest)]
    fit = {}
    for c in choices:
        for r in _BWD_ROWS:
            nbytes = smem_bytes(r, c)
            if 0 < nbytes <= smem_cap:
                fit[c, r] = nbytes
    if not fit or sms < 1:
        raise ValueError(f'scdm_attention_bwd: no block of {choices} columns '
                         f'fits {smem_cap} bytes of shared memory at N={N} '
                         f'on {sms} SMs')
    target = sms
    reach = 1 if elem_bytes == 4 else 2  # spans a choice of columns may take
    usable = [c for c in choices if any((c, r) in fit for r in _BWD_ROWS)]
    col = next((c for c in usable
                if reach * B * -(-Dh // c) >= target and c < 2 * Dh),
               usable[-1])
    chunks = B * -(-Dh // col)
    row_opts = [r for r in _BWD_ROWS if (col, r) in fit]
    rows = next((r for r in row_opts if r < 2 * T), row_opts[-1])
    tiles = -(-T // rows)
    if spans is None:
        spans = -(-target // chunks)
    t_len = -(-tiles // max(1, min(spans, tiles))) * rows
    spans = -(-T // t_len)
    return ScdmBwdPlan(col, rows, spans, t_len, spans * chunks,
                       fit[col, rows])


def _scdm_bwd_smem_bytes(rows: int, cols: int, N: int,
                         elem_bytes: int = 4) -> int:
    """Shared memory of a backward block of ``cols`` columns over tiles of
    ``rows`` rows at N words with inputs of ``elem_bytes`` bytes (f32 4,
    bf16 2: the bf16x2 kernel's own layout), as ``csrc/scdm.cu`` lays it
    out (``svtsg_scdm_bwd_smem_bytes``); -1 where the kernel takes no such
    block."""
    return _kernels.library().svtsg_scdm_bwd_smem_bytes(rows, cols, N,
                                                        elem_bytes)


@functools.lru_cache(maxsize=None)
def _scdm_bwd_launch(B: int, T: int, N: int, Dh: int, device: int,
                     cols: Optional[int] = None,
                     spans: Optional[int] = None,
                     elem_bytes: int = 4) -> ScdmBwdPlan:
    """The backward launch at (B, T, N, Dh) with inputs of ``elem_bytes``
    bytes on the card ``device``; ``cols`` and ``spans`` override the
    plan's choice (for measurements)."""
    return _scdm_bwd_plan(
        B, T, N, Dh, _sm_count(device),
        lambda rows, c: _scdm_bwd_smem_bytes(rows, c, N, elem_bytes),
        cols=cols, spans=spans, elem_bytes=elem_bytes)


def scdm_attention_bwd_core(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                            P: Tensor, dP: Tensor
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """K5's backward kernel: (d_video_proj, d_sent_proj, d_w) from the
    forward's inputs, its softmax P (f32) and dP, as
    :func:`scdm_attention_bwd_core_plain`, which CPU tensors take; the
    results in the inputs' dtype. video_proj, sent_proj, w and dP are all
    f32 or all bf16. CUDA tensors launch one kernel once or raise
    (contiguous, on one card, any shape and alignment): f32
    ``scdm_bwd_kernel``, bf16 ``scdm_bwd_bf16x2_kernel``, with the blocks
    :func:`_scdm_bwd_plan` picks. The partial sums over spans of t and
    batch rows are added in a fixed order, so two runs give equal bits."""
    dt = video_proj.dtype
    if dt not in _DTYPE_CODES or any(a.dtype != dt for a in (sent_proj, w)):
        raise TypeError('scdm_attention_bwd_core takes video_proj, sent_proj '
                        'and w all f32 or all bf16, got '
                        f'{[a.dtype for a in (video_proj, sent_proj, w)]}')
    B, T, Dh = video_proj.shape
    N = sent_proj.shape[1]
    for name, t, want in (('P', P, torch.float32), ('dP', dP, dt)):
        if tuple(t.shape) != (B, T, N) or t.dtype != want:
            raise ValueError(f'{name} must be {want} [{B}, {T}, {N}], got '
                             f'{t.dtype} {list(t.shape)}')
    args = (video_proj, sent_proj, w, P, dP)
    if all(a.device.type == 'cpu' for a in args):
        return scdm_attention_bwd_core_plain(*args)
    dev = _cuda_device('scdm_attention_bwd', args)
    return _launch_backward(args, _scdm_bwd_launch(
        B, T, N, Dh, _device_index(dev), elem_bytes=dt.itemsize))


def _bwd_partials(args: Tuple[Tensor, ...], plan: ScdmBwdPlan,
                  outs: Optional[Tuple[Tensor, Tensor, Tensor]] = None
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward kernel of the inputs' dtype once over the checked CUDA
    ``args`` (video_proj, sent_proj, w, P, dP) with the blocks of
    ``plan``, into ``outs`` (allocated where None): its f32 d_vp
    [B,T,Dh], the spans' partial d_sp [spans,B,N,Dh] and d_w
    [spans*B,Dh]."""
    dt = args[0].dtype
    B, T, Dh = args[0].shape
    N = args[1].shape[1]
    dev = args[0].device
    if outs is None:
        f32 = dict(device=dev, dtype=torch.float32)
        outs = (torch.empty(B, T, Dh, **f32),
                torch.empty(plan.spans, B, N, Dh, **f32),
                torch.empty(plan.spans * B, Dh, **f32))
    err = _kernels.library().svtsg_scdm_bwd(
        *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs), B, T,
        N, Dh, plan.cols, plan.rows, plan.spans, plan.t_len,
        _DTYPE_CODES[dt], _device_index(dev), _stream(dev))
    _kernels.check(err, 'scdm_attention_bwd')
    return outs


def _launch_backward(args: Tuple[Tensor, ...], plan: ScdmBwdPlan
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`_bwd_partials` and the fixed-order sums of its f32 partials,
    rounded to the inputs' dtype."""
    d_vp, d_sp, d_w = _bwd_partials(args, plan)
    grads = (d_vp, d_sp[0] if plan.spans == 1 else d_sp.sum(0), d_w.sum(0))
    return tuple(g.to(args[0].dtype) for g in grads)


def scdm_attention_bwd(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                       sent_feat: Tensor, P: Optional[Tensor],
                       grad_out: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K5's backward: the four gradients of :func:`scdm_attention_plain`,
    in the inputs' dtype (f32 or bf16; grad_out too).

    CPU tensors take :func:`scdm_attention_bwd_plain` (P may be None).
    CUDA tensors take P, the forward's f32 softmax, and run dP = dC
    sent_feat^T and d_sent_feat = P^T dC (P rounded to the dtype first) as
    two cuBLAS ``bmm`` (JAX leaves the whole backward to XLA), then
    :func:`scdm_attention_bwd_core`'s kernel for the rest, or raise.
    ``scdm_attention_fused_trainable.launches`` counts the kernel's
    launches."""
    B, T, _, _, Ds = _check_inputs(video_proj, sent_proj, w, sent_feat)
    dt = video_proj.dtype
    if tuple(grad_out.shape) != (B, T, Ds) or grad_out.dtype != dt:
        raise ValueError(f'grad_out must be {dt} [{B}, {T}, {Ds}], got '
                         f'{grad_out.dtype} {list(grad_out.shape)}')
    args = (video_proj, sent_proj, w, sent_feat, grad_out)
    if all(a.device.type == 'cpu' for a in args):
        return scdm_attention_bwd_plain(*args)
    if P is None:
        raise ValueError('scdm_attention_bwd needs the forward softmax P on '
                         'a CUDA device')
    _cuda_device('scdm_attention_bwd', (*args, P))
    dP = torch.bmm(grad_out, sent_feat.transpose(1, 2))
    d_sf = torch.bmm(P.to(dt).transpose(1, 2), grad_out)
    grads = scdm_attention_bwd_core(video_proj, sent_proj, w, P, dP)
    scdm_attention_fused_trainable.launches += 1
    return (*grads, d_sf)


class _ScdmAttentionTrainable(torch.autograd.Function):
    """K5 (``scdm_fused.py:102-122``): the K2 forward, which also keeps
    the f32 softmax P [B, T, N] as a residual on a card, and
    :func:`scdm_attention_bwd` as backward, the vector-Jacobian product
    that ``_scdm_bwd`` takes with ``jax.vjp`` of
    ``ops/attention.py::scdm_attention``."""

    @staticmethod
    def forward(ctx, video_proj, sent_proj, w, sent_feat):
        args = (video_proj, sent_proj, w, sent_feat)
        _check_inputs(*args)
        if all(a.device.type == 'cpu' for a in args):
            out, P = scdm_attention_plain(*args), None
        else:
            out, P = _launch_forward(args, want_p=True)
        ctx.save_for_backward(*args, P)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        *args, P = ctx.saved_tensors
        grads = scdm_attention_bwd(*args, P, grad_out.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def scdm_attention_fused_trainable(video_proj: Tensor, sent_proj: Tensor,
                                   w: Tensor, sent_feat: Tensor) -> Tensor:
    """Differentiable :func:`scdm_attention_fused`: same contract, with a
    backward. ``launches`` counts its backward kernel's launches on a
    card; the forward counts as K2's."""
    return _ScdmAttentionTrainable.apply(video_proj, sent_proj, w, sent_feat)


scdm_attention_fused_trainable.launches = 0
