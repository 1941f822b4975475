"""K1, K3 and K4: the BiLSTM recurrence, its train forward and its backward.

Counterparts of ``shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py``
(flat layout): ``lstm_scan_pallas_flat`` (K1, :func:`lstm_recurrence`),
``lstm_scan_pallas_train_flat`` (K3, :func:`lstm_recurrence_train`),
``lstm_scan_pallas_bwd_flat`` (K4, :func:`lstm_recurrence_bwd`) and the
custom VJP ``lstm_flat_fused`` that joins K3 and K4
(:class:`LSTMRecurrence`). The CUDA kernels are ``csrc/lstm_scan.cu`` (K1
and K3) and ``csrc/lstm_bwd.cu`` (K4). Each ``*_plain`` function is the
same function as a loop of PyTorch operations, which the wrappers take for
CPU tensors and the card's checks hold the kernels against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _kernels

Tensor = torch.Tensor


def _check_inputs(xw_flat: Tensor, w_hh: Tensor) -> Tuple[int, int, int]:
    if xw_flat.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f'lstm_recurrence takes float32 only, got '
                        f'{xw_flat.dtype} and {w_hh.dtype}')
    if xw_flat.dim() != 3 or xw_flat.shape[-1] % 8:
        raise ValueError(f'xw_flat must be [T, B, 8H], got {tuple(xw_flat.shape)}')
    T, B, H8 = xw_flat.shape
    H = H8 // 8
    if tuple(w_hh.shape) != (2, H, 4 * H):
        raise ValueError(f'w_hh must be [2, {H}, {4 * H}], got {tuple(w_hh.shape)}')
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
    if H % 8:
        raise ValueError(f'{name} needs H % 8 == 0, got H={H}')
    return dev


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check_smem(name: str, smem: int, B: int, H: int) -> None:
    if smem > _kernels.MAX_SMEM_BYTES:
        raise ValueError(f'{name}: B={B}, H={H} needs {smem} bytes of shared '
                         f'memory per block, over the {_kernels.MAX_SMEM_BYTES}'
                         ' a block may use')


def lstm_recurrence_train_plain(xw_flat: Tensor, w_hh: Tensor
                                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The recurrence as PyTorch operations (the JAX ``_lstm_scan`` step,
    ``ops/rnn.py:76-103``, on the flat layout), with the cell states of
    every step. Same contract as :func:`lstm_recurrence_train`."""
    T, B, H = _check_inputs(xw_flat, w_hh)
    H4 = 4 * H
    h = xw_flat.new_zeros(2, B, H)
    c = xw_flat.new_zeros(2, B, H)
    out = xw_flat.new_empty(T, B, 2 * H)
    c_seq = xw_flat.new_empty(T, 2, B, H)
    for s in range(T):
        x = torch.stack([xw_flat[s, :, :H4], xw_flat[T - 1 - s, :, H4:]])
        gates = torch.baddbmm(x, h, w_hh)
        i = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[s, :, :H] = h[0]
        out[T - 1 - s, :, H:] = h[1]
        c_seq[s] = c
    return out, c_seq, h, c


def lstm_recurrence_plain(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Same contract as :func:`lstm_recurrence`, as PyTorch operations."""
    out, _, h_T, c_T = lstm_recurrence_train_plain(xw_flat, w_hh)
    return out, h_T, c_T


def _launch_recurrence(xw_flat: Tensor, w_hh: Tensor, with_c_seq: bool):
    """One launch of ``csrc/lstm_scan.cu``: K3 with the c_seq residual, K1
    without. Returns (out, c_seq or None, h_T, c_T)."""
    T, B, H = _check_inputs(xw_flat, w_hh)
    name = 'lstm_recurrence_train' if with_c_seq else 'lstm_recurrence'
    dev = _cuda_checks(name, (xw_flat, w_hh), H)
    lib = _kernels.library()
    _check_smem(name, lib.svtsg_lstm_smem_bytes(B, H), B, H)
    out = torch.empty(T, B, 2 * H, device=dev, dtype=torch.float32)
    h_T = torch.empty(2, B, H, device=dev, dtype=torch.float32)
    c_T = torch.empty(2, B, H, device=dev, dtype=torch.float32)
    c_seq = (torch.empty(T, 2, B, H, device=dev, dtype=torch.float32)
             if with_c_seq else None)
    h_buf = torch.empty(2, 2, B, H, device=dev, dtype=torch.float32)
    barrier = torch.empty(1, device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.svtsg_lstm_recurrence(
        xw_flat.data_ptr(), w_hh.data_ptr(), out.data_ptr(), h_T.data_ptr(),
        c_T.data_ptr(), None if c_seq is None else c_seq.data_ptr(),
        h_buf.data_ptr(), barrier.data_ptr(), T, B, H, _device_index(dev),
        ctypes.c_void_p(stream))
    _kernels.check(err, name)
    return out, c_seq, h_T, c_T


def lstm_recurrence(xw_flat: Tensor, w_hh: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Run both directions of one BiLSTM layer.

    xw_flat: [T, B, 8H] f32; row t is [fwd projection(t) | bwd
    projection(t)] with biases added, and the backward half is NOT
    time-reversed. w_hh: [2, H, 4H] f32, gate order i, f, g, o. Zero
    initial state. Returns (out [T, B, 2H] in natural time order, h_T
    [2, B, H], c_T [2, B, H]), all f32.

    When autograd needs a gradient of either input, the call goes through
    :class:`LSTMRecurrence` (K3 forward, K4 backward). Otherwise CPU
    tensors take :func:`lstm_recurrence_plain` and CUDA tensors launch K1
    (``csrc/lstm_scan.cu``) or raise: it takes contiguous f32 inputs on one
    card, any T >= 1, H a multiple of 8 (the grid is 2H/8 blocks, which
    must all be resident at once) and B up to what one block's shared
    memory holds (B <= 186 at H = 256).
    """
    if torch.is_grad_enabled() and (xw_flat.requires_grad
                                    or w_hh.requires_grad):
        return LSTMRecurrence.apply(xw_flat, w_hh)
    _check_inputs(xw_flat, w_hh)
    if _on_cpu(xw_flat, w_hh):
        return lstm_recurrence_plain(xw_flat, w_hh)
    out, _, h_T, c_T = _launch_recurrence(xw_flat, w_hh, with_c_seq=False)
    lstm_recurrence.launches += 1
    return out, h_T, c_T


lstm_recurrence.launches = 0


def lstm_recurrence_train(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """K3: :func:`lstm_recurrence` plus the cell-state residual.

    Returns (out [T, B, 2H], c_seq [T, 2, B, H], h_T, c_T), all f32.
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
    result = _launch_recurrence(xw_flat, w_hh, with_c_seq=True)
    lstm_recurrence_train.launches += 1
    return result


lstm_recurrence_train.launches = 0


def _check_bwd_inputs(xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT):
    T, B, H = _check_inputs(xw_flat, w_hh)
    want = {'out': (T, B, 2 * H), 'c_seq': (T, 2, B, H),
            'd_out': (T, B, 2 * H), 'd_hT': (2, B, H), 'd_cT': (2, B, H)}
    got = {'out': out, 'c_seq': c_seq, 'd_out': d_out, 'd_hT': d_hT,
           'd_cT': d_cT}
    for k, t in got.items():
        if t.dtype != torch.float32:
            raise TypeError(f'lstm_recurrence_bwd takes float32 only, got '
                            f'{k} {t.dtype}')
        if tuple(t.shape) != want[k]:
            raise ValueError(f'{k} must be {list(want[k])}, got '
                             f'{list(t.shape)}')
    return T, B, H


def lstm_recurrence_bwd_plain(xw_flat: Tensor, w_hh: Tensor, out: Tensor,
                              c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                              d_cT: Tensor) -> Tuple[Tensor, Tensor]:
    """The backward recurrence as PyTorch operations: the gate algebra of
    the JAX kernel body (``ops/pallas/lstm_scan.py:858-907``), one reverse
    loop over the step s for both directions. Same contract as
    :func:`lstm_recurrence_bwd`."""
    T, B, H = _check_bwd_inputs(xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT)
    H4 = 4 * H
    dh = d_hT.clone()
    dc = d_cT.clone()
    d_xw = xw_flat.new_empty(T, B, 8 * H)
    d_w = xw_flat.new_zeros(2, H, H4)
    zeros = xw_flat.new_zeros(2, B, H)
    for s in range(T - 1, -1, -1):
        if s > 0:
            h_prev = torch.stack([out[s - 1, :, :H], out[T - s, :, H:]])
            c_prev = c_seq[s - 1]
        else:
            h_prev, c_prev = zeros, zeros
        x = torch.stack([xw_flat[s, :, :H4], xw_flat[T - 1 - s, :, H4:]])
        gates = torch.baddbmm(x, h_prev, w_hh)
        i = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        dh = dh + torch.stack([d_out[s, :, :H], d_out[T - 1 - s, :, H:]])
        tc = torch.tanh(c_seq[s])
        dc = dc + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            dh * tc * o * (1.0 - o)], dim=-1)  # [2, B, 4H]
        d_xw[s, :, :H4] = dgates[0]
        d_xw[T - 1 - s, :, H4:] = dgates[1]
        dh = torch.bmm(dgates, w_hh.transpose(1, 2))
        d_w += torch.bmm(h_prev.transpose(1, 2), dgates)
        dc = dc * f
    return d_xw, d_w


def lstm_recurrence_bwd(xw_flat: Tensor, w_hh: Tensor, out: Tensor,
                        c_seq: Tensor, d_out: Tensor, d_hT: Tensor,
                        d_cT: Tensor) -> Tuple[Tensor, Tensor]:
    """K4: gradients of one BiLSTM layer's recurrence.

    Takes the forward's inputs (xw_flat [T, B, 8H], w_hh [2, H, 4H]), its
    residuals from :func:`lstm_recurrence_train` (out [T, B, 2H], c_seq
    [T, 2, B, H]) and the cotangents of its outputs (d_out [T, B, 2H],
    d_hT and d_cT [2, B, H]). Returns (d_xw [T, B, 8H] in the flat layout
    of xw_flat, d_w_hh [2, H, 4H]), all f32.

    CPU tensors take :func:`lstm_recurrence_bwd_plain`. CUDA tensors launch
    ``csrc/lstm_bwd.cu`` or raise: contiguous f32 inputs on one card, H a
    multiple of 8 and B up to what one block's shared memory holds (B <=
    108 at H = 256).
    """
    args = (xw_flat, w_hh, out, c_seq, d_out, d_hT, d_cT)
    T, B, H = _check_bwd_inputs(*args)
    if _on_cpu(*args):
        return lstm_recurrence_bwd_plain(*args)
    dev = _cuda_checks('lstm_recurrence_bwd', args, H)
    lib = _kernels.library()
    _check_smem('lstm_recurrence_bwd', lib.svtsg_lstm_bwd_smem_bytes(B, H),
                B, H)
    d_xw = torch.empty(T, B, 8 * H, device=dev, dtype=torch.float32)
    d_w = torch.empty(2, H, 4 * H, device=dev, dtype=torch.float32)
    barrier = torch.empty(1, device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.svtsg_lstm_bwd(*(a.data_ptr() for a in args), d_xw.data_ptr(),
                             d_w.data_ptr(), barrier.data_ptr(), T, B, H,
                             _device_index(dev), ctypes.c_void_p(stream))
    _kernels.check(err, 'lstm_recurrence_bwd')
    lstm_recurrence_bwd.launches += 1
    return d_xw, d_w


lstm_recurrence_bwd.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """Differentiable recurrence: K3 forward, K4 backward (the port of the
    custom VJP ``lstm_flat_fused``, ``ops/pallas/lstm_scan.py:1033-1058``).
    Same contract as :func:`lstm_recurrence`; saves (xw, w_hh, out, c_seq)
    and gives d_xw in the flat layout, so the input projection's backward
    is one product too."""

    @staticmethod
    def forward(ctx, xw_flat: Tensor, w_hh: Tensor):
        out, c_seq, h_T, c_T = lstm_recurrence_train(xw_flat, w_hh)
        ctx.save_for_backward(xw_flat, w_hh, out, c_seq)
        return out, h_T, c_T

    @staticmethod
    def backward(ctx, d_out, d_hT, d_cT):
        xw_flat, w_hh, out, c_seq = ctx.saved_tensors
        T, B, H = _check_inputs(xw_flat, w_hh)

        def cotangent(g, shape):
            # an output that reached no loss has no gradient
            return (xw_flat.new_zeros(shape) if g is None
                    else g.contiguous())

        d_xw, d_w = lstm_recurrence_bwd(
            xw_flat, w_hh, out, c_seq, cotangent(d_out, (T, B, 2 * H)),
            cotangent(d_hT, (2, B, H)), cotangent(d_cT, (2, B, H)))
        return d_xw, d_w
