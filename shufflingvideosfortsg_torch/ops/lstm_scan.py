"""K1: the inference BiLSTM recurrence, both directions in one kernel.

Counterpart of ``shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py``
``lstm_scan_pallas_flat`` (flat layout). The CUDA kernel is
``csrc/lstm_scan.cu``; :func:`lstm_recurrence_plain` is the same function
as a loop of PyTorch operations, which the wrapper takes for CPU tensors
and the card's checks hold the kernel against.
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


def lstm_recurrence_plain(xw_flat: Tensor, w_hh: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """The recurrence as PyTorch operations (the JAX ``_lstm_scan`` step,
    ``ops/rnn.py:76-103``, on the flat layout). Same contract as
    :func:`lstm_recurrence`."""
    T, B, H = _check_inputs(xw_flat, w_hh)
    H4 = 4 * H
    h = xw_flat.new_zeros(2, B, H)
    c = xw_flat.new_zeros(2, B, H)
    out = xw_flat.new_empty(T, B, 2 * H)
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
    return out, h, c


def lstm_recurrence(xw_flat: Tensor, w_hh: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Run both directions of one BiLSTM layer.

    xw_flat: [T, B, 8H] f32; row t is [fwd projection(t) | bwd
    projection(t)] with biases added, and the backward half is NOT
    time-reversed. w_hh: [2, H, 4H] f32, gate order i, f, g, o. Zero
    initial state. Returns (out [T, B, 2H] in natural time order, h_T
    [2, B, H], c_T [2, B, H]), all f32.

    CPU tensors take :func:`lstm_recurrence_plain`. CUDA tensors launch
    ``csrc/lstm_scan.cu`` or raise: it takes contiguous f32 inputs on one
    card, any T >= 1, H a multiple of 8 (the grid is 2H/8 blocks, which
    must all be resident at once) and B up to what one block's shared
    memory holds (B <= 186 at H = 256). It has no backward: call it with
    gradients off.
    """
    T, B, H = _check_inputs(xw_flat, w_hh)
    if xw_flat.device.type == 'cpu' and w_hh.device.type == 'cpu':
        return lstm_recurrence_plain(xw_flat, w_hh)
    if not (xw_flat.is_cuda and w_hh.device == xw_flat.device):
        raise ValueError(f'xw_flat and w_hh must lie on one CUDA device, got '
                         f'{xw_flat.device} and {w_hh.device}')
    if not (xw_flat.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError('lstm_recurrence needs contiguous inputs')
    if H % 8:
        raise ValueError(f'lstm_recurrence needs H % 8 == 0, got H={H}')
    if torch.is_grad_enabled() and (xw_flat.requires_grad or w_hh.requires_grad):
        raise RuntimeError('lstm_recurrence has no backward kernel yet; '
                           'call it under torch.no_grad()')
    lib = _kernels.library()
    smem = lib.svtsg_lstm_smem_bytes(B, H)
    if smem > _kernels.MAX_SMEM_BYTES:
        raise ValueError(f'B={B}, H={H} needs {smem} bytes of shared memory '
                         f'per block, over the {_kernels.MAX_SMEM_BYTES} a '
                         f'block may use')
    dev = xw_flat.device
    out = torch.empty(T, B, 2 * H, device=dev, dtype=torch.float32)
    h_T = torch.empty(2, B, H, device=dev, dtype=torch.float32)
    c_T = torch.empty(2, B, H, device=dev, dtype=torch.float32)
    h_buf = torch.empty(2, 2, B, H, device=dev, dtype=torch.float32)
    barrier = torch.empty(1, device=dev, dtype=torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.svtsg_lstm_recurrence(
        xw_flat.data_ptr(), w_hh.data_ptr(), out.data_ptr(), h_T.data_ptr(),
        c_T.data_ptr(), h_buf.data_ptr(), barrier.data_ptr(), T, B, H,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(stream))
    _kernels.check(err, 'lstm_recurrence')
    lstm_recurrence.launches += 1
    return out, h_T, c_T


lstm_recurrence.launches = 0
