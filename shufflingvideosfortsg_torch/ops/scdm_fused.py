"""K2 and K5: fused SCDM additive word attention, and its trainable form.

Counterpart of ``shufflingvideosfortsg_tpu/ops/pallas/scdm_fused.py``
``scdm_attention_fused`` (K2) and ``scdm_attention_fused_trainable`` (K5),
and of their plain formulation ``ops/attention.py::scdm_attention``. The
CUDA kernel is ``csrc/scdm.cu``; :func:`scdm_attention_plain` is the
broadcast-tanh version in PyTorch, which the wrapper takes for CPU tensors
and the card's checks hold the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _kernels

Tensor = torch.Tensor


def _check_inputs(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                  sent_feat: Tensor) -> Tuple[int, int, int, int, int]:
    args = (video_proj, sent_proj, w, sent_feat)
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError('scdm_attention_fused takes float32 only, got '
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
    return B, T, N, Dh, Ds


def scdm_attention_plain(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                         sent_feat: Tensor) -> Tensor:
    """The attention as PyTorch operations (``ops/attention.py:21-44``):
    materialises the [B, T, N, Dh] tanh activation. Same contract as
    :func:`scdm_attention_fused`."""
    _check_inputs(video_proj, sent_proj, w, sent_feat)
    act = torch.tanh(video_proj[:, :, None, :] + sent_proj[:, None, :, :])
    logits = torch.einsum('btnh,h->btn', act, w)
    P = torch.softmax(logits, dim=-1)
    return torch.einsum('btn,bnd->btd', P, sent_feat)


def scdm_attention_fused(video_proj: Tensor, sent_proj: Tensor, w: Tensor,
                         sent_feat: Tensor) -> Tensor:
    """Per-frame text context C [B, T, Ds].

    video_proj: [B, T, Dh] (= W_a v + b_a); sent_proj: [B, N, Dh]
    (= W_s s); w: [Dh]; sent_feat: [B, N, Ds]; all f32. The softmax runs in
    f32 over all N word slots, padded slots included (the reference's
    quirk).

    CPU tensors take :func:`scdm_attention_plain`. CUDA tensors launch
    ``csrc/scdm.cu`` or raise: it takes contiguous f32 inputs on one card,
    N <= 32, Dh and Ds multiples of 32 up to 1024, and an N, Dh, Ds whose
    staged rows fit one block's shared memory. It has no backward: call it
    with gradients off, or call :func:`scdm_attention_fused_trainable`.
    """
    B, T, N, Dh, Ds = _check_inputs(video_proj, sent_proj, w, sent_feat)
    args = (video_proj, sent_proj, w, sent_feat)
    if all(a.device.type == 'cpu' for a in args):
        return scdm_attention_plain(*args)
    dev = video_proj.device
    if not (video_proj.is_cuda and all(a.device == dev for a in args)):
        raise ValueError('scdm_attention_fused inputs must lie on one CUDA '
                         f'device, got {[str(a.device) for a in args]}')
    if not all(a.is_contiguous() for a in args):
        raise ValueError('scdm_attention_fused needs contiguous inputs')
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise RuntimeError('scdm_attention_fused has no backward; call it '
                           'under torch.no_grad() or call '
                           'scdm_attention_fused_trainable')
    lib = _kernels.library()
    max_n, max_width = lib.svtsg_scdm_max_words(), lib.svtsg_scdm_max_width()
    if not 1 <= N <= max_n:
        raise ValueError(f'scdm_attention_fused takes 1 <= N <= {max_n}, got {N}')
    if Dh % 32 or Ds % 32 or not (0 < Dh <= max_width and 0 < Ds <= max_width):
        raise ValueError(f'Dh={Dh} and Ds={Ds} must be multiples of 32 up to '
                         f'{max_width}')
    smem = lib.svtsg_scdm_smem_bytes(N, Dh, Ds)
    if smem > _kernels.MAX_SMEM_BYTES:
        raise ValueError(f'N={N}, Dh={Dh}, Ds={Ds} need {smem} bytes of '
                         f'shared memory per block, over the '
                         f'{_kernels.MAX_SMEM_BYTES} a block may use')
    out = torch.empty(B, T, Ds, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.svtsg_scdm_attention(
        video_proj.data_ptr(), sent_proj.data_ptr(), w.data_ptr(),
        sent_feat.data_ptr(), out.data_ptr(), B, T, N, Dh, Ds,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(stream))
    _kernels.check(err, 'scdm_attention_fused')
    scdm_attention_fused.launches += 1
    return out


scdm_attention_fused.launches = 0


class _ScdmAttentionTrainable(torch.autograd.Function):
    """K5 (``scdm_fused.py:102-122``): the K2 forward, and as backward the
    vector-Jacobian product of the plain formulation recomputed from the
    saved inputs, as ``_scdm_bwd`` takes ``jax.vjp`` of
    ``ops/attention.py::scdm_attention``. The JAX backward is XLA, not a
    Pallas kernel, so PyTorch operations are its faithful port; at B=64,
    T=128, N=15, Dh=512 they materialise the 252 MB tanh activation."""

    @staticmethod
    def forward(ctx, video_proj, sent_proj, w, sent_feat):
        ctx.save_for_backward(video_proj, sent_proj, w, sent_feat)
        return scdm_attention_fused(video_proj, sent_proj, w, sent_feat)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = scdm_attention_plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        if inputs[0].is_cuda:
            scdm_attention_fused_trainable.launches += 1
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def scdm_attention_fused_trainable(video_proj: Tensor, sent_proj: Tensor,
                                   w: Tensor, sent_feat: Tensor) -> Tensor:
    """Differentiable :func:`scdm_attention_fused`: same contract, with a
    backward. ``launches`` counts its backward passes on a card."""
    return _ScdmAttentionTrainable.apply(video_proj, sent_proj, w, sent_feat)


scdm_attention_fused_trainable.launches = 0
