"""Bidirectional multi-layer LSTM on the K1 recurrence kernel.

Counterpart of ``shufflingvideosfortsg_tpu/ops/rnn.py::BiLSTM`` on its
flat-layout path. Parameters carry ``torch.nn.LSTM``'s names and shapes
(``weight_ih_l{k}[_reverse]`` [4H, D], ``weight_hh_l{k}[_reverse]`` [4H, H],
both biases [4H], gate order i, f, g, o), so reference state dicts load
strictly; the module does not use ``nn.LSTM``. Per layer, the input
projection of both directions is one [T*B, D] @ [D, 8H] product into the
flat [T, B, 8H] layout, and the recurrence is
:func:`~shufflingvideosfortsg_torch.ops.lstm_scan.lstm_recurrence` (K1
without gradients, K3 and K4 with them). At a ``dtype`` of bf16 (JAX
``ops/rnn.py:133,201-225``) the input is cast to bf16, the projection is
:func:`~shufflingvideosfortsg_torch.ops.dense.dense` of the f32 weights
and the f32 sum of the two biases, K1 (in training K3 and K4) takes bf16
xw and W_hh (its h and c stay f32) and gives bf16 outputs, dropout runs
on the bf16 outputs, and the final states are cast to bf16.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .dense import dense
from .lstm_scan import lstm_recurrence

_DIRECTIONS = ('', '_reverse')


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``: keep with probability 1-p,
    scale kept values by 1/(1-p)) with the mask drawn from ``generator``,
    so a run's masks follow its own seed and not the global RNG. The
    generator lives on ``x``'s device; None draws from the default one.
    The uniform draws are f32 whatever x's dtype, as JAX's bernoulli
    draws them; in bf16 x is divided by the keep rate rounded to bf16, as
    flax divides a bf16 array by the Python float."""
    if not training or p <= 0.0:
        return x
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    scale = keep if x.dtype == torch.float32 else \
        float(torch.tensor(keep, dtype=x.dtype))
    return torch.where(u < keep, x / scale, torch.zeros_like(x))


class BiLSTM(nn.Module):
    """Bidirectional ``num_layers``-deep LSTM over [B, T, D] inputs.

    Returns (outputs [B, T, 2H], hn [2L, B, H], cn [2L, B, H]) with hn/cn
    layer-major and forward before backward, so ``hn[-2], hn[-1]`` are the
    last layer's final forward and backward states. Dropout applies to
    each layer's output except the last, in training only, with masks
    from the ``generator`` given to :meth:`forward`. ``dtype`` is the
    compute dtype (f32 or bf16); the parameters are f32.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        H = hidden_size
        for k in range(num_layers):
            d_in = input_size if k == 0 else 2 * H
            for sfx in _DIRECTIONS:
                self.register_parameter(f'weight_ih_l{k}{sfx}',
                                        nn.Parameter(torch.empty(4 * H, d_in)))
                self.register_parameter(f'weight_hh_l{k}{sfx}',
                                        nn.Parameter(torch.empty(4 * H, H)))
                self.register_parameter(f'bias_ih_l{k}{sfx}',
                                        nn.Parameter(torch.empty(4 * H)))
                self.register_parameter(f'bias_hh_l{k}{sfx}',
                                        nn.Parameter(torch.empty(4 * H)))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """``nn.LSTM``'s init: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def _layer_weights(self, k: int):
        p = {n: [getattr(self, f'{n}_l{k}{sfx}') for sfx in _DIRECTIONS]
             for n in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
        w_ih = torch.cat(p['weight_ih'], 0)                            # [8H, D]
        b = torch.cat([p['bias_ih'][i] + p['bias_hh'][i] for i in (0, 1)])
        w_hh = torch.stack([w.t() for w in p['weight_hh']]).contiguous()  # [2, H, 4H]
        return w_ih, b, w_hh

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, T, _ = x.shape
        H, dt = self.hidden_size, self.dtype
        hn, cn = [], []
        inputs = x.to(dt)
        for k in range(self.num_layers):
            w_ih, b, w_hh = self._layer_weights(k)
            # [B, T, D] -> [T*B, D] (a view when the input is the previous
            # layer's [T, B, 2H] output seen as [B, T, 2H])
            flat_in = inputs.transpose(0, 1).reshape(T * B, inputs.shape[-1])
            xw = dense(flat_in, w_ih, b, dt).view(T, B, 8 * H)
            out, h_T, c_T = lstm_recurrence(xw, w_hh.to(dt))
            hn += [h_T[0].to(dt), h_T[1].to(dt)]
            cn += [c_T[0].to(dt), c_T[1].to(dt)]
            layer_out = out.transpose(0, 1)
            if k + 1 < self.num_layers:
                layer_out = dropout(layer_out, self.dropout, self.training,
                                    generator)
            inputs = layer_out
        return inputs, torch.stack(hn), torch.stack(cn)
