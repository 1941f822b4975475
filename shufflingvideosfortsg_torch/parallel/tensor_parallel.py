"""Tensor parallelism: the hidden-axis-sharded BiLSTM over a 2-D mesh.

Counterpart of ``shufflingvideosfortsg_tpu/parallel/tensor_parallel.py``
(``create_tp_mesh`` ``:53-62``, ``_perm_cols`` ``:65-74``,
``bilstm_hidden_sharded`` ``:77-177``): the Megatron split adapted to a
gated recurrence, over the ``model`` axis of a ``(data, model)`` mesh of
ranks (``parallel/mesh.create_2d_mesh``).

- Gate-aligned column shards: the 4H axis of each projection is permuted
  to shard-major order (:func:`_perm_cols`), so shard k holds the k-th
  H/n slice of every gate, and a rank computes its gates, cell-state
  shard and hidden shard locally. The weights stay replicated; each rank
  takes its shard inside the forward, and its gradient lands in those
  rows of the full weight (``sum_grads`` over the model axis assembles
  them, as JAX's shard_map transposes its sharded weight inputs).
- The one collective of the recurrence: each step all-gathers h ([2, B,
  H/n] -> [2, B, H], natural order) for the local ``[2, B, H] @ [2, H,
  4H/n]`` product. Its backward is a reduce-scatter (sum): each rank's
  product used the whole h.
- Layer boundaries gather the [T, B, 2H] outputs back to replicated (the
  backward takes the rank's slice: everything downstream is computed
  alike on every model rank), and the layer's input, replicated, has its
  gradient summed over the model axis (shard_map's transpose of a
  replicated input). Inter-layer dropout is drawn at that boundary, on
  the [B, T, 2H] output, as ``ops/rnn.BiLSTM`` draws it: the same masks
  from the same generator, so a dropout > 0 step equals the unsharded
  one in distribution and in its masks.

JAX's recurrence is a ``lax.scan`` of einsums with no ``pallas_call``, and
so is this one: per step one ``torch.matmul`` and the gates' element-wise
operations, in ``dtype`` as JAX rounds them (the products summed in f32
and rounded, the state in ``dtype``). Numerics equal ``ops/rnn.BiLSTM``
up to f32 reassociation of the split contractions
(``tests/test_torch_tensor_parallel.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.dense import dense
from ..ops.rnn import _sigmoid, dropout as apply_dropout
from .mesh import DataMesh, MeshAxis, create_2d_mesh, sum_grad

MODEL_AXIS = 'model'


def create_tp_mesh(dp: int, mp: int, device: str = 'cuda') -> DataMesh:
    """A ``(data=dp, model=mp)`` mesh over the run's ranks, 'model'
    innermost (:func:`~.mesh.create_2d_mesh`)."""
    return create_2d_mesh(dp, mp, MODEL_AXIS, device)


def _perm_cols(w: torch.Tensor, H: int, n: int, gates: int = 4
               ) -> torch.Tensor:
    """Permute a ``[..., gates*H]`` gate-blocked axis to SHARD-major order,
    so a plain n-way split of the last axis hands shard k the k-th H/n
    slice of every gate: ``new[k*gates*Hs + g*Hs + j] = old[g*H + k*Hs +
    j]``."""
    Hs = H // n
    return torch.cat([w[..., g * H + k * Hs: g * H + (k + 1) * Hs]
                      for k in range(n) for g in range(gates)], dim=-1)


def _shard(w: torch.Tensor, H: int, axis: MeshAxis) -> torch.Tensor:
    """This rank's gate-aligned shard of ``w`` [..., 4H]: [..., 4H/n]."""
    G = 4 * H // axis.size
    return _perm_cols(w, H, axis.size)[..., axis.rank * G:(axis.rank + 1) * G]


def _gather_last(h: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """[..., Hs] of every rank -> [..., n*Hs], the ranks in order."""
    parts = axis.all_gather(h)                       # [n, ..., Hs]
    return parts.movedim(0, -2).reshape(h.shape[:-1] + (-1,))


class _GatherHidden(torch.autograd.Function):
    """h's shards all-gathered along the last axis; the backward sums the
    cotangent's slices over the ranks (a reduce-scatter): each rank's
    product used the whole h."""

    @staticmethod
    def forward(ctx, h, axis):
        ctx.axis = axis
        return _gather_last(h, axis)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        parts = g.reshape(g.shape[:-1] + (axis.size, -1)).movedim(-2, 0)
        return axis.reduce_scatter(parts), None


class _GatherReplicated(torch.autograd.Function):
    """A layer's output shards gathered to the replicated tensor; the
    backward takes the rank's slice of the cotangent, which every model
    rank holds alike."""

    @staticmethod
    def forward(ctx, h, axis):
        ctx.axis = axis
        ctx.width = h.shape[-1]
        return _gather_last(h, axis)

    @staticmethod
    def backward(ctx, g):
        k, w = ctx.axis.rank, ctx.width
        return g[..., k * w:(k + 1) * w].contiguous(), None


def bilstm_hidden_sharded(lstm, x: torch.Tensor, axis: MeshAxis,
                          generator: Optional[torch.Generator] = None,
                          dropout: float = 0.0) -> torch.Tensor:
    """``lstm`` (an ``ops/rnn.BiLSTM``, its weights replicated) over x [B,
    T, D], replicated over ``axis``, with its hidden axis sharded over
    ``axis``: [B, T, 2H], replicated. ``dropout`` > 0 applies inter-layer
    dropout (each layer's output but the last) with masks from
    ``generator``, drawn as ``lstm`` draws them. Computes in ``lstm.dtype``
    as JAX's ``bilstm_hidden_sharded`` does at its ``dtype``."""
    H, n, dt = lstm.hidden_size, axis.size, lstm.dtype
    if H % n:
        raise ValueError(
            f'hidden size {H} must divide the {n}-way {axis.name!r} axis')
    Hs = H // n
    B, T = x.shape[:2]
    inputs = x.to(dt)
    for layer in range(lstm.num_layers):
        p = {name: [getattr(lstm, f'{name}_l{layer}{sfx}')
                    for sfx in ('', '_reverse')]
             for name in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
        # [4H, *] per direction -> this rank's [4Hs, *] rows, gate-aligned
        w_ih = [_shard(w.t(), H, axis).t() for w in p['weight_ih']]
        w_hh = torch.stack([_shard(w.t(), H, axis)
                            for w in p['weight_hh']]).to(dt)  # [2, H, 4Hs]
        b = [_shard(p['bias_ih'][d] + p['bias_hh'][d], H, axis)
             for d in (0, 1)]
        src = sum_grad(inputs, axis)
        # column-parallel projection of both directions, direction 1 on
        # the time-reversed input: xw [T, 2, B, 4Hs]
        xw = torch.stack([dense(s.transpose(0, 1), w_ih[d], b[d], dt)
                          for d, s in enumerate((src, src.flip(1)))], 1)
        h = c = xw.new_zeros((2, B, Hs))
        steps = []
        for t in range(T):
            h_full = _GatherHidden.apply(h, axis)             # [2, B, H]
            gates = xw[t] + torch.matmul(h_full, w_hh)
            i = _sigmoid(gates[..., :Hs])
            f = _sigmoid(gates[..., Hs:2 * Hs])
            g = torch.tanh(gates[..., 2 * Hs:3 * Hs])
            o = _sigmoid(gates[..., 3 * Hs:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            steps.append(h)
        out = _GatherReplicated.apply(torch.stack(steps), axis)  # [T, 2, B, H]
        layer_out = torch.cat([out[:, 0], out[:, 1].flip(0)],
                              dim=-1).transpose(0, 1)            # [B, T, 2H]
        if dropout > 0.0 and layer + 1 < lstm.num_layers:
            layer_out = apply_dropout(layer_out, dropout, True, generator)
        inputs = layer_out
    return inputs
