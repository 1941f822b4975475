"""Expert parallelism: a mixture-of-experts FFN over an 'expert' axis of
ranks, with two all-to-all transposes.

Counterpart of ``shufflingvideosfortsg_tpu/parallel/expert_parallel.py``
(``create_ep_mesh`` ``:46``, ``init_moe_params`` ``:57``, ``_route``
``:77``, ``_expert_ffn`` ``:99``, ``moe_ffn_dense`` ``:109``,
``moe_ffn_sharded`` ``:121``, ``moe_span_head`` ``:166``). No config key
or driver reaches it, in JAX either: it is the scaling surface that widens
the per-frame head by conditional computation, the GShard recipe over the
[B, T, C] fused features as B*T tokens:

- a top-1 softmax router (f32 logits, the first expert on a tie) with a
  capacity per (rank, expert); a token past its expert's capacity is
  dropped and contributes zero (``moe_span_head`` adds the layer to a
  residual, so a dropped token keeps its input);
- dispatch and combine are einsums with one-hot masks, so the router's
  gradient flows through the gate probability in the combine;
- as the layer has gradients and composes with the data axis, it runs
  over a process group, like the model and pipe axes: a ``(data=dp,
  expert=ep)`` mesh (``parallel/mesh.create_2d_mesh``, rank = d*ep + k),
  rank r routing token stripe r (JAX's ``P((data, expert))``) and running
  experts ``[k E/ep, (k+1) E/ep)`` of the replicated weights;
- the only collectives are the two ``all_to_all`` transposes, tokens to
  experts and results back (:class:`_AllToAll`, whose backward is the
  same transpose of the cotangent), and the gradient sums: the router,
  used by every rank, summed over all of them; a rank's experts over the
  data axis.

The expert products are einsums, as JAX computes them outside any Pallas
kernel. The layer equals the dense oracle (:func:`moe_ffn_dense`) applied
to each stripe, forward and gradient
(``tests/test_torch_expert_parallel.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import DataMesh, MeshAxis, create_2d_mesh, sum_grad

EXPERT_AXIS = 'expert'
DATA_AXIS = 'data'
Params = Dict[str, torch.Tensor]


def create_ep_mesh(dp: int, ep: int, device: str = 'cuda') -> DataMesh:
    """A ``(data=dp, expert=ep)`` mesh over the run's ranks, 'expert'
    innermost (:func:`~.mesh.create_2d_mesh`): rank = d * ep + k."""
    return create_2d_mesh(dp, ep, EXPERT_AXIS, device)


def init_moe_params(generator: torch.Generator, dim: int, hidden: int,
                    n_experts: int, dtype: torch.dtype = torch.float32,
                    device='cpu') -> Params:
    """A router and E two-layer tanh expert FFNs (dim -> hidden -> dim),
    drawn from ``generator``: router and w1 U(-1/sqrt(dim), 1/sqrt(dim)),
    w2 U(-1/sqrt(hidden), 1/sqrt(hidden)), zero biases (JAX's shapes and
    ranges)."""
    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((u * 2 - 1) * bound).to(dtype=dtype, device=device)

    s1, s2 = 1.0 / math.sqrt(dim), 1.0 / math.sqrt(hidden)
    return {'router': uniform((dim, n_experts), s1),
            'w1': uniform((n_experts, dim, hidden), s1),
            'b1': torch.zeros(n_experts, hidden, dtype=dtype, device=device),
            'w2': uniform((n_experts, hidden, dim), s2),
            'b2': torch.zeros(n_experts, dim, dtype=dtype, device=device)}


def _route(params: Params, x: torch.Tensor, capacity: int) -> torch.Tensor:
    """Top-1 routing with a capacity per expert over one token stripe x
    [S, C]: combine [S, E, cap], each kept token's gate probability at its
    expert and slot, zero elsewhere (JAX ``:77-96``: f32 logits, the first
    expert on a tie, slots by a cumulative sum, slots past the capacity
    dropped)."""
    router = params['router']
    E = router.shape[1]
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                      # [S, E]
    expert = torch.argmax(probs, dim=-1)                       # [S]
    gate = probs.amax(dim=-1)                                  # [S]
    onehot = torch.nn.functional.one_hot(expert, E).float()    # [S, E]
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
    slot = pos.sum(dim=-1).to(torch.int32)                     # [S]
    keep = (slot < capacity).float()
    # one_hot of a slot past the capacity is all zeros, as jax.nn.one_hot
    slot_oh = (slot[:, None] == torch.arange(
        capacity, device=x.device, dtype=torch.int32)).float()  # [S, cap]
    return (gate * keep)[:, None, None] * onehot[:, :, None] \
        * slot_oh[:, None, :]


def _expert_ffn(w1, b1, w2, b2, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [..., E_local, cap, C] through each expert's two-layer tanh
    FFN (w1 [E_local, C, Hm], w2 [E_local, Hm, C])."""
    h = torch.tanh(torch.einsum('...ecd,edh->...ech', tokens, w1)
                   + b1[:, None, :])
    return torch.einsum('...ech,ehd->...ecd', h, w2) + b2[:, None, :]


def moe_ffn_dense(params: Params, x: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """The one-device oracle: the same routing and capacity drops, no
    collective. x [S, C] -> [S, C]."""
    combine = _route(params, x, capacity)
    dispatch = (combine > 0).to(x.dtype)
    tokens = torch.einsum('sec,sd->ecd', dispatch, x)          # [E, cap, C]
    y = _expert_ffn(params['w1'], params['b1'], params['w2'], params['b2'],
                    tokens)
    return torch.einsum('sec,ecd->sd', combine, y).to(x.dtype)


class _AllToAll(torch.autograd.Function):
    """x [n, ...] over ``axis``: block j goes to rank j, whose block i is
    what rank i sent (JAX's ``all_to_all(split_axis=0, concat_axis=0)``).
    The transpose is its own inverse, so the backward is the same
    exchange of the cotangent. Over gloo a CUDA tensor crosses through
    the host."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis), None


def _all_to_all(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    if not axis.distributed:
        return x.clone()
    dev = x.device
    through_host = x.is_cuda and axis.backend == 'gloo'
    src = (x.cpu() if through_host else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    return out.to(dev)


def moe_ffn_sharded(params: Params, x: torch.Tensor, mesh: DataMesh,
                    capacity: int, axis: str = EXPERT_AXIS,
                    data_axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Expert-parallel MoE FFN over ``mesh`` (:func:`create_ep_mesh`).

    ``x`` [S_local, C] is this rank's token stripe (rank r's of the
    global S, r = d * ep + k). ``params`` (replicated) hold the router and
    all E experts; rank (d, k) runs experts [k E/ep, (k+1) E/ep), and
    their gradient lands in those rows. ``capacity`` is per (rank,
    expert), as the oracle applies it to one
    stripe. The router's gradient is summed over every rank, the experts'
    over the data axis (``data_axis`` None: a mesh whose data axis is
    one). Returns [S_local, C].
    """
    ax = mesh.inner
    if ax is None or ax.name != axis:
        raise ValueError(f'a mesh with an inner {axis!r} axis '
                         '(create_ep_mesh) is needed')
    n = ax.size
    E = params['router'].shape[1]
    if E % n:
        raise ValueError(f'{E} experts must divide the {n}-way {axis!r} '
                         'axis')
    El = E // n
    data = mesh if data_axis is not None and mesh.distributed else None

    def over_data(t):
        return sum_grad(t, data) if data is not None else t

    router = over_data(sum_grad(params['router'], ax))
    mine = slice(ax.rank * El, (ax.rank + 1) * El)
    w1, b1, w2, b2 = (over_data(params[k][mine])
                      for k in ('w1', 'b1', 'w2', 'b2'))
    combine = _route({'router': router}, x, capacity)
    dispatch = (combine > 0).to(x.dtype)
    tokens = torch.einsum('sec,sd->ecd', dispatch, x)          # [E, cap, C]
    # tokens to experts: block j (experts of rank j) to rank j, which
    # stacks what every source rank sent: [n_src, El, cap, C]
    tokens = _AllToAll.apply(tokens.reshape((n, El) + tokens.shape[1:]), ax)
    y = _expert_ffn(w1, b1, w2, b2, tokens)
    # results back: the exact inverse
    y = _AllToAll.apply(y, ax).reshape((E,) + tokens.shape[2:])
    return torch.einsum('sec,ecd->sd', combine, y).to(x.dtype)


def moe_span_head(params: Params, feat: torch.Tensor, capacity: int,
                  mesh: Optional[DataMesh] = None, axis: str = EXPERT_AXIS,
                  data_axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """A residual MoE block over per-frame fused features [B, T, C]:
    ``feat + MoE(feat)``, so a dropped token keeps its features. With
    ``mesh`` the MoE is :func:`moe_ffn_sharded` over this rank's [B, T, C]
    (its stripe of the tokens), without it :func:`moe_ffn_dense`."""
    B, T, C = feat.shape
    x = feat.reshape(B * T, C)
    if mesh is None:
        y = moe_ffn_dense(params, x, capacity)
    else:
        y = moe_ffn_sharded(params, x, mesh, capacity, axis=axis,
                            data_axis=data_axis)
    return feat + y.reshape(B, T, C)
