"""Pipeline parallelism: the GPipe microbatch schedule over QAVE's blocks.

Counterpart of ``shufflingvideosfortsg_tpu/parallel/pipeline.py``
(``create_pp_mesh`` ``:53``, ``stack_stage_params`` ``:66-91``,
``pipeline_blocks`` ``:94-183``, ``qave_pipelined`` ``:186-244``), over
the ``pipe`` axis of a ``(data, pipe)`` mesh of ranks
(``parallel/mesh.create_2d_mesh``). The homogeneous tail of the QAVE
stack (blocks 1..k, each [B, T, 2H] -> [B, T, 2H]) is one stage a pipe
rank, which holds that block alone (``train/pipelined.py``):

- block 0 runs data-parallel in front: pipe rank s takes its n-th of the
  rows, and the rows are all-gathered over the pipe axis (the backward a
  reduce-scatter: the pipeline's first stage alone reads them);
- the rows split into ``n_micro`` microbatches that ripple through the
  stages: stage 0 takes microbatch m, and a stage's output and the
  microbatch's word features (every stage's SCDM gate reads them) move
  one rank to the right, by a send and a receive whose backward sends the
  cotangents to the left (:class:`_SendRight`, :class:`_RecvLeft`);
- the last stage's output goes to every pipe rank (:class:`_FromLast`, a
  broadcast; JAX's psum of the last stage's output), whose backward hands
  the cotangent to the last stage once: every pipe rank computes the
  replicated heads' loss alike, so the stages' gradients are not
  multiplied by n.

A rank runs a stage for its n_micro real microbatches only: the (n - 1)
bubble ticks of JAX's tick scan are the time a rank waits for its first
input or its last cotangent. The backward runs the microbatches in
reverse order on every rank (autograd takes the latest-made node first),
so the sends and receives pair in order over NCCL too. The dropout masks
of every block are drawn first, for the whole local batch and in the
sequential stack's order, and each stage and microbatch takes its rows
of them, so a pipelined step draws the masks the sequential one draws
(JAX folds a key a stage and tick instead).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..ops.dense import layer_norm
from .mesh import DataMesh, MeshAxis, create_2d_mesh, sum_grad

PIPE_AXIS = 'pipe'


def create_pp_mesh(dp: int, pp: int, device: str = 'cuda') -> DataMesh:
    """A ``(data=dp, pipe=pp)`` mesh over the run's ranks, 'pipe'
    innermost (:func:`~.mesh.create_2d_mesh`)."""
    return create_2d_mesh(dp, pp, PIPE_AXIS, device)


def stack_stage_params(block_params: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """The blocks' parameters (one ``{name: tensor}`` a block) stacked on a
    new leading stage axis, [n_stages, ...]. The blocks must share their
    names and shapes (QAVE blocks 1..k do)."""
    first = list(block_params[0])
    for p in block_params[1:]:
        if list(p) != first:
            raise ValueError('pipeline stages must share a param treedef')
    try:
        return {k: torch.stack([p[k] for p in block_params]) for k in first}
    except RuntimeError as e:
        raise ValueError(
            f'pipeline stages must be shape-homogeneous: {e}') from e


class _GatherRows(torch.autograd.Function):
    """Each pipe rank's rows all-gathered in rank order; the backward
    sums the cotangent over the ranks and keeps the rank's rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather(x).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        parts = g.reshape((axis.size, -1) + g.shape[1:])
        return axis.reduce_scatter(parts), None


class _SendRight(torch.autograd.Function):
    """A stage's output and its microbatch's word features to the next
    stage; returns a 0-d token that joins the pipeline's output, so the
    backward reaches this node, which receives their cotangents."""

    @staticmethod
    def forward(ctx, y, w, axis):
        ctx.axis = axis
        ctx.like = [(t.shape, t.dtype) for t in (y, w)]
        axis.send(y, axis.rank + 1)
        axis.send(w, axis.rank + 1)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        axis = ctx.axis
        return (*(axis.recv(shape, dtype, axis.rank + 1)
                  for shape, dtype in ctx.like), None)


class _RecvLeft(torch.autograd.Function):
    """The previous stage's output and word features; the backward sends
    their cotangents back. ``anchor`` (a 0-d tensor that needs a gradient)
    puts the node in the graph."""

    @staticmethod
    def forward(ctx, anchor, axis, *like):
        ctx.axis = axis
        return tuple(axis.recv(shape, dtype, axis.rank - 1)
                     for shape, dtype in like)

    @staticmethod
    def backward(ctx, gx, gw):
        axis = ctx.axis
        axis.send(gx, axis.rank - 1)
        axis.send(gw, axis.rank - 1)
        return gx.new_zeros(()), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's output on every pipe rank (a broadcast); its
    cotangent goes to the last stage alone. ``others`` (the send tokens,
    and on the later stages the gathered block-0 rows they do not read)
    get zero cotangents, so every rank's backward reaches its sends and
    its collectives."""

    @staticmethod
    def forward(ctx, y, axis, *others):
        ctx.axis = axis
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        out = y.clone()
        return axis.broadcast_(out, axis.size - 1)

    @staticmethod
    def backward(ctx, g):
        last = ctx.axis.rank == ctx.axis.size - 1
        return (g if last else None, None,
                *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes))


def pipeline_blocks(block, x: torch.Tensor, word_feat: torch.Tensor,
                    axis: MeshAxis, n_micro: int,
                    draws: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Run the pipe axis's stages (``block``: this rank's stage, an
    ``RNNRecalibrationLayer``) as a GPipe microbatch pipeline over x [B,
    T, C] (the stage-0 input, replicated over the pipe axis) and
    word_feat [B, N, Ds]: the last stage's output [B, T, C] on every pipe
    rank. ``draws``: the stage's dropout draws for the whole B rows (one
    [B, T, 2H] tensor a layer but the last, ``BiLSTM.dropout_draws``), or
    None for no dropout."""
    n, s = axis.size, axis.rank
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f'local batch {B} must divide into {n_micro} '
                         'microbatches')
    Bm = B // n_micro
    outs, others = [], []
    for m in range(n_micro):
        rows = slice(m * Bm, (m + 1) * Bm)
        if s == 0:
            bx, bw = x[rows], word_feat[rows]
        else:
            anchor = x.new_zeros((), requires_grad=True)
            bx, bw = _RecvLeft.apply(
                anchor, axis, ((Bm,) + x.shape[1:], x.dtype),
                ((Bm,) + word_feat.shape[1:], word_feat.dtype))
        y = block(bx, bw, None,
                  None if draws is None else [d[rows] for d in draws])
        if s < n - 1:
            others.append(_SendRight.apply(y, bw, axis))
        else:
            outs.append(y)
    if s > 0:
        others.append(x)
    y = torch.cat(outs) if s == n - 1 else x.new_zeros(x.shape)
    return _FromLast.apply(y, axis, *others)


def qave_pipelined(encoder, video_feat: torch.Tensor,
                   word_feat: torch.Tensor, axis: MeshAxis, n_micro: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """QAVE (``encoder``, its blocks 1..nblocks-1 the pipe axis's stages,
    this rank's stage ``encoder.blocks[1 + axis.rank]``) with block 0
    data-parallel over the pipe ranks, the tail pipelined
    (:func:`pipeline_blocks`) and the final LayerNorm. Dropout follows the
    blocks' training mode, its masks drawn from ``generator`` as the
    sequential stack draws them."""
    n, s = axis.size, axis.rank
    nblocks = len(encoder.blocks)
    if nblocks - 1 != n:
        raise ValueError(f'nblocks={nblocks} needs a {nblocks - 1}-way '
                         f'{axis.name!r} mesh axis (got {n})')
    B, T = video_feat.shape[:2]
    if B % n:
        raise ValueError(f'local batch {B} must divide over the {n}-way '
                         f'{axis.name!r} mesh axis')
    draws = [blk.rnn_cell['lstm'].dropout_draws(B, T, video_feat.device,
                                                generator)
             for blk in encoder.blocks]
    # replicated inputs, each rank's use of them partial
    video, words = (sum_grad(t, axis) for t in (video_feat, word_feat))
    rows = slice(s * (B // n), (s + 1) * (B // n))
    y0 = encoder.blocks[0](video[rows], words[rows], None,
                           None if draws[0] is None
                           else [d[rows] for d in draws[0]])
    x = _GatherRows.apply(y0, axis)
    out = pipeline_blocks(encoder.blocks[1 + s], x, words, axis, n_micro,
                          draws[1 + s])
    return layer_norm(encoder.norm, out, encoder.dtype)
