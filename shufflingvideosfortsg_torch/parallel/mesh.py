"""The data axis: data-parallel training and evaluation over a process
group.

Counterpart of ``shufflingvideosfortsg_tpu/parallel/mesh.py``. JAX runs a
one-dimensional ``data`` mesh: batches sharded on their first axis,
parameters and optimizer state replicated, XLA inserting the gradient and
metric all-reduces; across hosts each process loads a disjoint stripe of
the identically seeded global shuffle (JAX ``cli.py:191-208``). Here each
JAX process is one ``torch.distributed`` rank with one card, launched by
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), and the port follows JAX's multi-host contract:

- :func:`create_mesh` starts the process group from that environment
  (NCCL on a card, gloo with ``--device cpu``; once a process, torn down
  at exit) or takes the one the caller started, pins the rank to
  ``cuda:LOCAL_RANK`` and returns a :class:`DataMesh`. A ``mesh_shape``
  whose product is not the world size raises. With ``WORLD_SIZE`` unset
  (or 1) and no group started, the mesh has no group and every path runs
  as without it, bit for bit.
- Each rank's loader yields its stripe (``data/pipeline.BatchLoader``,
  ``process_index``/``process_count``), and its batches go to its own
  card whole: JAX's ``shard_batch`` and ``host_local_rows`` have nothing
  left to do, and an evaluation's outputs are the rank's own rows, in its
  batches' order (JAX's multi-host ``OutputAccumulator.append``).
- ``replicate_tree`` becomes :meth:`DataMesh.broadcast_` of rank 0's
  weights and optimizer state, at the start and after ``--start_from``.
- A train step runs its forward and backward on the rank's rows, then
  :meth:`DataMesh.sync_grads`: one flat all-reduce that sums the
  gradients and divides once by the world size, before the clip and the
  optimizer. Its metrics are meaned over the ranks
  (:meth:`DataMesh.mean_metrics`), so every rank logs and checks the same
  global values.
- The step's random draws (pseudo-video offsets, dropout masks) are drawn
  for the global batch from the shared generator, and each rank keeps its
  own rows (:func:`uniform`, inside :meth:`DataMesh.rows`). Global row j
  of a step is row j // P of rank j % P, the order in which the loader's
  stripes deal the shuffled samples out, so a P-rank step equals the
  single-process step at P times the batch on the same samples, up to the
  order of summation.

Two-dimensional meshes (:func:`create_2d_mesh`, JAX's ``create_tp_mesh``
and ``create_pp_mesh``): ``dp`` rows of ``n`` ranks, the inner axis
innermost as in JAX's ``reshape(dp, n)``, so rank = d * n + k. Every rank
makes one subgroup a row and one a column, in the same order. The
returned :class:`DataMesh` runs over the rank's data column (its ``rank``
and ``world`` are the data index d and dp: the loader's stripes,
:meth:`DataMesh.rows`, the means and the ``.part{d}`` submits are keyed
by d, and the n ranks of a row take the same rows); its ``inner``
:class:`MeshAxis` is the rank's row, the model axis of tensor
parallelism or the pipe axis of pipeline parallelism. Rank 0 alone
writes checkpoints and metrics, the first rank of each row its row's
submit part, and the barriers and the start's broadcast span every rank.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import math
import os
import sys
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# (rank, world) whose rows a draw of uniform() keeps; (0, 1) outside a
# data-parallel step
_ROWS = (0, 1)
_OWNED = False  # whether create_mesh started the default process group
_FAILED = False  # whether an uncaught exception is ending the process


def uniform(shape: Sequence[int], generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """f32 U[0, 1) draws of ``shape`` [rows, ...] from ``generator``. Inside
    :meth:`DataMesh.rows` of a P-rank mesh the draw is made for the
    global batch, [P * rows, ...], and this rank's rows r, r + P, ... are
    kept, so the generator advances on every rank as on one process."""
    rank, world = _ROWS
    shape = tuple(int(s) for s in shape)
    if world == 1:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    u = torch.rand((shape[0] * world,) + shape[1:], generator=generator,
                   device=device, dtype=torch.float32)
    return u[rank::world]


def _flat_grads_(params: Iterable[torch.nn.Parameter], reduce_) -> None:
    """``params``' gradients (those that exist) replaced by ``reduce_`` of
    them, one flat tensor a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = reduce_(torch.cat([g.reshape(-1) for g in grads]))
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


class DataMesh:
    """The data axis of a run: this process's ``rank`` of ``world``, its
    ``device``, and ``group`` (None without a process group: then every
    collective is skipped)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 group=None, inner: Optional['MeshAxis'] = None,
                 world_group=None):
        self.rank, self.world, self.device, self.group = \
            rank, world, device, group
        self.inner = inner
        # every rank of the run: the barriers and the start's broadcast
        self.world_group = group if world_group is None else world_group

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def leads_row(self) -> bool:
        """Whether this rank writes its row's outputs (its submit part):
        the row's first rank on a 2-D mesh, every rank otherwise."""
        return self.inner is None or self.inner.rank == 0

    @property
    def is_rank0(self) -> bool:
        return self.rank == 0 and self.leads_row

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.distributed else None

    @contextlib.contextmanager
    def rows(self):
        """A step's draws keep this rank's rows of the global batch
        (:func:`uniform`)."""
        global _ROWS
        before, _ROWS = _ROWS, (self.rank, self.world)
        try:
            yield
        finally:
            _ROWS = before

    def all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` meaned over the ranks, in place: summed, then divided once
        by the world size."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
            t.div_(self.world)
        return t

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """A step's 0-d metrics meaned over the ranks in one all-reduce:
        every rank holds the global batch's values."""
        if not self.distributed:
            return metrics
        keys = list(metrics)
        flat = self.mean_(torch.stack([metrics[k].float() for k in keys]))
        return dict(zip(keys, flat.unbind()))

    def sync_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """The gradients in ``params``' ``.grad`` replaced by their mean
        over the ranks: one flat all-reduce a dtype that sums them, then
        one division by the world size."""
        if self.distributed:
            _flat_grads_(params, self.mean_)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Every tensor overwritten, in place, by rank 0's (JAX's
        ``replicate_tree``), on every rank of the run."""
        if self.world_group is None:
            return
        for t in tensors:
            dist.broadcast(t, 0, group=self.world_group)

    def barrier(self) -> None:
        """Every rank of the run meets here."""
        if self.world_group is not None:
            if self.device.type == 'cuda' and \
                    dist.get_backend(self.world_group) == 'nccl':
                dist.barrier(group=self.world_group,
                             device_ids=[self.device.index])
            else:
                dist.barrier(group=self.world_group)

    def mean_host(self, arrays: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        """numpy arrays of per-batch means (an evaluation's loss and mIoU)
        meaned over the ranks in one all-reduce on the device."""
        if not self.distributed or not arrays:
            return arrays
        keys = list(arrays)
        flat = torch.from_numpy(np.stack(
            [np.asarray(arrays[k], np.float32) for k in keys])).to(self.device)
        flat = self.mean_(flat).cpu().numpy()
        return {k: flat[i] for i, k in enumerate(keys)}


def replicate_state(mesh: DataMesh, state) -> None:
    """Rank 0's weights, buffers and optimizer state on every rank
    (``state`` a ``TrainState``): JAX's ``replicate_tree`` of its train
    state, run at the start of training and after ``--start_from``."""
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for per_param in state.optimizer.state.values():
        tensors += [v for v in per_param.values()
                    if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        mesh.broadcast_(tensors)


def _torchrun_world() -> int:
    return int(os.environ.get('WORLD_SIZE', '1') or 1)


def teardown() -> None:
    """Destroy the process group that :func:`create_mesh` started (run at
    exit), unless an uncaught exception is ending the process: the other
    ranks may then be waiting in a collective this rank will not join, and
    a graceful destroy would wait with them, so the rank would never exit
    and torchrun never stop the rest; the rank exits without it. The dead
    steps' CUDA graphs, which keep the NCCL
    communicator's captured collectives and sit in reference cycles with
    their steps, are collected first: NCCL does not finish destroying a
    communicator of several ranks while such graphs live."""
    global _OWNED
    if _OWNED and dist.is_initialized() and not _FAILED:
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()
    _OWNED = False


def _noting_failure(hook):
    """``sys.excepthook`` that records the failure for :func:`teardown`
    before ``hook`` reports it."""
    def note(*exc_info):
        global _FAILED
        _FAILED = True
        hook(*exc_info)
    return note


def world_size() -> int:
    """The ranks of the run: the process group's, or torchrun's
    ``WORLD_SIZE`` before the group starts (1 without either)."""
    return dist.get_world_size() if dist.is_initialized() else \
        _torchrun_world()


def _start_group(device: str) -> torch.device:
    """The rank's device, with the default process group started from
    torchrun's environment where it has more than one rank (see
    :func:`create_mesh`)."""
    global _OWNED
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and _torchrun_world() > 1:
        if dev.type == 'cuda' and not dist.is_nccl_available():
            raise RuntimeError(f'WORLD_SIZE={_torchrun_world()} on {dev}: '
                               'this torch has no NCCL backend')
        dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                                init_method='env://',
                                **({'device_id': dev}
                                   if dev.type == 'cuda' else {}))
        _OWNED = True
        sys.excepthook = _noting_failure(sys.excepthook)
        atexit.register(teardown)
    return dev


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                device: str = 'cuda') -> DataMesh:
    """The run's data axis (JAX ``create_mesh``). Under ``torchrun``
    (``WORLD_SIZE`` > 1) the default process group starts here, once a
    process: NCCL on a card (which raises where NCCL is missing), gloo on
    the CPU; a group the caller started is taken as it is, at any size and
    backend. ``device`` 'cuda' becomes ``cuda:LOCAL_RANK`` (0 without it),
    the rank's own card; an index given stays. ``mesh_shape``'s product
    must equal the world size."""
    dev = _start_group(device)
    if dist.is_initialized():
        mesh = DataMesh(dist.get_rank(), dist.get_world_size(), dev,
                        dist.group.WORLD)
    else:
        mesh = DataMesh(0, 1, dev)
    if mesh_shape:
        n = math.prod(int(s) for s in mesh_shape)
        if n != mesh.world:
            raise ValueError(f'mesh_shape {list(mesh_shape)} holds {n} '
                             f'devices, the process group {mesh.world} '
                             'ranks')
    return mesh


class MeshAxis:
    """The inner axis of a 2-D mesh (:func:`create_2d_mesh`): this rank's
    place ``rank`` of ``size`` along its row, the row's ``group`` (None
    with one rank: every collective is then the identity) and the row's
    global ``ranks`` in order. ``name`` is JAX's axis name, 'model' or
    'pipe'. gloo takes no CUDA tensor in a send or receive, so over gloo
    those cross through the host."""

    def __init__(self, name: str, rank: int, size: int, group,
                 ranks: Sequence[int], device: torch.device):
        self.name, self.rank, self.size, self.group = name, rank, size, group
        self.ranks, self.device = list(ranks), device

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.distributed else None

    def all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the row, in place."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def sum_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """The gradients in ``params``' ``.grad`` summed over the row: one
        flat all-reduce a dtype."""
        if self.distributed:
            _flat_grads_(params, self.all_sum_)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in row order."""
        out = t.new_empty((self.size,) + tuple(t.shape))
        if not self.distributed:
            out[0] = t
            return out
        dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                    group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t`` [size, ...] summed over the row."""
        if not self.distributed:
            return t[0].clone()
        out = t.new_empty(t.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), t.contiguous().view(-1),
                                   group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` overwritten, in place, by row rank ``src``'s."""
        if self.distributed:
            dist.broadcast(t, self.ranks[src], group=self.group)
        return t

    def send(self, t: torch.Tensor, dst: int) -> None:
        """``t`` to row rank ``dst``."""
        t = t.detach().contiguous()
        if t.is_cuda and self.backend == 'gloo':
            t = t.cpu()
        dist.send(t, self.ranks[dst], group=self.group)

    def recv(self, shape, dtype: torch.dtype, src: int) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` on this rank's device from
        row rank ``src``."""
        host = self.device.type == 'cuda' and self.backend == 'gloo'
        buf = torch.empty(shape, dtype=dtype,
                          device='cpu' if host else self.device)
        dist.recv(buf, self.ranks[src], group=self.group)
        return buf.to(self.device)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.axis.all_sum_(g), None


def sum_grad(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``x`` itself, its gradient summed over ``axis``: a tensor every rank
    of the row holds alike, which each rank's computation uses in part
    (JAX's shard_map transposes a replicated input so)."""
    return _SumGrad.apply(x, axis)


def create_2d_mesh(dp: int, n: int, name: str,
                   device: str = 'cuda') -> DataMesh:
    """A ``(data=dp, name=n)`` mesh over the run's ranks (JAX's
    ``create_tp_mesh``/``create_pp_mesh``): the process group started as
    :func:`create_mesh` starts it, ``dp * n`` of them, rank = d * n + k.
    Every rank makes the dp row subgroups and then the n column subgroups
    (``new_group`` is collective), each in index order. Returns the data
    column's :class:`DataMesh` with the row as its ``inner``
    :class:`MeshAxis`."""
    dev = _start_group(device)
    world = world_size()
    if dp * n != world:
        raise ValueError(f'need {dp * n} devices, have {world}')
    if world == 1:
        return DataMesh(0, 1, dev, inner=MeshAxis(name, 0, 1, None, [0],
                                                  dev))
    rank = dist.get_rank()
    d, k = divmod(rank, n)
    rows = [list(range(i * n, (i + 1) * n)) for i in range(dp)]
    cols = [list(range(j, dp * n, n)) for j in range(n)]
    row_groups = [dist.new_group(r) for r in rows]
    col_groups = [dist.new_group(c) for c in cols]
    inner = MeshAxis(name, k, n, row_groups[d] if n > 1 else None, rows[d],
                     dev)
    return DataMesh(d, dp, dev, col_groups[k], inner=inner,
                    world_group=dist.group.WORLD)
