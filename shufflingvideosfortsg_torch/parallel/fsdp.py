"""FSDP: ZeRO-3 sharding of the train state over the data axis.

Counterpart of ``shufflingvideosfortsg_tpu/parallel/fsdp.py``
(``FSDP_MIN_BYTES``, ``sharding_for_leaf``, ``shard_train_state``,
``gather_state``, ``resident_state_bytes``) and of JAX ``cli._place_state``.
JAX places each state leaf with a ``NamedSharding`` and lets XLA gather a
parameter before use and reduce-scatter its gradient into the sharded
Adam update. Here the same rule places the same leaves, by hand:

- :func:`shard_dim` is ``sharding_for_leaf``: a leaf of at least
  ``fsdp_min_bytes`` is split on its largest axis that the world size
  divides; smaller leaves, scalars and leaves with no such axis stay
  replicated. FSDP2's ``fully_shard`` splits dim 0 of every parameter,
  which is another placement, so the port does not use it.
- :class:`ShardedState` takes a :class:`~..train.state.TrainState` whose
  weights and optimizer state every rank holds whole and alike: each
  split parameter keeps only its rank's slice, which the optimizer then
  updates in place of the parameter, its Adam moments (or SGD momentum)
  sliced with it; the model's copy of the parameter is freed.
- :meth:`ShardedState.gathered` all-gathers the full parameters into the
  model for a forward and backward (or a valid pass) and frees them
  after. :meth:`ShardedState.update` reduce-scatters each split
  parameter's gradient into its slice (summed, then divided by the world
  size), all-reduces the replicated leaves' gradients in one flat
  all-reduce, clips by the global norm over all of them and steps the
  optimizer on the slices.
- :meth:`ShardedState.weights` and :meth:`ShardedState.state_dict`
  gather the full weights and optimizer state (collectives: every rank
  calls them), so a checkpoint is the same ``.ckp`` and sidecar as a
  replicated run's.

The full parameters exist only inside :meth:`ShardedState.gathered`, at
an address a CUDA graph would have to pin, so FSDP steps and valid
passes run eagerly (``cli._train`` logs it).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import DataMesh

# leaves below this many bytes stay replicated (JAX's 64 KiB)
FSDP_MIN_BYTES = 64 * 1024


def shard_dim(shape: Tuple[int, ...], itemsize: int, n: int,
              min_bytes: int = FSDP_MIN_BYTES) -> Optional[int]:
    """JAX's ``sharding_for_leaf``: the axis of a leaf of ``shape`` split
    over ``n`` ranks, or None where it stays replicated."""
    size = 1
    for d in shape:
        size *= int(d)
    if n <= 1 or not shape or size * itemsize < min_bytes:
        return None
    cands = [i for i, d in enumerate(shape) if d % n == 0 and d >= n]
    if not cands:
        return None
    return max(cands, key=lambda i: shape[i])


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    return t.chunk(n, dim)[rank].clone(memory_format=torch.contiguous_format)


def _gather(shard: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    """The full tensor from every rank's ``shard`` (split on ``dim``): one
    flat ``all_gather_into_tensor``, seen as [world, *shard], the ranks
    then laid along ``dim``."""
    buf = shard.new_empty(mesh.world * shard.numel())
    with torch.no_grad():
        dist.all_gather_into_tensor(buf, shard.detach().contiguous().view(-1),
                                    group=mesh.group)
    full = buf.view((mesh.world,) + tuple(shard.shape)).movedim(0, dim)
    shape = list(shard.shape)
    shape[dim] *= mesh.world
    return full.reshape(shape)


def _reduce_scatter_mean(full: torch.Tensor, dim: int, mesh: DataMesh,
                         out: torch.Tensor) -> None:
    """``out`` = this rank's slice (on ``dim``) of ``full`` summed over
    the ranks, divided once by the world size."""
    parts = full.reshape(full.shape[:dim] + (mesh.world, -1)
                         + full.shape[dim + 1:]).movedim(dim, 0)
    dist.reduce_scatter_tensor(out.view(-1), parts.contiguous().view(-1),
                               group=mesh.group)
    out.div_(mesh.world)


class ShardedState:
    """ZeRO-3 over ``mesh`` of a train state (JAX ``shard_train_state``):
    see the module's docstring. ``plan`` maps each parameter's name to its
    split axis, or None where it stays replicated."""

    def __init__(self, state, mesh: DataMesh,
                 min_bytes: int = FSDP_MIN_BYTES):
        self.state, self.mesh = state, mesh
        self.model = state.model
        self.names = {id(p): n for n, p in self.model.named_parameters()}
        self.plan: Dict[str, Optional[int]] = {}
        self.sharded: List[Tuple[torch.nn.Parameter, torch.Tensor, int]] = []
        self.replicated: List[torch.nn.Parameter] = []
        opt = state.optimizer
        swap = {}
        with torch.no_grad():
            for p in self.model.parameters():
                dim = shard_dim(tuple(p.shape), p.element_size(), mesh.world,
                                min_bytes)
                self.plan[self.names[id(p)]] = dim
                if dim is None:
                    self.replicated.append(p)
                    continue
                shard = torch.nn.Parameter(_slice(p.detach(), dim, mesh.rank,
                                                  mesh.world))
                self.sharded.append((p, shard, dim))
                swap[p] = shard
                moved = opt.state.pop(p, None)
                if moved is not None:
                    opt.state[shard] = {
                        k: (_slice(v, dim, mesh.rank, mesh.world)
                            if isinstance(v, torch.Tensor)
                            and v.shape == p.shape else v)
                        for k, v in moved.items()}
            for group in opt.param_groups:
                group['params'] = [swap.get(p, p) for p in group['params']]
            self._free()

    def _free(self) -> None:
        for p, _, _ in self.sharded:
            p.data = p.data.new_empty(0)
            p.grad = None

    @contextlib.contextmanager
    def gathered(self):
        """The full parameters in the model, gathered from the ranks'
        slices, for the body's forward and backward; freed after (their
        gradients stay for :meth:`update`)."""
        with torch.no_grad():
            for p, shard, dim in self.sharded:
                p.data = _gather(shard, dim, self.mesh)
        try:
            yield
        finally:
            for p, _, _ in self.sharded:
                p.data = p.data.new_empty(0)

    def update(self) -> None:
        """The sharded update from the full gradients in the model:
        reduce-scatter into the slices, the replicated leaves'
        all-reduced, the clip over the global norm, the optimizer's step."""
        with torch.no_grad():
            for p, shard, dim in self.sharded:
                if p.grad is None:
                    shard.grad = None
                    continue
                if shard.grad is None:
                    shard.grad = torch.empty_like(shard)
                _reduce_scatter_mean(p.grad, dim, self.mesh, shard.grad)
                p.grad = None
            self.mesh.sync_grads(self.replicated)
            if self.state.clip is not None:
                self._clip(self.state.clip)
        self.state.optimizer.step()

    def _clip(self, max_norm: float) -> None:
        """``clip_by_global_norm`` over the full gradients: the slices'
        squared norms summed over the ranks, the replicated leaves' (the
        same on every rank) added once."""
        shards = [s.grad for _, s, _ in self.sharded if s.grad is not None]
        repl = [p.grad for p in self.replicated if p.grad is not None]
        zero = torch.zeros((), device=self.mesh.device)
        sq = sum((g.float().square().sum() for g in shards), zero)
        sq = self.mesh.all_sum_(sq.reshape(1))[0]
        sq = sq + sum((g.float().square().sum() for g in repl), zero)
        norm = sq.sqrt()
        keep = norm < max_norm
        for g in shards + repl:
            g.copy_(torch.where(keep, g, g / norm * max_norm))

    def weights(self) -> Dict[str, torch.Tensor]:
        """The model's full ``state_dict`` (a collective)."""
        full = {id(p): _gather(shard, dim, self.mesh)
                for p, shard, dim in self.sharded}
        out = {}
        for name, t in self.model.state_dict(keep_vars=True).items():
            out[name] = (full[id(t)] if id(t) in full else t).detach()
        return out

    def state_dict(self) -> Dict:
        """:meth:`TrainState.state_dict` with the full optimizer state, as
        a replicated run's (a collective)."""
        sd = self.state.optimizer.state_dict()
        by_shard = {id(s): (p, dim) for p, s, dim in self.sharded}
        params = [p for g in self.state.optimizer.param_groups
                  for p in g['params']]
        state = {}
        for i, p in enumerate(params):
            per = sd['state'].get(i)
            if per is None:
                continue
            if id(p) in by_shard:
                _, dim = by_shard[id(p)]
                per = {k: (_gather(v, dim, self.mesh)
                           if isinstance(v, torch.Tensor)
                           and v.shape == p.shape else v)
                       for k, v in per.items()}
            state[i] = per
        return {'step': self.state.step,
                'optimizer': {'state': state,
                              'param_groups': sd['param_groups']}}


def resident_state_bytes(state) -> int:
    """Bytes a rank holds of a train state between steps (JAX
    ``resident_state_bytes``): each parameter as its optimizer holds it (a
    slice under :class:`ShardedState`) and every tensor of the
    optimizer's state."""
    total = 0
    for group in state.optimizer.param_groups:
        for p in group['params']:
            total += p.numel() * p.element_size()
            for v in state.optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    total += v.numel() * v.element_size()
    return total
