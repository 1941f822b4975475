"""Sequence parallelism: the time-sharded BiLSTM recurrence.

Counterpart of ``shufflingvideosfortsg_tpu/parallel/seq_parallel.py``
(``_dir_step`` ``:49``, ``lstm_flat_time_sharded`` ``:64``,
``bilstm_time_sharded`` ``:178``). One long video's recurrence is cut
along time into n chunks, chunk i held by shard i, so that the raw
features, the [T, B, 8H] projections and the output stream live T/n on
each device: a video's length is bounded by the shards' memory together,
not by one card's.

JAX runs one program over a mesh and moves the carries by ``ppermute``;
here one process drives the shards, a sequence of devices that may repeat
one (n shards on one card, or on the CPU in the tests):

- the input projection is per time step, so each shard projects its own
  chunk (one fused [D, 8H] product, the biases summed in f32);
- the recurrence is a wavefront of n stages: at stage s the shard holding
  chunk s runs the forward direction over it from the carry it was handed
  and the shard holding chunk n-1-s the backward direction over its own;
  then both carries hop one shard (``.to(next, non_blocking=True)``).
  After n stages both directions have swept the whole sequence. On a card
  each shard works on a CUDA stream of its own and a stage's two
  directions are issued step by step in turn, so on two cards (or two
  streams of one) they overlap;
- the output stays time-sharded: chunk i on shard i, the forward half
  ``[..., :H]`` and the backward half ``[..., H:]`` both in natural time
  order. The final carries come from the last chunk (forward) and the
  first (backward).

Gradients flow through autograd over the copies; d_xw and d_w_hh equal
the one-shard scan's up to f32 reassociation
(``tests/test_torch_seq_parallel.py``). As JAX's ``lax.scan`` step, the
step is plain PyTorch (one ``torch.matmul`` and the gates' element-wise
operations) with ``_dir_step``'s rounding points: the product summed in
f32 and rounded to the carry's dtype, the gates and the state in that
dtype (bf16 at ``precision: bf16``, where K1 would keep h and c in f32).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..ops.dense import dense
from ..ops.rnn import _sigmoid

Chunks = List[torch.Tensor]


def _dir_step(w_hh_d: torch.Tensor, H: int, carry, x: torch.Tensor):
    """One single-direction LSTM step (gate order i, f, g, o): the
    product summed in f32 and rounded to h's dtype, the gates in it."""
    h, c = carry
    gates = x + torch.matmul(h, w_hh_d)
    i = _sigmoid(gates[..., :H])
    f = _sigmoid(gates[..., H:2 * H])
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = _sigmoid(gates[..., 3 * H:])
    c = f * c + i * g
    h = o * torch.tanh(c)
    return (h, c), h


class Shards:
    """The devices of a time-sharded run, and on a card a stream each:
    :meth:`on` runs a shard's work on its stream, :meth:`hop` hands a
    tensor from one shard's stream to another's."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError('time sharding needs at least one shard')
        self.cuda = self.devices[0].type == 'cuda'
        if any((d.type == 'cuda') != self.cuda for d in self.devices):
            raise ValueError(f'shards on the CPU and on a card at once: '
                             f'{[str(d) for d in self.devices]}')
        self.streams = ([torch.cuda.Stream(device=d) for d in self.devices]
                        if self.cuda else [None] * len(self.devices))

    def __len__(self) -> int:
        return len(self.devices)

    def on(self, i: int):
        """Context of shard i's work: its device and stream."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def begin(self) -> None:
        """Each shard's stream waits for what its device's current stream
        has queued (the inputs)."""
        if self.cuda:
            for d, s in zip(self.devices, self.streams):
                s.wait_stream(torch.cuda.current_stream(d))

    def hop(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``t``, made on shard ``src``'s stream, on shard ``dst`` and
        ready for its stream: the copy is ordered after ``t``'s making."""
        if not self.cuda:
            return t.to(self.devices[dst])
        with self.on(src):
            moved = t.to(self.devices[dst], non_blocking=True)
        self.streams[dst].wait_stream(self.streams[src])
        moved.record_stream(self.streams[dst])
        return moved

    def end(self, tensors: Sequence[torch.Tensor]) -> None:
        """The callers' current streams wait for every shard's stream, and
        ``tensors`` (made on those streams) are marked as used there."""
        if not self.cuda:
            return
        for d, s in zip(self.devices, self.streams):
            torch.cuda.current_stream(d).wait_stream(s)
        for t in tensors:
            t.record_stream(torch.cuda.current_stream(t.device))


def time_chunks(x: Union[torch.Tensor, Chunks], shards: Shards,
                what: str = 'T') -> Chunks:
    """``x`` [T, ...] cut into len(shards) equal time chunks, chunk i on
    shard i; a list of chunks is taken as it is (equal lengths, each on
    its shard). A T that n does not divide raises JAX's message."""
    n = len(shards)
    if isinstance(x, torch.Tensor):
        T = x.shape[0]
        if T % n:
            raise ValueError(
                f"{what}={T} must be a multiple of the {n}-way 'data' "
                'mesh axis (pad or trim the video; zero FEATURE rows are '
                'not neutral here because xw rows carry the bias)')
        return [c.to(d, non_blocking=True)
                for c, d in zip(x.split(T // n), shards.devices)]
    chunks = list(x)
    if len(chunks) != n or len({c.shape[0] for c in chunks}) != 1:
        raise ValueError(f'{n} shards take {n} time chunks of one length, '
                         f'got {[tuple(c.shape) for c in chunks]}')
    if any(c.device != d for c, d in zip(chunks, shards.devices)):
        raise ValueError('chunk i must lie on shard i')
    return chunks


def lstm_flat_time_sharded(xw: Union[torch.Tensor, Chunks],
                           w_hh: torch.Tensor,
                           shards: Union[Shards, Sequence],
                           ) -> Tuple[Chunks, torch.Tensor, torch.Tensor]:
    """Two-direction LSTM recurrence over a time-sharded projection.

    xw: [T, B, 8H] flat-layout projections with the biases added, both
    halves in natural time order (fwd gates ``[..., :4H]``, bwd
    ``[..., 4H:]``), as one tensor (cut here) or as its n time chunks on
    their shards. w_hh: [2, H, 4H], cast to xw's dtype. ``shards``: the
    devices, chunk i on shard i.

    Returns (out: the n chunks [T/n, B, 2H] on their shards, fwd half
    ``[..., :H]``, bwd ``[..., H:]``, natural time order; the final
    carries h, c [2, B, H] on shard 0), in xw's dtype.
    """
    if not isinstance(shards, Shards):
        shards = Shards(shards)
    n = len(shards)
    chunks = time_chunks(xw, shards)
    Tc, B, G8 = chunks[0].shape
    H = G8 // 8
    dt = chunks[0].dtype
    shards.begin()
    w = []
    for i, d in enumerate(shards.devices):
        with shards.on(i):
            w.append(w_hh.to(d).to(dt))
    with shards.on(0):
        hf = cf = chunks[0].new_zeros((B, H))
    with shards.on(n - 1):
        hb = cb = chunks[n - 1].new_zeros((B, H))
    fwd: List[Optional[torch.Tensor]] = [None] * n
    bwd: List[Optional[torch.Tensor]] = [None] * n
    for s in range(n):
        i_f, i_b = s, n - 1 - s
        xf = chunks[i_f][..., :4 * H]
        xb = chunks[i_b][..., 4 * H:]
        of: List[Optional[torch.Tensor]] = [None] * Tc
        ob: List[Optional[torch.Tensor]] = [None] * Tc
        # the two directions' steps in turn, each on its shard's stream
        for t in range(Tc):
            with shards.on(i_f):
                (hf, cf), of[t] = _dir_step(w[i_f][0], H, (hf, cf), xf[t])
            tb = Tc - 1 - t
            with shards.on(i_b):
                (hb, cb), ob[tb] = _dir_step(w[i_b][1], H, (hb, cb), xb[tb])
        with shards.on(i_f):
            fwd[i_f] = torch.stack(of)
        with shards.on(i_b):
            bwd[i_b] = torch.stack(ob)
        if s + 1 < n:
            hf, cf = (shards.hop(v, i_f, i_f + 1) for v in (hf, cf))
            hb, cb = (shards.hop(v, i_b, i_b - 1) for v in (hb, cb))
    out = []
    for i in range(n):
        with shards.on(i):
            out.append(torch.cat([fwd[i], bwd[i]], dim=-1))
    # the forward's whole-sequence carry ends on the last shard, the
    # backward's on the first
    hf, cf = (shards.hop(v, n - 1, 0) for v in (hf, cf))
    with shards.on(0):
        h, c = torch.stack([hf, hb]), torch.stack([cf, cb])
    shards.end(out + [h, c])
    return out, h, c


def bilstm_time_sharded(lstm, x: Union[torch.Tensor, Chunks],
                        shards: Union[Shards, Sequence],
                        num_layers: Optional[int] = None,
                        dtype: Optional[torch.dtype] = None) -> Chunks:
    """Multi-layer inference BiLSTM over a time-sharded [T, B, D] input.

    ``lstm`` is an ``ops/rnn.BiLSTM`` (its f32 weights anywhere: each
    shard takes its copy); ``x`` one [T, B, D] tensor or its n time chunks
    on their shards. Each layer projects each shard's chunk on that shard
    (one [Tc*B, D] @ [D, 8H] product, x and the weights in ``dtype``, the
    biases summed in f32 and then cast, JAX ``:195-201``) and runs the
    recurrence through :func:`lstm_flat_time_sharded`. No dropout (the
    inference path). ``num_layers`` and ``dtype`` default to ``lstm``'s.
    Returns the n output chunks [T/n, B, 2H] on their shards."""
    if not isinstance(shards, Shards):
        shards = Shards(shards)
    layers = lstm.num_layers if num_layers is None else num_layers
    dt = lstm.dtype if dtype is None else dtype
    chunks = time_chunks(x, shards)
    for layer in range(layers):
        w_ih, b, w_hh = lstm._layer_weights(layer)
        shards.begin()
        xw = []
        for i, (c, d) in enumerate(zip(chunks, shards.devices)):
            with shards.on(i):
                Tc, B, D = c.shape
                xw.append(dense(c.reshape(Tc * B, D), w_ih.to(d), b.to(d),
                                dt).view(Tc, B, -1))
        shards.end(xw)
        chunks, _, _ = lstm_flat_time_sharded(xw, w_hh, shards)
    return chunks
