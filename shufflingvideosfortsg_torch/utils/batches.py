"""Query batches of the grounders.

Shared by the live ``serving.MultiQueryGrounder`` and the exported
``utils/aot.ExportedGrounder``, so that both put arrays on the device,
check indices and cut, pad and trim query batches alike: a call's queries
go in batches of ``query_batch`` rows, the last padded by repeating its
last row (JAX ``utils/aot.py:277-352``), every batch is dispatched before
the first fetch, and the padding is trimmed. Imports torch and numpy
only: the exported grounder serves without the model's source.

A grounder over several shards (:func:`in_shards`) cuts each padded batch
into one equal part a shard, as JAX's ``batch_sharding`` shards it over
the data axis, or, against a bank split over the shards, routes each
query to the shard that holds its video's row; every part of every batch
is dispatched before the first fetch, and the results come back in query
order. One device is the case of one shard (:func:`in_batches`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def put(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """``a`` as ``dtype`` on ``device``: on a card from pinned host memory
    without waiting, ordered on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


def check_rows(ids: np.ndarray, n: int, what: str) -> np.ndarray:
    """Indices from outside, checked on the host: an index out of range
    on the card would be a device-side assert, not an error."""
    ids = np.asarray(ids)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise IndexError(f'{what} outside [0, {n}): '
                         f'[{ids.min()}, {ids.max()}]')
    return ids


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with its last row repeated up to ``n`` rows."""
    if len(a) == n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], n - len(a), axis=0)])


def in_batches(serve: Callable, arrays: Sequence[Tuple[np.ndarray, type]],
               query_batch: int, device: torch.device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """serve(*device batches) -> (spans, scores) over batches of
    ``query_batch`` rows of each (array, ship dtype) on one device:
    :func:`in_shards` over one shard."""
    return in_shards([serve], arrays, query_batch, [device])


def on_device(device: torch.device):
    """Context of work on ``device``: on a card that card is made current,
    so that what is launched or recorded without a tensor to say where
    (an event, a ctypes launch's stream) goes to it."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_rows(n_rows: int, n: int, route: Optional[np.ndarray] = None
               ) -> List:
    """Each shard's rows of a batch of ``n_rows``: n equal slices in
    order, or with ``route`` (the shard of each row) the indices of the
    rows routed to each."""
    if route is None:
        part = n_rows // n
        return [slice(k * part, (k + 1) * part) for k in range(n)]
    return [np.nonzero(route == k)[0] for k in range(n)]


def dispatch_shards(serves: Sequence[Callable],
                    batch: Sequence[Tuple[np.ndarray, type]],
                    devices: Sequence[torch.device],
                    route: Optional[np.ndarray] = None):
    """One padded batch of (array, ship dtype) over the shards: shard k's
    rows (:func:`shard_rows`) put on ``devices[k]`` and given to
    ``serves[k]``, with that card current, without waiting. Returns
    [(rows, serve's output)] of the shards that got rows."""
    parts = []
    for k, rows in enumerate(shard_rows(len(batch[0][0]), len(devices),
                                        route)):
        part = [(a[rows], dt) for a, dt in batch]
        if len(part[0][0]):
            with on_device(devices[k]):
                parts.append((rows, serves[k](
                    *[put(a, dt, devices[k]) for a, dt in part])))
    return parts


def parts_to_host(parts, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """(spans, scores) of a batch of ``n_rows`` from its shards' parts
    (:func:`dispatch_shards`, or their host copies), each row back in its
    place."""
    got = [(rows, [t.cpu().numpy() for t in out]) for rows, out in parts]
    whole = []
    for j in range(2):
        first = got[0][1][j]
        a = np.empty((n_rows,) + first.shape[1:], first.dtype)
        for rows, arrays in got:
            a[rows] = arrays[j]
        whole.append(a)
    return whole[0], whole[1]


def in_shards(serves: Sequence[Callable],
              arrays: Sequence[Tuple[np.ndarray, type]], query_batch: int,
              devices: Sequence[torch.device],
              route: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`in_batches` over several shards: each padded batch of
    ``query_batch`` rows cut over ``devices`` by :func:`dispatch_shards`
    (``route``, where given, the shard of each query), every part
    dispatched before the first fetch; spans come back int32, in query
    order."""
    Q, qb = len(arrays[0][0]), query_batch
    outs = []
    for i in range(0, Q, qb):
        batch = [(pad_rows(a[i:i + qb], qb), dt) for a, dt in arrays]
        r = None if route is None else pad_rows(route[i:i + qb], qb)
        outs.append((min(qb, Q - i),
                     dispatch_shards(serves, batch, devices, r)))
    host = [(n, parts_to_host(parts, qb)) for n, parts in outs]
    return (np.concatenate([s[:n].astype(np.int32) for n, (s, _) in host]),
            np.concatenate([sc[:n] for n, (_, sc) in host]))
