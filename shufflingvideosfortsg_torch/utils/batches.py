"""Query batches of the grounders.

Shared by the live ``serving.MultiQueryGrounder`` and the exported
``utils/aot.ExportedGrounder``, so that both put arrays on the device,
check indices and cut, pad and trim query batches alike: a call's queries
go in batches of ``query_batch`` rows, the last padded by repeating its
last row (JAX ``utils/aot.py:277-352``), every batch is dispatched before
the first fetch, and the padding is trimmed. Imports torch and numpy
only: the exported grounder serves without the model's source.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

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
    ``query_batch`` rows of each (array, ship dtype); spans come back
    int32."""
    Q, qb = len(arrays[0][0]), query_batch
    outs = []
    for i in range(0, Q, qb):
        n = min(qb, Q - i)
        outs.append((n, serve(*[put(pad_rows(a[i:i + qb], qb), dt, device)
                                for a, dt in arrays])))
    spans = [p.cpu().numpy()[:n].astype(np.int32) for n, (p, _) in outs]
    scores = [s.cpu().numpy()[:n] for n, (_, s) in outs]
    return np.concatenate(spans), np.concatenate(scores)
