"""Online serving gateway: native micro-batching over the grounder.

Counterpart of ``shufflingvideosfortsg_tpu/gateway.py``. Client threads
submit single (token-id query, video row) requests; the port's own build
of ``native/gateway.cpp`` (``_native.gateway_library``: a mutex, two
condition variables, no allocation a request; ctypes calls release the
GIL) forms deadline-bounded batches, and one dispatch thread runs each
batch through a :class:`~.serving.MultiQueryGrounder`, padded to its
``query_batch``. A completer thread posts the results.

Batching (the latency/throughput dial):

- ``first_wait_us``: how long the dispatch thread waits for any request;
- ``flush_us``: once a batch has its first request, how long it stays
  open for more before it goes out part full.

``pipeline_depth`` batches may be in flight: the dispatch thread takes a
slot before it forms a batch (so a batch closes as late, and as full, as
the window allows), launches the batch, copies its results into pinned
host memory without waiting and records a CUDA event; the completer waits
on that event, posts the results and frees the slot. Depth 1 is the
synchronous form, launch, fetch, post loop. A worker that raises shuts the
queue and hands its exception to every client.

Each padded batch is cut over the grounder's shards as its ``ground*``
calls cut theirs (JAX ``gateway.py:262-265``;
``MultiQueryGrounder._dispatch_tokens``: equal parts, one of them on one
shard, or each request routed to the shard that holds its video in a
sharded bank); the worker makes each card current as it dispatches its
part and records its part's event there, and the completer waits for the
events and puts the rows back in order (``utils/batches.parts_to_host``).

Usage::

    g = MultiQueryGrounder(params, state_dict, query_batch=256)
    g.set_corpus(pack); g.set_vocab(vocab_matrix)
    gw = ServingGateway(g)                      # starts the dispatch thread
    t = gw.submit([4, 17, 9], video_row=123)    # any thread
    start, end, score = gw.result(t, timeout_s=30)
    gw.close()
"""

from __future__ import annotations

import ctypes
import queue as pyqueue
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _native
from .utils.batches import on_device, parts_to_host

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


class QueueFull(RuntimeError):
    pass


class GatewayClosed(RuntimeError):
    pass


class NativeBatchQueue:
    """A handle on one native micro-batching queue (``gateway.cpp``); the
    library is built at first use."""

    def __init__(self, capacity: int = 4096, max_tokens: int = 32):
        self._lib = _native.gateway_library()
        self.capacity = capacity
        self.max_tokens = max_tokens
        h = ctypes.c_void_p()
        rc = self._lib.gw_create(capacity, max_tokens, ctypes.byref(h))
        if rc != 0:
            raise RuntimeError(f'gw_create failed: {rc}')
        self._h = h

    def submit(self, tokens: Sequence[int], video_row: int = 0) -> int:
        arr = np.ascontiguousarray(tokens, np.int32)
        if arr.ndim != 1 or arr.shape[0] > self.max_tokens:
            raise ValueError(f'tokens must be [<= {self.max_tokens}] 1-D')
        t = self._lib.gw_submit(self._h, arr.ctypes.data_as(_I32P),
                                arr.shape[0], int(video_row))
        if t == -1:
            raise QueueFull('gateway queue full')
        if t == -2:
            raise GatewayClosed('gateway is shut down')
        if t < 0:
            raise RuntimeError(f'gw_submit failed: {t}')
        return int(t)

    def next_batch(self, max_batch: int, first_wait_us: int, flush_us: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Waits up to ``first_wait_us``; returns (tickets [n], tokens
        [n, max_tokens], video rows [n]), n == 0 on a timeout; raises
        GatewayClosed once shut down and drained."""
        tickets = np.empty(max_batch, np.int64)
        tokens = np.empty((max_batch, self.max_tokens), np.int32)
        vids = np.empty(max_batch, np.int32)
        n = self._lib.gw_next_batch(
            self._h, max_batch, first_wait_us, flush_us,
            tickets.ctypes.data_as(_I64P), tokens.ctypes.data_as(_I32P),
            vids.ctypes.data_as(_I32P))
        if n == -1:
            raise GatewayClosed('gateway drained')
        return tickets[:n], tokens[:n], vids[:n]

    def complete(self, tickets: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray, scores: np.ndarray) -> None:
        tickets = np.ascontiguousarray(tickets, np.int64)
        starts, ends, scores = (np.ascontiguousarray(a, np.float32)
                                for a in (starts, ends, scores))
        self._lib.gw_complete(self._h, tickets.ctypes.data_as(_I64P),
                              tickets.shape[0], starts.ctypes.data_as(_F32P),
                              ends.ctypes.data_as(_F32P),
                              scores.ctypes.data_as(_F32P))

    def wait(self, ticket: int, timeout_us: int
             ) -> Optional[Tuple[float, float, float]]:
        """(start, end, score) of ``ticket``, or None after ``timeout_us``."""
        s, e, sc = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
        rc = self._lib.gw_wait(self._h, ticket, timeout_us, ctypes.byref(s),
                               ctypes.byref(e), ctypes.byref(sc))
        if rc == 0:
            return s.value, e.value, sc.value
        if rc == -1:
            return None
        raise KeyError(f'bad or consumed ticket {ticket}')

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.gw_stats(self._h, *[ctypes.byref(v) for v in vals])
        submitted, completed, batches, batched = (v.value for v in vals)
        return {'submitted': submitted, 'completed': completed,
                'batches': batches,
                'mean_batch': batched / batches if batches else 0.0}

    def shutdown(self) -> None:
        self._lib.gw_shutdown(self._h)

    def __del__(self):
        h = getattr(self, '_h', None)
        if h is not None:
            self._lib.gw_shutdown(h)
            self._lib.gw_destroy(h)
            self._h = None


def _to_host(*tensors: torch.Tensor):
    """(host copies, event): on a card each tensor is copied into pinned
    host memory without waiting and the event marks the copies' end; on
    the CPU the tensors themselves and no event."""
    if tensors[0].device.type != 'cuda':
        return tensors, None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return tuple(host), done


class ServingGateway:
    """The dispatch and completer threads between a
    :class:`NativeBatchQueue` and a grounder.

    ``mode='bank'`` serves against the resident bank or corpus
    (``set_videos``/``set_corpus``; each request names its ``video_row``),
    ``mode='video'`` against the resident video (``set_video``). Both take
    token ids, so the grounder needs ``set_vocab``."""

    def __init__(self, grounder, mode: str = 'bank',
                 max_batch: Optional[int] = None,
                 first_wait_us: int = 50_000, flush_us: int = 2_000,
                 capacity: int = 4096, max_tokens: Optional[int] = None,
                 pipeline_depth: int = 1, tokenizer=None):
        if mode not in ('bank', 'video'):
            raise ValueError(f'mode {mode!r}: bank or video')
        if grounder._resident_emb is None:
            raise ValueError('the grounder needs set_vocab() (token-id '
                             'serving)')
        if mode == 'bank' and grounder._resident_bank is None:
            raise ValueError('mode=bank needs set_videos()/set_corpus()')
        if mode == 'video' and grounder._resident_rnn0 is None:
            raise ValueError('mode=video needs set_video()')
        self.grounder = grounder
        self.mode = mode
        self.max_batch = max_batch or grounder.query_batch
        if self.max_batch > grounder.query_batch:
            raise ValueError(f'max_batch {self.max_batch} exceeds the '
                             f'grounder\'s query_batch {grounder.query_batch}')
        self.first_wait_us = first_wait_us
        self.flush_us = flush_us
        n_tok = max_tokens or int(grounder.params.get('sent_len', 32))
        self.queue = NativeBatchQueue(capacity=capacity, max_tokens=n_tok)
        self.tokenizer = tokenizer  # data.text_native.NativeTokenizer
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._n_words = grounder._resident_emb.shape[0]
        self._n_rows = grounder._bank_size() if mode == 'bank' else 1
        self._exc: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name='svtsg-gateway-dispatch')
        self._worker.start()

    # -- dispatch worker ---------------------------------------------------
    def _run(self) -> None:
        g = self.grounder
        qb = g.query_batch
        # the in-flight window, a slot taken BEFORE a batch forms: with
        # the window full, requests gather in the native queue and the
        # batch closes as late, and as full, as the traffic allows
        slots = threading.Semaphore(self.pipeline_depth)
        inflight: 'pyqueue.Queue' = pyqueue.Queue()
        completer_dead = threading.Event()

        def completer() -> None:
            try:
                while True:
                    item = inflight.get()
                    if item is None:
                        return
                    tickets, parts, events, n = item
                    for done in events:
                        if done is not None:
                            done.synchronize()
                    pred, score = parts_to_host(parts, qb)
                    pred = pred[:n]
                    self.queue.complete(tickets,
                                        pred[:, 0].astype(np.float32),
                                        pred[:, 1].astype(np.float32),
                                        score[:n])
                    slots.release()
            except Exception as exc:  # noqa: BLE001 — surfaced to clients
                self._exc = exc
                completer_dead.set()
                self.queue.shutdown()

        comp = threading.Thread(target=completer, daemon=True,
                                name='svtsg-gateway-complete')
        comp.start()
        try:
            if g.device.type == 'cuda':
                torch.cuda.set_device(g.device)
            while True:
                while not slots.acquire(timeout=0.1):
                    if completer_dead.is_set():
                        return
                try:
                    tickets, tokens, vids = self.queue.next_batch(
                        self.max_batch, self.first_wait_us, self.flush_us)
                except GatewayClosed:
                    return
                n = tickets.shape[0]
                if n == 0:
                    slots.release()
                    continue
                # pad to the grounder's batch by repeating the last row,
                # as MultiQueryGrounder.ground_tokens does
                if n < qb:
                    tokens = np.concatenate(
                        [tokens, np.repeat(tokens[-1:], qb - n, axis=0)])
                    vids = np.concatenate([vids, np.repeat(vids[-1:], qb - n)])
                parts = g._dispatch_tokens(
                    tokens, vids if self.mode == 'bank' else None)
                host, events = [], []
                for rows, out in parts:
                    with on_device(out[0].device):
                        copies, done = _to_host(*out)
                    host.append((rows, copies))
                    events.append(done)
                inflight.put((tickets, host, events, n))
        except Exception as exc:  # noqa: BLE001 — surfaced to clients
            self._exc = exc
            self.queue.shutdown()
        finally:
            inflight.put(None)
            comp.join(timeout=30.0)

    # -- client API --------------------------------------------------------
    def submit(self, tokens: Sequence[int], video_row: int = 0) -> int:
        if self._exc is not None:
            raise RuntimeError('gateway worker died') from self._exc
        # checked here, on the host: an index out of range on the card
        # would be a device-side assert in the worker
        arr = np.asarray(tokens)
        if arr.size and (arr.min() < 0 or arr.max() >= self._n_words):
            raise IndexError(f'token ids outside [0, {self._n_words})')
        if self.mode == 'bank' and not 0 <= int(video_row) < self._n_rows:
            raise IndexError(f'video_row {video_row} outside '
                             f'[0, {self._n_rows})')
        return self.queue.submit(tokens, video_row)

    def result(self, ticket: int, timeout_s: float = 30.0
               ) -> Tuple[int, int, float]:
        """(start, end, score) of ``ticket``. Waits in slices of at most
        0.1 s, so a worker that died raises here at once, not at the
        timeout; TimeoutError after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            out = self.queue.wait(ticket, int(max(0.0, min(left, 0.1)) * 1e6))
            if out is not None:
                s, e, sc = out
                return int(s), int(e), sc
            if self._exc is not None:
                raise RuntimeError('gateway worker died') from self._exc
            if left <= 0.1:
                raise TimeoutError(f'no result for ticket {ticket}')

    def ground(self, tokens: Sequence[int], video_row: int = 0,
               timeout_s: float = 30.0) -> Tuple[int, int, float]:
        return self.result(self.submit(tokens, video_row), timeout_s)

    # -- raw text (the native tokenizer) -----------------------------------
    def submit_text(self, text: str, video_row: int = 0) -> int:
        """Tokenize a raw sentence (``data.text_native.NativeTokenizer``
        given at construction) and enqueue it: ids past the queue's
        ``max_tokens`` are dropped, a sentence with no word in the
        vocabulary is refused."""
        if self.tokenizer is None:
            raise ValueError('gateway built without tokenizer= (pass a '
                             'data.text_native.NativeTokenizer)')
        ids, _ = self.tokenizer.encode(text)
        ids = ids[:self.queue.max_tokens]
        if not ids:
            raise ValueError(f'no in-vocab words in query: {text!r}')
        return self.submit(ids, video_row)

    def ground_text(self, text: str, video_row: int = 0,
                    timeout_s: float = 30.0) -> Tuple[int, int, float]:
        return self.result(self.submit_text(text, video_row), timeout_s)

    def stats(self) -> dict:
        return self.queue.stats()

    def close(self, timeout_s: float = 30.0) -> None:
        """Shut the queue (the worker drains what is queued) and join the
        worker; raises if it is still running after ``timeout_s``."""
        self.queue.shutdown()
        self._worker.join(timeout=timeout_s)
        if self._worker.is_alive():
            raise TimeoutError('gateway worker still running after close')
