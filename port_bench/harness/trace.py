"""The traced window: ``torch.profiler`` over a stretch of a run's work,
reduced to device time by kernel, the device's busy share and the longest
idle gaps with what the host was doing in them.

The harness marks its own calls into the program with
``record_function('bench.*')`` spans; an idle gap is named by the
innermost host span that covers its middle (an operator, a CUDA runtime
call or a bench span), or ``host: no span`` where none does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = 'bench.traced_window'


def _times(evt) -> Tuple[float, float]:
    """(start, end) in seconds of a kineto event."""
    if hasattr(evt, 'start_ns'):
        start = evt.start_ns() * 1e-9
        return start, start + evt.duration_ns() * 1e-9
    start = evt.start_us() * 1e-6
    return start, start + evt.duration_us() * 1e-6


def _is_device(evt) -> bool:
    return 'CUDA' in str(evt.device_type())


def _annotation(evt) -> bool:
    flag = getattr(evt, 'is_user_annotation', None)
    return bool(flag()) if callable(flag) else False


class Trace:
    """Holds the profiler across a traced stretch::

        tr = Trace()
        with tr:
            ... work, synchronised at its end ...
        tr.reduce()
    """

    def __init__(self):
        self.prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self._stack.enter_context(self.prof)
        self._stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._stack.close()
        return False

    def reduce(self, top: int = 10) -> Dict:
        """{'kernels': {name: [launches, device s]}, 'busy_s', 'window_s',
        'device_ops', 'idle_gaps'} of the window."""
        events = list(self.prof.profiler.kineto_results.events())
        window = [_times(e) for e in events
                  if not _is_device(e) and e.name() == WINDOW]
        # a host span (record_function, the optimizer's step) also shows
        # on the device's timeline, as an annotation over its kernels
        host_names = {e.name() for e in events if not _is_device(e)}
        if not window:
            raise RuntimeError('the traced window has no bench span')
        w0, w1 = window[0]
        kernels: Dict[str, List[float]] = {}
        spans = []
        host = []
        for e in events:
            a, b = _times(e)
            if _is_device(e):
                if e.name() in host_names or _annotation(e):
                    continue
                a, b = max(a, w0), min(b, w1)
                if b <= a:
                    continue
                spans.append((a, b))
                k = kernels.setdefault(e.name(), [0, 0.0])
                k[0] += 1
                k[1] += b - a
            elif e.name() != WINDOW:
                host.append((a, b, e.name()))
        spans.sort()
        busy, gaps, edge = 0.0, [], w0
        for a, b in spans:
            if a > edge:
                gaps.append((edge, a))
            if b > edge:
                busy += b - max(a, edge)
                edge = b
        if w1 > edge:
            gaps.append((edge, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named: Dict[str, float] = {}
        for a, b in gaps[:200]:
            mid = 0.5 * (a + b)
            inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
            name = min(inside)[1] if inside else 'host: no span'
            named[name] = named.get(name, 0.0) + (b - a)
        ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return {'kernels': kernels, 'busy_s': busy, 'window_s': w1 - w0,
                'device_ops': [[n[:200], v[1]] for n, v in ops],
                'idle_gaps': [[n[:200], s] for n, s in sorted(
                    named.items(), key=lambda kv: -kv[1])[:top]]}


def matching(kernels: Dict[str, List[float]], patterns) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds any of
    ``patterns``."""
    n, s = 0, 0.0
    for name, (count, secs) in kernels.items():
        if any(p in name for p in patterns):
            n += count
            s += secs
    return n, s
