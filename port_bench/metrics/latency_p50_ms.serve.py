"""The median request time of the window, timed as serve_p95_ms is."""

import numpy as np

UNIT = 'ms'
LAYER = 'gateway'
SOURCE = 'host_clock'
MOVES = 'serve_p95_ms'


def read(ctx):
    return float(np.percentile(ctx['latency_ms'], 50)) if 'latency_ms' in ctx else None
