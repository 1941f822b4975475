"""Share of the traced window in which no operation ran on the card."""

from harness import layers

UNIT = '%'
LAYER = 'device'
SOURCE = 'device_trace'
MOVES = 'serve_p95_ms'


def read(ctx):
    return layers.idle(ctx)
