"""Model FLOP utilisation of serving: a served batch's model operations
(block 0's recurrence cached), times the batches of the traced window
(K2 launches over two), over the window and the f32 peak."""

from harness import layers

UNIT = '%'
LAYER = 'grounder'
SOURCE = 'device_trace'
MOVES = 'serve_p95_ms'


def read(ctx):
    return layers.mfu(ctx)
