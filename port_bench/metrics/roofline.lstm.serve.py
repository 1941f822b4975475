"""K1 at a served batch's shapes (the sentence encoder, block 1) over
the device seconds of the kernel."""

from harness import layers

UNIT = '%'
LAYER = 'kernels'
SOURCE = 'device_trace'
MOVES = 'serve_p95_ms'
PATTERNS = ('lstm_fwd_kernel',)


def read(ctx):
    return layers.roofline(ctx, 'lstm', PATTERNS)
