"""K2 at a served batch's shapes (blocks 0 and 1) over the device
seconds of the kernel."""

from harness import layers

UNIT = '%'
LAYER = 'kernels'
SOURCE = 'device_trace'
MOVES = 'serve_p95_ms'
PATTERNS = ('scdm_fwd_kernel',)


def read(ctx):
    return layers.roofline(ctx, 'scdm', PATTERNS)
