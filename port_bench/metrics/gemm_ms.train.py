"""Device milliseconds a train step of cuBLAS's products (the dense
layers, the input projections, their gradients)."""

from harness import layers

UNIT = 'ms'
LAYER = 'dense layers'
SOURCE = 'device_trace'
MOVES = 'train_pairs_per_s'
PATTERNS = layers.GEMM_KERNELS


def read(ctx):
    return layers.unit_ms(ctx, PATTERNS)
