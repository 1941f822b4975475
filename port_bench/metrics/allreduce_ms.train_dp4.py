"""Device milliseconds a train step of NCCL's kernels: the flat gradient
all-reduce (parallel/mesh.DataMesh.sync_grads) and the metrics'."""

from harness import layers

UNIT = 'ms'
LAYER = 'data axis'
SOURCE = 'device_trace'
MOVES = 'train_pairs_per_s'
PATTERNS = layers.NCCL_KERNELS


def read(ctx):
    return layers.unit_ms(ctx, PATTERNS)
