"""K2 keeping P as K5's forward, and K5's backward (ops/scdm_fused): the
least seconds at their shapes (harness/flops.scdm_bound,
scdm_bwd_bound) over the device seconds of the kernels that ran them."""

from harness import layers

UNIT = '%'
LAYER = 'kernels'
SOURCE = 'device_trace'
MOVES = 'train_pairs_per_s'
PATTERNS = layers.SCDM_KERNELS


def read(ctx):
    return layers.roofline(ctx, 'scdm', PATTERNS)
