"""K2 (ops/scdm_fused): the least seconds of a tick's SCDM launches over
the device seconds of the kernel."""

from harness import layers

UNIT = '%'
LAYER = 'kernels'
SOURCE = 'device_trace'
MOVES = 'eval_sentences_per_s'
PATTERNS = ('scdm_fwd_kernel',)


def read(ctx):
    return layers.roofline(ctx, 'scdm', PATTERNS)
