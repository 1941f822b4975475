"""K1 (ops/lstm_scan): the least seconds of a tick's recurrence launches
over the device seconds of the kernel."""

from harness import layers

UNIT = '%'
LAYER = 'kernels'
SOURCE = 'device_trace'
MOVES = 'eval_sentences_per_s'
PATTERNS = ('lstm_fwd_kernel',)


def read(ctx):
    return layers.roofline(ctx, 'lstm', PATTERNS)
