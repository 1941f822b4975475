"""K3, K4 and K4's weight gradient (ops/lstm_scan): the least seconds of
the step's recurrence launches at their shapes (harness/flops.
lstm_bounds) over the device seconds of the kernels that ran them."""

from harness import layers

UNIT = '%'
LAYER = 'kernels'
SOURCE = 'device_trace'
MOVES = 'train_pairs_per_s'
PATTERNS = layers.LSTM_KERNELS


def read(ctx):
    return layers.roofline(ctx, 'lstm', PATTERNS)
