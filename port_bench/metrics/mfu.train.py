"""Model FLOP utilisation of the GMD train step: its model operations
(harness/flops.model_flops, forward and backward, nothing recomputed) a
step, times the steps of the traced window, over the window and the f32
peak (67 TFLOP/s; TF32 off, as the port runs)."""

from harness import layers

UNIT = '%'
LAYER = 'model step'
SOURCE = 'device_trace'
MOVES = 'train_pairs_per_s'


def read(ctx):
    return layers.mfu(ctx)
