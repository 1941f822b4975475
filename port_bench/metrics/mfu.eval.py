"""Model FLOP utilisation of the banked evaluation: the forward's model
operations a tick of G batches, times the ticks of the traced window,
over the window and the f32 peak."""

from harness import layers

UNIT = '%'
LAYER = 'model step'
SOURCE = 'device_trace'
MOVES = 'eval_sentences_per_s'


def read(ctx):
    return layers.mfu(ctx)
