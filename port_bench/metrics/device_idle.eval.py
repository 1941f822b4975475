"""Share of the traced window in which no operation ran on the card."""

from harness import layers

UNIT = '%'
LAYER = 'device'
SOURCE = 'device_trace'
MOVES = 'eval_sentences_per_s'


def read(ctx):
    return layers.idle(ctx)
