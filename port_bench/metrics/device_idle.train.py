"""Share of the traced window in which no operation ran on the card
(the mean over the ranks)."""

from harness import layers

UNIT = '%'
LAYER = 'device'
SOURCE = 'device_trace'
MOVES = 'train_pairs_per_s'


def read(ctx):
    return layers.idle(ctx)
