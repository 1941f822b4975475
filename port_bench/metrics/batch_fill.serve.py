"""The gateway's mean batch over the window, over its max_batch
(ServingGateway.stats())."""

UNIT = '%'
LAYER = 'gateway'
SOURCE = 'program_counter'
MOVES = 'serve_p95_ms'


def read(ctx):
    return 100.0 * ctx['batch_fill'] if 'batch_fill' in ctx else None
