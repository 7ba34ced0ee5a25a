"""admit_wait_p90_ms: The batcher's own admit_wait_ms (submit to the start of the request's admission), 90th percentile."""
from portbench import readers

LAYER = 'continuous batching (serving.ContinuousBatcher)'
SOURCE = 'program_span'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    return readers.admit_wait_p90_ms(window)
