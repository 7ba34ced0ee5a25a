"""ttfa_p90_ms.cb8: the open-loop cell's time to first audio from when each request was due, 90th
percentile, over the requests due before the traced window. Its run-to-run spread (32-34% over sets of
six, with the same seeds) is too wide for an end-to-end bound in this cell, so it is read here."""
from portbench import readers

LAYER = 'continuous batching (serving.ContinuousBatcher)'
SOURCE = 'host_clock'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    return readers.ttfa_p90_before_trace(window)
