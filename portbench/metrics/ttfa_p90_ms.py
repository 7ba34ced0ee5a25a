"""ttfa_p90_ms: Time to the first audio chunk of every request sent in the window, from when it was due, at the 90th
percentile (nearest rank); a failed request counts as missing every limit."""
from portbench import readers

LAYER = 'end to end'
SOURCE = 'host_clock'
MOVES = None


def read(window):
    return readers.percentile(readers.ttfa_ms(window), 0.9)
