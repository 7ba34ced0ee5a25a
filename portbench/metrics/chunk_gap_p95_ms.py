"""chunk_gap_p95_ms: Gap between consecutive audio chunks of one stream, at the 95th percentile of all gaps whose later
chunk reached the client inside the window: a playback stall shows here."""
from portbench import readers

LAYER = 'end to end'
SOURCE = 'host_clock'
MOVES = None


def read(window):
    return readers.percentile(readers.chunk_gaps_ms(window), 0.95)
