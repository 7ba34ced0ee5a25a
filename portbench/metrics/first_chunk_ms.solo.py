"""first_chunk_ms.solo: Median decode_ms the stream driver gives a stream's first chunk: its prefill (dispatched without
blocking, so folded in), its first frames and their window vocode."""
from portbench import readers

LAYER = 'stream driver (engine/generate.py)'
SOURCE = 'program_span'
MOVES = 'ttfa_p90_ms'


def read(window):
    return readers.first_chunk_ms(window)
