"""step_mfu.cb8: Operations of the frames and window vocodes of the batcher's pool chunks (from shapes) over the
program's decode_ms of those chunks and the bf16 dense peak of 989 TFLOP/s, in %."""
from portbench import readers

LAYER = 'frame step (engine/core.py under engine/graphs.py)'
SOURCE = 'program_span'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    return readers.step_mfu(window)
