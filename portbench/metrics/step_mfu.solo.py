"""step_mfu.solo: Operations of the frames and window vocodes of each stream's chunks after its first (from shapes) over
the driver's decode_ms of those chunks and the bf16 dense peak of 989 TFLOP/s, in %."""
from portbench import readers

LAYER = 'frame step (engine/core.py under engine/graphs.py)'
SOURCE = 'program_span'
MOVES = 'audio_rtf'


def read(window):
    return readers.step_mfu(window)
