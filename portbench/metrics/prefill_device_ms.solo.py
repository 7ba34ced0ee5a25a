"""prefill_device_ms.solo: Median device ms of a solo stream's prefill (the program's `sess.prefill` spans: a CUDA-event
pair around the prefill graph's replay, read after the first chunk's host read), streams before the traced window."""
from portbench import spans

LAYER = 'stream driver (engine/generate.py)'
SOURCE = 'program_span'
MOVES = 'ttfa_p90_ms'


def read(window):
    found = spans.untraced(window, "sess.prefill")
    return None if found is None else spans.median_or_none([s.value for s in found if s.value is not None])
