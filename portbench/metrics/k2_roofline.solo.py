"""k2_roofline.solo: K2's least time for the bytes of the traced window's launches (counted from the projection shapes and
the launches the taps saw) against 3.35 TB/s, over K2's device time in the trace, in %."""
from portbench import readers

LAYER = 'kernels (K2: ops/quant.py, csrc/int8_gemv.cu)'
SOURCE = 'device_trace'
MOVES = 'audio_rtf'


def read(window):
    return readers.k2_roofline(window)
