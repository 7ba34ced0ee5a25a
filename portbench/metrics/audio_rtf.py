"""audio_rtf: Seconds of audio delivered inside the window over the window's wall seconds."""
from portbench import readers

LAYER = 'end to end'
SOURCE = 'host_clock'
MOVES = None


def read(window):
    return readers.audio_rtf(window)
