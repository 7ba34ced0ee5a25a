"""frame_queue_ms.solo: Median host ms to queue one frame of a batch-1 set (the program's `graph.frame` spans: the frame
graph's replay call and its row copy), before the traced window; set against the frame's ~16 ms of device time."""
from portbench import spans

LAYER = 'frame step (engine/core.py under engine/graphs.py)'
SOURCE = 'program_span'
MOVES = 'audio_rtf'


def read(window):
    return spans.frame_queue_ms(window, 1)
