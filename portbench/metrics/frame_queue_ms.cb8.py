"""frame_queue_ms.cb8: Median host ms to queue one frame of the batcher's batch-8 pool set (the program's `graph.frame`
spans: the frame graph's replay call and its row copy), before the traced window."""
from portbench import spans

LAYER = 'frame step (engine/core.py under engine/graphs.py)'
SOURCE = 'program_span'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    return spans.frame_queue_ms(window, 8)
