"""device_idle_pct.cb8: Share of the traced window in which no operation ran on the card (one minus the union of device
activity in torch.profiler over the window), in %."""
from portbench import readers

LAYER = 'device (H100)'
SOURCE = 'device_trace'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    return readers.device_idle_pct(window)
