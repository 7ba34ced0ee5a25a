"""host_vocode_p95_ms: The host vocodes the batcher runs between its pool chunks: per pool iteration, the summed
duration of the `voc.host` spans between the previous `cb.pool_chunk` span and it (0 where none; a lane's host vocodes
follow its chunk's host read, an admission's first chunk is vocoded inside it), 95th percentile (nearest rank), before
the traced window. The first pool chunk of the interval has no previous one to bound it and is left out."""
from portbench import readers, spans

LAYER = 'frame step (engine/core.py under engine/graphs.py)'
SOURCE = 'program_span'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    found = spans.untraced(window, "voc.host", "cb.pool_chunk")
    if found is None:
        return None
    pools = [s for s in found if s.name == "cb.pool_chunk"]
    vocodes = [s for s in found if s.name == "voc.host"]
    per = [sum(spans.ms(v) for v in vocodes if prev.t1 <= v.t0 < cur.t0) for prev, cur in zip(pools, pools[1:])]
    return readers.percentile(per, 0.95)
