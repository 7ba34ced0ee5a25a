"""admit_pause_p95_ms: The pause admissions put on every lane: per pool iteration, the summed duration of the batcher's
`cb.admit` spans between the previous `cb.pool_chunk` span and it (0 where none), 95th percentile (nearest rank), before
the traced window. The first pool chunk of the interval has no previous one to bound it and is left out."""
from portbench import readers, spans

LAYER = 'continuous batching (serving.ContinuousBatcher)'
SOURCE = 'program_span'
MOVES = 'chunk_gap_p95_ms'


def read(window):
    found = spans.untraced(window, "cb.admit", "cb.pool_chunk")
    if found is None:
        return None
    pools = [s for s in found if s.name == "cb.pool_chunk"]
    admits = [s for s in found if s.name == "cb.admit"]
    pauses = [sum(spans.ms(a) for a in admits if prev.t1 <= a.t0 < cur.t0) for prev, cur in zip(pools, pools[1:])]
    return readers.percentile(pauses, 0.95)
