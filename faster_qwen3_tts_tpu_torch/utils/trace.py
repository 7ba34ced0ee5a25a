"""The port's span recorder: named host intervals at its layer boundaries,
kept in memory for whoever reads them after a run.

A span is `Record(id, parent, rid, name, t0, t1, value)`: its id, the id of
the innermost span open on the same thread when it opened (None at the
top), its request id (given, or the parent's), its name, its start and end
in nanoseconds of `time.perf_counter_ns()` (the clock of
`time.perf_counter()`), and a value of the span's own (a count, or device
milliseconds). Spans live in a ring of `CAPACITY` records written in the
order they end; a full ring overwrites its oldest, and `snapshot` says when
a record of the asked interval may have been lost that way. Writes take no
lock: their slots come from an `itertools.count`, whose `next` and a list
store are each one step under the interpreter lock, so the server's threads
and a batcher's feeder may record at once.

The recorder is on from the start; `set_enabled(False)` turns it off
(`span` and `begin` then hand out one shared null span, `add` returns at
once, and the sessions record no CUDA events). Spans are per chunk and per
frame, never per kernel or per layer: 1.6-2.2 us of host time each.

What the port records, and where (portbench's `program_span` metrics read some of them):

| span | recorded in | value |
|---|---|---|
| `api.prompt` | `model._prepare_generation` / `_prepare_generation_custom` | prompt rows |
| `cb.queue` | `serving.ContinuousBatcher._admit_pending`: a request's submit to its admission | None |
| `cb.admit` | around `ContinuousBatcher._admit`: the whole admission | the slot |
| `cb.pool_chunk` | `ContinuousBatcher._pump`: a pool chunk's dispatch to the end of its host read | lanes holding a stream |
| `sess.prefill` | `engine.generate.GenerationSession.prefill` (written at its first chunk's read) | device ms, None on the CPU |
| `sess.chunk` | a session chunk's dispatch to the end of its host read | device ms, None on the CPU |
| `graph.frame` | `engine.graphs.GraphSet.run_chunk`: one frame's replay and its row copy | the set's lanes |
| `voc.host` | `model._StreamVocoder.vocode_new` | frames |

A batcher's spans carry the request's sid; a session opened outside any span
takes a request id from this module's process-wide counter (`new_rid`), so
the two are separate spaces, told apart by their spans' names and parents.
Device milliseconds come from a CUDA-event pair read only after the host
read that already waited for the chunk: the recorder adds no host
synchronization. Nothing here calls `torch.profiler`: `profiler_offset_ns`
puts a span on a profiler's timeline instead.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, List, NamedTuple, Optional, Tuple

CAPACITY = 65536
_now = time.perf_counter_ns


class Record(NamedTuple):
    id: int
    parent: Optional[int]
    rid: Optional[int]
    name: str
    t0: int
    t1: int
    value: Any


class Span:
    """An open span. Its id, parent, request id and start are fixed when it
    is made; inside `with` it is the parent of the spans opened on this
    thread; it is written when it ends (at the block's exit when made by
    `span`, at `end` when made by `begin`)."""

    __slots__ = ("_rec", "_stack", "_auto", "id", "parent", "rid", "name", "t0", "value")

    def __init__(self, rec: "Recorder", name: str, rid: Optional[int], value: Any, auto: bool):
        stack = rec._local.stack
        self._rec, self._stack, self._auto = rec, stack, auto
        self.id = next(rec._ids)
        if stack:
            top = stack[-1]
            self.parent = top.id
            self.rid = top.rid if rid is None else rid
        else:
            self.parent, self.rid = None, rid
        self.name, self.value = name, value
        self.t0 = _now()

    def __enter__(self) -> "Span":
        self._stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._stack.pop()
        if self._auto:
            self.end()
        return False

    def end(self, value: Any = None) -> None:
        """Write the span, ending now (`value`, where given, replaces its own)."""
        t1 = _now()
        rec = self._rec
        seq = next(rec._seq)
        rec._ring[seq % rec.capacity] = (seq, t1, self.id, self.parent, self.rid, self.name, self.t0, t1,
                                         self.value if value is None else value)


class _NullSpan:
    """What `span` and `begin` give while the recorder is off: records nothing."""

    __slots__ = ()
    id = parent = rid = None
    value = property(lambda self: None, lambda self, v: None)

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self, value: Any = None) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Stack(threading.local):
    def __init__(self):
        self.stack: List[Span] = []


class Recorder:
    """A ring of `capacity` span records (see the module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = True
        self._local = _Stack()
        self.reset()

    def reset(self) -> None:
        """Forget every record and restart the ids (not while spans are open)."""
        self._ring: List[Optional[tuple]] = [None] * self.capacity  # (seq, written_ns, *Record)
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._rids = itertools.count(1)

    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    def _top(self) -> Optional[Span]:
        stack = self._local.stack
        return stack[-1] if stack else None

    def span(self, name: str, rid: Optional[int] = None, value: Any = None):
        """A span of the `with` block that follows."""
        return Span(self, name, rid, value, True) if self.enabled else NULL_SPAN

    def begin(self, name: str, rid: Optional[int] = None):
        """A span open from now until its `end()` (enter it with `with`
        where the spans opened meanwhile are its children)."""
        return Span(self, name, rid, None, False) if self.enabled else NULL_SPAN

    def add(self, name: str, t0_ns: int, t1_ns: int, rid: Optional[int] = None, value: Any = None) -> None:
        """A span stamped earlier, from t0_ns to t1_ns (parent: the innermost
        span open on this thread now)."""
        if not self.enabled:
            return
        top = self._top()
        if rid is None and top is not None:
            rid = top.rid
        seq = next(self._seq)
        self._ring[seq % self.capacity] = (seq, _now(), next(self._ids), None if top is None else top.id, rid, name,
                                           int(t0_ns), int(t1_ns), value)

    def current_rid(self) -> Optional[int]:
        """The request id of the innermost span open on this thread, or None."""
        top = self._top()
        return None if top is None else top.rid

    def new_rid(self) -> int:
        """A request id from the process-wide counter."""
        return next(self._rids)

    def _slots(self) -> List[tuple]:
        return [s for s in list(self._ring) if s is not None]

    def dropped(self) -> int:
        """How many records the ring has overwritten."""
        slots = self._slots()
        return max(0, max(s[0] for s in slots) + 1 - self.capacity) if slots else 0

    def snapshot(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> Tuple[List[Record], bool]:
        """-> (the records of spans inside [t0_ns, t1_ns] by start, whether a
        span of that interval may have been overwritten). A lost record was
        written before the oldest kept one, and a span is written when it
        ends, so none of the interval was lost if the oldest kept record was
        written before t0_ns."""
        slots = self._slots()
        lo = float("-inf") if t0_ns is None else t0_ns
        hi = float("inf") if t1_ns is None else t1_ns
        spans = sorted((Record(*s[2:]) for s in slots if s[6] >= lo and s[7] <= hi), key=lambda r: (r.t0, r.id))
        oldest = min(slots) if slots else None
        wrapped = oldest is not None and oldest[0] > 0 and oldest[1] >= lo
        return spans, wrapped


RECORDER = Recorder()

span = RECORDER.span
begin = RECORDER.begin
add = RECORDER.add
current_rid = RECORDER.current_rid
new_rid = RECORDER.new_rid
snapshot = RECORDER.snapshot
dropped = RECORDER.dropped
reset = RECORDER.reset
set_enabled = RECORDER.set_enabled


def enabled() -> bool:
    return RECORDER.enabled


def profiler_offset_ns() -> int:
    """Add to a span's t0 / t1 to put it on `torch.profiler`'s timeline,
    whose host and device events kineto stamps in Unix nanoseconds."""
    return time.time_ns() - time.perf_counter_ns()
