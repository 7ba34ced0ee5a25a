"""The port's own spans (`faster_qwen3_tts_tpu_torch.utils.trace`) inside a
run's window, for the metrics that read them.

The recorder is on by default in the program, so nothing here turns it on:
the harness computes its metrics in the process that ran the window, and
the recorder still holds the window's spans then. `untraced` gives the
interval [window t0, the profiler's start), or the whole window without a
profiler, so that no span carries the profiler's cost, as
`readers._untraced` keeps it out of the timing keys. `traced` gives the
profiler's own interval, for the counts the program records there (the
values of its spans), which a reader sets beside the kernels of the same
trace. A program without the recorder, an interval without the spans asked
for, and an interval whose spans the recorder's ring may have overwritten
all read as None.
"""
from __future__ import annotations

import statistics
from typing import List, Optional


def untraced(window, *names: str) -> Optional[list]:
    """The recorder's spans named `names` inside the window before the
    profiler started, by start -> a list, or None (see the module
    docstring)."""
    tr = window.get("trace")
    return _spans(window["t0"], tr["t0"] if tr else window["t1"], names)


def traced(window, *names: str) -> Optional[list]:
    """The recorder's spans named `names` between the profiler's start and
    stop, by start -> a list, or None (see the module docstring). Their
    values (counts) are sound; their durations carry the profiler's cost,
    and no metric may time them."""
    tr = window.get("trace")
    if not tr:
        return None
    return _spans(tr["t0"], tr["t1"], names)


def _spans(t0: float, t1: float, names) -> Optional[list]:
    """The spans named `names` inside [t0, t1] (host seconds), or None."""
    try:
        from faster_qwen3_tts_tpu_torch.utils import trace
    except ImportError:
        return None
    spans, wrapped = trace.snapshot(round(t0 * 1e9), round(t1 * 1e9))
    if wrapped:
        return None
    return [s for s in spans if s.name in names]


def ms(span) -> float:
    return (span.t1 - span.t0) / 1e6


def median_or_none(values: List[float]) -> Optional[float]:
    return float(statistics.median(values)) if values else None


def frame_queue_ms(window, lanes: int) -> Optional[float]:
    """Median host ms of the `graph.frame` spans of sets of `lanes` lanes:
    the host's time to queue one frame's replay and its row copy."""
    spans = untraced(window, "graph.frame")
    return None if spans is None else median_or_none([ms(s) for s in spans if s.value == lanes])
