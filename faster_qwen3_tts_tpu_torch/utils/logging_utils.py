"""Logging helpers: loader-chatter suppression, timing-dict formatting and a
profiler trace (the JAX package's `utils.logging_utils`).

`suppress_platform_warnings` quiets what torch and the CUDA libraries log
and warn on a fresh process; `enable_profiler_trace` is the package's
tracing hook, a `torch.profiler` window written as a Chrome trace with the
port's own spans (`utils.trace`) beside it (the counterpart of
`jax.profiler.trace`).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
import warnings
from typing import Any, Dict

from . import trace

# the loggers torch and its CUDA / compiler layers print start-up chatter on
_PLATFORM_LOGGERS = ("torch", "torch.cuda", "torch.distributed", "torch._dynamo", "torch._inductor")


@contextlib.contextmanager
def suppress_platform_warnings():
    """Silence the loader chatter of torch and the CUDA libraries inside the
    block (cosmetic only): their loggers at ERROR and torch's UserWarnings
    ignored; the levels and the warning filters are restored on exit."""
    saved = {name: logging.getLogger(name).level for name in _PLATFORM_LOGGERS}
    for name in _PLATFORM_LOGGERS:
        logging.getLogger(name).setLevel(logging.ERROR)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", category=UserWarning, module=r"torch(\.|$)")
            yield
    finally:
        for name, level in saved.items():
            logging.getLogger(name).setLevel(level)


def format_timing(timing: Dict[str, Any], frame_rate: float = 12.5) -> str:
    """A generation timing dict (steps, prefill_ms, decode_s, ms_per_step)
    as one log line: audio seconds, wall seconds, ms per step and RTF."""
    steps = timing.get("steps", 0)
    audio_s = steps / frame_rate
    total = timing.get("prefill_ms", 0.0) / 1000.0 + timing.get("decode_s", 0.0)
    rtf = audio_s / total if total > 0 else 0.0
    return (
        f"Generated {audio_s:.2f}s audio in {total:.2f}s "
        f"({timing.get('ms_per_step', 0.0):.1f}ms/step, RTF: {rtf:.2f})"
    )


@contextlib.contextmanager
def enable_profiler_trace(logdir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels where CUDA is available) and write it into `logdir` as a Chrome
    trace, `trace-<pid>-<ms>.json` (open it in chrome://tracing or
    Perfetto), with the port's spans of the block (`utils.trace`) on a row
    of their own, `fq3t`, on the profiler's clock. Yields the profiler,
    whose `key_averages()` reads the same window.

    Usage:
        with enable_profiler_trace("/tmp/trace"):
            model.generate_voice_clone(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    offset = trace.profiler_offset_ns()
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
    spans, _ = trace.snapshot(t0, time.perf_counter_ns())
    path = os.path.join(logdir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    if spans:
        _add_spans(path, spans, offset)


def _add_spans(path: str, spans, offset_ns: int) -> None:
    """The spans as complete host events of the row `fq3t` of the Chrome
    trace at `path` (its `ts` are microseconds after `baseTimeNanoseconds`)."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    doc["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": pid, "tid": "fq3t",
                               "args": {"name": "fq3t"}})
    for s in spans:
        doc["traceEvents"].append({
            "ph": "X", "cat": "fq3t", "name": s.name, "pid": pid, "tid": "fq3t",
            "ts": (s.t0 + offset_ns - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "rid": s.rid, "value": s.value},
        })
    with open(path, "w") as f:
        json.dump(doc, f)
