"""Timing-dict formatting (the JAX package's `utils.logging_utils.format_timing`).

Its other two helpers silence JAX plugin warnings and start a JAX profiler
trace; neither has a use here.
"""
from __future__ import annotations

from typing import Any, Dict


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
