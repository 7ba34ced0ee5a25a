"""The arithmetic the metric readers share: percentiles, chunk gaps, audio
throughput, and the shares of the roofline and of the peak.

A window record (`traffic/*.run`, completed by the harness) holds, per
request sent in the window: when it was due, when its first audio and each
chunk reached the client, each chunk's samples and frames, and the program's
timing keys; for the batcher each pool chunk's `decode_ms` and lanes; and
with --trace 1 the reduced profiler window (`taps.reduce_trace`), every
kernel's launches and device seconds in it among them (`kernel_roofline`).
"""
from __future__ import annotations

import math
import statistics
from typing import List, Optional, Tuple

from . import models, shapes, voices as voice_kinds

SAMPLE_RATE = 24000
MISSING_MS = 1e9  # a request that failed, or never gave audio, misses every limit


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (the value at rank ceil(q n)); None if empty."""
    if not values:
        return None
    v = sorted(values)
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


def ttfa_ms(window) -> List[float]:
    """Time to first audio of every request sent in the window, from when it
    was due; a failed request counts as missing every limit."""
    out = []
    for r in window["records"]:
        ok = r["first"] is not None and r["error"] is None
        out.append((r["first"] - r["due"]) * 1e3 if ok else MISSING_MS)
    return out


def chunk_gaps_ms(window) -> List[float]:
    """Gaps between consecutive chunks of one stream whose later chunk
    reached the client inside the window."""
    t0, t1 = window["t0"], window["t1"]
    out = []
    for r in window["records"]:
        times = [c[0] for c in r["chunks"]]
        out += [(b - a) * 1e3 for a, b in zip(times, times[1:]) if t0 <= b <= t1]
    return out


def audio_rtf(window) -> float:
    """Seconds of audio delivered inside the window over its length."""
    t0, t1 = window["t0"], window["t1"]
    samples = sum(c[1] for r in window["records"] for c in r["chunks"] if t0 <= c[0] <= t1)
    return samples / SAMPLE_RATE / (t1 - t0)


def stalls(window) -> List[Optional[int]]:
    """Per request, the index of the first chunk that reached the client
    after the audio before it had finished playing (playback starts at the
    first chunk), or None; -1 for a request that gave no audio."""
    out: List[Optional[int]] = []
    for r in window["records"]:
        start, played, at = r["first"], 0.0, None
        if start is None:
            out.append(-1)
            continue
        for i, (t, n, _) in enumerate(r["chunks"]):
            if n and played > 0 and t > start + played + 1e-9:
                at = i
                break
            played += n / SAMPLE_RATE
        out.append(at)
    return out


def underrun_share(window) -> float:
    """Share of requests whose playback would stall at least once."""
    s = stalls(window)
    return sum(x is not None for x in s) / max(1, len(s))


K2_KEPT = 0.95  # the least share of the counted K2 launches the trace must hold


def k2_roofline(window) -> Optional[float]:
    """The least time of the traced window's K2 launches (their bytes over
    the HBM rate) over K2's device time, in %. The profiler can drop a few
    hundred of some 400,000 device records (seen once in a 52-frame solo
    stream); then the launches in the trace are taken at the counted ones'
    mean bound. Nothing when the trace holds no K2 launch, more than the
    taps counted, or fewer than 95% of them."""
    tr = window.get("trace")
    if not tr or not tr["k2_launches"] or tr["k2_s"] <= 0:
        return None
    kept = tr["k2_launches"] / tr["k2_predicted"] if tr["k2_predicted"] else 0.0
    if not K2_KEPT <= kept <= 1.0:
        return None
    return 100.0 * tr["k2_bound_s"] * kept / tr["k2_s"]


def traced_kernels(window, match: str) -> Optional[Tuple[int, float]]:
    """(launches, device seconds) of the traced window's kernels whose short
    name holds `match` (`taps.reduce_trace`'s `kernels`), or None when the
    trace holds no such launch."""
    tr = window.get("trace")
    found = [k for name, k in ((tr or {}).get("kernels") or {}).items() if match in name]
    launches = sum(k["launches"] for k in found)
    if not launches:
        return None
    return launches, sum(k["s"] for k in found)


def kernel_roofline(window, match: str, least_s: Optional[float]) -> Optional[float]:
    """`least_s`, the least time of the traced window's launches of the
    kernels `traced_kernels` matches (the larger of their bytes over the HBM
    rate and their operations over the peak, which the metric counts from
    the model module's shapes and the program's counters), over those
    launches' device seconds, in %. None when the trace holds no such
    launch or no least time was counted."""
    got = traced_kernels(window, match)
    if got is None or least_s is None or least_s <= 0 or got[1] <= 0:
        return None
    return 100.0 * least_s / got[1]


def device_idle_pct(window) -> Optional[float]:
    tr = window.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr["busy_s"] / tr["window_s"])


def _untraced(window, t: float) -> bool:
    """Whether host time t lies before the traced window opened (program
    spans after it carry the profiler's cost, and the stall of its stop)."""
    tr = window.get("trace")
    return tr is None or t < tr["t0"]


def step_mfu(window) -> Optional[float]:
    """The operations of the frames and window vocodes the chunks served,
    over the program's `decode_ms` of those chunks and the bf16 peak, in %:
    the batcher's pool chunks, a solo stream's chunks after its first, run
    before the traced window. Operations come from the configuration's model
    module; a prompt's rows add the mix's kind of voice's own (an ICL
    voice's reference block), and lanes of a kind that stays on its host
    vocoder add no window vocode (the host's vocodes are outside
    `decode_ms`)."""
    cfg = window["cfg"]
    mod = models.of(cfg)
    params = window["workload"]["traffic_params"]
    kind = voice_kinds.of(params)
    extra = kind.extra_prompt_rows(params)
    chunk = window["workload"]["entry"]["chunk_size"]
    flops = seconds = 0.0
    if "pool_chunks" in window:
        for c in window["pool_chunks"].values():
            if not _untraced(window, c["t"]):
                continue
            mature = [] if kind.HOST_VOCODER else [lane for lane in c["lanes"] if lane[1] >= 24]
            for v, before, req in c["lanes"]:
                flops += v * mod.frame_flops(cfg, mod.prompt_rows(req) + extra + before + v // 2)
            flops += len(mature) * mod.window_flops(cfg, 24 + chunk)
            seconds += c["decode_ms"] / 1e3
    else:
        for r in window["records"]:
            if not _untraced(window, r["due"]):
                continue
            before = 0
            for tm in r.get("timings", []):
                v = tm["chunk_steps"]
                if tm["chunk_index"] >= 1:
                    flops += v * mod.frame_flops(cfg, mod.prompt_rows(r["req"]) + extra + before + v // 2)
                    flops += mod.window_flops(cfg, min(before, 24) + chunk)
                    seconds += tm["decode_ms"] / 1e3
                before += v
    if seconds <= 0:
        return None
    return 100.0 * flops / seconds / shapes.BF16_DENSE_FLOPS


def first_chunk_ms(window) -> Optional[float]:
    """Median `decode_ms` of a solo stream's first chunk: its prefill, its
    first frames and their window vocode, as the stream driver times them
    (streams sent before the traced window)."""
    v = [tm["decode_ms"] for r in window["records"] if _untraced(window, r["due"])
         for tm in r.get("timings", []) if tm["chunk_index"] == 0]
    return float(statistics.median(v)) if v else None


def ttfa_p90_before_trace(window) -> Optional[float]:
    """`ttfa_ms` at the 90th percentile over the requests due before the
    traced window opened."""
    recs = [r for r in window["records"] if _untraced(window, r["due"])]
    return percentile(ttfa_ms(dict(window, records=recs)), 0.9)


def admit_wait_p90_ms(window) -> Optional[float]:
    """90th percentile of the batcher's admit_wait_ms over the requests
    admitted before the traced window."""
    return percentile([r["admit_wait_ms"] for r in window["records"] if r.get("admit_wait_ms") is not None
                       and _untraced(window, r["sent"] + r["admit_wait_ms"] / 1e3)], 0.9)
