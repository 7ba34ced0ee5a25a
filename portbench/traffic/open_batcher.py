"""Open loop into the continuous batcher.

Requests arrive on a fixed schedule (`mix.arrivals`) from a feeder thread,
which calls `ContinuousBatcher.submit` at each request's due time whatever
the batcher is doing; the main thread consumes `run(wait=True)`. When the
window closes the feeder stops sending, waits (at most `drain_s`) until
every request it sent has its first audio, cancels the streams still
running and closes the batcher. Chunk arrival times are taken where the
consumer receives them.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import numpy as np

from portbench.traffic import mix as mix_lib

DRAIN_S = 60.0
TRACE_CHUNKS = 3  # pool chunks in the traced window
TRACE_LEAD_S = 3.0  # the traced window opens this long before the window closes


def _request(ctx, req: Dict[str, Any]) -> Dict[str, Any]:
    """A submission: the text, its language and the voice's arguments as the
    mix's kind of voice gives them (a voice-clone prompt, a preset speaker)."""
    return {"text": req["text"], "language": req["language"], **ctx.voice_args(req)}


def _warm_request(ctx) -> Dict[str, Any]:
    """The warm request: a fixed text in the mix's language, with the first
    voice of the mix's kind (x-vector voice 0, the first preset speaker)."""
    params = ctx.workload["traffic_params"]
    return {"text": "A warm request of some length", "language": params.get("language", "English"),
            ctx.kind.KEY: ctx.kind.labels(params)[0]}


def _batcher(ctx):
    w = ctx.workload["entry"]
    return ctx.model.continuous_batcher(
        max_slots=w["max_slots"], chunk_size=w["chunk_size"], first_chunk_size=w["first_chunk_size"],
        seed=ctx.seed % (2 ** 31), **ctx.sampling)


def warm(ctx) -> None:
    """One request through a batcher of the cell's shape: admission, the
    pool's chunks, the host vocoder and the device window."""
    cb = _batcher(ctx)
    cb.submit(_request(ctx, _warm_request(ctx)), max_new_tokens=ctx.workload["entry"].get("warm_frames", 40))
    cb.close()
    for _ in cb.run():
        pass


def plan(ctx, seconds: float, rate: float) -> Dict[str, Any]:
    n = max(1, int(round(rate * seconds)))
    return {"requests": mix_lib.make(ctx.workload["traffic_params"], ctx.seed, n),
            "arrivals": mix_lib.arrivals(rate, n, seconds, np.random.default_rng(ctx.seed + 1))}


def run(ctx, seconds: float, rate: float, tracer=None) -> Dict[str, Any]:
    p = plan(ctx, seconds, rate)
    reqs, arrivals = p["requests"], p["arrivals"]
    cb = _batcher(ctx)
    taps = ctx.taps.install(cb)
    recs: List[Dict[str, Any]] = [
        {"index": r["index"], "req": r, "due": None, "sent": None, "first": None, "chunks": [], "audio": [],
         "frames": [], "finished": False, "eos": False, "error": None, "admit_wait_ms": None, "cancelled": False}
        for r in reqs]
    pool: Dict[int, Dict[str, Any]] = {}
    lock = threading.Lock()
    stop = threading.Event()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    sent = [0]

    def feeder():
        for i, rec in enumerate(recs):
            due = t0 + float(arrivals[i])
            if stop.wait(max(0.0, due - time.perf_counter())):
                break
            with lock:
                rec["due"], rec["sent"] = due, time.perf_counter()
                sid = cb.submit(_request(ctx, rec["req"]), max_new_tokens=rec["req"]["frames"])
                assert sid == i, "the batcher numbers submissions in order"
                sent[0] = i + 1
        if stop.wait(max(0.0, t1 - time.perf_counter())):
            cb.close()  # the consumer ended early
            return
        deadline = time.perf_counter() + DRAIN_S
        while time.perf_counter() < deadline and not stop.is_set():
            with lock:
                waiting = [r for r in recs[:sent[0]] if r["first"] is None and r["error"] is None]
            if not waiting:
                break
            time.sleep(0.005)
        for r in recs[:sent[0]]:
            if not r["finished"] and r["error"] is None:
                cb.cancel(r["index"])
        cb.close()

    th = threading.Thread(target=feeder, name="portbench-feeder", daemon=True)
    th.start()
    frames_before: Dict[int, int] = {}
    traced = [None, 0]  # (last pool chunk seen, pool chunks traced)
    try:
        for sid, audio, _sr, timing in cb.run(wait=True):
            now = time.perf_counter()
            rec = recs[sid]
            v = int(timing.get("chunk_steps", 0))
            slot = timing.get("slot", -1)
            if timing.get("error"):
                rec["error"] = timing["error"]
            elif timing.get("solo_first_chunk"):
                got = np.concatenate(taps.take_solo(sid) or [np.zeros((0, 16), np.int32)])[:v]
                rec["frames"].append(got)
                rec["admit_wait_ms"] = timing.get("admit_wait_ms")
                rec["solo_ms"] = timing.get("decode_ms")
            elif v:
                f, valid = taps.last_batch
                rec["frames"].append(f[:, slot][valid[:, slot]][:v])
                c = pool.setdefault(timing["chunk_index"], {"decode_ms": timing["decode_ms"], "t": now, "lanes": []})
                c["lanes"].append((v, frames_before.get(sid, 0), rec["req"]))
            if v or len(audio):
                with lock:
                    if rec["first"] is None and len(audio):
                        rec["first"] = now
                rec["chunks"].append((now, int(len(audio)), v))
                rec["audio"].append(np.asarray(audio, np.float32))
                frames_before[sid] = frames_before.get(sid, 0) + v
            if timing.get("is_final"):
                rec["cancelled"] = bool(timing.get("cancelled"))
                rec["finished"] = not rec["cancelled"] and rec["error"] is None
                rec["eos"] = rec["finished"] and frames_before.get(sid, 0) < rec["req"]["frames"]
            # The traced window opens and closes between yields, where the pump has no device work
            # queued, and closes the window: stopping the profiler holds the host for seconds.
            if tracer is not None and not tracer.done:
                if not tracer.active:
                    if max(t0, t1 - TRACE_LEAD_S) <= now < t1:
                        tracer.start()
                        traced = [timing.get("chunk_index"), 0]
                else:
                    ci = timing.get("chunk_index")
                    if v and slot >= 0 and not timing.get("solo_first_chunk") and ci != traced[0]:
                        traced[0], traced[1] = ci, traced[1] + 1
                    if traced[1] >= TRACE_CHUNKS or now >= t1:
                        tracer.stop()
    finally:
        stop.set()
        th.join()
        taps.remove()
        if tracer is not None and tracer.active:
            tracer.stop()
    attempted = [r for r in recs[:sent[0]]]
    late = [r["sent"] - r["due"] for r in attempted]
    return {"t0": t0, "t1": t1, "records": attempted, "pool_chunks": pool, "late_s": late,
            "offered_rate": rate}
