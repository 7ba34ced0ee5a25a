"""One client in a closed loop over a solo streaming entry.

The client sends its next request as soon as the last one has streamed its
final chunk, so each request is due when it is sent. The entry is the
cell's public streaming method (`generate_voice_clone_streaming` with an
x-vector voice prompt, or `generate_custom_voice_streaming` with a preset
speaker). When the window closes the stream in flight is closed after its
first audio. The traced window covers one whole request near the window's
end, from before it is sent to after its last chunk, where no device work is
in flight.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from portbench.traffic import mix as mix_lib

# The traced request is the first sent this long before the window closes
# (longer than the longest request, so one always is): the program spans of
# the requests before it carry no profiler cost.
TRACE_LEAD_S = 8.0


def _stream(ctx, req: Dict[str, Any]):
    e = ctx.workload["entry"]
    kw = dict(max_new_tokens=req["frames"], chunk_size=e["chunk_size"], first_chunk_size=e["first_chunk_size"],
              seed=ctx.seed % (2 ** 31), **ctx.sampling)
    if e["method"] == "generate_custom_voice_streaming":
        return ctx.model.generate_custom_voice_streaming(req["text"], req["speaker"], req["language"], **kw)
    vcp = {"ref_spk_embedding": [ctx.voices[req["voice"]]], "x_vector_only_mode": [True], "icl_mode": [False],
           "ref_code": [None]}
    return ctx.model.generate_voice_clone_streaming(req["text"], req["language"], voice_clone_prompt=vcp, **kw)


def warm(ctx) -> None:
    """One request of the cell's entry: every window context of its chunks."""
    req = mix_lib.make(ctx.workload["traffic_params"], ctx.seed, 1)[0]
    for _ in _stream(ctx, dict(req, frames=ctx.workload["entry"].get("warm_frames", 40))):
        pass


def run(ctx, seconds: float, rate=None, tracer=None) -> Dict[str, Any]:
    reqs = mix_lib.make(ctx.workload["traffic_params"], ctx.seed, ctx.workload["traffic_params"]["pool"])
    taps = ctx.taps.install()
    recs: List[Dict[str, Any]] = []
    t0 = time.perf_counter()
    t1 = t0 + seconds
    try:
        while time.perf_counter() < t1:
            i = len(recs)
            req = dict(reqs[i % len(reqs)], index=i)
            traced = tracer is not None and not tracer.done and time.perf_counter() >= max(t0, t1 - TRACE_LEAD_S)
            if traced:
                tracer.start()
            rec = {"index": i, "req": req, "due": time.perf_counter(), "first": None, "chunks": [], "audio": [],
                   "frames": [], "finished": False, "eos": False, "error": None, "timings": []}
            rec["sent"] = rec["due"]
            recs.append(rec)
            taps.current = i
            gen = _stream(ctx, req)
            try:
                for audio, _sr, timing in gen:
                    now = time.perf_counter()
                    if rec["first"] is None and len(audio):
                        rec["first"] = now
                    v = int(timing["chunk_steps"])
                    rec["chunks"].append((now, int(len(audio)), v))
                    rec["audio"].append(np.asarray(audio, np.float32))
                    rec["timings"].append({k: timing[k] for k in ("chunk_index", "chunk_steps", "decode_ms")})
                    if timing["is_final"]:
                        n = sum(c[2] for c in rec["chunks"])
                        rec["finished"] = True
                        rec["eos"] = n < req["frames"]
                    if now >= t1 and rec["first"] is not None and not traced:
                        break
            except Exception as e:  # noqa: BLE001 -- a failed request counts, the client goes on
                rec["error"] = f"{type(e).__name__}: {e}"
            finally:
                gen.close()
            n = sum(c[2] for c in rec["chunks"])
            rec["frames"] = [np.concatenate(taps.take_solo(i) or [np.zeros((0, 16), np.int32)])[:n]]
            if traced:
                tracer.stop()
    finally:
        taps.remove()
        if tracer is not None and tracer.active:
            tracer.stop()
    return {"t0": t0, "t1": t1, "records": recs, "late_s": [0.0] * len(recs)}
