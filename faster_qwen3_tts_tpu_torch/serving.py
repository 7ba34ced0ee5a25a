"""Continuous batching: requests join a running pool of lanes at chunk boundaries.

Port of faster_qwen3_tts_tpu/serving.py. A fixed pool of `max_slots` engine
lanes runs a steady chunk pump. A request is admitted into a free lane at a
chunk boundary; it pays its own prompt (a streaming request's assembled on
the device, `_prepare_generation`'s default), a B=1 prefill and one solo
first chunk through the single-stream session (its first audio, in B=1
time; on the card a replay of the B=1 set's prefill graph, then of its
frame), then enters the pool through `core.insert_slot` and a copy of its
trailing text: device copies of its state, KV cache and text rows into the
pool's tensors. The session's B=1 cache is freed once the lane is copied.
A finished lane (EOS, budget or `cancel`) frees its slot
for the next pending request. The pool's shapes never change.

Vocoding is two-phase per lane. While a lane has fewer than 24 frames of its
own, the shared device history window still holds the slot's previous
occupant, so the lane's own host vocoder (`model._StreamVocoder`) vocodes
it. Once the lane has emitted >= 24 frames the window is all its own and an
x-vector lane takes the batched device vocode: one window vocode of every
lane behind the decode chunk. The seam is sample-exact for x-vector lanes.
ICL lanes keep the host vocoder for their whole stream (the early
proportional reference cut makes the seam inexact), as in the JAX package.
The device vocode runs only in chunks that have a mature x-vector lane.

The host reads the device once per chunk (the packed tokens and, when a
lane is vocoded on the device, every lane's audio); lane insert and release
are device writes. There is no dispatch-ahead, as in the JAX package.

The pool is the static state of a B = `max_slots` graph set
(`engine/graphs.py`), leased at the first admission and returned by
`close()` once the pump has stopped (or when the batcher is collected):
lane surgery writes into it in place, and on the card each pool chunk and
window vocode is a replay of that set's graphs. Admission's solo chunk runs
on a B = 1 set, returned once its lane is copied.

Kernels: at B lanes the talker's projections and codec head run K2 (K4
for int4 weights) at M = B rows and the predictor's first pass at M = 2B;
both go to the kernel up to 16 rows, so up to 8 slots. With max_slots > 8
the predictor's first pass (and with max_slots > 16 every projection) has
more than 16 rows and takes the many-row product
(`ops.quant._int8_matmul` / `_int4_matmul`), as a prefill does. K1 runs every
lane of the pool in one launch, done lanes included.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from .engine import core, fused_stream, graphs
from .engine import generate as gen_lib
from .ops.sampling import SamplingParams
from .utils import trace

logger = logging.getLogger(__name__)


class _Stream:
    __slots__ = ("sid", "request", "slot", "submitted_at", "admitted_at", "first_audio_at", "vocoder",
                 "frames_emitted", "max_new_tokens", "host_only")

    def __init__(self, sid, request, max_new_tokens):
        self.sid = sid
        self.request = request
        self.slot = None
        self.submitted_at = time.perf_counter()
        self.admitted_at = None
        self.first_audio_at = None
        self.vocoder = None
        self.frames_emitted = 0
        self.max_new_tokens = max_new_tokens
        self.host_only = False  # ICL lanes stay on their host vocoder


def _ms_since(t0: float, t1: Optional[float] = None) -> float:
    return round(((time.perf_counter() if t1 is None else t1) - t0) * 1000.0, 1)


class ContinuousBatcher:
    """Fixed-pool continuous batching over one model.

        cb = ContinuousBatcher(model, max_slots=8, chunk_size=8)
        sid = cb.submit({"text": ..., "voice_clone_prompt": ..., ...})
        for sid, audio, sr, timing in cb.run():   # until drained
            ...

    `submit` and `cancel` may be called from another thread; the pump takes
    submissions and cancellations at chunk boundaries. Yielded timing keys:
    chunk_index, slot, chunk_steps, decode_ms, total_steps_so_far, is_final,
    ttfa_from_submit_ms, admit_wait_ms; plus solo_first_chunk (the
    admission chunk), cancelled (a cancelled stream's terminal) or error (a
    request that failed admission; slot -1). Up to 8 slots every projection
    of a frame is a K2 launch; see the module docstring for more. A model
    with a (dp, tp) mesh is refused, as in the JAX package."""

    def __init__(
        self,
        model,
        max_slots: int = 8,
        chunk_size: int = 8,
        first_chunk_size: Optional[int] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        seed: Optional[int] = None,
        subtalker_dosample: Optional[bool] = None,
        subtalker_top_k: Optional[int] = None,
        subtalker_top_p: Optional[float] = None,
        subtalker_temperature: Optional[float] = None,
    ):
        if getattr(model, "mesh", None) is not None:
            raise ValueError("continuous batching is single-chip for now; "
                             "use the lockstep batched API under a dp mesh")
        self.model = model
        self.B = max_slots
        self.chunk_size = chunk_size
        self.first_chunk = first_chunk_size or chunk_size  # the solo admission chunk
        self.max_new_tokens = max_new_tokens
        self.min_new_tokens = min_new_tokens
        self.sampling = SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty)
        self.pred_sampling = gen_lib.predictor_sampling(
            subtalker_dosample, subtalker_top_k, subtalker_top_p, subtalker_temperature)
        self._lock = threading.Lock()  # guards _pending, _next_sid and _cancelled
        self._pending: deque = deque()
        self._slots: List[Optional[_Stream]] = [None] * max_slots
        self._next_sid = 0
        self._seed = seed
        self._set: Optional[graphs.GraphSet] = None  # the pool's graph set, leased at the first admission
        self._lease: Optional[graphs.Lease] = None
        self._state: Optional[core.DecodeState] = None  # the set's static state
        self._tth: Optional[torch.Tensor] = None  # [B, tb, H] each lane's trailing text
        self._hist: Optional[torch.Tensor] = None  # [B, ctx, 16] shared vocoder window
        self._ctx = gen_lib.CONTEXT_FRAMES
        self._cancelled: set = set()
        self._closed = False
        self._running = False

    def close(self) -> None:
        """No further submits: run(wait=True) drains and returns. The pool's
        graph set goes back to the model once no pump runs."""
        with self._lock:
            self._closed = True
            if not self._running:
                self._release_pool()

    def _release_pool(self) -> None:
        """Return the pool's set once no lane holds a stream (under _lock)."""
        if self._lease is not None and not any(self._slots):
            self._lease.release()
            self._lease = self._set = self._state = self._tth = self._hist = None

    def active(self) -> int:
        """Lanes that hold a stream now (readable from any thread)."""
        return sum(s is not None for s in self._slots)

    def cancel(self, sid: int) -> None:
        """Release a stream's lane at the next chunk boundary (the client
        went away). Unknown or finished sids are ignored. The pump yields
        one `cancelled` terminal for the stream."""
        with self._lock:
            self._cancelled.add(sid)

    def submit(self, request: Dict[str, Any], max_new_tokens: Optional[int] = None) -> int:
        with self._lock:
            s = _Stream(self._next_sid, request, max_new_tokens or self.max_new_tokens)
            self._next_sid += 1
            self._pending.append(s)
        return s.sid

    # -- admission --------------------------------------------------------------

    def _bootstrap(self, tth_rows: int, tpe) -> None:
        """The pool: a leased B-lane graph set, every lane done until a stream
        is inserted."""
        m = self.model
        seed = self._seed
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        reg = graphs.registry_for(m.params)
        key = graphs.make_key(m.params, self.B, m.max_seq_len, gen_lib.tth_bucket(tth_rows), self.sampling,
                              self.pred_sampling, self.min_new_tokens)
        self._set = reg.lease(m.params, m.config, key)
        self._lease = graphs.Lease(self, reg, self._set)
        self._set.reset_empty(seed)
        self._set.tpe.copy_(torch.as_tensor(np.asarray(tpe)).to(self._set.tpe.dtype).expand_as(self._set.tpe))
        self._state, self._tth, self._hist = self._set.state, self._set.tth, self._set.hist(self._ctx)

    def _admit(self, s: _Stream, slot: int) -> Tuple[np.ndarray, int, bool, float]:
        """B=1 prefill and solo first chunk (the stream's first audio), then
        lane surgery into the pool -> (first audio, frames emitted,
        finished, solo ms). A stream that finished inside its first chunk
        never occupies the slot."""
        m = self.model
        r = s.request
        nsm = m._resolve_non_streaming_mode(r.get("non_streaming_mode"), default=False)
        tie, tam, tth, tpe, ref_codes = m._prepare_generation(
            text=r["text"], language=r.get("language", "English"), ref_audio=r.get("ref_audio"),
            ref_text=r.get("ref_text", ""), xvec_only=bool(r.get("xvec_only", False)),
            non_streaming_mode=nsm, append_silence=bool(r.get("append_silence", True)),
            voice_clone_prompt=r.get("voice_clone_prompt"), instruct=r.get("instruct"),
        )
        if self._state is None:
            self._bootstrap(tth.shape[1], tpe)
        tb = self._tth.shape[1]
        if tth.shape[1] > tb:
            # the pool's trailing-text bucket is one shape: fail this request
            # before any lane surgery, never the pump
            raise ValueError(
                f"request trailing text ({tth.shape[1]} rows) exceeds the pool's bucket ({tb}); "
                "shorten the text or serve it through the solo or lockstep path")
        sess = gen_lib.GenerationSession(
            m.params, m.config, tie, tam, tth, tpe, m.max_seq_len, self.sampling, self.pred_sampling,
            self.min_new_tokens, seed=self._seed,
        )
        try:
            s.admitted_at = time.perf_counter()
            sess.prefill(block=False)
            t0 = time.perf_counter()
            frames, done = sess.decode_chunk(self.first_chunk)
            v = min(frames.shape[0], s.max_new_tokens)
            s.vocoder = m._make_stream_vocoder(ref_codes)
            s.host_only = ref_codes is not None
            audio = s.vocoder.vocode_new(frames[:v]) if v > 0 else np.zeros((0,), np.float32)
            s.frames_emitted = v
            now = time.perf_counter()
            if v > 0:
                s.first_audio_at = now
            if done or v >= s.max_new_tokens:
                return audio, v, True, (now - t0) * 1000.0
            # not finished: every frame of the solo chunk was valid (v == first_chunk).
            # The lane's state and cache, its trailing-text row, and the newest
            # rows of its vocoder window (so that maturity stays exact).
            core.insert_slot(self._state, sess.state, slot)
        finally:
            sess.close()  # its B=1 set goes back to the model
        # the lane's trailing text, device to device: the session's bucket, then pad rows to the pool's
        n = sess.tth.shape[1]
        self._tth[slot, :n].copy_(sess.tth[0])
        self._tth[slot, n:].copy_(sess.tpe[0].expand(tb - n, -1))
        k = min(v, self._ctx)
        self._hist[slot, self._ctx - k:] = torch.as_tensor(frames[v - k:v])
        s.slot = slot
        self._slots[slot] = s
        return audio, v, False, (now - t0) * 1000.0

    def _admit_pending(self):
        """Admit pending requests into free slots -> (emissions, failures).
        A request whose admission raises (text over the pool's bucket, a bad
        voice prompt, ...) becomes a (stream, error) pair: admission errors
        end that request only."""
        emits, failed = [], []
        for slot in range(self.B):
            while self._slots[slot] is None:
                with self._lock:
                    if not self._pending:
                        return emits, failed
                    s = self._pending.popleft()
                try:
                    # spans of the whole admission: its wait since submit, then `_admit`
                    trace.add("cb.queue", round(s.submitted_at * 1e9), time.perf_counter_ns(), rid=s.sid)
                    with trace.span("cb.admit", rid=s.sid, value=slot):
                        audio, v, finished, solo_ms = self._admit(s, slot)
                    emits.append((s, slot, audio, v, finished, solo_ms))
                except Exception as e:  # noqa: BLE001 -- the pool keeps serving the others
                    logger.warning("request %d failed admission", s.sid, exc_info=True)
                    failed.append((s, e))
        return emits, failed

    def _take_cancelled(self) -> List[Tuple[int, _Stream]]:
        """Drop cancelled pending requests; -> the cancelled lanes (slot, stream)."""
        with self._lock:
            if not self._cancelled:
                return []
            kept = [p for p in self._pending if p.sid not in self._cancelled]
            self._cancelled.difference_update(p.sid for p in self._pending)
            self._pending = deque(kept)
            lanes = [(slot, s) for slot, s in enumerate(self._slots)
                     if s is not None and s.sid in self._cancelled]
            self._cancelled.difference_update(s.sid for _, s in lanes)
        return lanes

    # -- the pump ---------------------------------------------------------------

    def run(self, wait: bool = False) -> Generator[Tuple[int, np.ndarray, int, Dict[str, Any]], None, None]:
        """Pump chunks until every submitted stream finished. Yields
        (stream id, audio chunk f32, sample rate, timing).

        wait=True: keep serving across idle gaps until close() (server
        mode, with submit() called from another thread)."""
        with self._lock:
            self._running = True
        try:
            yield from self._pump(wait)
        finally:
            with self._lock:
                self._running = False
                if self._closed:
                    self._release_pool()

    def _pump(self, wait: bool):
        m = self.model
        cfg = m.config
        up = cfg.codec.total_upsample
        ncg = cfg.talker.num_code_groups
        empty = np.zeros((0,), np.float32)
        chunk_index = 0
        while self._pending or any(self._slots) or (wait and not self._closed):
            if not self._pending and not any(self._slots):
                time.sleep(0.001)  # idle: wait for a submit or close()
                continue
            emits, failed = self._admit_pending()
            for s, err in failed:
                wait_ms = _ms_since(s.submitted_at)
                yield s.sid, empty, m.sample_rate, {
                    "chunk_index": chunk_index, "slot": -1, "chunk_steps": 0, "decode_ms": 0.0,
                    "total_steps_so_far": 0, "is_final": True, "error": str(err),
                    "ttfa_from_submit_ms": wait_ms, "admit_wait_ms": wait_ms,
                }
            for s, slot, audio, v, finished, solo_ms in emits:
                yield s.sid, audio, m.sample_rate, {
                    "chunk_index": chunk_index, "slot": slot, "chunk_steps": v,
                    "decode_ms": round(solo_ms, 1), "total_steps_so_far": s.frames_emitted,
                    "is_final": finished, "solo_first_chunk": True,
                    "ttfa_from_submit_ms": _ms_since(s.submitted_at, s.first_audio_at),
                    "admit_wait_ms": _ms_since(s.submitted_at, s.admitted_at),
                }
                if finished:
                    with self._lock:
                        self._cancelled.discard(s.sid)
            for slot, s in self._take_cancelled():
                core.release_slot(self._state, slot)
                self._slots[slot] = None
                yield s.sid, empty, m.sample_rate, {
                    "chunk_index": chunk_index, "slot": slot, "chunk_steps": 0, "decode_ms": 0.0,
                    "total_steps_so_far": s.frames_emitted, "is_final": True, "cancelled": True,
                    "ttfa_from_submit_ms": _ms_since(s.submitted_at, s.first_audio_at),
                    "admit_wait_ms": _ms_since(s.submitted_at, s.admitted_at),
                }
            if not any(self._slots):
                continue  # every pending request failed admission or was cancelled
            t0 = time.perf_counter()
            with trace.span("cb.pool_chunk", value=self.active()):
                packed = self._set.run_chunk(m.params, self.chunk_size)
                if any(s is not None and not s.host_only and s.frames_emitted >= self._ctx
                       for s in self._slots):
                    # a mature x-vector lane: vocode every lane's window behind the chunk
                    audio_t = self._set.vocode(m.params, self.chunk_size, self._ctx)
                    audio_b, frames, valid, done = fused_stream.split_fused_output_batch(audio_t, packed)
                else:
                    audio_b = None
                    frames, valid, done = core.read_packed_batch(packed)
            # the window rolls on, in place: the last ctx frames of [window | chunk]
            self._hist.copy_(torch.cat([self._hist, packed[:, :, :ncg].transpose(0, 1)], dim=1)[:, -self._ctx:])
            decode_ms = (time.perf_counter() - t0) * 1000.0
            for slot, s in enumerate(self._slots):
                if s is None:
                    continue
                v = min(int(valid[:, slot].sum()), s.max_new_tokens - s.frames_emitted)
                finished = bool(done[slot])
                if v > 0:
                    if not s.host_only and s.frames_emitted >= self._ctx:
                        audio = audio_b[slot, :v * up]  # mature: the window is all its own
                    else:
                        audio = s.vocoder.vocode_new(frames[:, slot][valid[:, slot]][:v])
                    s.frames_emitted += v
                    if s.first_audio_at is None:
                        s.first_audio_at = time.perf_counter()
                    if s.frames_emitted >= s.max_new_tokens and not finished:
                        finished = True
                        core.release_slot(self._state, slot)
                elif finished:
                    # EOS on the previous chunk's boundary: no valid frame, but
                    # the consumer still needs the is_final terminal
                    audio = empty
                else:
                    continue
                if s.first_audio_at is None:
                    s.first_audio_at = time.perf_counter()
                yield s.sid, audio, m.sample_rate, {
                    "chunk_index": chunk_index, "slot": slot, "chunk_steps": v, "decode_ms": decode_ms,
                    "total_steps_so_far": s.frames_emitted, "is_final": finished,
                    "ttfa_from_submit_ms": _ms_since(s.submitted_at, s.first_audio_at),
                    "admit_wait_ms": _ms_since(s.submitted_at, s.admitted_at),
                }
                if finished:
                    self._slots[slot] = None  # free for the next admission
                    with self._lock:
                        self._cancelled.discard(s.sid)
            chunk_index += 1
