"""OpenAI-compatible TTS server over the port: POST /v1/audio/speech, GET /health.

The HTTP contract of the JAX package's `servers/openai_server.py` on the
standard library alone (`http.server.ThreadingHTTPServer`, HTTP/1.1, chunked
transfer encoding, threads), since the card's machine has no aiohttp:

- POST /v1/audio/speech: `input`, `voice` (a name of the voices.json
  registry; an unknown name takes the first voice), `response_format`
  (wav | pcm | mp3), `chunk_size` (4 | 8 | 12). A bad field is a JSON 400
  before any audio. wav and pcm stream as they are generated (wav behind a
  header of unknown length); mp3 is encoded once at the end, 501 where no
  encoder is installed (`utils.mp3`).
- GET /health: status, model_loaded, sample_rate, voices, batched,
  max_batch, continuous, max_slots.

Three serving modes, and in each exactly one thread drives the engine at a
time:
- mutex (default): each request's generator runs on a producer thread
  behind the engine lock, into a bounded queue the response drains;
- `batch=N`: a `BatchScheduler` thread gathers concurrent requests of one
  chunk size for `batch_window_s`, pads them to a power-of-two bucket by
  repeating the first (so that a later captured CUDA graph sees few batch
  sizes) and decodes them in lockstep (`generate_voice_clone_streaming_batch`)
  under the engine lock, which the mp3 path takes too;
- `continuous=N`: a `ContinuousScheduler` thread pumps a
  `serving.ContinuousBatcher` of N lanes (`run(wait=True)`, restarted with a
  fresh batcher if it fails); every request joins it, mp3 included, and
  per-request chunk_size is ignored (the pool decodes at chunk 8).

A client that goes away shows as BrokenPipeError or ConnectionResetError on
a write: its job is cancelled, and the scheduler releases its lane
(`ContinuousBatcher.cancel`), or the producer stops after its chunk.

    python -m faster_qwen3_tts_tpu_torch.server --model <checkpoint dir or id> \\
        --voices voices.json --continuous 8 --warmup

In-process (tests, smoke runs): `srv = make_server(model, "127.0.0.1", 0,
voices={...}, continuous=8)`, then `srv.serve_forever()` on a thread;
`srv.server_address[1]` is the port, `srv.shutdown(); srv.server_close()`
stops it and its scheduler.
"""
from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from .utils.audio import float_to_pcm16, wav_header

logger = logging.getLogger(__name__)

# the chunk sizes a warmed server decodes at; anything else is refused
ALLOWED_CHUNK_SIZES = frozenset({4, 8, 12})
_FORMATS = ("wav", "pcm", "mp3")


def terminal_put(q: "queue.Queue", item) -> None:
    """Deliver a terminal item (None or an Exception) without ever blocking:
    when the bounded queue is full because its consumer stopped draining,
    evict the oldest chunk. The producer always exits, and a consumer
    parked in get() always wakes."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:
                pass


class _BatchJob:
    """One streaming request waiting for, or inside, an engine batch."""

    def __init__(self, request: dict, chunk_size: int):
        self.request = request
        self.chunk_size = chunk_size
        self.out_q: queue.Queue = queue.Queue(maxsize=32)
        self.cancelled = False  # the consumer is gone: never block on out_q for it
        self.sid: Optional[int] = None  # its stream id in a ContinuousBatcher


class BatchScheduler:
    """Micro-batching: one daemon thread takes the oldest job, waits up to
    `window_s` for more with the same chunk size, pads the batch to a
    power-of-two bucket (at most `max_batch`) by repeating the first
    request, and fans each slot's chunks out to its job's queue; padded
    slots are dropped. A failure fails the whole round."""

    def __init__(self, model, max_batch: int, window_s: float, engine_lock: Optional[threading.Lock] = None,
                 max_new_tokens: int = 2048):
        self.model = model
        self.max_batch = max_batch
        self.window_s = window_s
        self.engine_lock = engine_lock or threading.Lock()
        self.max_new_tokens = max_new_tokens
        self._pending: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, job: _BatchJob) -> None:
        with self._cv:
            self._pending.append(job)
            self._cv.notify()

    def cancel(self, job: _BatchJob) -> None:
        job.cancelled = True  # the lockstep batch runs on; the slot's chunks are dropped

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=30)

    def _collect(self) -> Optional[list]:
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if self._closed:
                return None
            first = self._pending.pop(0)
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                i = 0
                while i < len(self._pending) and len(batch) < self.max_batch:
                    if self._pending[i].chunk_size == first.chunk_size:
                        batch.append(self._pending.pop(i))
                    else:
                        i += 1
                remaining = deadline - time.monotonic()
                if len(batch) >= self.max_batch or remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
        return batch

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                self._run(batch)
            except Exception as e:  # noqa: BLE001 -- every job of the round gets the error
                logger.exception("batch generation failed")
                for job in batch:
                    terminal_put(job.out_q, e)

    def _run(self, batch: list) -> None:
        B = len(batch)
        requests = [j.request for j in batch] + [batch[0].request] * (self._bucket(B) - B)
        finished = [False] * B
        with self.engine_lock:
            for slot, audio, _sr, timing in self.model.generate_voice_clone_streaming_batch(
                    requests, chunk_size=batch[0].chunk_size, max_new_tokens=self.max_new_tokens):
                if slot >= B or finished[slot]:
                    continue  # a padding slot, or a chunk after the final one
                job = batch[slot]
                if not job.cancelled:
                    try:  # a consumer that stopped draining costs one timeout, never a wedge
                        job.out_q.put(float_to_pcm16(audio), timeout=30)
                    except queue.Full:
                        job.cancelled = True
                if timing.get("is_final"):
                    finished[slot] = True
                    terminal_put(job.out_q, None)
        for job in batch:
            terminal_put(job.out_q, None)  # a lane that ended on a chunk boundary, or was cancelled


class ContinuousScheduler:
    """One daemon thread pumps a `ContinuousBatcher` (`run(wait=True)`);
    chunks fan out to the jobs by stream id. A request that fails its
    admission ends with its own error; if the pump itself fails, it restarts
    with a fresh batcher and the jobs in flight get the error."""

    def __init__(self, model, max_slots: int, chunk_size: int = 8, max_new_tokens: int = 2048):
        self.model = model
        self.max_slots = max_slots
        self.chunk_size = chunk_size
        self.max_new_tokens = max_new_tokens
        self.cancelled_streams = 0  # lanes released for a consumer that went away
        self._jobs: Dict[int, _BatchJob] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._make_batcher()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _make_batcher(self) -> None:
        self.cb = self.model.continuous_batcher(max_slots=self.max_slots, chunk_size=self.chunk_size,
                                                max_new_tokens=self.max_new_tokens)

    def submit(self, job: _BatchJob) -> None:
        with self._lock:
            job.sid = self.cb.submit(job.request)
            self._jobs[job.sid] = job

    def cancel(self, job: _BatchJob) -> None:
        """The consumer went away: free the lane at the next chunk boundary."""
        job.cancelled = True
        with self._lock:
            if self._jobs.get(job.sid) is job:
                self.cb.cancel(job.sid)

    def live_lanes(self) -> int:
        return self.cb.active()

    def close(self) -> None:
        self._closed = True
        self.cb.close()
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        while True:
            try:
                for sid, audio, _sr, timing in self.cb.run(wait=True):
                    with self._lock:
                        job = self._jobs.get(sid)
                    if job is None:
                        continue
                    if not job.cancelled:
                        try:
                            job.out_q.put(float_to_pcm16(audio), timeout=30)
                        except queue.Full:
                            job.cancelled = True
                    if job.cancelled and not timing.get("is_final"):
                        self.cb.cancel(sid)  # release the lane, do not decode into the void
                    if timing.get("is_final"):
                        if timing.get("cancelled"):
                            self.cancelled_streams += 1
                        err = timing.get("error")  # an admission failure: a real error, not an empty 200
                        terminal_put(job.out_q, RuntimeError(err) if err else None)
                        with self._lock:
                            self._jobs.pop(sid, None)
                return  # run() returns only after close()
            except Exception as e:  # noqa: BLE001 -- restart the pump, fail the jobs in flight
                if self._closed:
                    return
                logger.exception("continuous pump failed; restarting the batcher")
                with self._lock:
                    dead, self._jobs = self._jobs, {}
                    self._make_batcher()
                for job in dead.values():
                    terminal_put(job.out_q, e)


def load_voices(path) -> Dict[str, dict]:
    """voices.json: {"alloy": {"ref_audio": "...", "ref_text": "...",
    "xvec_only": false, "language": "English"}, ...}; {} if there is none."""
    if path and Path(path).exists():
        with open(path) as f:
            return json.load(f)
    return {}


def _voice_request(text: str, voice: dict) -> dict:
    """The engine request of a text in a resolved voice."""
    return {
        "text": text,
        "language": voice.get("language", "English"),
        "ref_audio": voice.get("ref_audio"),
        "ref_text": voice.get("ref_text", ""),
        "xvec_only": bool(voice.get("xvec_only", False)),
        "voice_clone_prompt": voice.get("voice_clone_prompt"),
    }


class _HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _Chunked:
    """Chunked transfer encoding onto a handler's socket. `write` returns
    False once the client is gone."""

    def __init__(self, handler: BaseHTTPRequestHandler):
        self.h = handler
        self.gone = False

    def _send(self, data: bytes) -> bool:
        if self.gone:
            return False
        try:
            self.h.wfile.write(data)
            self.h.wfile.flush()
            return True
        except (BrokenPipeError, ConnectionResetError):
            self.gone = True
            self.h.close_connection = True
            return False

    def write(self, data: bytes) -> bool:
        return self._send(b"%x\r\n%s\r\n" % (len(data), data)) if data else not self.gone

    def end(self) -> None:
        self._send(b"0\r\n\r\n")


class SpeechServer(ThreadingHTTPServer):
    """The server and its serving state: one model, one voice registry, at
    most one scheduler."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, model, voices: Optional[Dict[str, dict]] = None, batch: int = 1,
                 batch_window_s: float = 0.1, continuous: int = 0, max_new_tokens: int = 2048):
        if batch > 1 and continuous > 1:
            raise ValueError("batch and continuous are mutually exclusive")
        super().__init__(address, _Handler)  # binds: a busy port fails before any thread starts
        self.model = model
        self.voices = dict(voices or {})
        self.max_new_tokens = max_new_tokens
        self.engine_lock = threading.Lock()  # mutex streams, lockstep rounds and mp3 requests
        self.scheduler = (BatchScheduler(model, batch, batch_window_s, self.engine_lock, max_new_tokens)
                          if batch > 1 else None)
        self.continuous = (ContinuousScheduler(model, continuous, chunk_size=8, max_new_tokens=max_new_tokens)
                           if continuous > 1 else None)

    def server_close(self) -> None:
        super().server_close()
        for sched in (self.scheduler, self.continuous):
            if sched is not None:
                sched.close()

    def health(self) -> dict:
        return {
            "status": "ok",
            "model_loaded": self.model is not None,
            "sample_rate": getattr(self.model, "sample_rate", None),
            "voices": sorted(self.voices),
            "batched": self.scheduler is not None,
            "max_batch": getattr(self.scheduler, "max_batch", 1),
            "continuous": self.continuous is not None,
            "max_slots": getattr(self.continuous, "max_slots", None),
        }

    def resolve_voice(self, name: str) -> dict:
        if name in self.voices:
            return self.voices[name]
        if self.voices:
            return next(iter(self.voices.values()))
        raise _HttpError(400, f"unknown voice {name!r} and no voices registered")

    # -- POST /v1/audio/speech ------------------------------------------------------------------

    def speech(self, h: "_Handler", body: dict) -> None:
        text = body.get("input")
        if not text:
            raise _HttpError(400, "missing 'input'")
        fmt = body.get("response_format", "wav")
        if fmt not in _FORMATS:
            raise _HttpError(400, f"unsupported response_format {fmt!r} (wav|pcm|mp3)")
        voice = self.resolve_voice(body.get("voice", "default"))
        try:
            chunk_size = int(body.get("chunk_size", 8))
        except (TypeError, ValueError):
            raise _HttpError(400, "chunk_size must be an integer")
        if chunk_size not in ALLOWED_CHUNK_SIZES:
            raise _HttpError(400, f"chunk_size must be one of {sorted(ALLOWED_CHUNK_SIZES)}")
        if fmt == "mp3":
            return self._mp3(h, text, voice)

        try:
            h.send_response(200)
            h.send_header("Content-Type", "audio/wav" if fmt == "wav" else "audio/pcm")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
        except (BrokenPipeError, ConnectionResetError):
            h.close_connection = True
            return  # gone before any work was queued
        out = _Chunked(h)
        if fmt == "wav":
            out.write(wav_header(self.model.sample_rate))  # unknown length: a stream
        sched = self.scheduler or self.continuous
        if sched is not None:
            job = _BatchJob(_voice_request(text, voice), chunk_size)
            sched.submit(job)
            ended = False
            while not out.gone:
                item = job.out_q.get()
                ended = item is None or isinstance(item, Exception)
                if ended or not out.write(item):
                    break
            if not ended:  # the client went away: release its lane
                sched.cancel(job)
        else:
            self._stream_mutex(text, voice, chunk_size, out)
        out.end()

    def _stream_mutex(self, text: str, voice: dict, chunk_size: int, out: _Chunked) -> None:
        """One request owns the engine: its generator runs on a producer
        thread into a bounded queue drained here."""
        with self.engine_lock:
            out_q: queue.Queue = queue.Queue(maxsize=8)
            cancelled = threading.Event()
            t = threading.Thread(target=self._produce, args=(text, voice, chunk_size, out_q, cancelled),
                                 daemon=True)
            t.start()
            try:
                while True:
                    item = out_q.get()
                    if item is None or isinstance(item, Exception) or not out.write(item):
                        break
            finally:
                cancelled.set()
                while t.is_alive():  # the engine lock is held until the producer has stopped
                    try:
                        out_q.get(timeout=0.05)
                    except queue.Empty:
                        pass

    def _produce(self, text, voice, chunk_size, out_q: queue.Queue, cancelled: threading.Event) -> None:
        terminal = None
        try:
            for audio, _sr, _timing in self.model.generate_voice_clone_streaming(
                    text, voice.get("language", "English"), ref_audio=voice.get("ref_audio"),
                    ref_text=voice.get("ref_text", ""), xvec_only=bool(voice.get("xvec_only", False)),
                    chunk_size=chunk_size, first_chunk_size=min(4, chunk_size),
                    voice_clone_prompt=voice.get("voice_clone_prompt"), max_new_tokens=self.max_new_tokens):
                if cancelled.is_set():
                    return
                try:
                    out_q.put(float_to_pcm16(audio), timeout=30)
                except queue.Full:
                    return
        except Exception as e:  # noqa: BLE001 -- surfaced to the consumer
            logger.exception("generation failed")
            terminal = e
        finally:
            terminal_put(out_q, terminal)

    def _mp3(self, h: "_Handler", text: str, voice: dict) -> None:
        """The whole stream, then one encode (mp3 frames do not chunk cleanly)."""
        from .utils.mp3 import Mp3Unavailable, encode_mp3

        if self.continuous is not None:  # ride the batcher: one engine owner
            job = _BatchJob(_voice_request(text, voice), self.continuous.chunk_size)
            self.continuous.submit(job)
            parts = []
            while True:
                item = job.out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise _HttpError(500, str(item))
                parts.append(item)
            audio = np.frombuffer(b"".join(parts), dtype=np.int16).astype(np.float32) / 32768.0
            sr = self.model.sample_rate
        else:
            with self.engine_lock:
                (audio,), sr = self.model.generate_voice_clone(
                    text, voice.get("language", "English"), ref_audio=voice.get("ref_audio"),
                    ref_text=voice.get("ref_text", ""), xvec_only=bool(voice.get("xvec_only", False)),
                    voice_clone_prompt=voice.get("voice_clone_prompt"), max_new_tokens=self.max_new_tokens)
        try:
            data = encode_mp3(np.asarray(audio), sr)
        except Mp3Unavailable as e:
            raise _HttpError(501, str(e))
        h.send_bytes(200, "audio/mpeg", data)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: SpeechServer

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s %s", self.address_string(), fmt % args)

    def send_bytes(self, status: int, content_type: str, data: bytes, headers: Optional[Dict[str, str]] = None) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _json(self, status: int, obj: Any) -> None:
        self.send_bytes(status, "application/json", json.dumps(obj).encode())

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def do_GET(self) -> None:
        if self.path.split("?", 1)[0] == "/health":
            self._json(200, self.server.health())
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:
        raw = self._body()
        if self.path.split("?", 1)[0] != "/v1/audio/speech":
            self._json(404, {"error": f"no route {self.path}"})
            return
        try:
            body = json.loads(raw or b"{}")
        except ValueError:
            body = None
        if not isinstance(body, dict):
            self._json(400, {"error": "the body must be a JSON object"})
            return
        try:
            self.server.speech(self, body)
        except _HttpError as e:
            self._json(e.status, {"error": e.message})


def make_server(model, host: str = "127.0.0.1", port: int = 8880,
                voices: Union[None, str, Path, Dict[str, dict]] = None, batch: int = 1,
                batch_window_s: float = 0.1, continuous: int = 0, max_new_tokens: int = 2048) -> SpeechServer:
    """A bound, not yet serving, server over `model` (port 0: any free
    port). `voices` is a registry dict or the path of a voices.json.
    `max_new_tokens` caps every request's frames."""
    if not isinstance(voices, dict):
        voices = load_voices(voices)
    return SpeechServer((host, port), model, voices, batch=batch, batch_window_s=batch_window_s,
                        continuous=continuous, max_new_tokens=max_new_tokens)


def warm(model, continuous: int = 0, batch: int = 1) -> None:
    """Capture the serving graphs: the solo path (every allowed chunk size,
    first chunk 4), with --batch the lockstep buckets (`BatchScheduler._bucket`:
    powers of two up to N, the first chunk a whole chunk), with a continuous
    pool its lanes (chunk 8); then one throwaway request through the pool."""
    sizes = tuple(sorted(ALLOWED_CHUNK_SIZES))
    model.warmup(chunk_sizes=sizes, first_chunk_size=4, pool_slots=continuous if continuous > 1 else 0)
    if batch > 1:
        buckets = sorted({min(1 << i, batch) for i in range(batch.bit_length() + 1)})
        model.warmup(chunk_sizes=sizes, first_chunk_size=None, batch_sizes=buckets)
    if continuous > 1:
        cb = model.continuous_batcher(max_slots=continuous, chunk_size=8, max_new_tokens=8)
        cb.submit({"text": "warm the continuous lanes.", "xvec_only": True,
                   "voice_clone_prompt": {"ref_spk_embedding": [np.zeros(2048, np.float32)],
                                          "x_vector_only_mode": [True], "icl_mode": [False],
                                          "ref_code": [None]}})
        for _ in cb.run():
            pass
        cb.close()  # its pool's graph set goes back to the model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="OpenAI-compatible TTS server over the PyTorch port")
    ap.add_argument("--model", default="Qwen/Qwen3-TTS-12Hz-0.6B-Base",
                    help="model id (random init), deploy bundle, own-format checkpoint dir, or HF checkpoint dir")
    ap.add_argument("--quant", default="BF16",
                    help="BF16 (default), Q8_0 (int8), Q4_K_M (int4) or Q8_4 (talker int8, predictor int4)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--strict", action=argparse.BooleanOptionalAction, default=None,
                    help="HF checkpoint dirs: fail on any missing tensor (default) or random-init it")
    ap.add_argument("--backend", default="torch", choices=["torch", "native", "jax"],
                    help="'torch' = this engine ('jax' selects it too); 'native' adds the host library and "
                         "the voice-reference cache")
    ap.add_argument("--fuse-qkv", action="store_true",
                    help="fused projection layout (wqkv, w_gateup): 4 projections a layer instead of 7")
    ap.add_argument("--voices", default=None, help="voices.json registry")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8880)
    ap.add_argument("--warmup", action="store_true",
                    help="capture the serving graphs (solo, --batch buckets, the continuous pool) before serving")
    ap.add_argument("--batch", type=int, default=1, metavar="N",
                    help="micro-batch up to N concurrent streams into one lockstep engine batch "
                         "(1 = one request at a time behind a mutex)")
    ap.add_argument("--batch-window-ms", type=float, default=100.0,
                    help="how long the batch scheduler waits to fill a batch")
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="continuous batching over N engine lanes: a request joins the running pool at "
                         "the next chunk boundary (chunk 8; per-request chunk_size is ignored). "
                         "Excludes --batch")
    ap.add_argument("--max-new-tokens", type=int, default=2048, help="frames per request at most")
    ap.add_argument("--dp", type=int, default=None,
                    help="shard the serving batch over a dp-way device mesh (pass to from_pretrained; pair "
                         "with --batch). With --device cpu: a one-process mesh of cpu entries. On cards one "
                         "process a card over cuda:0 .. cuda:n-1, this server's process the first")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ways for per-request latency (on cards one process a card, the tp "
                         "collectives over NCCL; with --device cpu a one-process mesh)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.batch > 1 and args.continuous > 1:
        ap.error("--batch and --continuous are mutually exclusive")
    from .model import FasterQwen3TTS

    model = FasterQwen3TTS.from_pretrained(args.model, device=args.device, quant=args.quant,
                                           strict=args.strict, backend=args.backend, fuse_qkv=args.fuse_qkv,
                                           dp=args.dp, tp=args.tp)
    if args.warmup:
        warm(model, args.continuous, args.batch)
    srv = make_server(model, args.host, args.port, voices=args.voices, batch=args.batch,
                      batch_window_s=args.batch_window_ms / 1000.0, continuous=args.continuous,
                      max_new_tokens=args.max_new_tokens)
    logger.info("serving on %s:%d", *srv.server_address[:2])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
