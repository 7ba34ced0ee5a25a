"""Browser demo server over the port: the SSE streaming UI backend.

The route surface, status codes, SSE events, environment variables and
usage store of the JAX package's `servers/demo_server.py`, on the standard
library alone (`http.server.ThreadingHTTPServer`, HTTP/1.1, chunked transfer
encoding through `server._Chunked`, threads), since the card's machine has
no aiohttp:

- POST /generate/stream: SSE `data: {json}\\n\\n` events `queued{position}`,
  `chunk{chunk_index, wav_b64, ttfa_ms, rtf}`..., then `done{ttfa_ms, rtf,
  audio_s, usage}` or `error{message}`; modes `clone` (ref_audio,
  uploaded_ref, preset_ref, ref_text, xvec_only), `custom` (speaker,
  language, instruct) and `design` (instruct). Empty text, text over
  MAX_TEXT_CHARS and a chunk_size outside {4, 8, 12} are a JSON 400 before
  any quota is consumed.
- POST /generate (non-streaming voice clone -> {wav_b64, sample_rate}),
  POST /load (the model LRU; `warmup: true` captures the serving graphs),
  GET /status, GET /usage, POST /upload_ref (raw audio/* or multipart field
  `file` -> a sha1 content-addressed temp file and its `ref_id`),
  GET /preset_ref/{id}, POST /transcribe (501 without a transcriber),
  GET / (the page; the login splash, or in web-only mode the page with a
  signed token) and GET /favicon.ico.
- Login and quotas: with DEMO_REQUIRE_LOGIN the generation routes answer
  401 unless the server's `oauth_parser(handler)` names a user, and a
  free-tier user past DEMO_DAILY_FREE_REQUESTS a day gets 429 (`UsageDB`,
  HMAC-pseudonymized keys). With DEMO_WEB_ONLY they need the page's signed
  token (`WebGate`) and a same-site fetch, else 403.

One generation runs at a time: a request waits for the generation lock and
is told its place as `queued{position}` (the requests ahead of it, the one
generating included). Its generator runs on a producer thread into a
bounded queue that the response drains; a client that goes away shows as
BrokenPipeError or ConnectionResetError on a write, the producer stops at
its next chunk and closes the generator (returning the session's graph
set), and only then is the lock released.

    python -m faster_qwen3_tts_tpu_torch.demo_server --preload 0.6b --device cuda

In-process (tests, smoke runs): `srv = make_demo_server("127.0.0.1", 0,
models={("0.6b", "Q8_0"): model})`, then `srv.serve_forever()` on a thread;
`srv.shutdown(); srv.server_close()` stops it. The environment is read when
the server is made.
"""
from __future__ import annotations

import argparse
import base64
import email.parser
import hashlib
import io
import json
import logging
import mimetypes
import os
import queue
import tempfile
import threading
import time
import wave
from collections import OrderedDict
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from .server import ALLOWED_CHUNK_SIZES, _Chunked, _Handler, _HttpError, terminal_put
from .usage_db import QuotaExceeded, UsageDB, WebGate

logger = logging.getLogger(__name__)

MAX_TEXT_CHARS = 1000  # KV budget guard
MAX_UPLOAD_BYTES = 16 * 1024 * 1024  # a reference recording
MAX_BODY_BYTES = 32 * 1024 * 1024  # any request body
WEB_TOKEN_HEADER = "x-fq3t-web-token"
INDEX_HTML = Path(__file__).resolve().parent / "demo" / "index.html"

ALL_MODEL_IDS = {
    "0.6b": "Qwen/Qwen3-TTS-12Hz-0.6B-Base",
    "1.7b": "Qwen/Qwen3-TTS-12Hz-1.7B-Base",
    "0.6b-custom": "Qwen/Qwen3-TTS-12Hz-0.6B-CustomVoice",
    "1.7b-custom": "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
    "1.7b-design": "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign",
}

_LOGIN_PAGE = """<!doctype html><html><head><title>faster-qwen3-tts-tpu demo</title>
</head><body style="font-family:sans-serif;max-width:28rem;margin:4rem auto">
<h1>Sign in required</h1>
<p>This demo requires login. Configure your identity provider (the demo
server's `oauth_parser`) or start the server without DEMO_REQUIRE_LOGIN.</p></body></html>"""


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip().lower() not in {"0", "false", "no", "off", ""}


def active_model_ids() -> Dict[str, str]:
    """The servable models: every key, or those ACTIVE_MODELS names by key or id."""
    active = os.environ.get("ACTIVE_MODELS", "")
    if not active:
        return dict(ALL_MODEL_IDS)
    allowed = {m.strip() for m in active.split(",") if m.strip()}
    return {k: v for k, v in ALL_MODEL_IDS.items() if k in allowed or v in allowed}


def _stable_usage_secret(usage_secret: Optional[str], db_path: str, gate: WebGate) -> bytes:
    """The pseudonym HMAC key when no secret is configured: a per-process
    random key would re-pseudonymize every user on restart (daily quotas
    reset, usage_users fills with unlinkable rows), so a generated key is
    kept next to the sqlite file. An explicit secret wins."""
    if usage_secret:
        return usage_secret.encode()
    path = db_path + ".hmac-key"
    try:
        with open(path, "rb") as f:
            key = f.read()
        if key:
            return key
    except FileNotFoundError:
        pass
    key = gate.secret
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "wb") as f:
            f.write(key)
        os.replace(tmp, path)
        os.chmod(path, 0o600)
    except OSError:
        logger.warning("could not persist usage HMAC key at %s; pseudonyms will rotate on restart", path)
    return key


def _wav_b64(audio: np.ndarray, sr: int) -> str:
    """A chunk as a base64 mono PCM16 WAV."""
    buf = io.BytesIO()
    pcm16 = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def _payload(body: bytes) -> dict:
    try:
        payload = json.loads(body or b"{}")
    except ValueError:
        payload = None
    if not isinstance(payload, dict):
        raise _HttpError(400, "the body must be a JSON object")
    return payload


def _multipart_file(content_type: str, body: bytes) -> bytes:
    """The `file` field of a multipart/form-data body (else its first part)."""
    msg = email.parser.BytesParser().parsebytes(
        b"MIME-Version: 1.0\r\nContent-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body)
    parts = msg.get_payload() if msg.is_multipart() else []
    if not parts:
        return b""
    part = next((p for p in parts if p.get_param("name", header="content-disposition") == "file"), parts[0])
    return part.get_payload(decode=True) or b""


class ModelCache:
    """LRU of loaded models keyed (model key, quant), at most `limit`; a key
    of `model_ids` loads its id (random init at its geometry when it is no
    checkpoint directory), any other key loads as given. `models` seeds it."""

    def __init__(self, model_ids: Dict[str, str], limit: int = 2, device: str = "cuda",
                 models: Optional[Dict[Tuple[str, str], Any]] = None):
        self.model_ids = model_ids
        self.limit = limit
        self.device = device
        self._cache: "OrderedDict[Tuple[str, str], Any]" = OrderedDict(models or {})
        self._lock = threading.Lock()  # the dict only; loads run under the server's generation lock
        self._trim()

    def _trim(self) -> None:
        with self._lock:
            while len(self._cache) > self.limit:
                self._cache.popitem(last=False)

    def get(self, key: str, quant: str):
        k = (key, quant)
        with self._lock:
            if k in self._cache:
                self._cache.move_to_end(k)
                return self._cache[k]
        from .model import FasterQwen3TTS

        model = FasterQwen3TTS.from_pretrained(self.model_ids.get(key, key), quant=quant, device=self.device)
        with self._lock:
            self._cache[k] = model
        self._trim()
        return model

    def loaded(self):
        with self._lock:
            return [f"{k[0]} ({k[1]})" for k in self._cache]


class DemoServer(ThreadingHTTPServer):
    """The demo's routes and state: the model cache, the generation lock and
    its queue, the uploaded and preset references, the usage store and the
    web gate. `oauth_parser(handler) -> {"sub", "username", "is_pro"} or
    None` names the request's user (the handler's `headers` and
    `client_address`); `transcriber(path) -> str` is the ASR of an uploaded
    reference."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, models: Optional[Dict[Tuple[str, str], Any]] = None, device: str = "cuda",
                 oauth_parser: Optional[Callable] = None, transcriber: Optional[Callable[[str], str]] = None,
                 presets: Optional[Dict[str, dict]] = None):
        env = os.environ
        super().__init__(address, _DemoHandler)
        self.model_ids = active_model_ids()
        self.models = ModelCache(self.model_ids, int(env.get("MODEL_CACHE_SIZE", "2")), device, models)
        self.web_only = _env_flag("DEMO_WEB_ONLY", "0")
        self.require_login = _env_flag("DEMO_REQUIRE_LOGIN", "1" if self.web_only else "0")
        gate_secret = env.get("DEMO_WEB_GATE_SECRET")
        usage_secret = env.get("DEMO_USAGE_HASH_SECRET") or gate_secret
        db_path = env.get("USAGE_DB_PATH", os.path.join(tempfile.gettempdir(), "fq3t-demo-usage.sqlite3"))
        self.web_gate = WebGate(gate_secret.encode() if gate_secret else None,
                                ttl_seconds=int(env.get("DEMO_WEB_TOKEN_TTL_SECONDS", "7200")))
        self.usage_db = UsageDB(db_path, hash_secret=_stable_usage_secret(usage_secret, db_path, self.web_gate),
                                daily_free_limit=int(env.get("DEMO_DAILY_FREE_REQUESTS", "10")))
        self.oauth_parser = oauth_parser
        self.transcriber = transcriber
        self.presets: Dict[str, dict] = dict(presets or {})
        self.uploaded_refs: Dict[str, str] = {}  # sha1 -> temp wav path
        self.generation_lock = threading.Lock()
        self._queue_lock = threading.Lock()  # guards the two counts below
        self._waiting = 0  # requests waiting for the generation lock
        self._running = 0  # requests holding it

    @property
    def queue_depth(self) -> int:
        with self._queue_lock:
            return self._waiting

    # -- auth / quota -------------------------------------------------------------------------

    def request_user(self, h: "_DemoHandler"):
        return self.oauth_parser(h) if self.oauth_parser is not None else None

    @staticmethod
    def client_fingerprint(h: "_DemoHandler") -> str:
        fwd = h.headers.get("x-forwarded-for", "")
        ip = fwd.split(",", 1)[0].strip() if fwd else h.client_address[0]
        return f"{ip}|{h.headers.get('user-agent', '')[:256]}"

    def require_user(self, h: "_DemoHandler"):
        """401 unless logged in (when login is required) -> the user or None."""
        if not self.require_login:
            return None
        user = self.request_user(h)
        if not user or not user.get("sub"):
            raise _HttpError(401, "Sign in to use this demo.")
        return user

    def require_web_client(self, h: "_DemoHandler") -> None:
        """Web-only mode: generation routes need the signed page token."""
        if not self.web_only:
            return
        fetch_site = h.headers.get("sec-fetch-site")
        if fetch_site and fetch_site not in {"same-origin", "same-site", "none"}:
            raise _HttpError(403, "Use the web UI to run this demo.")
        if not self.web_gate.verify(h.headers.get(WEB_TOKEN_HEADER, ""), self.client_fingerprint(h)):
            raise _HttpError(403, "Open the demo page before making requests.")

    def consume_quota(self, user) -> Optional[dict]:
        """One generation off the user's daily quota; 429 when out."""
        if not self.require_login or user is None:
            return None
        try:
            return self.usage_db.consume(user["sub"], user.get("username", ""), bool(user.get("is_pro")))
        except QuotaExceeded as e:
            raise _HttpError(429, str(e))

    def _usage_of(self, user) -> Optional[dict]:
        return self.usage_db.get_usage(user["sub"], user.get("username", ""), bool(user.get("is_pro")))

    # -- generation ---------------------------------------------------------------------------

    def _generator(self, model, payload: dict):
        mode = payload.get("mode", "clone")
        text = payload["text"]
        chunk_size = int(payload.get("chunk_size", 8))
        common = dict(chunk_size=chunk_size, max_new_tokens=int(payload.get("max_new_tokens", 600)),
                      first_chunk_size=min(4, chunk_size))
        if mode == "custom":
            return model.generate_custom_voice_streaming(
                text, speaker=payload["speaker"], language=payload.get("language", "English"),
                instruct=payload.get("instruct"), **common)
        if mode == "design":
            return model.generate_voice_design_streaming(
                text, instruct=payload["instruct"], language=payload.get("language", "English"), **common)
        vcp = self.presets.get(payload.get("preset_ref"))
        ref_audio = payload.get("ref_audio")
        uploaded = payload.get("uploaded_ref")
        if uploaded:
            if uploaded not in self.uploaded_refs:
                raise ValueError(f"unknown uploaded_ref {uploaded!r}")
            ref_audio = self.uploaded_refs[uploaded]
        return model.generate_voice_clone_streaming(
            text, payload.get("language", "English"), ref_audio=ref_audio, ref_text=payload.get("ref_text", ""),
            xvec_only=bool(payload.get("xvec_only", False)), voice_clone_prompt=vcp, **common)

    def _produce(self, model, payload: dict, out_q: queue.Queue, cancelled: threading.Event) -> None:
        """Producer thread: the request's chunks into `out_q`, then one
        terminal that always lands. The generator is closed on every exit,
        so the session's graph set goes back at once."""
        terminal = ("done", None, None, None)
        gen = None
        try:
            gen = self._generator(model, payload)
            for audio, sr, timing in gen:
                if cancelled.is_set():
                    return
                try:
                    out_q.put(("chunk", audio, sr, timing), timeout=30)
                except queue.Full:
                    return
        except Exception as e:  # noqa: BLE001 -- reported to the client as an error event
            logger.exception("generation failed")
            terminal = ("error", str(e), None, None)
        finally:
            if gen is not None:
                gen.close()
            terminal_put(out_q, terminal)

    def _stream(self, out: _Chunked, payload: dict, usage) -> None:
        """Under the generation lock: the request's events, until its end or
        until the client is gone; returns once the producer has stopped."""
        def sse(obj) -> bool:
            return out.write(f"data: {json.dumps(obj)}\n\n".encode())

        try:
            model = self.models.get(payload.get("model", "0.6b"), payload.get("quant", "BF16"))
        except Exception as e:  # noqa: BLE001 -- a model that fails to load ends this stream only
            logger.exception("model load failed")
            sse({"type": "error", "message": str(e)})
            return
        out_q: queue.Queue = queue.Queue(maxsize=16)
        cancelled = threading.Event()
        t = threading.Thread(target=self._produce, args=(model, payload, out_q, cancelled), daemon=True)
        t.start()
        t_start = time.perf_counter()
        total_ms = audio_s = 0.0
        ttfa_ms = None
        try:
            while True:
                kind, a, sr, timing = out_q.get()
                if kind == "done":
                    sse({"type": "done", "ttfa_ms": ttfa_ms, "rtf": audio_s / max(total_ms / 1000, 1e-9),
                         "audio_s": audio_s, "usage": usage})
                    break
                if kind == "error":
                    sse({"type": "error", "message": a})
                    break
                if ttfa_ms is None:
                    ttfa_ms = (time.perf_counter() - t_start) * 1000
                total_ms += timing.get("prefill_ms", 0) + timing.get("decode_ms", 0)
                audio_s += len(a) / sr
                if not sse({"type": "chunk", "chunk_index": timing["chunk_index"], "wav_b64": _wav_b64(a, sr),
                            "ttfa_ms": ttfa_ms, "rtf": audio_s / max(total_ms / 1000, 1e-9)}):
                    break  # the client is gone
        finally:
            cancelled.set()
            while t.is_alive():  # the generation lock is held until the producer has stopped
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass

    # -- routes -------------------------------------------------------------------------------

    def generate_stream(self, h: "_DemoHandler", body: bytes) -> None:
        user = self.require_user(h)
        self.require_web_client(h)
        payload = _payload(body)
        text = payload.get("text", "")
        if not text:
            raise _HttpError(400, "missing text")
        if len(text) > MAX_TEXT_CHARS:
            raise _HttpError(400, f"text too long (max {MAX_TEXT_CHARS} chars)")
        try:
            chunk_size = int(payload.get("chunk_size", 8))
        except (TypeError, ValueError):
            chunk_size = -1
        if chunk_size not in ALLOWED_CHUNK_SIZES:
            raise _HttpError(400, f"chunk_size must be one of {sorted(ALLOWED_CHUNK_SIZES)}")
        usage = self.consume_quota(user)  # after validation: a 400 burns no quota

        try:
            h.send_response(200)
            h.send_header("Content-Type", "text/event-stream")
            h.send_header("Cache-Control", "no-cache")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
        except (BrokenPipeError, ConnectionResetError):
            h.close_connection = True
            return
        out = _Chunked(h)
        with self._queue_lock:
            position = self._waiting + self._running
            self._waiting += 1
        out.write(f"data: {json.dumps({'type': 'queued', 'position': position})}\n\n".encode())
        with self.generation_lock:
            with self._queue_lock:
                self._waiting -= 1
                self._running += 1
            try:
                if not out.gone:
                    self._stream(out, payload, usage)
            finally:
                with self._queue_lock:
                    self._running -= 1
        out.end()

    def generate(self, h: "_DemoHandler", body: bytes) -> None:
        """Non-streaming voice clone."""
        user = self.require_user(h)
        self.require_web_client(h)
        self.consume_quota(user)
        payload = _payload(body)
        with self.generation_lock:
            try:
                model = self.models.get(payload.get("model", "0.6b"), payload.get("quant", "BF16"))
                (audio,), sr = model.generate_voice_clone(
                    payload["text"], payload.get("language", "English"), ref_audio=payload.get("ref_audio"),
                    ref_text=payload.get("ref_text", ""), xvec_only=bool(payload.get("xvec_only", False)),
                    max_new_tokens=int(payload.get("max_new_tokens", 600)))
            except Exception as e:  # noqa: BLE001 -- the request fails, the server runs on
                logger.exception("generation failed")
                raise _HttpError(500, str(e))
        h._json(200, {"wav_b64": _wav_b64(audio, sr), "sample_rate": sr})

    def load(self, h: "_DemoHandler", body: bytes) -> None:
        self.require_user(h)
        self.require_web_client(h)
        payload = _payload(body)
        key = payload.get("model", "0.6b")
        if key not in self.model_ids:
            raise _HttpError(400, f"model not in ACTIVE_MODELS: {sorted(self.model_ids)}")
        with self.generation_lock:
            try:
                model = self.models.get(key, payload.get("quant", "BF16"))
                if payload.get("warmup"):
                    # the serving configuration: chunk 8 with a 4-frame first chunk
                    model.warmup(chunk_sizes=(8,), first_chunk_size=4)
            except Exception as e:  # noqa: BLE001 -- the request fails, the server runs on
                logger.exception("model load failed")
                raise _HttpError(500, str(e))
        h._json(200, {"loaded": self.models.loaded()})

    def status(self, h: "_DemoHandler") -> None:
        user = self.require_user(h)
        h._json(200, {
            "loaded_models": self.models.loaded(),
            "available_models": sorted(self.model_ids),
            "queue_depth": self.queue_depth,
            "presets": sorted(self.presets),
            "max_text_chars": MAX_TEXT_CHARS,
            "require_login": self.require_login,
            "web_only": self.web_only,
            "user": ({"username": user.get("username", ""), "is_pro": bool(user.get("is_pro"))}
                     if user else None),
            "usage": self._usage_of(user) if self.require_login and user is not None else None,
        })

    def usage(self, h: "_DemoHandler") -> None:
        user = self.require_user(h)
        h._json(200, {"usage": None if user is None else self._usage_of(user)})

    def upload_ref(self, h: "_DemoHandler", body: bytes) -> None:
        """A reference recording -> a content-addressed temp file -> its id."""
        self.require_user(h)
        self.require_web_client(h)
        ctype = h.headers.get("Content-Type", "")
        data = _multipart_file(ctype, body) if ctype.startswith("multipart/") else body
        if not data:
            raise _HttpError(400, "empty upload")
        sha = hashlib.sha1(data).hexdigest()
        if sha not in self.uploaded_refs:
            path = Path(tempfile.gettempdir()) / f"fq3t_ref_{sha}.wav"
            path.write_bytes(data)
            self.uploaded_refs[sha] = str(path)
        h._json(200, {"ref_id": sha})

    def preset_ref(self, h: "_DemoHandler", rid: str) -> None:
        entry = self.presets.get(rid)
        path = entry.get("ref_audio") if isinstance(entry, dict) else None
        if not path or not Path(path).exists():
            raise _HttpError(404, f"unknown preset {rid!r}")
        h.send_bytes(200, mimetypes.guess_type(path)[0] or "application/octet-stream", Path(path).read_bytes())

    def transcribe(self, h: "_DemoHandler", body: bytes) -> None:
        self.require_user(h)
        self.require_web_client(h)
        payload = _payload(body)
        rid = payload.get("ref_id")
        path = self.uploaded_refs.get(rid)
        if path is None:
            raise _HttpError(400, f"unknown ref_id {rid!r}")
        if self.transcriber is None:
            raise _HttpError(501, "no ASR model configured; set the demo server's transcriber "
                                  "or type the reference text manually")
        h._json(200, {"text": self.transcriber(path)})

    def index(self, h: "_DemoHandler") -> None:
        if self.require_login and self.request_user(h) is None:
            h.send_bytes(200, "text/html; charset=utf-8", _LOGIN_PAGE.encode())
            return
        html = INDEX_HTML.read_text()
        if not self.web_only:
            h.send_bytes(200, "text/html; charset=utf-8", html.encode())
            return
        # bootstrap the signed page token
        token = self.web_gate.make_token(self.client_fingerprint(h))
        boot = f"<script>window.__FQ3T_WEB_TOKEN__ = {json.dumps(token)};</script>"
        html = html.replace("</head>", f"{boot}\n</head>", 1)
        h.send_bytes(200, "text/html; charset=utf-8", html.encode(), {"Cache-Control": "no-store"})


_POST_ROUTES = {"/generate/stream": DemoServer.generate_stream, "/generate": DemoServer.generate,
                "/load": DemoServer.load, "/upload_ref": DemoServer.upload_ref,
                "/transcribe": DemoServer.transcribe}
_GET_ROUTES = {"/": DemoServer.index, "/status": DemoServer.status, "/usage": DemoServer.usage}


class _DemoHandler(_Handler):
    """The routes of `DemoServer` (`_Handler` gives the JSON and byte replies)."""

    server: DemoServer

    def _read_body(self, limit: int) -> bytes:
        """The body by Content-Length; over `limit` it is refused unread."""
        n = int(self.headers.get("Content-Length") or 0)
        if n > limit:
            self.close_connection = True  # the body stays unread
            raise _HttpError(413, f"request body over {limit} bytes")
        return self.rfile.read(n) if n > 0 else b""

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        try:
            if path in _GET_ROUTES:
                _GET_ROUTES[path](self.server, self)
            elif path.startswith("/preset_ref/"):
                self.server.preset_ref(self, path[len("/preset_ref/"):])
            elif path == "/favicon.ico":
                self.send_bytes(204, "image/x-icon", b"")
            else:
                raise _HttpError(404, f"no route {self.path}")
        except _HttpError as e:
            self._json(e.status, {"error": e.message})

    def do_POST(self) -> None:
        path = self.path.split("?", 1)[0]
        try:
            body = self._read_body(MAX_UPLOAD_BYTES if path == "/upload_ref" else MAX_BODY_BYTES)
            if path not in _POST_ROUTES:
                raise _HttpError(404, f"no route {self.path}")
            _POST_ROUTES[path](self.server, self, body)
        except _HttpError as e:
            self._json(e.status, {"error": e.message})


def make_demo_server(host: str = "127.0.0.1", port: int = 7860, models: Optional[Dict[Tuple[str, str], Any]] = None,
                     device: str = "cuda", oauth_parser: Optional[Callable] = None,
                     transcriber: Optional[Callable[[str], str]] = None,
                     presets: Optional[Dict[str, dict]] = None) -> DemoServer:
    """A bound, not yet serving, demo server (port 0: any free port).
    `models` seeds the model cache: {(model key, quant): loaded model}; a
    model not in it loads on `device` at first use. `presets`: {id:
    {"ref_audio": path, ...}}, served by /preset_ref and handed to the
    model as `voice_clone_prompt` by a clone request's `preset_ref`."""
    return DemoServer((host, port), models, device, oauth_parser=oauth_parser, transcriber=transcriber,
                      presets=presets)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Browser demo server over the PyTorch port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--preload", default=None, help="model key to preload, e.g. 0.6b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = make_demo_server(args.host, args.port, device=args.device)
    if args.preload:
        srv.models.get(args.preload, "BF16")
    logger.info("serving the demo on %s:%d", *srv.server_address[:2])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
