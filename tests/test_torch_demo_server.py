"""The port's browser demo server (faster_qwen3_tts_tpu_torch/demo_server.py).

The demo tests of tests/test_servers.py (the JAX package's aiohttp demo)
held against the port's standard-library server over a real socket: the same
stub model (stream and guards, upload and transcribe, login and quota, an
invalid payload burns no quota, the web-only token gate). Then what the
threads add: a client that goes away (the producer stops, its generator is
closed, the lock is released), queue positions, the model LRU at
MODEL_CACHE_SIZE=1, multipart uploads and presets. Then the real port model
at the tiny geometry on the CPU: its SSE chunks equal its direct greedy
stream, and the same requests through the JAX demo (aiohttp, where
installed) on the same weights give the same events, chunk lengths and
audio_s, with PCM16 within 4 LSB (the codec tolerance, 1e-4)."""
import asyncio
import base64
import dataclasses
import hashlib
import http.client
import io
import json
import socket
import tempfile
import threading
import time
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.utils import audio as jax_audio
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import demo_server as demo
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.usage_db import UsageDB

torch.set_num_threads(1)
DEMO_ENV = ("DEMO_WEB_ONLY", "DEMO_REQUIRE_LOGIN", "DEMO_DAILY_FREE_REQUESTS", "DEMO_WEB_GATE_SECRET",
            "DEMO_USAGE_HASH_SECRET", "DEMO_WEB_TOKEN_TTL_SECONDS", "MODEL_CACHE_SIZE", "ACTIVE_MODELS")
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)


class _StubModel:
    """Three chunks a request, with the engine's timing keys; `closed` is
    set when its generator is closed before its end; with a `gate`, each
    chunk waits for it."""
    sample_rate = 24000

    def __init__(self, chunks=3, delay=0.0, gate=None):
        self.chunks, self.delay, self.gate = chunks, delay, gate
        self.calls, self.produced, self.closed = [], 0, threading.Event()
        self.warmups = []

    def generate_voice_clone_streaming(self, text, language, **kw):
        self.calls.append(dict(kw, text=text, language=language))
        chunk = kw.get("chunk_size", 8)
        try:
            for i in range(self.chunks):
                time.sleep(self.delay)
                if self.gate is not None:
                    assert self.gate.wait(60)
                self.produced += 1
                yield (np.full(chunk * 1920, 0.01 * (i + 1), np.float32), self.sample_rate,
                       {"chunk_index": i, "chunk_steps": chunk, "prefill_ms": 5.0 if i == 0 else 0.0,
                        "decode_ms": 10.0, "total_steps_so_far": (i + 1) * chunk, "is_final": i == self.chunks - 1})
        except GeneratorExit:
            self.closed.set()
            raise

    def generate_voice_clone(self, text, language, **kw):
        self.calls.append(dict(kw, text=text, language=language))
        return [np.zeros(1920, np.float32)], self.sample_rate

    def warmup(self, **kw):
        self.warmups.append(kw)


@pytest.fixture
def serve(tmp_path, monkeypatch):
    """serve(model=None, **make_demo_server kwargs) -> (server, port); the
    environment is the demo's defaults with the usage store and uploads
    under tmp_path; every server stops after the test."""
    for name in DEMO_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("USAGE_DB_PATH", str(tmp_path / "usage.sqlite3"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    started = []

    def start(model=None, **kw):
        kw.setdefault("models", {("0.6b", "BF16"): model or _StubModel()})
        kw.setdefault("device", "cpu")
        s = demo.make_demo_server("127.0.0.1", 0, **kw)
        t = threading.Thread(target=s.serve_forever, daemon=True)
        t.start()
        started.append((s, t))
        return s, s.server_address[1]

    yield start
    for s, t in started:
        s.shutdown()
        s.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def call(port, method, path, body=None, headers=None, timeout=120):
    """-> (status, headers, body bytes); a dict body goes as JSON."""
    hdrs = dict(headers or {})
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=hdrs)
        r = conn.getresponse()
        return r.status, r.headers, r.read()
    finally:
        conn.close()


def events(raw: bytes):
    return [json.loads(line[6:]) for line in raw.decode().splitlines() if line.startswith("data: ")]


def wav_pcm(b64: str):
    """A chunk's wav_b64 -> (PCM16 samples, rate); it must be mono 16-bit."""
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), "<i2"), w.getframerate()


# -- the JAX demo's tests -------------------------------------------------------------------------


def test_demo_stream_and_guards(serve):
    srv, port = serve()
    status, headers, raw = call(port, "POST", "/generate/stream", {"text": "hello", "mode": "clone", "xvec_only": True})
    assert status == 200
    assert headers["Content-Type"] == "text/event-stream" and headers["Cache-Control"] == "no-cache"
    ev = events(raw)
    assert [e["type"] for e in ev] == ["queued", "chunk", "chunk", "chunk", "done"]
    assert ev[0]["position"] == 0 and [e["chunk_index"] for e in ev[1:4]] == [0, 1, 2]
    pcm = [wav_pcm(e["wav_b64"]) for e in ev[1:4]]
    assert all(sr == 24000 and p.size == 8 * 1920 for p, sr in pcm)
    assert [int(p[0]) for p, _ in pcm] == [int(0.01 * k * 32767.0) for k in (1, 2, 3)]
    done = ev[-1]
    assert done["audio_s"] == 3 * 8 * 1920 / 24000 and done["usage"] is None
    assert done["rtf"] == pytest.approx(done["audio_s"] / 0.035) and done["ttfa_ms"] > 0
    assert set(ev[1]) == {"type", "chunk_index", "wav_b64", "ttfa_ms", "rtf"}
    # the streaming arguments: first chunk min(4, chunk), 600 frames by default
    kw = srv.models.get("0.6b", "BF16").calls[0]
    assert (kw["chunk_size"], kw["first_chunk_size"], kw["max_new_tokens"], kw["xvec_only"]) == (8, 4, 600, True)
    # guards: text too long, empty, a chunk size outside the warmed set, not JSON
    for bad in ({"text": "x" * 1500}, {"text": ""}, {"text": "hi", "chunk_size": 5}, {"text": "hi", "chunk_size": None}):
        status, headers, raw = call(port, "POST", "/generate/stream", bad)
        assert status == 400 and headers["Content-Type"] == "application/json" and json.loads(raw)["error"], bad
    assert call(port, "POST", "/generate/stream", b"not json")[0] == 400
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "chunk_size": 4})
    assert status == 200 and wav_pcm(events(raw)[1]["wav_b64"])[0].size == 4 * 1920
    st = json.loads(call(port, "GET", "/status")[2])
    assert st == {"loaded_models": ["0.6b (BF16)"], "available_models": sorted(demo.ALL_MODEL_IDS),
                  "queue_depth": 0, "presets": [], "max_text_chars": 1000, "require_login": False,
                  "web_only": False, "user": None, "usage": None}
    assert json.loads(call(port, "GET", "/usage")[2]) == {"usage": None}
    assert call(port, "GET", "/nowhere")[0] == 404 and call(port, "POST", "/nowhere", {})[0] == 404
    assert call(port, "GET", "/favicon.ico")[0] == 204
    status, headers, raw = call(port, "GET", "/")
    assert status == 200 and raw == demo.INDEX_HTML.read_bytes() and "Cache-Control" not in headers
    # non-streaming voice clone
    status, _, raw = call(port, "POST", "/generate", {"text": "hi", "ref_audio": "r.wav", "xvec_only": True})
    body = json.loads(raw)
    assert status == 200 and body["sample_rate"] == 24000 and wav_pcm(body["wav_b64"])[0].size == 1920


def test_demo_upload_and_transcribe(serve, tmp_path):
    """upload_ref -> a content-addressed id; clone through uploaded_ref;
    transcribe: 501 without an ASR hook, 200 with one, 400 for an unknown id."""
    srv, port = serve()
    stub = srv.models.get("0.6b", "BF16")
    wav = b"RIFF" + b"\x00" * 256
    status, _, raw = call(port, "POST", "/upload_ref", wav, {"Content-Type": "audio/wav"})
    rid = json.loads(raw)["ref_id"]
    assert status == 200 and rid == hashlib.sha1(wav).hexdigest()
    assert json.loads(call(port, "POST", "/upload_ref", wav, {"Content-Type": "audio/wav"})[2])["ref_id"] == rid
    path = srv.uploaded_refs[rid]
    assert path == str(tmp_path / f"fq3t_ref_{rid}.wav") and open(path, "rb").read() == wav

    # clone through uploaded_ref hands the temp path to the model as ref_audio
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "mode": "clone", "uploaded_ref": rid})
    assert status == 200 and events(raw)[-1]["type"] == "done"
    assert stub.calls[-1]["ref_audio"] == path
    # an unknown uploaded_ref -> an error event in the stream
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "mode": "clone", "uploaded_ref": "nope"})
    ev = events(raw)
    assert status == 200 and [e["type"] for e in ev] == ["queued", "error"] and "nope" in ev[-1]["message"]
    assert call(port, "POST", "/upload_ref", b"", {"Content-Type": "audio/wav"})[0] == 400

    assert call(port, "POST", "/transcribe", {"ref_id": rid})[0] == 501
    srv.transcriber = lambda p: "spoken words" if p == path else "?"
    status, _, raw = call(port, "POST", "/transcribe", {"ref_id": rid})
    assert status == 200 and json.loads(raw)["text"] == "spoken words"
    assert call(port, "POST", "/transcribe", {"ref_id": "zz"})[0] == 400


def test_demo_require_login_and_quota(serve, tmp_path):
    srv, port = serve()
    srv.require_login = True
    srv.usage_db = UsageDB(tmp_path / "u.sqlite3", hash_secret=b"k", daily_free_limit=2)
    # anonymous -> 401 on generation, the login splash on /
    assert call(port, "POST", "/generate/stream", {"text": "hi"})[0] == 401
    assert call(port, "GET", "/status")[0] == 401
    assert b"Sign in" in call(port, "GET", "/")[2]

    srv.oauth_parser = lambda h: {"sub": "u1", "username": "u1", "is_pro": False}
    st = json.loads(call(port, "GET", "/status")[2])
    assert st["require_login"] and st["user"] == {"username": "u1", "is_pro": False}
    assert st["usage"]["remaining"] == 2
    for expect in (1, 0):
        status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "xvec_only": True})
        assert status == 200
        done = [e for e in events(raw) if e["type"] == "done"][0]
        assert done["usage"]["remaining"] == expect
    # out of quota -> 429
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi"})
    assert status == 429 and "Daily free limit" in json.loads(raw)["error"]
    assert json.loads(call(port, "GET", "/usage")[2])["usage"]["used_today"] == 2
    # a pro user is not limited
    srv.oauth_parser = lambda h: {"sub": "p1", "username": "p1", "is_pro": True}
    for _ in range(3):
        assert call(port, "POST", "/generate/stream", {"text": "hi"})[0] == 200


def test_demo_invalid_payload_does_not_burn_quota(serve, tmp_path):
    """400-rejected payloads consume no free-tier unit: quota is consumed
    only after validation."""
    srv, port = serve()
    srv.require_login = True
    srv.oauth_parser = lambda h: {"sub": "u1", "username": "u1", "is_pro": False}
    srv.usage_db = UsageDB(tmp_path / "u.sqlite3", hash_secret=b"k", daily_free_limit=2)
    for bad in ({"text": "hi", "chunk_size": 5}, {"text": "hi", "chunk_size": "big"}, {"text": "x" * 2000},
                {"text": ""}):
        assert call(port, "POST", "/generate/stream", bad)[0] == 400, bad
    assert json.loads(call(port, "GET", "/usage")[2])["usage"]["used_today"] == 0
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "xvec_only": True})
    assert status == 200 and events(raw)[-1]["type"] == "done"
    assert json.loads(call(port, "GET", "/usage")[2])["usage"]["used_today"] == 1


def test_demo_web_only_token_gate(serve, monkeypatch):
    monkeypatch.setenv("DEMO_WEB_ONLY", "1")
    monkeypatch.setenv("DEMO_REQUIRE_LOGIN", "0")
    srv, port = serve()
    assert srv.web_only and not srv.require_login
    assert call(port, "POST", "/generate/stream", {"text": "hi"})[0] == 403
    # load the page, read the bootstrapped token
    _, headers, raw = call(port, "GET", "/", headers={"User-Agent": "ua"})
    html = raw.decode()
    assert headers["Cache-Control"] == "no-store"
    marker = "window.__FQ3T_WEB_TOKEN__ = "
    start = html.index(marker) + len(marker)
    token = json.loads(html[start: html.index(";", start)])
    assert html.index(marker) < html.index("</head>")
    ok = {demo.WEB_TOKEN_HEADER: token, "User-Agent": "ua"}
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "xvec_only": True}, ok)
    assert status == 200 and events(raw)[-1]["type"] == "done"
    # cross-site fetch metadata -> 403 even with a token; so does another client
    assert call(port, "POST", "/generate/stream", {"text": "hi"}, dict(ok, **{"sec-fetch-site": "cross-site"}))[0] == 403
    assert call(port, "POST", "/generate/stream", {"text": "hi"}, dict(ok, **{"User-Agent": "other"}))[0] == 403
    assert call(port, "POST", "/generate/stream", {"text": "hi"},
                dict(ok, **{"x-forwarded-for": "10.0.0.9"}))[0] == 403


# -- what the threads add -------------------------------------------------------------------------


def test_client_that_goes_away_stops_the_producer(serve):
    """A client that closes after its first chunk: the write fails, the
    producer stops and closes its generator, the lock is released, and the
    next request completes."""
    stub = _StubModel(chunks=400, delay=0.005)
    srv, port = serve(stub)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate/stream", body=json.dumps({"text": "long"}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    seen = []
    while len(seen) < 2:
        line = resp.readline()
        assert line, seen
        if line.startswith(b"data: "):
            seen.append(json.loads(line[6:])["type"])
    assert seen == ["queued", "chunk"]
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    assert stub.closed.wait(30)  # GeneratorExit inside the model's generator
    assert srv.generation_lock.acquire(timeout=30)
    srv.generation_lock.release()
    assert stub.produced < 400
    stub.chunks = 2
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "after"})
    assert status == 200 and [e["type"] for e in events(raw)] == ["queued", "chunk", "chunk", "done"]


def test_queue_positions(serve):
    """A request that waits is told how many are ahead of it, the one
    generating included; /status counts those waiting."""
    gate = threading.Event()  # the first request generates until the other two wait
    srv, port = serve(_StubModel(gate=gate))
    out = {}
    first = threading.Thread(target=lambda: out.__setitem__("first", call(port, "POST", "/generate/stream",
                                                                          {"text": "one"})))
    first.start()
    deadline = time.monotonic() + 30
    while srv._running == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    waiting = [threading.Thread(target=lambda k: out.__setitem__(k, call(port, "POST", "/generate/stream",
                                                                         {"text": k})), args=(k,))
               for k in ("second", "third")]
    waiting[0].start()
    while srv.queue_depth < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    waiting[1].start()
    while srv.queue_depth < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert json.loads(call(port, "GET", "/status")[2])["queue_depth"] == 2
    gate.set()
    for t in [first] + waiting:
        t.join(timeout=60)
        assert not t.is_alive()
    positions = {k: events(v[2])[0]["position"] for k, v in out.items()}
    assert positions == {"first": 0, "second": 1, "third": 2}
    assert all(events(v[2])[-1]["type"] == "done" for v in out.values())
    assert srv.queue_depth == 0 and srv._running == 0


def test_model_cache_lru_and_load(serve, monkeypatch):
    """MODEL_CACHE_SIZE=1: loading another model evicts the first, which
    then loads again; /load refuses a key outside ACTIVE_MODELS and warms
    the serving configuration; models load on the server's device."""
    monkeypatch.setenv("MODEL_CACHE_SIZE", "1")
    monkeypatch.setenv("ACTIVE_MODELS", "0.6b,Qwen/Qwen3-TTS-12Hz-1.7B-Base")
    loads = []

    def fake_from_pretrained(name, **kw):
        loads.append((name, kw))
        return _StubModel()

    monkeypatch.setattr(FasterQwen3TTS, "from_pretrained", staticmethod(fake_from_pretrained))
    srv, port = serve(models={})
    assert srv.model_ids == {"0.6b": demo.ALL_MODEL_IDS["0.6b"], "1.7b": demo.ALL_MODEL_IDS["1.7b"]}
    status, _, raw = call(port, "POST", "/load", {"model": "0.6b", "quant": "Q8_0", "warmup": True})
    assert status == 200 and json.loads(raw) == {"loaded": ["0.6b (Q8_0)"]}
    first = srv.models.get("0.6b", "Q8_0")
    assert first.warmups == [{"chunk_sizes": (8,), "first_chunk_size": 4}]
    assert json.loads(call(port, "POST", "/load", {"model": "1.7b", "quant": "Q8_0"})[2]) == {"loaded": ["1.7b (Q8_0)"]}
    assert json.loads(call(port, "POST", "/load", {"model": "0.6b", "quant": "Q8_0"})[2]) == {"loaded": ["0.6b (Q8_0)"]}
    assert srv.models.get("0.6b", "Q8_0") is not first  # evicted, then loaded again
    assert [(n, kw["quant"], kw["device"]) for n, kw in loads] == [
        (demo.ALL_MODEL_IDS["0.6b"], "Q8_0", "cpu"), (demo.ALL_MODEL_IDS["1.7b"], "Q8_0", "cpu"),
        (demo.ALL_MODEL_IDS["0.6b"], "Q8_0", "cpu")]
    status, _, raw = call(port, "POST", "/load", {"model": "1.7b-design"})
    assert status == 400 and "ACTIVE_MODELS" in json.loads(raw)["error"]
    assert json.loads(call(port, "GET", "/status")[2])["available_models"] == ["0.6b", "1.7b"]
    # a stream of a model not in the cache loads it too (default quant BF16)
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "model": "1.7b"})
    assert status == 200 and events(raw)[-1]["type"] == "done" and loads[-1][1]["quant"] == "BF16"
    assert srv.models.loaded() == ["1.7b (BF16)"]


def _multipart(fields, boundary="----fq3tBoundary7MA4YWxk"):
    parts = []
    for name, filename, data in fields:
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename else "")
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\nContent-Type: audio/wav\r\n\r\n".encode()
                     + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def test_multipart_upload_and_limits(serve, tmp_path):
    """A multipart `file` field gives the same ref_id as the same bytes
    raw, byte for byte (CR, LF and every other value included); an empty
    upload is 400, a body over 16 MiB is 413 without being read."""
    _, port = serve()
    data = bytes(range(256)) * 64 + b"\r\n--not-a-boundary\r\n\r\r\n\n" + bytes(np.random.default_rng(0).integers(
        0, 256, 5000, dtype=np.uint8))
    raw_id = json.loads(call(port, "POST", "/upload_ref", data, {"Content-Type": "audio/wav"})[2])["ref_id"]
    body, ctype = _multipart([("note", None, b"ignored"), ("file", "ref.wav", data)])
    status, _, raw = call(port, "POST", "/upload_ref", body, {"Content-Type": ctype})
    assert status == 200 and json.loads(raw)["ref_id"] == raw_id == hashlib.sha1(data).hexdigest()
    assert (tmp_path / f"fq3t_ref_{raw_id}.wav").read_bytes() == data
    body, ctype = _multipart([("file", "empty.wav", b"")])
    assert call(port, "POST", "/upload_ref", body, {"Content-Type": ctype})[0] == 400
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.putrequest("POST", "/upload_ref")
    conn.putheader("Content-Type", "audio/wav")
    conn.putheader("Content-Length", str(demo.MAX_UPLOAD_BYTES + 1))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413 and "bytes" in json.loads(resp.read())["error"]
    conn.close()


def test_preset_refs(serve, tmp_path):
    """GET /preset_ref/{id} serves a preset's recording (404 otherwise), and
    a clone request's preset_ref hands the preset to the model as its
    voice_clone_prompt."""
    ref = tmp_path / "preset.wav"
    jax_audio.write_wav(ref, np.zeros(2400, np.float32), 24000)
    preset = {"ref_audio": str(ref), "ref_spk_embedding": [np.zeros(4, np.float32)]}
    srv, port = serve(presets={"calm": preset})
    status, headers, raw = call(port, "GET", "/preset_ref/calm")
    assert status == 200 and raw == ref.read_bytes() and headers["Content-Type"].startswith("audio/")
    assert call(port, "GET", "/preset_ref/nobody")[0] == 404
    assert json.loads(call(port, "GET", "/status")[2])["presets"] == ["calm"]
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "hi", "preset_ref": "calm"})
    assert status == 200 and events(raw)[-1]["type"] == "done"
    assert srv.models.get("0.6b", "BF16").calls[-1]["voice_clone_prompt"] is preset


# -- the real model -------------------------------------------------------------------------------


class _Greedy:
    """A model whose voice-clone streams are greedy (talker and predictor), seed 0."""

    def __init__(self, model):
        self.model = model
        self.sample_rate = model.sample_rate

    def generate_voice_clone_streaming(self, text, language, **kw):
        return self.model.generate_voice_clone_streaming(text, language, **kw, **GREEDY)

    def generate_voice_clone(self, text, language, **kw):  # no subtalker_* here: the seed fixes the predictor
        return self.model.generate_voice_clone(text, language, **kw, do_sample=False, seed=0)


@pytest.fixture(scope="module")
def tiny_models(tiny_config, tmp_path_factory):
    """(JAX model, port model, a reference wav) on one seeded tree, float32."""
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=128)
    rng = np.random.default_rng(5)
    t = np.arange(24000) / 24000
    clip = 0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(t.size)
    path = tmp_path_factory.mktemp("ref") / "ref.wav"
    jax_audio.write_wav(path, clip.astype(np.float32), 24000)
    return jax_model, port, path.read_bytes()


STREAM = {"text": "The quick brown fox.", "mode": "clone", "xvec_only": True, "chunk_size": 8,
          "max_new_tokens": 20}


def test_tiny_model_streams_through_the_demo(serve, tiny_models):
    """The port model at the tiny geometry on the CPU: the SSE chunks equal
    its direct greedy stream from the same recording, converted to PCM16 as
    `_wav_b64` does, exactly; /generate equals the direct non-streaming call."""
    _, port_model, wav = tiny_models
    srv, port = serve(_Greedy(port_model))
    rid = json.loads(call(port, "POST", "/upload_ref", wav, {"Content-Type": "audio/wav"})[2])["ref_id"]
    status, _, raw = call(port, "POST", "/generate/stream", dict(STREAM, uploaded_ref=rid))
    ev = events(raw)
    assert status == 200 and ev[-1]["type"] == "done", ev[-1]
    direct = list(port_model.generate_voice_clone_streaming(
        STREAM["text"], "English", ref_audio=srv.uploaded_refs[rid], xvec_only=True, chunk_size=8,
        first_chunk_size=4, max_new_tokens=20, **GREEDY))
    chunks = [e for e in ev if e["type"] == "chunk"]
    assert [e["chunk_index"] for e in chunks] == [t["chunk_index"] for _, _, t in direct] == list(range(len(direct)))
    for e, (audio, sr, _) in zip(chunks, direct):
        assert e["wav_b64"] == demo._wav_b64(audio, sr)
        pcm, rate = wav_pcm(e["wav_b64"])
        assert rate == sr == 24000 and np.array_equal(pcm, (np.clip(audio, -1, 1) * 32767.0).astype("<i2"))
    assert ev[-1]["audio_s"] == sum(len(a) / sr for a, sr, _ in direct)

    ref_path = srv.uploaded_refs[rid]
    status, _, raw = call(port, "POST", "/generate", {"text": "Hello.", "ref_audio": ref_path, "xvec_only": True,
                                                       "max_new_tokens": 12})
    (audio,), sr = port_model.generate_voice_clone("Hello.", "English", ref_audio=ref_path, xvec_only=True,
                                                   max_new_tokens=12, do_sample=False, seed=0)
    assert status == 200 and json.loads(raw) == {"wav_b64": demo._wav_b64(audio, sr), "sample_rate": 24000}


def test_tiny_model_client_that_goes_away_returns_its_graph_set(serve, tiny_models):
    """A client of the real model that closes after its first chunk: the
    producer stops and closes the generator, so the session's graph set is
    back in the registry (no lease left) before the next request runs."""
    from faster_qwen3_tts_tpu_torch.engine import graphs

    _, port_model, _ = tiny_models
    xvec = np.random.default_rng(0).standard_normal(2048).astype(np.float32)
    srv, port = serve(_Greedy(port_model), presets={"xvec": {"ref_spk_embedding": [xvec]}})
    reg = graphs.registry_for(port_model.params)
    before = reg.leased()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate/stream", body=json.dumps({
        "text": "A long request that the client leaves.", "xvec_only": True, "max_new_tokens": 64,
        "preset_ref": "xvec"}), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    line = b"?"
    while line and not line.startswith(b'data: {"type": "chunk"'):
        line = resp.readline()
    assert line, "the stream ended before its first chunk"
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    assert srv.generation_lock.acquire(timeout=60)
    try:
        assert reg.leased() == before
    finally:
        srv.generation_lock.release()
    status, _, raw = call(port, "POST", "/generate/stream", {"text": "Next.", "preset_ref": "xvec",
                                                             "max_new_tokens": 8})
    assert status == 200 and events(raw)[-1]["type"] == "done" and reg.leased() == before


def _jax_demo_run(jax_demo, wav, payload):
    """The JAX demo (aiohttp TestServer) on one upload and one stream -> the SSE events."""
    from aiohttp.test_utils import TestClient, TestServer

    async def body():
        async with TestClient(TestServer(jax_demo.make_app())) as client:
            r = await client.post("/upload_ref", data=wav, headers={"Content-Type": "audio/wav"})
            rid = (await r.json())["ref_id"]
            r = await client.post("/generate/stream", json=dict(payload, uploaded_ref=rid))
            assert r.status == 200
            return rid, events(await r.read())

    return asyncio.new_event_loop().run_until_complete(body())


def test_demo_matches_the_jax_demo(serve, tiny_models, monkeypatch):
    """One seeded tree, a greedy wrapper in each cache, the same uploaded
    reference with xvec_only: the port's demo over its socket and the JAX
    demo over aiohttp give the same event types, chunk_index sequence, chunk
    lengths and audio_s; PCM16 within 4 LSB (1e-4 of full scale)."""
    pytest.importorskip("aiohttp")
    import servers.demo_server as jax_demo

    jax_model, port_model, wav = tiny_models

    class _Cache:
        def get(self, key, quant):
            return _Greedy(jax_model)

        def loaded(self):
            return ["tiny"]

    monkeypatch.setattr(jax_demo, "_models", _Cache())
    monkeypatch.setattr(jax_demo, "_uploaded_refs", {})
    monkeypatch.setattr(jax_demo, "REQUIRE_LOGIN", False)
    monkeypatch.setattr(jax_demo, "WEB_ONLY_MODE", False)
    jax_rid, jax_ev = _jax_demo_run(jax_demo, wav, STREAM)

    _, port = serve(_Greedy(port_model))
    rid = json.loads(call(port, "POST", "/upload_ref", wav, {"Content-Type": "audio/wav"})[2])["ref_id"]
    _, _, raw = call(port, "POST", "/generate/stream", dict(STREAM, uploaded_ref=rid))
    ev = events(raw)

    assert rid == jax_rid
    assert [e["type"] for e in ev] == [e["type"] for e in jax_ev]
    assert ev[0] == jax_ev[0] == {"type": "queued", "position": 0}
    chunks = [e for e in ev if e["type"] == "chunk"]
    jax_chunks = [e for e in jax_ev if e["type"] == "chunk"]
    assert len(chunks) >= 3 and [e["chunk_index"] for e in chunks] == [e["chunk_index"] for e in jax_chunks]
    for e, je in zip(chunks, jax_chunks):
        assert set(e) == set(je)
        pcm, sr = wav_pcm(e["wav_b64"])
        jpcm, jsr = wav_pcm(je["wav_b64"])
        assert sr == jsr == 24000 and pcm.size == jpcm.size > 0
        assert np.abs(pcm.astype(np.int32) - jpcm.astype(np.int32)).max() <= 4
    assert set(ev[-1]) == set(jax_ev[-1]) and ev[-1]["audio_s"] == jax_ev[-1]["audio_s"]
