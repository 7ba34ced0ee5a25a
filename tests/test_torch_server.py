"""The port's OpenAI-compatible server (faster_qwen3_tts_tpu_torch/server.py).

The route contracts of tests/test_servers.py (the JAX package's aiohttp
server) held against the port's standard-library server: the same stub
engines (wav, errors, batched, a cancelled slot that never wedges the
scheduler, power-of-two padding, continuous with a failing admission, mp3),
served in-process by `make_server(..., port=0)` and read with urllib. Then a
client that goes away mid-stream, and one tiny real model on the CPU
answering continuous requests end to end.
"""
import http.client
import json
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch import server as srv
from faster_qwen3_tts_tpu_torch.utils.audio import float_to_pcm16

torch.set_num_threads(1)
VOICES = {"alloy": {"ref_audio": None, "xvec_only": True}}


class _StubModel:
    sample_rate = 24000

    def generate_voice_clone_streaming(self, text, language, **kw):
        chunk = kw.get("chunk_size", 8)
        for i in range(3):
            yield (np.zeros(chunk * 1920, np.float32), self.sample_rate,
                   {"chunk_index": i, "chunk_steps": chunk, "total_steps_so_far": (i + 1) * chunk,
                    "is_final": i == 2})

    def generate_voice_clone(self, text, language, **kw):
        return [np.zeros(1920, np.float32)], self.sample_rate


class _StubBatchModel(_StubModel):
    """Records every batched call; yields 2 chunks per slot, interleaved."""

    def __init__(self):
        self.batch_calls = []

    def generate_voice_clone_streaming_batch(self, requests, chunk_size=8, **kw):
        self.batch_calls.append([dict(r) for r in requests])
        for i in range(2):
            for s in range(len(requests)):
                yield (s, np.full(chunk_size * 1920, 0.01 * (s + 1), np.float32), self.sample_rate,
                       {"chunk_index": i, "slot": s, "is_final": i == 1})


class _FakeBatcher:
    """A ContinuousBatcher stand-in: each request streams `chunks` chunks of
    0.01 * (sid + 1); text "boom" fails the pump; cancel ends a stream with
    a `cancelled` terminal at the next chunk."""

    def __init__(self, model, max_slots, chunk_size, chunks):
        self.model, self.max_slots, self.chunk_size, self.chunks = model, max_slots, chunk_size, chunks
        self._pending, self._next, self._closed = [], 0, False
        self._cancelled, self._live = set(), 0
        self.requests = []

    def submit(self, request, **_kw):
        sid = self._next
        self._next += 1
        self.requests.append(request)
        self._pending.append((sid, request))
        return sid

    def cancel(self, sid):
        self._cancelled.add(sid)

    def close(self):
        self._closed = True

    def active(self):
        return self._live

    def run(self, wait=False):
        while not self._closed:
            if not self._pending:
                time.sleep(0.005)
                continue
            sid, req = self._pending.pop(0)
            if req["text"] == "boom":
                raise RuntimeError("bad voice config")
            self._live = 1
            for i in range(self.chunks):
                if sid in self._cancelled:
                    self._live = 0
                    yield sid, np.zeros(0, np.float32), 24000, {"slot": 0, "is_final": True, "cancelled": True}
                    break
                time.sleep(0.002)
                self._live = int(i + 1 < self.chunks)
                yield (sid, np.full(self.chunk_size * 1920, 0.01 * (sid + 1), np.float32), 24000,
                       {"chunk_index": i, "slot": 0, "is_final": i == self.chunks - 1})


class _StubContinuousModel(_StubModel):
    def __init__(self, chunks=2):
        self.chunks = chunks
        self.batchers = []

    def continuous_batcher(self, max_slots=8, chunk_size=8, **kw):
        self.batchers.append(_FakeBatcher(self, max_slots, chunk_size, self.chunks))
        return self.batchers[-1]


@pytest.fixture
def serve():
    """serve(model, **make_server kwargs) -> base URL; every server stops after the test."""
    started = []

    def start(model, **kw):
        s = srv.make_server(model, "127.0.0.1", 0, **kw)
        t = threading.Thread(target=s.serve_forever, daemon=True)
        t.start()
        started.append((s, t))
        return f"http://127.0.0.1:{s.server_address[1]}", s

    yield start
    for s, t in started:
        s.shutdown()
        s.server_close()
        t.join(timeout=10)


def post(url, body, timeout=60):
    """-> (status, headers, body bytes); a JSON body, or raw bytes."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + "/v1/audio/speech", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def test_speech_wav_and_health(serve):
    url, _ = serve(_StubModel(), voices=VOICES)
    status, headers, body = post(url, {"input": "hi", "voice": "alloy"})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert headers["Transfer-Encoding"] == "chunked"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and len(body) == 44 + 3 * 8 * 1920 * 2
    health = get(url, "/health")
    assert health == {"status": "ok", "model_loaded": True, "sample_rate": 24000, "voices": ["alloy"],
                      "batched": False, "max_batch": 1, "continuous": False, "max_slots": None}


def test_speech_errors(serve):
    url, _ = serve(_StubModel(), voices=VOICES)
    status, _, body = post(url, {"voice": "alloy"})
    assert status == 400 and "input" in json.loads(body)["error"]
    assert post(url, {"input": "x", "response_format": "ogg"})[0] == 400
    # chunk_size values outside the warmed set, and non-integers, are refused
    for bad in (5, 0, -8, "big", None):
        assert post(url, {"input": "x", "voice": "alloy", "chunk_size": bad})[0] == 400, bad
    status, headers, body = post(url, {"input": "x", "voice": "alloy", "chunk_size": 4, "response_format": "pcm"})
    assert status == 200 and headers["Content-Type"] == "audio/pcm" and len(body) == 3 * 4 * 1920 * 2
    assert post(url, b"not json")[0] == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nowhere", timeout=30)
    assert e.value.code == 404


def test_unknown_voice_without_a_registry_is_refused(serve):
    url, _ = serve(_StubModel())
    status, _, body = post(url, {"input": "x", "voice": "nobody"})
    assert status == 400 and "no voices registered" in json.loads(body)["error"]


def test_batched_serving(serve):
    """batch mode: concurrent requests coalesce into ONE lockstep engine
    batch, and each response gets exactly its own slot's audio."""
    stub = _StubBatchModel()
    url, _ = serve(stub, voices=VOICES, batch=4, batch_window_s=0.5)
    out = {}
    threads = [threading.Thread(target=lambda k, b: out.__setitem__(k, post(url, b)), args=(k, b)) for k, b in
               (("first", {"input": "first", "voice": "alloy"}),
                ("second", {"input": "second", "voice": "alloy", "response_format": "pcm"}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert out["first"][0] == 200 and out["second"][0] == 200
    health = get(url, "/health")
    assert health["batched"] and health["max_batch"] == 4
    assert len(stub.batch_calls) == 1
    texts = [r["text"] for r in stub.batch_calls[0]]
    assert sorted(texts) == ["first", "second"]  # two real requests: bucket 2, no padding
    b1, b2 = out["first"][2], out["second"][2]
    assert b1[:4] == b"RIFF"
    pcm1, pcm2 = np.frombuffer(b1[44:], np.int16), np.frombuffer(b2, np.int16)
    slot1 = texts.index("first")
    exp = [np.frombuffer(float_to_pcm16(np.full(1, 0.01 * (s + 1), np.float32)), np.int16)[0] for s in (0, 1)]
    assert pcm1.size == pcm2.size == 2 * 8 * 1920
    assert int(pcm1[0]) == exp[slot1] and int(pcm2[0]) == exp[1 - slot1]


def test_batch_cancelled_slot_never_wedges_scheduler():
    """A consumer that went away never blocks the scheduler: its slot's
    chunks are dropped, the other slot streams, and both get a terminal."""
    sched = srv.BatchScheduler.__new__(srv.BatchScheduler)  # no thread
    sched.model, sched.max_batch = _StubBatchModel(), 4
    sched.engine_lock, sched.max_new_tokens = threading.Lock(), 2048
    ok, dead = srv._BatchJob({"text": "alive"}, 8), srv._BatchJob({"text": "gone"}, 8)
    dead.cancelled = True
    sched._run([ok, dead])
    items = [ok.out_q.get_nowait() for _ in range(3)]
    assert items[-1] is None and all(isinstance(b, bytes) for b in items[:2])
    drained = []
    while not dead.out_q.empty():
        drained.append(dead.out_q.get_nowait())
    assert drained and all(d is None for d in drained)


def test_batch_pads_to_pow2(serve):
    """3 concurrent requests pad to the bucket of 4 by repeating slot 0;
    the padded slot's audio is dropped."""
    stub = _StubBatchModel()
    url, _ = serve(stub, voices=VOICES, batch=8, batch_window_s=0.5)
    out = [None] * 3
    threads = [threading.Thread(target=lambda i: out.__setitem__(i, post(
        url, {"input": f"t{i}", "voice": "alloy", "response_format": "pcm"})), args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(o[0] == 200 for o in out)
    assert len(stub.batch_calls) == 1
    reqs = stub.batch_calls[0]
    assert len(reqs) == 4 and reqs[3]["text"] == reqs[0]["text"]
    assert all(np.frombuffer(o[2], np.int16).size == 2 * 8 * 1920 for o in out)


def test_continuous_serving(serve):
    """continuous mode: each response gets its own stream's audio; a
    request that breaks the pump errors only itself, and the restarted
    pump serves the next request."""
    stub = _StubContinuousModel()
    url, s = serve(stub, voices=VOICES, continuous=4)
    out = {}
    threads = [threading.Thread(target=lambda k, b: out.__setitem__(k, post(url, b)), args=(k, b)) for k, b in
               (("first", {"input": "first", "voice": "alloy"}),
                ("second", {"input": "second", "voice": "alloy", "response_format": "pcm"}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    health = get(url, "/health")
    assert health["continuous"] and health["max_slots"] == 4
    b1, b2 = out["first"][2], out["second"][2]
    assert b1[:4] == b"RIFF"
    pcm1, pcm2 = np.frombuffer(b1[44:], np.int16), np.frombuffer(b2, np.int16)
    assert pcm1.size == pcm2.size == 2 * 8 * 1920
    assert abs(int(pcm1[0])) != abs(int(pcm2[0]))  # distinct streams
    assert post(url, {"input": "boom", "voice": "alloy", "response_format": "pcm"})[2] == b""
    status, _, b3 = post(url, {"input": "after", "voice": "alloy", "response_format": "pcm"})
    assert status == 200 and np.frombuffer(b3, np.int16).size == 2 * 8 * 1920
    assert len(stub.batchers) == 2  # restarted once


def test_client_that_goes_away_releases_its_lane(serve):
    """A client that closes after its first audio bytes: the write fails,
    the job is cancelled and the batcher's lane is released."""
    stub = _StubContinuousModel(chunks=400)
    _, s = serve(stub, voices=VOICES, continuous=4)
    conn = http.client.HTTPConnection("127.0.0.1", s.server_address[1], timeout=30)
    conn.request("POST", "/v1/audio/speech", body=json.dumps({"input": "long", "voice": "alloy"}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and len(resp.read(45)) == 45  # the wav header and the first audio
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    deadline = time.monotonic() + 30
    while (s.continuous.cancelled_streams == 0 or s.continuous.live_lanes()) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert s.continuous.cancelled_streams == 1 and s.continuous.live_lanes() == 0
    assert stub.batchers[0]._cancelled == {0}


def test_mp3(serve, monkeypatch):
    """mp3 through a stub lameenc; then with no encoder installed, 501. In
    continuous mode an mp3 request rides the batcher."""
    class _FakeEnc:
        def set_bit_rate(self, b): self.b = b
        def set_in_sample_rate(self, s): self.s = s
        def set_channels(self, c): self.c = c
        def set_quality(self, q): self.q = q
        def encode(self, pcm): return b"MP3" + bytes([len(pcm) % 251])
        def flush(self): return b"END"

    fake = types.ModuleType("lameenc")
    fake.Encoder = _FakeEnc
    monkeypatch.setitem(sys.modules, "lameenc", fake)
    url, _ = serve(_StubModel(), voices=VOICES)
    status, headers, body = post(url, {"input": "hi", "voice": "alloy", "response_format": "mp3"})
    assert status == 200 and headers["Content-Type"] == "audio/mpeg"
    assert body.startswith(b"MP3") and body.endswith(b"END")

    stub = _StubContinuousModel()
    curl, _ = serve(stub, voices=VOICES, continuous=2)
    status, _, body = post(curl, {"input": "via the pool", "voice": "alloy", "response_format": "mp3"})
    assert status == 200 and body.startswith(b"MP3")
    assert [r["text"] for r in stub.batchers[0].requests] == ["via the pool"]

    monkeypatch.setitem(sys.modules, "pydub", None)  # ImportError
    monkeypatch.setitem(sys.modules, "lameenc", None)
    status, _, body = post(url, {"input": "hi", "voice": "alloy", "response_format": "mp3"})
    assert status == 501 and "encoder" in json.loads(body)["error"]


def test_voices_file(tmp_path, serve):
    path = tmp_path / "voices.json"
    path.write_text(json.dumps({"nova": {"ref_audio": "ref.wav", "ref_text": "Hi.", "language": "English"}}))
    url, s = serve(_StubModel(), voices=str(path))
    assert get(url, "/health")["voices"] == ["nova"]
    assert srv._voice_request("x", s.resolve_voice("someone else"))["ref_text"] == "Hi."


def test_batch_and_continuous_exclude_each_other():
    with pytest.raises(ValueError, match="exclusive"):
        srv.make_server(_StubModel(), "127.0.0.1", 0, batch=2, continuous=2)


def test_tiny_model_serves_continuous_requests_end_to_end(serve):
    """The real port on the CPU (tiny geometry, float32): two concurrent
    continuous requests, wav and pcm, stream 24 kHz PCM16 of whole frames."""
    import dataclasses

    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    model = FasterQwen3TTS(weights.init_all(cfg, dtype=torch.float32, device="cpu"), cfg,
                           PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    voices = {"x": {"voice_clone_prompt": {"ref_spk_embedding": [
        np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}, "xvec_only": True}}
    url, s = serve(model, voices=voices, continuous=2, max_new_tokens=12)
    out = {}
    threads = [threading.Thread(target=lambda f: out.__setitem__(f, post(url, {
        "input": f"Hello in {f}.", "voice": "x", "response_format": f})), args=(f,)) for f in ("wav", "pcm")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    (ws, _, wav), (ps, _, pcm) = out["wav"], out["pcm"]
    assert ws == ps == 200
    assert wav[:4] == b"RIFF" and int.from_bytes(wav[24:28], "little") == 24000
    for body in (wav[44:], pcm):
        assert len(body) > 0 and len(body) % 2 == 0
        samples = np.frombuffer(body, np.int16)
        assert samples.size <= 12 * 1920 and np.abs(samples).max() > 0
    assert s.continuous.live_lanes() == 0


@pytest.mark.parametrize("flags, expect", [([], ("torch", False)), (["--backend", "jax"], ("jax", False)),
                                           (["--backend", "native", "--fuse-qkv"], ("native", True))])
def test_backend_and_fuse_flags_reach_from_pretrained(monkeypatch, flags, expect):
    """`--backend` (as servers/openai_server.py has it; `from_pretrained`
    takes `jax` as this engine) and `--fuse-qkv` reach `from_pretrained`."""
    seen = {}

    def fake(model, **kw):
        seen.update(kw)
        raise RuntimeError("stop before the model is built")

    monkeypatch.setattr("faster_qwen3_tts_tpu_torch.model.FasterQwen3TTS.from_pretrained", fake)
    with pytest.raises(RuntimeError, match="stop before"):
        srv.main(["--model", "ckpt", "--device", "cpu", *flags])
    assert (seen["backend"], seen["fuse_qkv"]) == expect


def test_server_serves_from_a_deploy_bundle(tmp_path, monkeypatch):
    """`server.main(["--model", <bundle dir>])` restarts from a deploy bundle
    with no code of its own and answers a request (tiny geometry, CPU)."""
    import dataclasses

    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.ops import quant
    from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    FasterQwen3TTS(weights.init_all(cfg, device="cpu", quant="int8"), cfg, PromptTokenizer(ByteTokenizer()),
                   max_seq_len=128).save_deploy_bundle(str(tmp_path / "bundle"))
    from faster_qwen3_tts_tpu_torch.utils.audio import write_wav

    write_wav(tmp_path / "ref.wav", (0.3 * np.sin(np.arange(12000) / 20)).astype(np.float32), 24000)
    voices = tmp_path / "voices.json"
    voices.write_text(json.dumps({"x": {"ref_audio": str(tmp_path / "ref.wav"), "xvec_only": True}}))
    started = []
    real = srv.make_server

    def capture(*a, **kw):
        started.append(real(*a, **kw))
        return started[-1]

    monkeypatch.setattr(srv, "make_server", capture)
    t = threading.Thread(target=srv.main, args=([
        "--model", str(tmp_path / "bundle"), "--device", "cpu", "--quant", "Q8_0", "--host", "127.0.0.1",
        "--port", "0", "--max-new-tokens", "8", "--voices", str(voices)],), daemon=True)
    t.start()
    deadline = time.time() + 120
    while not started and time.time() < deadline and t.is_alive():
        time.sleep(0.05)
    assert started, "the server did not start"
    s = started[0]
    try:
        url = f"http://127.0.0.1:{s.server_address[1]}"
        status, _, body = post(url, {"input": "Hello from a bundle.", "voice": "x", "response_format": "pcm"})
        assert status == 200 and len(body) > 0 and len(body) % 2 == 0
        assert np.abs(np.frombuffer(body, np.int16)).max() > 0
        assert s.model.load_phases["transfer_mb"] > 0
        assert isinstance(s.model.params["talker"]["layers"]["wq"], quant.QuantizedLinear)
    finally:
        s.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()
