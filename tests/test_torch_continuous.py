"""Continuous batching on the port (`serving.ContinuousBatcher`) against the
JAX package's batcher, same weights, same submission schedules.

Tiny geometry, float32, greedy talker and predictor, on the CPU. For each
schedule (all upfront, a late joiner, slot reuse, `run(wait=True)` across an
idle gap, a smaller solo first chunk, the mature-lane seam, ICL lanes, EOS on
a chunk boundary, cancel, an oversized request) the port must yield the same
(stream, chunk, slot) sequence with the same timing keys as the JAX batcher,
audio within 1e-4, and each stream's audio within 1e-4 of its solo stream
on the port."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import serving as jax_serving
from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import serving, weights
from faster_qwen3_tts_tpu_torch.engine import graphs
from faster_qwen3_tts_tpu_torch.engine.generate import CONTEXT_FRAMES
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

torch.set_num_threads(1)
MAXNEW, CHUNK = 12, 4
GREEDY = dict(do_sample=False, seed=0, subtalker_dosample=False)
SEQ_KEYS = ("chunk_index", "slot", "chunk_steps", "total_steps_so_far", "is_final", "solo_first_chunk",
            "cancelled")


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=128)
    return jax_model, port


def _xvec(seed):
    rng = np.random.default_rng(seed)
    return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [True], "icl_mode": [False], "ref_code": [None]}


def _icl(seed, frames):
    rng = np.random.default_rng(seed)
    return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [False], "icl_mode": [True],
            "ref_code": [rng.integers(0, 2048, size=(frames, 16)).astype(np.int32)]}


TEXTS = ["Hello world.", "A different second sentence.", "Third stream content here.", "Fourth one."]


def _requests(n):
    return [{"text": TEXTS[i % 4], "xvec_only": True, "voice_clone_prompt": _xvec(i)} for i in range(n)]


def _batcher(model, max_slots, **kw):
    kw = dict(dict(chunk_size=CHUNK, max_new_tokens=MAXNEW), **kw)
    return model.continuous_batcher(max_slots=max_slots, **kw, **GREEDY)


def _solo(model, req, chunk_size=CHUNK, max_new_tokens=MAXNEW, **kw):
    return np.concatenate([a for a, _, _ in model.generate_voice_clone_streaming(
        req["text"], "English", voice_clone_prompt=req["voice_clone_prompt"], ref_text=req.get("ref_text", ""),
        xvec_only=bool(req.get("xvec_only", False)), chunk_size=chunk_size, max_new_tokens=max_new_tokens,
        **kw, **GREEDY)])


def _upfront(model, reqs, max_slots, **kw):
    cb = _batcher(model, max_slots, **kw)
    for r in reqs:
        cb.submit(r)
    return list(cb.run())


def _per_sid(out):
    got = {}
    for sid, audio, sr, _ in out:
        assert sr == 24000 and audio.dtype == np.float32
        got.setdefault(sid, []).append(audio)
    return {sid: np.concatenate(parts) for sid, parts in got.items()}


def _assert_same_run(out, ref, order=True):
    """The port's yields against the JAX batcher's: the same sequence of
    (stream, chunk, slot, steps, flags) and timing keys (order=False: the
    same per stream), audio within 1e-4."""
    if order:
        assert [(s, [t.get(k) for k in SEQ_KEYS]) for s, _, _, t in out] == \
            [(s, [t.get(k) for k in SEQ_KEYS]) for s, _, _, t in ref]
        assert [set(t) for *_, t in out] == [set(t) for *_, t in ref]
        for (_, a, _, t), (_, ja, _, _) in zip(out, ref):
            assert a.shape == np.shape(ja)
            np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
    got, want = _per_sid(out), _per_sid(ref)
    assert set(got) == set(want)
    for sid in want:
        assert got[sid].shape == want[sid].shape, sid
        np.testing.assert_allclose(got[sid], want[sid], atol=1e-4, rtol=0)
    for sid in want:  # every stream ends once, with is_final
        finals = [t for s, _, _, t in out if s == sid and t["is_final"]]
        assert len(finals) == 1 and [t for s, *_, t in out if s == sid][-1]["is_final"]


def _assert_solo(port, out, reqs, **solo_kw):
    got = _per_sid(out)
    for sid, req in enumerate(reqs):
        want = _solo(port, req, **solo_kw)
        assert got[sid].shape == want.shape, sid
        np.testing.assert_allclose(got[sid], want, atol=1e-4, rtol=0)


def test_all_submitted_upfront(models):
    jax_model, port = models
    reqs = _requests(3)
    out = _upfront(port, reqs, 3)
    _assert_same_run(out, _upfront(jax_model, reqs, 3))
    _assert_solo(port, out, reqs)
    first = [t for *_, t in out if t.get("solo_first_chunk")]
    assert len(first) == 3 and all(t["chunk_steps"] == CHUNK == t["total_steps_so_far"] for t in first)
    assert all(t["ttfa_from_submit_ms"] >= t["admit_wait_ms"] >= 0.0 for *_, t in out)


def _late_join(model, reqs):
    cb = _batcher(model, 2)
    cb.submit(reqs[0])
    out, joined = [], False
    for item in cb.run():
        out.append(item)
        if not joined and item[3]["chunk_index"] >= 1:
            cb.submit(reqs[1])
            joined = True
    assert joined, "the first stream ended before the second was submitted"
    return out


def test_late_join_into_running_batch(models):
    jax_model, port = models
    reqs = _requests(2)
    out = _late_join(port, reqs)
    _assert_same_run(out, _late_join(jax_model, reqs))
    _assert_solo(port, out, reqs)


def test_slot_reuse_after_finish(models):
    """More streams than lanes: finished lanes are reused."""
    jax_model, port = models
    reqs = _requests(4)
    out = _upfront(port, reqs, 2)
    _assert_same_run(out, _upfront(jax_model, reqs, 2))
    assert {t["slot"] for *_, t in out} == {0, 1}
    _assert_solo(port, out, reqs)


def _idle_gap(model, reqs):
    cb = _batcher(model, 2)
    cb.submit(reqs[0])

    def feeder():
        time.sleep(0.5)
        cb.submit(reqs[1])
        cb.close()

    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    out = list(cb.run(wait=True))
    th.join(timeout=30)
    assert not th.is_alive()
    return out


def test_run_wait_serves_across_an_idle_gap_until_close(models):
    """Server mode: a request submitted from another thread after the first
    stream drained is still served; close() ends the pump."""
    jax_model, port = models
    reqs = _requests(2)
    out = _idle_gap(port, reqs)
    assert {s for s, *_ in out} == {0, 1}
    _assert_same_run(out, _idle_gap(jax_model, reqs), order=False)
    _assert_solo(port, out, reqs)


def test_smaller_solo_first_chunk(models):
    jax_model, port = models
    reqs = _requests(2)
    out = _upfront(port, reqs, 2, first_chunk_size=2)
    _assert_same_run(out, _upfront(jax_model, reqs, 2, first_chunk_size=2))
    assert [t["chunk_steps"] for *_, t in out if t.get("solo_first_chunk")] == [2, 2]
    _assert_solo(port, out, reqs)


LONG = CONTEXT_FRAMES + 2 * 8  # host-vocoded chunks, then device-vocoded ones


def test_mature_lanes_take_the_device_vocode(models, monkeypatch):
    """Streams longer than the vocoder context switch from their host
    vocoder to the batched device window; the seam is sample-exact."""
    jax_model, port = models
    reqs = _requests(2)
    kw = dict(chunk_size=8, max_new_tokens=LONG, min_new_tokens=LONG)
    windows = []
    vocode = serving.fused_stream._vocode_window
    monkeypatch.setattr(serving.fused_stream, "_vocode_window", lambda *a: windows.append(1) or vocode(*a))
    out = _upfront(port, reqs, 2, **kw)
    assert windows, "no lane reached the device vocode"
    _assert_same_run(out, _upfront(jax_model, reqs, 2, **kw))
    got = _per_sid(out)
    assert all(len(a) > CONTEXT_FRAMES * port.config.codec.total_upsample for a in got.values())
    _assert_solo(port, out, reqs, **kw)


def _dirty_then_probe(model, reqs, kw):
    cb = _batcher(model, 1, **kw)
    cb.submit(reqs[1])
    for _ in cb.run():  # slot 0's window now holds another stream's frames
        pass
    sid = cb.submit(reqs[0])
    return [item for item in cb.run() if item[0] == sid]


def test_mature_lane_seam_after_a_previous_occupant(models):
    """The window rows seeded at admission make the first device-vocoded
    chunk exact even when the lane's previous occupant left its frames."""
    jax_model, port = models
    reqs = _requests(2)
    kw = dict(chunk_size=8, max_new_tokens=LONG, min_new_tokens=LONG)
    out = _dirty_then_probe(port, reqs, kw)
    _assert_same_run(out, _dirty_then_probe(jax_model, reqs, kw))
    want = _solo(port, reqs[0], **kw)
    np.testing.assert_allclose(np.concatenate([a for _, a, _, _ in out]), want, atol=1e-4, rtol=0)


def test_icl_lanes_stay_on_their_host_vocoders(models):
    """ICL lanes (a short and a long reference) beside a mature x-vector lane."""
    jax_model, port = models
    reqs = [_requests(1)[0],
            {"text": "Second text.", "voice_clone_prompt": _icl(5, 6), "ref_text": "Ref words."},
            {"text": "Third text here.", "voice_clone_prompt": _icl(6, 30), "ref_text": "Ref three."}]
    kw = dict(chunk_size=8, max_new_tokens=LONG, min_new_tokens=LONG)
    out = _upfront(port, reqs, 3, **kw)
    _assert_same_run(out, _upfront(jax_model, reqs, 3, **kw))


def test_eos_on_a_chunk_boundary_still_yields_is_final(models, monkeypatch):
    """From the second chunk (the first pool chunk after the solo one) every
    lane reports zero valid frames and done: the stream still gets its
    is_final terminal."""
    jax_model, port = models
    real_jax, real_port = jax_serving.aot.call, graphs.GraphSet.run_chunk
    calls = {"jax": 0, "port": 0}

    def fake_jax(name, fn, **kw):
        out = real_jax(name, fn, **kw)
        if name != "decode_chunk":
            return out
        calls["jax"] += 1
        st, packed = out
        if calls["jax"] >= 2:
            packed = packed.at[:, :, -2].set(0).at[:, :, -1].set(1)
            st = st._replace(done=jnp.ones_like(st.done))
        return st, packed

    def fake_port(gset, *a, **kw):
        packed = real_port(gset, *a, **kw)
        calls["port"] += 1
        if calls["port"] >= 2:  # the chunk's packed rows and the set's state are static buffers
            packed[:, :, -2], packed[:, :, -1] = 0, 1
            gset.state.done.fill_(True)
        return packed

    monkeypatch.setattr(jax_serving.aot, "call", fake_jax)
    monkeypatch.setattr(graphs.GraphSet, "run_chunk", fake_port)
    req = _requests(1)
    out, ref = _upfront(port, req, 1), _upfront(jax_model, req, 1)
    _assert_same_run(out, ref)
    assert out[-1][3]["is_final"] and out[-1][3]["chunk_steps"] == 0


def _cancel_first(model, reqs):
    cb = _batcher(model, 2, max_new_tokens=64)
    sid0 = cb.submit(reqs[0])
    cb.submit(reqs[1])
    out = []
    for item in cb.run():
        out.append(item)
        if item[0] == sid0 and item[3]["chunk_index"] == 0:
            cb.cancel(sid0)
    return out


def test_cancel_releases_the_lane(models):
    jax_model, port = models
    reqs = _requests(2)
    out = _cancel_first(port, reqs)
    _assert_same_run(out, _cancel_first(jax_model, reqs))
    finals = {s: t for s, _, _, t in out if t["is_final"]}
    assert finals[0].get("cancelled") is True and finals[0]["total_steps_so_far"] <= 2 * CHUNK
    assert "cancelled" not in finals[1]
    got = _per_sid(out)
    assert len(got[1]) > len(got[0])


def _oversized(model, reqs):
    cb = _batcher(model, 2)
    cb.submit(reqs[0])
    cb.submit(dict(reqs[0], text="word " * 3000))  # trailing text far over the pool's bucket
    return list(cb.run())


def test_oversized_request_fails_alone(models):
    jax_model, port = models
    reqs = _requests(1)
    out = _oversized(port, reqs)
    _assert_same_run(out, _oversized(jax_model, reqs))
    finals = {s: t for s, _, _, t in out if t["is_final"]}
    assert "exceeds the pool's bucket" in finals[1]["error"] and finals[1]["slot"] == -1
    assert "error" not in finals[0]
    got = _per_sid(out)
    assert got[1].size == 0 and got[0].size > 0


def test_submit_and_cancel_from_many_threads(models):
    """Concurrent submits get distinct ids and are all queued; cancelled
    pending requests are dropped at the boundary and the rest kept."""
    _, port = models
    cb = _batcher(port, 2)
    n_threads, per_thread = 16, 25
    sids, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            try:
                for _ in range(per_thread):
                    sid = cb.submit({"text": "x"})
                    sids.append(sid)
                    if sid % 3 == 0:
                        cb.cancel(sid)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads) and not errors
    finally:
        sys.setswitchinterval(old)
    n = n_threads * per_thread
    assert sorted(sids) == list(range(n)) and len(cb._pending) == n
    assert cb._take_cancelled() == []  # no lane is running
    assert sorted(p.sid for p in cb._pending) == [s for s in range(n) if s % 3]
    assert not cb._cancelled


def test_batcher_signature_matches_jax():
    import inspect

    assert list(inspect.signature(serving.ContinuousBatcher).parameters) == \
        list(inspect.signature(jax_serving.ContinuousBatcher).parameters)
    for name in ("submit", "cancel", "close", "run"):
        assert list(inspect.signature(getattr(serving.ContinuousBatcher, name)).parameters) == \
            list(inspect.signature(getattr(jax_serving.ContinuousBatcher, name)).parameters)
