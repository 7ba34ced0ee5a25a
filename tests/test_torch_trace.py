"""The port's span recorder (`utils.trace`): parents and request ids, the
ring and its overwritten count, the off switch, writes from several threads,
the offset onto the profiler's clock, and the spans a tiny solo stream and a
tiny continuous batcher record on the CPU."""
import dataclasses
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.utils import trace
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

torch.set_num_threads(1)


def test_nesting_gives_parents_and_request_ids():
    rec = trace.Recorder()
    with rec.span("outer", rid=7, value=1) as outer:
        with rec.span("inner") as inner:
            rec.add("stamped", 5, 6)
        sp = rec.begin("opened", rid=9)
        with sp:
            with rec.span("child"):
                pass
    sp.end(2.5)
    with rec.span("top"):
        pass
    got = {r.name: r for r in rec.snapshot()[0]}
    assert got["outer"].parent is None and got["outer"].rid == 7 and got["outer"].value == 1
    assert (got["inner"].parent, got["inner"].rid) == (outer.id, 7)
    assert (got["stamped"].parent, got["stamped"].rid, got["stamped"].t0, got["stamped"].t1) == (inner.id, 7, 5, 6)
    assert (got["opened"].parent, got["opened"].rid, got["opened"].value) == (outer.id, 9, 2.5)
    assert (got["child"].parent, got["child"].rid) == (sp.id, 9)
    assert got["top"].parent is None and got["top"].rid is None
    assert got["opened"].t1 >= got["child"].t1 >= got["child"].t0 >= got["opened"].t0
    assert rec.current_rid() is None and rec.dropped() == 0
    assert rec.new_rid() != rec.new_rid()


def test_ring_wraps_and_counts_dropped():
    rec = trace.Recorder(capacity=8)
    for i in range(5):
        rec.add("early", 100 + i, 101 + i)
    assert rec.dropped() == 0 and not rec.snapshot()[1]
    t_mid = time.perf_counter_ns()
    for i in range(7):
        with rec.span("late", value=i):
            pass
    spans, wrapped = rec.snapshot()
    assert rec.dropped() == 4 and len(spans) == 8
    assert [s.value for s in spans if s.name == "late"] == list(range(7))
    assert wrapped  # the first early spans are gone
    late, wrapped_late = rec.snapshot(t_mid)
    assert len(late) == 7 and not wrapped_late  # nothing lost was written after t_mid
    early, _ = rec.snapshot(100, 110)
    assert [s.t0 for s in early] == [104]
    rec.reset()
    assert rec.snapshot() == ([], False) and rec.dropped() == 0


def test_disabled_records_nothing():
    rec = trace.Recorder()
    rec.set_enabled(False)
    a, b = rec.span("x", rid=1), rec.span("y")
    assert a is b is trace.NULL_SPAN and rec.begin("z") is trace.NULL_SPAN
    with a as sp:
        sp.value = 3
        rec.add("w", 1, 2)
        assert rec.current_rid() is None
    sp.end(1.0)
    assert rec.snapshot() == ([], False)
    rec.set_enabled(True)
    with rec.span("on"):
        pass
    assert [s.name for s in rec.snapshot()[0]] == ["on"]


def test_threads_lose_no_span_below_capacity():
    rec = trace.Recorder(capacity=4 * 2000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(2000):
                with rec.span("t", rid=k, value=i):
                    pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans, wrapped = rec.snapshot()
    assert not wrapped and rec.dropped() == 0 and len(spans) == 8000
    assert len({s.id for s in spans}) == 8000
    assert all(s.parent is None for s in spans)
    for k in range(4):
        assert sorted(s.value for s in spans if s.rid == k) == list(range(2000))


def test_profiler_offset_maps_a_span_onto_the_profiler_clock():
    rec = trace.Recorder()
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("mm"):
            torch.mm(a, a)
    offset = trace.profiler_offset_ns()
    (sp,), _ = rec.snapshot()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(starts) == 1
    assert sp.t0 + offset - 1_000_000 <= starts[0] <= sp.t1 + offset + 1_000_000


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    cfg = dataclasses.replace(
        cfg, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302,
        codec=dataclasses.replace(cfg.codec, hidden_size=32, intermediate_size=64, head_dim=16, decoder_dim=32,
                                  upsampling_ratios=(2, 2)))
    return FasterQwen3TTS(weights.init_all(cfg, dtype=torch.float32, device="cpu"), cfg,
                          PromptTokenizer(ByteTokenizer()), max_seq_len=128)


VOICE = {"ref_spk_embedding": [np.ones(2048, np.float32)], "x_vector_only_mode": [True], "icl_mode": [False],
         "ref_code": [None]}
GREEDY = dict(do_sample=False, seed=0, subtalker_dosample=False)


def test_solo_stream_spans(model):
    trace.reset()
    chunks = [t for _, _, t in model.generate_voice_clone_streaming(
        "Hello there.", "English", voice_clone_prompt=VOICE, max_new_tokens=10, min_new_tokens=10, chunk_size=4,
        first_chunk_size=2, **GREEDY)]
    spans, wrapped = trace.snapshot()
    assert not wrapped
    names = Counter(s.name for s in spans)
    assert names == {"api.prompt": 1, "sess.prefill": 1, "sess.chunk": len(chunks), "graph.frame": 2 + 4 + 4}
    prompt = next(s for s in spans if s.name == "api.prompt")
    assert prompt.value >= 1 and prompt.parent is None
    session = [s for s in spans if s.name.startswith(("sess.", "graph."))]
    rid = session[0].rid
    assert rid is not None and all(s.rid == rid for s in session)
    by_id = {s.id: s for s in spans}
    for s in session:
        if s.name == "graph.frame":
            assert by_id[s.parent].name == "sess.chunk" and s.value == 1
            assert by_id[s.parent].t0 <= s.t0 <= s.t1 <= by_id[s.parent].t1
        else:
            assert s.parent is None and s.value is None  # no device ms on the CPU
    frames = Counter(s.parent for s in spans if s.name == "graph.frame")
    assert [frames[s.id] for s in spans if s.name == "sess.chunk"] == [t["chunk_steps"] for t in chunks]
    prefill = next(s for s in spans if s.name == "sess.prefill")
    assert prefill.t1 <= min(s.t0 for s in spans if s.name == "sess.chunk")


def test_continuous_batcher_spans(model):
    trace.reset()
    cb = model.continuous_batcher(max_slots=2, chunk_size=2, first_chunk_size=2, max_new_tokens=4, **GREEDY)
    reqs = [{"text": t, "xvec_only": True, "voice_clone_prompt": VOICE} for t in ("Hi one.", "Hi two.", "Three.")]
    sids = [cb.submit(r) for r in reqs]
    out = list(cb.run())
    spans, wrapped = trace.snapshot()
    assert not wrapped
    by_id = {s.id: s for s in spans}
    finals = {sid for sid, _, _, t in out if t["is_final"] and "error" not in t}
    assert finals == set(sids)
    for sid in sids:
        mine = [s for s in spans if s.rid == sid]
        names = Counter(s.name for s in mine)
        assert names["cb.queue"] == 1 and names["cb.admit"] == 1
        assert names["api.prompt"] == names["sess.prefill"] == names["sess.chunk"] == 1
        admit = next(s for s in mine if s.name == "cb.admit")
        queue = next(s for s in mine if s.name == "cb.queue")
        assert queue.parent is None and admit.parent is None and queue.t1 <= admit.t0
        slot = next(t["slot"] for s, _, _, t in out if s == sid and t.get("solo_first_chunk"))
        assert admit.value == slot
        for s in mine:
            if s.name in ("api.prompt", "sess.prefill", "sess.chunk"):
                assert s.parent == admit.id and admit.t0 <= s.t0 <= s.t1 <= admit.t1
            if s.name == "graph.frame":
                assert by_id[s.parent].name == "sess.chunk" and s.value == 1
        assert names["graph.frame"] == 2  # the solo admission chunk
    pools = [s for s in spans if s.name == "cb.pool_chunk"]
    assert pools and all(s.parent is None and s.rid is None and 1 <= s.value <= 2 for s in pools)
    pool_frames = [s for s in spans if s.name == "graph.frame" and s.value == 2]
    assert len(pool_frames) == 2 * len(pools)
    assert all(by_id[s.parent].name == "cb.pool_chunk" for s in pool_frames)
    # one frame span a frame run: solo chunks (2 a request) and pool chunks (2 each)
    assert Counter(s.name for s in spans)["graph.frame"] == 2 * len(sids) + 2 * len(pools)
    vocodes = [s for s in spans if s.name == "voc.host"]
    assert vocodes and all(s.rid in sids for s in vocodes)
