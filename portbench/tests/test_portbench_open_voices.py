"""The open-loop driver (`traffic/open_batcher.py`) takes every kind of voice
and the mix's language: the x-vector cell's warm request is the one it has
always sent, and a preset-speaker open-loop cell with a language of its own,
added to a copy of the benchmark as files alone, resolves, warms and sends
its window's requests with their speakers. A recording stand-in takes the
batcher's place: the port's batcher admits voice-clone requests only."""
from __future__ import annotations

import json
import queue
import shutil
from pathlib import Path

import numpy as np

from portbench import harness, taps as taps_lib, voices
from portbench.traffic import mix

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 23
WARM_TEXT = "A warm request of some length"


class RecordingBatcher:
    """Stands in for `ContinuousBatcher`: records every submission and gives
    each request one final chunk of audio at once."""

    def __init__(self, log):
        self.log, self.sids, self.n = log, queue.Queue(), 0

    def submit(self, req, max_new_tokens):
        self.log.append((req, max_new_tokens))
        self.sids.put(self.n)
        self.n += 1
        return self.n - 1

    def _admit(self, s, slot):  # what the taps wrap
        pass

    def cancel(self, sid):
        pass

    def close(self):
        self.sids.put(None)

    def run(self, wait=False):
        while (sid := self.sids.get()) is not None:
            yield sid, np.zeros(1920, np.float32), 24000, {"is_final": True, "chunk_steps": 0, "slot": -1,
                                                            "chunk_index": 0}


class RecordingModel:
    def __init__(self):
        self.log, self.batchers = [], []

    def continuous_batcher(self, **kw):
        self.batchers.append(kw)
        return RecordingBatcher(self.log)


def _context(res):
    cfg, workload = res["cfg"], res["workload"]
    params = workload["traffic_params"]
    kind = voices.of(params)
    # x-vector voices stand as labels: the program's arguments carry them untouched
    drawn = ([f"voice {i}" for i in range(params["voices"])] if kind.KEY == "voice"
             else kind.draw(params, SEED, cfg))
    return harness.Context(RecordingModel(), cfg, workload, SEED, drawn, taps_lib.Taps(cfg))


def test_the_xvector_warm_request_is_the_one_it_always_was():
    res = harness.resolve("tts06b.xvec.open_cb8")
    ctx = _context(res)
    harness.load_module(res["driver"]).warm(ctx)
    today = {"text": WARM_TEXT, "language": "English", "voice_clone_prompt": {
        "ref_spk_embedding": ["voice 0"], "x_vector_only_mode": [True], "icl_mode": [False], "ref_code": [None]}}
    assert [(json.dumps(req), n) for req, n in ctx.model.log] == [(json.dumps(today), 40)]
    assert ctx.model.batchers == [dict(max_slots=8, chunk_size=8, first_chunk_size=4, seed=SEED % 2 ** 31,
                                       **res["workload"]["sampling"])]


def test_a_preset_speaker_open_loop_cell_needs_no_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    speakers = ["vivian", "ryan", "aiden"]
    wl = json.loads((pb / "workloads" / "tts06b.xvec.open_cb8.json").read_text())
    wl.update(name="tts17b.preset.open_cb8", config="qwen3-tts-12hz-1.7b-customvoice-q8_0",
              traffic="preset_open_poisson")
    params = wl["traffic_params"]
    del params["voices"]
    params.update(voice_kind="speaker", speakers=speakers, language="Auto")
    (pb / "workloads" / "tts17b.preset.open_cb8.json").write_text(json.dumps(wl))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tts17b.preset.open_cb8", "config": "qwen3-tts-12hz-1.7b-customvoice-q8_0",
                               "traffic": "preset_open_poisson", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = harness.resolve("tts17b.preset.open_cb8", bench_root=tmp_path)
    assert res["driver"] == pb / "traffic" / "open_batcher.py"
    assert {m["name"] for m in res["end_to_end"]} == {"chunk_gap_p95_ms", "audio_rtf", "setup_s"}
    ctx = _context(res)
    driver = harness.load_module(res["driver"])
    driver.warm(ctx)
    assert ctx.model.log == [({"text": WARM_TEXT, "language": "Auto", "speaker": "vivian"}, 40)]

    ctx.model.log.clear()
    window = driver.run(ctx, 1.0, 4.0)
    sent = mix.make(params, SEED, 4)
    assert {r["speaker"] for r in sent} <= set(speakers)
    assert ctx.model.log == [({"text": r["text"], "language": "Auto", "speaker": r["speaker"]}, r["frames"])
                             for r in sent]
    assert [r["finished"] for r in window["records"]] == [True] * 4
    files = {p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert {str(p) for p in files if not (ROOT / p).exists()} == {"portbench/workloads/tts17b.preset.open_cb8.json"}
    assert {str(p) for p in files if (ROOT / p).exists() and (ROOT / p).read_bytes() != (tmp_path / p).read_bytes()} \
        == {"BENCHMARK.json"}
