"""The metrics that read the port's spans (`portbench/spans.py`): each
reader's value on spans recorded at chosen times, admissions and host
vocodes grouped by pool iteration, None on an empty or overwritten interval
and without the recorder, and each resolves for the cells BENCHMARK.json
gives it."""
from __future__ import annotations

import builtins
import json
from pathlib import Path

import pytest

from faster_qwen3_tts_tpu_torch.utils import trace
from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = ("prefill_device_ms.solo", "admit_pause_p95_ms", "frame_queue_ms.solo", "frame_queue_ms.cb8",
         "host_vocode_p95_ms")
MS = 1_000_000
T0 = 1_000 * 10 ** 9  # the window opens at 1000 s on the recorder's clock


def _metric(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


@pytest.fixture
def rec(monkeypatch):
    """A recorder of its own behind `trace.snapshot`."""
    r = trace.Recorder(capacity=256)
    monkeypatch.setattr(trace, "snapshot", r.snapshot)
    return r


def _window(trace_at_s=None, seconds=50.0):
    tr = None if trace_at_s is None else {"t0": T0 / 1e9 + trace_at_s}
    return {"t0": T0 / 1e9, "t1": T0 / 1e9 + seconds, "trace": tr}


def _at(rec, name, start_ms, dur_ms, value=None):
    rec.add(name, T0 + round(start_ms * MS), T0 + round((start_ms + dur_ms) * MS), value=value)


def test_prefill_device_ms_is_the_median_device_ms(rec):
    for i, v in enumerate([9.0, 11.0, 10.0, None]):
        _at(rec, "sess.prefill", 100 * i, 1.0, v)
    _at(rec, "sess.prefill", 45_000, 1.0, 99.0)  # inside the traced window: left out
    _at(rec, "sess.chunk", 500, 100.0, 120.0)
    assert _metric("prefill_device_ms.solo").read(_window(trace_at_s=40.0)) == 10.0


def test_admit_pause_groups_admissions_by_pool_iteration(rec):
    _at(rec, "cb.admit", 10, 30)  # before the first pool chunk: no previous one bounds it
    _at(rec, "cb.pool_chunk", 50, 400, 3)
    _at(rec, "cb.admit", 460, 20, 0)  # iteration 2: 20 + 25 ms
    _at(rec, "cb.admit", 482, 25, 1)
    _at(rec, "cb.pool_chunk", 510, 400, 5)
    _at(rec, "cb.pool_chunk", 920, 400, 5)  # iteration 3: no admission
    _at(rec, "cb.admit", 1330, 70, 2)  # iteration 4: 70 ms
    _at(rec, "cb.pool_chunk", 1410, 400, 6)
    metric = _metric("admit_pause_p95_ms")
    assert metric.read(_window()) == pytest.approx(70.0)
    _at(rec, "cb.pool_chunk", 1820, 400, 6)  # iterations 45, 0, 70, 0: the p95 of four is the largest
    assert metric.read(_window()) == pytest.approx(70.0)
    assert metric.read(_window(trace_at_s=1.0)) == pytest.approx(45.0)  # up to the profiler's start: 45 and 0


def test_host_vocode_groups_host_vocodes_by_pool_iteration(rec):
    _at(rec, "voc.host", 10, 12, 4)  # before the first pool chunk: no previous one bounds it
    _at(rec, "cb.pool_chunk", 50, 100, 8)
    _at(rec, "voc.host", 151, 20, 8)  # iteration 2: two lanes' vocodes after the chunk's read, 20 + 25 ms,
    _at(rec, "voc.host", 172, 25, 8)
    _at(rec, "cb.admit", 200, 40, 0)
    _at(rec, "voc.host", 230, 5, 4)  # and an admission's first chunk, 5 ms: 50 ms
    _at(rec, "cb.pool_chunk", 245, 100, 8)
    _at(rec, "cb.pool_chunk", 350, 100, 8)  # iteration 3: no host vocode
    _at(rec, "voc.host", 451, 30, 8)  # iteration 4: 30 ms
    _at(rec, "cb.pool_chunk", 490, 100, 8)
    _at(rec, "voc.host", 591, 70, 8)  # no pool chunk after it inside the interval
    metric = _metric("host_vocode_p95_ms")
    assert metric.read(_window()) == pytest.approx(50.0)  # iterations 50, 0, 30: the p95 of three is the largest
    assert metric.read(_window(trace_at_s=0.4)) == pytest.approx(50.0)  # up to the profiler's start: 50 alone
    assert metric.read(_window(trace_at_s=0.3)) is None  # one whole pool chunk bounds no iteration


def test_frame_queue_ms_reads_the_frames_of_its_batch(rec):
    for i, (dur, lanes) in enumerate([(0.2, 1), (0.4, 1), (0.3, 1), (0.9, 8), (0.7, 8), (0.5, 8), (0.6, 8)]):
        _at(rec, "graph.frame", i, dur, lanes)
    assert _metric("frame_queue_ms.solo").read(_window()) == pytest.approx(0.3)
    assert _metric("frame_queue_ms.cb8").read(_window()) == pytest.approx(0.65)


@pytest.mark.parametrize("name", NAMES)
def test_none_on_an_empty_or_overwritten_interval(rec, name):
    assert _metric(name).read(_window()) is None
    _at(rec, "voc.host", 5, 1.0, 4)  # other spans only
    assert _metric(name).read(_window()) is None
    for i in range(300):  # more than the ring holds, all inside the window
        _at(rec, "sess.prefill", i, 1.0, 10.0)
        _at(rec, "cb.pool_chunk", i, 0.5, 1)
        _at(rec, "graph.frame", i + 0.5, 0.25, 1 if i % 2 else 8)
    assert rec.dropped() > 0
    assert _metric(name).read(_window()) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_recorder(name, monkeypatch):
    real_import = builtins.__import__

    def no_trace(mod, globals=None, locals=None, fromlist=(), level=0):
        if mod == "faster_qwen3_tts_tpu_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("a program without the recorder")
        return real_import(mod, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert _metric(name).read(_window()) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_resolves_for_its_cells(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"]
    for cell in entry["workloads"]:
        assert name in [m["name"] for m in harness.resolve(cell)["per_layer"]]
    for cell in {c["name"] for c in BENCH["workloads"]} - set(entry["workloads"]):
        assert name not in [m["name"] for m in harness.resolve(cell)["per_layer"]]
