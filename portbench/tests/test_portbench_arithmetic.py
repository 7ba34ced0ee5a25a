"""The yardstick's arithmetic: traffic from the seed, percentiles from due
times, chunk gaps, audio throughput, bytes and operations from shapes, and
the reduction of a device trace."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import readers, shapes, taps
from portbench.traffic import mix

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "portbench" / "workloads" / "tts06b.xvec.open_cb8.json").read_text())["traffic_params"]
BIG = 2 ** 31 + 977


def _cfg(name="qwen3-tts-12hz-0.6b-base-q8_0"):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_traffic_is_a_function_of_the_seed(seed):
    a, b = mix.make(MIX, seed, 40), mix.make(MIX, seed, 40)
    assert a == b
    ta = mix.arrivals(3.0, 40, 40.0, np.random.default_rng(seed))
    tb = mix.arrivals(3.0, 40, 40.0, np.random.default_rng(seed))
    assert np.array_equal(ta, tb) and np.all(np.diff(ta) > 0) and 0 < ta[0] and ta[-1] < 40.0


def test_every_seed_gets_the_same_work_in_another_order():
    runs = [mix.make(MIX, s, 64) for s in (1, 2, BIG)]
    sizes = [sorted(r["frames"] for r in run) for run in runs]
    assert sizes[0] == sizes[1] == sizes[2]
    assert [r["frames"] for r in runs[0]] != [r["frames"] for r in runs[1]]
    # every prefix of 8k requests holds k lengths of each eighth of the sorted lengths
    order = mix._stratified_order(np.arange(64), np.random.default_rng(BIG))
    for k in (1, 2, 4):
        assert np.bincount(order[: 8 * k] // 8, minlength=8).tolist() == [k] * 8
    gaps = [np.sort(np.diff(np.concatenate([[0], mix.arrivals(3.0, 64, 21.0, np.random.default_rng(s))])))
            for s in (1, 2)]
    assert np.allclose(gaps[0], gaps[1])
    for r in runs[0]:
        assert MIX["min_frames"] <= r["frames"] <= MIX["max_frames"]
        assert len(r["text"]) == int(np.ceil(r["frames"] / 3.2)) and r["text"].isascii() and r["text"][0] != " "
        assert 0 <= r["voice"] < MIX["voices"]


def _window(records, t0=0.0, t1=10.0):
    return {"t0": t0, "t1": t1, "records": records}


def _rec(due, chunks, error=None):
    return {"due": due, "first": chunks[0][0] if chunks else None, "chunks": chunks, "error": error}


def test_latency_percentiles_count_from_due_times_and_failures_miss():
    recs = [_rec(1.0, [(1.1, 100, 4)]), _rec(2.0, [(2.5, 100, 4)]), _rec(3.0, [], error="boom")]
    ttfa = readers.ttfa_ms(_window(recs))
    assert ttfa[:2] == pytest.approx([100.0, 500.0]) and ttfa[2] == readers.MISSING_MS
    assert readers.percentile(ttfa, 0.5) == pytest.approx(500.0)
    assert readers.percentile([float(i) for i in range(1, 101)], 0.9) == 90.0
    assert readers.percentile([], 0.9) is None


def test_gaps_and_audio_inside_the_window_only():
    recs = [_rec(0.0, [(0.5, 24000, 12), (1.0, 24000, 12), (10.5, 24000, 12)])]
    w = _window(recs)
    assert readers.chunk_gaps_ms(w) == pytest.approx([500.0])
    assert readers.audio_rtf(w) == pytest.approx(2 / 10.0)
    assert readers.underrun_share(w) == 1.0  # 10.5 s arrives after 2 s of audio played out
    ok = _window([_rec(0.0, [(0.5, 24000, 12), (1.0, 24000, 12)])])
    assert readers.underrun_share(ok) == 0.0


def test_k2_launches_and_bytes_from_shapes():
    cfg = _cfg()
    one = shapes.frame_launches(cfg, 1)
    assert len(one) == 752  # 28 x 7 + 1 talker, 15 x (1 + 5 x 7) + 15 predictor
    assert sum(r == 2 for r, _, _ in one) == 36  # the predictor's first pass, two rows a lane
    eight = shapes.frame_launches(cfg, 8)
    assert {r for r, _, _ in eight} == {8, 16}
    # a 1024 x 3072 int8 weight at one row: the weight, its scales, the row in and out
    assert shapes.k2_bytes(1, 1024, 3072) == 1024 * 3072 + 4 * 3072 + 2 * 1024 + 2 * 3072
    assert shapes.k2_bound_s([(1, 1024, 3072)]) == pytest.approx(shapes.k2_bytes(1, 1024, 3072) / 3.35e12)


def test_frame_and_window_operations():
    cfg = _cfg()
    t = cfg["talker"]
    talker_params = t["num_hidden_layers"] * (3 * 1024 * 3072 + 1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024)
    f = shapes.frame_flops(cfg, 100)
    # the predictor's 16 positions through 5 layers outweigh the talker's one through 28
    assert 2 * talker_params < f < 5 * 2 * talker_params
    assert 3e9 < f < 4e9  # ~3.5 GFLOP a 0.6B frame
    assert shapes.frame_flops(_cfg("qwen3-tts-12hz-1.7b-customvoice-q8_0"), 100) > f
    assert shapes.window_flops(cfg, 32) > 2 * shapes.window_flops(cfg, 12) > 0


def test_trace_reduction():
    dev = [("int8_gemv_kernel<1>", 0.0, 10.0), ("other", 5.0, 20.0), ("int8_gemv_kernel<1>", 100.0, 110.0),
           ("other", 300.0, 400.0)]
    host = [("portbench.admit", 120.0, 290.0), ("aten::copy_", 25.0, 90.0)]
    r = taps.reduce_trace(dev, host, window_s=500e-6)
    assert r["busy_s"] == pytest.approx((20 + 10 + 100) / 1e6)
    assert r["k2_launches"] == 2 and r["k2_s"] == pytest.approx(20e-6)
    assert r["idle_gaps"][0][0] == "portbench.admit" and r["idle_gaps"][0][1] == pytest.approx(190e-6)
    assert r["device_ops"][0] == ["other", pytest.approx(115e-6)]
    w = {"trace": dict(r, k2_predicted=2, k2_bound_s=10e-6)}
    assert readers.k2_roofline(w) == pytest.approx(50.0)
    assert readers.device_idle_pct(w) == pytest.approx(100 * (1 - 130 / 500))
    assert readers.k2_roofline({"trace": dict(r, k2_predicted=1, k2_bound_s=10e-6)}) is None  # more than counted
    assert readers.k2_roofline({"trace": dict(r, k2_predicted=3, k2_bound_s=10e-6)}) is None  # a third lost
    lost = dict(r, k2_launches=39, k2_s=39e-5, k2_predicted=40, k2_bound_s=40e-6)  # one record of 40 dropped
    assert readers.k2_roofline({"trace": lost}) == pytest.approx(10.0)
