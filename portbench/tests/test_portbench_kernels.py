"""Every kernel of the traced window, and the program's counters inside it:
`taps.reduce_trace` keeps each device kernel's launches and seconds (and
every key it had, as it had it), `spans.traced` gives the spans recorded
between the profiler's start and stop, and a new kernel's roofline metric,
added to a copy of the benchmark as a file of its own, reads both with the
bytes from its configuration's model module."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from faster_qwen3_tts_tpu_torch.utils import trace
from portbench import readers, spans, taps
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
K2_4 = "void fq3t::int8_gemv_kernel<__nv_bfloat16, 4>(fq3t::GemvArgs<__nv_bfloat16>)"
ROUTED = "void fq3t::routed_gemv_kernel<__nv_bfloat16, 8>(fq3t::RoutedArgs<__nv_bfloat16>)"
KINDS = [(K2_4, 3.5), (ROUTED, 6.25), ("void fq3t::decode_attn_kernel<__nv_bfloat16, 2, 128>(fq3t::AttnArgs)", 2.0),
         ("Memcpy DtoD (Device -> Device)", 0.75),
         ("void fq3t::int8_gemv_kernel<__nv_bfloat16, 1>(fq3t::GemvArgs<__nv_bfloat16>)", 1.5),
         ("void at::native::(anonymous namespace)::elementwise_kernel<128, 4>(int, at::native::Loop)", 1.25)]


def synthetic_trace():
    """(device events, host events) in us: four frames of 18 launches, with
    idle gaps of 40-70 us after every fifth and 300 us between frames."""
    dev, t = [], 1000.0
    for frame in range(4):
        for i, (name, dur) in enumerate(KINDS * 3):
            dev.append((name, t, t + dur))
            t += dur + (0.5 if i % 5 else 40.0 + 10 * frame)
        t += 300.0
    host = [("portbench.host_read", 1000.0 + 200.0 * k, 1035.0 + 200.0 * k) for k in range(8)]
    host += [("cudaGraphLaunch", 990.0 + 150.0 * k, 1050.0 + 150.0 * k) for k in range(10)]
    return dev, host + [("aten::copy_", 1500.0, 2100.0)]


# `reduce_trace` of the parent tree (before `kernels`) on `synthetic_trace()`, window 2 ms
PARENT = {"busy_s": 0.000183, "window_s": 0.002,
          "device_ops": [["fq3t::routed_gemv_kernel<__nv_bfloat16, 8>", 7.500000000000002e-05],
                         ["fq3t::int8_gemv_kernel<__nv_bfloat16, 4>", 4.199999999999999e-05],
                         ["fq3t::decode_attn_kernel<__nv_bfloat16, 2, 128>", 2.4000000000000004e-05],
                         ["fq3t::int8_gemv_kernel<__nv_bfloat16, 1>", 1.7999999999999997e-05],
                         ["at::native::elementwise_kernel<128, 4>", 1.5e-05], ["Memcpy DtoD", 8.999999999999999e-06]],
          "idle_gaps": [["portbench.host_read", 0.0010215], ["host (no profiled operation)", 0.00028],
                        ["cudaGraphLaunch", 6e-05]],
          "k2_launches": 24, "k2_s": 6e-05, "device_events": 72}


def test_reduce_trace_keeps_every_kernel_and_every_key_it_had():
    out = taps.reduce_trace(*synthetic_trace(), 0.002)
    assert {k: v for k, v in out.items() if k != "kernels"} == PARENT
    kernels = out["kernels"]
    assert set(kernels) == {name for name, _ in PARENT["device_ops"]}
    assert sum(k["launches"] for k in kernels.values()) == 72
    routed = kernels["fq3t::routed_gemv_kernel<__nv_bfloat16, 8>"]
    assert routed["launches"] == 12 and routed["s"] == pytest.approx(12 * 6.25e-6)
    assert readers.traced_kernels({"trace": out}, "int8_gemv_kernel") == (24, pytest.approx(out["k2_s"]))


def test_kernel_roofline_reads_the_matched_launches():
    window = {"trace": taps.reduce_trace(*synthetic_trace(), 0.002)}
    assert readers.kernel_roofline(window, "routed_gemv", 3e-5) == pytest.approx(100.0 * 3e-5 / 7.5e-5)
    assert readers.kernel_roofline(window, "no_such_kernel", 3e-5) is None
    assert readers.kernel_roofline(window, "routed_gemv", None) is None
    assert readers.kernel_roofline(window, "routed_gemv", 0.0) is None
    assert readers.kernel_roofline({"trace": None}, "routed_gemv", 3e-5) is None
    assert readers.kernel_roofline({"trace": {"busy_s": 1.0}}, "routed_gemv", 3e-5) is None  # a trace before `kernels`


T0 = 1_000 * 10 ** 9  # the window opens at 1000 s on the recorder's clock
MS = 1_000_000


@pytest.fixture
def rec(monkeypatch):
    """A recorder of its own behind `trace.snapshot`."""
    r = trace.Recorder(capacity=64)
    monkeypatch.setattr(trace, "snapshot", r.snapshot)
    return r


def _window(trace_from_s=40.0, trace_to_s=41.0):
    return {"t0": T0 / 1e9, "t1": T0 / 1e9 + 50.0,
            "trace": {"t0": T0 / 1e9 + trace_from_s, "t1": T0 / 1e9 + trace_to_s}}


def test_traced_gives_the_spans_between_the_profilers_start_and_stop(rec):
    for at_ms, value in [(39_990, 1), (40_010, 5), (40_500, 6), (40_995, 7), (41_002, 9)]:
        rec.add("moe.experts", T0 + at_ms * MS, T0 + (at_ms + 4) * MS, value=value)
    rec.add("graph.frame", T0 + 40_100 * MS, T0 + 40_101 * MS, value=8)
    assert [s.value for s in spans.traced(_window(), "moe.experts")] == [5, 6, 7]
    assert [s.value for s in spans.untraced(_window(), "moe.experts")] == [1]
    assert spans.traced(dict(_window(), trace=None), "moe.experts") is None
    for i in range(80):  # more than the ring holds, all inside the traced interval
        rec.add("moe.experts", T0 + (40_100 + i) * MS, T0 + (40_100 + i) * MS + 1, value=i)
    assert spans.traced(_window(), "moe.experts") is None


METRIC = textwrap.dedent('''\
    """routed_roofline: the routed expert GEMV's least time (each expert a layer read in the traced frames, counted by
    the program's `moe.experts` spans, its int8 weights and scales once, over 3.35 TB/s) over its device time, in %."""
    from portbench import models, readers, shapes, spans

    LAYER = 'kernels (routed experts)'
    SOURCE = 'device_trace'
    MOVES = 'chunk_gap_p95_ms'


    def read(window):
        counts = spans.traced(window, "moe.experts")
        if not counts:
            return None
        cfg = window["cfg"]
        least_s = sum(s.value for s in counts) * models.of(cfg).expert_bytes(cfg) / shapes.HBM_BYTES_PER_S
        return readers.kernel_roofline(window, "routed_gemv", least_s)
''')

READ = textwrap.dedent("""
    import json, sys
    from pathlib import Path

    root = Path(sys.argv[1])
    sys.path[:0] = [str(root), sys.argv[2]]  # the copy's benchmark first, then the program
    from faster_qwen3_tts_tpu_torch.utils import trace
    from portbench import harness, taps
    from portbench.tests import test_portbench_kernels as t

    res = harness.resolve("toy.cell", bench_root=root)
    tr = taps.reduce_trace(*t.synthetic_trace(), 0.002)
    tr.update(t0=1040.0, t1=1041.0)
    window = {"cfg": res["cfg"], "workload": res["workload"], "trace": tr, "t0": 1000.0, "t1": 1050.0}
    out = {"before": harness.metrics(res, window, True)}
    for at_s, experts in [(1039.5, 90), (1040.2, 7), (1040.4, 8), (1040.6, 5), (1041.5, 90)]:
        trace.add("moe.experts", round(at_s * 1e9), round(at_s * 1e9) + 1000, value=experts)
    out["metrics"] = harness.metrics(res, window, True)
    out["per_layer"] = [m["name"] for m in res["per_layer"]]
    print(json.dumps(out))
""")


def test_a_kernel_roofline_metric_from_trace_and_counters_needs_no_edit(tmp_path):
    """The toy expert configuration and its cell, and a roofline metric of its
    routed kernel that counts the experts read from the program's spans
    inside the traced window: added as files, with no other file edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    shutil.copy(pb / "tests" / "toy_moe.py", pb / "models" / "toy_moe.py")
    cfg = tiny.tiny_cfg("base")
    cfg["model"] = "toy_moe"
    cfg["talker"].update(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
                         shared_expert_intermediate_size=128)
    (pb / "configs" / "toy-moe.json").write_text(json.dumps(cfg))
    wl = json.loads((pb / "workloads" / "tts06b.xvec.open_cb8.json").read_text())
    wl.update(name="toy.cell", config="toy-moe", traffic="toy_mix")
    (pb / "workloads" / "toy.cell.json").write_text(json.dumps(wl))
    (pb / "metrics" / "routed_roofline.py").write_text(METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-moe", "source": "https://example.org/toy", "file":
                             "portbench/configs/toy-moe.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy-moe", "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "routed_roofline", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "kernels (routed experts)", "moves": "chunk_gap_p95_ms",
                               "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", READ, str(tmp_path), str(ROOT)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["per_layer"] == ["routed_roofline"]
    assert r["before"] == {}  # no counter span in the traced window: nothing to read
    H, Fe = cfg["talker"]["hidden_size"], 64
    expert = 2 * (H * Fe + 4 * Fe) + Fe * H + 4 * H
    want = 100.0 * (7 + 8 + 5) * expert / 3.35e12 / (12 * 6.25e-6)
    assert r["metrics"] == {"routed_roofline": {"value": pytest.approx(want), "unit": "%"}}
    files = {p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert {str(p) for p in files if not (ROOT / p).exists()} == {
        "portbench/models/toy_moe.py", "portbench/configs/toy-moe.json", "portbench/workloads/toy.cell.json",
        "portbench/metrics/routed_roofline.py"}
    assert {str(p) for p in files if (ROOT / p).exists() and (ROOT / p).read_bytes() != (tmp_path / p).read_bytes()} \
        == {"BENCHMARK.json"}
