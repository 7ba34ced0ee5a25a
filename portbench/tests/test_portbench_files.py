"""The benchmark is driven by files found by name, and BENCHMARK.json keeps
to the contract's shape."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_resolves_its_files(cell):
    res = harness.resolve(cell)
    assert res["driver"].is_file()
    assert res["cfg"]["talker"]["hidden_size"] in (1024, 2048)
    names = {m["name"] for m in res["end_to_end"]}
    assert {"setup_s"} < names and len(names) >= 2
    assert res["per_layer"], "every cell reports a per-layer metric"
    for m in res["end_to_end"] + res["per_layer"]:
        assert (res["metrics_dir"] / f"{m['name']}.py").is_file()
    for key in ("config", "traffic", "driver", "entry", "sampling", "traffic_params", "correct", "why"):
        assert key in res["workload"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_agree_with_benchmark_json(metric):
    mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{metric['name']}.py")
    assert callable(mod.read)
    assert mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert mod.LAYER == metric["layer"] and mod.MOVES == metric["moves"]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = BENCH["workloads"]
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"]) and 1 <= len(c["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", []):
            assert cell in {c["name"] for c in cells}
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_as_files_alone_resolves(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric by
    adding files and entries; the harness finds them by name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "qwen3-tts-12hz-0.6b-base-q8_0.json").read_text())
    cfg["name"] = "another-config"
    (pb / "configs" / "another-config.json").write_text(json.dumps(cfg))
    wl = json.loads((pb / "workloads" / "tts06b.xvec.solo.json").read_text())
    wl.update(name="another.cell", config="another-config", traffic="another_mix")
    (pb / "workloads" / "another.cell.json").write_text(json.dumps(wl))
    (pb / "metrics" / "another_metric.py").write_text(
        "LAYER = 'device (H100)'\nSOURCE = 'device_trace'\nMOVES = 'audio_rtf'\n\n\ndef read(window):\n    return None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "another-config", "source": "https://example.org/model",
                             "file": "portbench/configs/another-config.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "another.cell", "config": "another-config", "traffic": "another_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "another_metric", "unit": "%", "better": "lower", "source": "device_trace",
                               "layer": "device (H100)", "moves": "audio_rtf", "workloads": ["another.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.resolve("another.cell", bench_root=tmp_path)
    assert res["cfg"]["name"] == "another-config"
    assert [m["name"] for m in res["per_layer"]] == ["another_metric"]
    assert res["driver"] == pb / "traffic" / "closed_solo.py"
    assert harness.metrics(res, {"trace": None}, True) == {}
