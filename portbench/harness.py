"""One run of one cell: set-up, the measured window, the check of what the
window served against the plain reference, and the result line.

Set-up (all of it counted in `setup_s`, from process start): the imports,
the kernel library (built into the checkout's `build/` on the first run of a
checkout, loaded after), the weights drawn on the card from the seed by the
configuration's model module (`portbench/models`) and quantized by the port
as the configuration serves them, the model, the voices of the mix's kind
(`portbench/voices`), and a warm-up of exactly the graph keys the cell
serves (its sampling, chunk 8, first chunk 4, its batch) plus one warm
request through the cell's entry, with --trace 1 the profiler's first
start, then on a card `SETTLE_S` seconds of rest (below). Then the window,
`--seconds` long, under the cell's traffic driver. Then the memory peak is
read, the program is freed, and the reference (built from the same seed's
tree, drawn again) judges a sample of the requests the window finished,
longest included.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

from . import models, voices as voice_kinds

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "faster_qwen3_tts_tpu")
# After the warm-up the port serves some 15% slower for a while (every chunk and every first chunk
# alike: 0.6B solo chunks 146 against 123 ms on an H100), then steps to its steady speed, 1 to 17 s
# after set-up in the runs measured, at a time no two runs share; a window that opens inside that
# stretch reads a mix of both speeds. Set-up ends by waiting it out: an idle wait did as well as one
# under the cell's load, and with it every solo run of a set read the steady speed.
SETTLE_S = 30.0


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's folder by its file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload_name: str, bench_root: Path = ROOT) -> Dict[str, Any]:
    """A cell's files, found by name: its workload file, its configuration
    file, its traffic driver, and the reader of every metric BENCHMARK.json
    gives it (end to end with --trace 0, per layer with --trace 1)."""
    folder = bench_root / "portbench"
    bench = load_json(bench_root / "BENCHMARK.json")
    cell = next((c for c in bench["workloads"] if c["name"] == workload_name), None)
    if cell is None:
        raise SystemExit(f"no workload named {workload_name!r} in BENCHMARK.json")
    workload = load_json(folder / "workloads" / f"{workload_name}.json")
    if workload["config"] != cell["config"] or workload["traffic"] != cell["traffic"]:
        raise SystemExit(f"{workload_name}: its file and BENCHMARK.json name different configs or traffic")
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(bench_root / config_entry["file"])

    def applies(m):
        return workload_name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m) and m["moves"] in names]
    return {"cell": cell, "workload": workload, "cfg": cfg, "driver": folder / "traffic" / f"{workload['driver']}.py",
            "end_to_end": e2e, "per_layer": layer, "metrics_dir": folder / "metrics"}


class Context:
    """What a driver needs: the model, the cell, the seed, the voices and
    their kind (`portbench/voices`), the taps."""

    def __init__(self, model, cfg, workload, seed, voices, taps):
        self.model, self.cfg, self.workload, self.seed = model, cfg, workload, seed
        self.voices, self.taps = voices, taps
        self.kind = voice_kinds.of(workload["traffic_params"])
        self.sampling = dict(workload["sampling"])

    def voice_args(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """The program call's keyword arguments that carry `req`'s voice."""
        return self.kind.program(self.voices, req)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cfg, workload, seed: int, device, t_start: float, phases: Dict[str, float], driver):
    """Everything before the window -> the driver's Context."""
    import torch

    from faster_qwen3_tts_tpu_torch.config import config_from_dict
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
    from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

    from . import taps as taps_lib

    last = [time.perf_counter()]

    def mark(name):
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - last[0]
        last[0] = now

    phases["import"] = last[0] - t_start
    if device.type == "cuda":
        from faster_qwen3_tts_tpu_torch.ops import kernels

        kernels.library()
    mark("library")
    mod = models.of(cfg)
    tree = mod.make_tree(cfg, seed, device)
    mark("weights_draw")
    params = mod.quantize(tree)
    del tree
    mark("weights_quantize")
    model = FasterQwen3TTS(params, config_from_dict(cfg), PromptTokenizer(ByteTokenizer()),
                           max_seq_len=workload["entry"].get("max_seq_len", 2048))
    mark("model")
    voices = voice_kinds.of(workload["traffic_params"]).draw(workload["traffic_params"], seed, cfg)
    mark("voices")
    e = workload["entry"]
    warm_kw = {k: v for k, v in workload["sampling"].items()}
    model.warmup(chunk_sizes=(e["chunk_size"],), first_chunk_size=e["first_chunk_size"],
                 batch_sizes=tuple(e.get("warm_batches", ())), pool_slots=e.get("max_slots", 0), **warm_kw)
    phases["warmup_captures"] = float(model.warmup_phases.get("captures", 0))
    mark("warmup")
    ctx = Context(model, cfg, workload, seed, voices, taps_lib.Taps(cfg))
    driver.warm(ctx)
    mark("warm_request")
    return ctx


def settle(device, phases: Dict[str, float]) -> None:
    """The last step of set-up on a card, after every warm-up (`SETTLE_S`)."""
    if device.type == "cuda":
        t = time.perf_counter()
        time.sleep(SETTLE_S)
        phases["settle"] = time.perf_counter() - t


def _captures(model) -> int:
    from faster_qwen3_tts_tpu_torch.engine import graphs

    return sum(r.stats["captures"] for r in graphs.registries(model.params))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(res: Dict[str, Any], seed: int, seconds: float, trace: bool, device: str, t_start: float,
             control: bool = False) -> Dict[str, Any]:
    """One run -> the result object (without printing)."""
    import torch

    from . import judge as judge_lib, taps as taps_lib

    device = torch.device(device)
    cfg, workload = res["cfg"], res["workload"]
    driver = load_module(res["driver"])
    phases: Dict[str, float] = {}
    ctx = setup(cfg, workload, seed, device, t_start, phases, driver)
    captures0 = _captures(ctx.model)
    tracer = None
    if trace:  # the profiler's first start loads CUPTI, which takes seconds: not inside the window
        t = time.perf_counter()
        tracer = taps_lib.Tracer(ctx.taps)
        tracer.warm()
        phases["profiler"] = time.perf_counter() - t
    settle(device, phases)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    window = driver.run(ctx, seconds, workload.get("rate"), tracer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    captures_in_window = _captures(ctx.model) - captures0
    trace_result = tracer.reduce() if tracer is not None and tracer.done else None
    window.update(setup_s=setup_s, setup_phases=phases, trace=trace_result, cfg=cfg, workload=workload,
                  seconds=seconds, captures_in_window=captures_in_window)
    del ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = judge_lib.check(window, cfg, workload, seed, device, control=control)
    window["judge_s"] = time.perf_counter() - t
    return {"window": window, "peak": peak, "checks": checks}


def metrics(res: Dict[str, Any], window: Dict[str, Any], trace: bool) -> Dict[str, Any]:
    """The cell's metrics by name, each read by its own file; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in (res["per_layer"] if trace else res["end_to_end"]):
        value = load_module(res["metrics_dir"] / f"{m['name']}.py").read(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(device, peak: int, trace_result) -> Dict[str, Any]:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": peak}
    if trace_result is not None:
        info.update(busy_s=trace_result["busy_s"], window_s=trace_result["window_s"])
    return info


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"


def attempted_failed(window) -> tuple:
    recs = window["records"]
    failed = sum(1 for r in recs if r["error"] is not None or r["first"] is None)
    return len(recs), failed
