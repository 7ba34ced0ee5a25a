"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints set-up and check lines, then as its last
line of standard output one JSON object: correct, attempted, failed, the
cell's end-to-end metrics (--trace 0) or per-layer metrics (--trace 1, with
the device's busy and window seconds and a breakdown), the device, and the
numbers the check compared beside their limits. Exits non-zero, printing no
result, without a CUDA device, or if jax, jaxlib, flax or the JAX package
was loaded.

Two modes measure the cell instead of running it:
  --sweep r1,r2,...   the open-loop cell at each offered rate (req/s), one
                      process, each rate for --seconds; prints a line a rate.
  --calibrate n       n seeds from --seed, each with its own weights and a
                      window of --seconds at the cell's load: the check's
                      numbers of the program and of the control.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every build and kernel cache stays inside the checkout, at a fixed path.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "portbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "portbench" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _forbidden_exit(harness) -> None:
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        sys.exit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None)
    ap.add_argument("--calibrate", type=int, default=0)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device; the benchmark measures the card only", file=sys.stderr)
        return 2
    from portbench import harness, readers

    res = harness.resolve(a.workload)
    if res["cell"]["chips"] > torch.cuda.device_count():
        print(f"portbench: the cell asks for {res['cell']['chips']} cards", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    if a.sweep:
        return sweep(a, res, harness, readers)
    if a.calibrate:
        return calibrate(a, res, harness)

    out = harness.run_cell(res, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    w, checks = out["window"], out["checks"]
    attempted, failed = harness.attempted_failed(w)
    _emit({"setup": {k: round(v, 4) for k, v in w["setup_phases"].items()}, "setup_s": w["setup_s"],
           "captures_in_window": w["captures_in_window"], "judge_s": w["judge_s"], "judged": checks["judged"], "tokens": checks["tokens"],
           "requests": attempted, "late_p99_ms": 1e3 * (readers.percentile(w["late_s"], 0.99) or 0.0),
           "underrun_share": readers.underrun_share(w),
           "stall_chunks": sorted(x for x in readers.stalls(w) if x is not None),
           "gap_max_ms": max(readers.chunk_gaps_ms(w) or [0.0]),
           "ttfa_p50_p75_ms": [readers.percentile(readers.ttfa_ms(w), q) for q in (0.5, 0.75)],
           "frames_made": sum(c[2] for r in w["records"] for c in r["chunks"]),
           "frames_asked": sum(r["req"]["frames"] for r in w["records"]),
           "trace": {k: len(v) if k == "kernels" else v for k, v in (w["trace"] or {}).items()
                     if k not in ("device_ops", "idle_gaps")}})
    for r in w["records"]:
        if r["error"] is not None or r["first"] is None:
            print(f"failed request {r['index']}: error={r['error']!r} chunks={len(r['chunks'])} "
                  f"frames={r['req']['frames']} text={len(r['req']['text'])} bytes", file=sys.stderr)
    correct = checks["correct"] and failed == 0 and w["captures_in_window"] == 0
    numbers = dict(checks["numbers"], failed={"value": failed, "limit": 0},
                   captures_in_window={"value": w["captures_in_window"], "limit": 0})
    metrics = harness.metrics(res, w, bool(a.trace))
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": harness.device_info(torch.device("cuda"), out["peak"], w["trace"] if a.trace else None)}
    if a.trace and w["trace"]:
        result["breakdown"] = {"device_ops": w["trace"]["device_ops"], "idle_gaps": w["trace"]["idle_gaps"]}
    result["checks"] = numbers
    _forbidden_exit(harness)
    _emit(result)
    for k, d in numbers.items():
        print(f"check {k}: {d['value']!r} limit {d['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


def sweep(a, res, harness, readers) -> int:
    """Each offered rate for --seconds in one process (one set-up)."""
    import torch

    from portbench import taps as taps_lib

    driver = harness.load_module(res["driver"])
    phases = {}
    ctx = harness.setup(res["cfg"], res["workload"], a.seed, torch.device("cuda"), T_START, phases, driver)
    harness.settle(torch.device("cuda"), phases)
    limit = res["workload"]["limits"]["ttfa_ms"]
    for rate in (float(r) for r in a.sweep.split(",")):
        ctx.taps = taps_lib.Taps(res["cfg"])
        w = driver.run(ctx, a.seconds, rate, None)
        ttfa = readers.ttfa_ms(w)
        first_half = [r for r in w["records"] if r["due"] < w["t0"] + a.seconds / 2]
        backlog = [max(0.0, (r["first"] or w["t1"]) - r["due"]) for r in w["records"]]
        _emit({"rate": rate, "requests": len(w["records"]),
               "ttfa_p50_ms": readers.percentile(ttfa, 0.5), "ttfa_p90_ms": readers.percentile(ttfa, 0.9),
               "ttfa_within_limit": sum(t <= limit for t in ttfa) / max(1, len(ttfa)),
               "chunk_gap_p95_ms": readers.percentile(readers.chunk_gaps_ms(w), 0.95),
               "audio_rtf": readers.audio_rtf(w), "underrun_share": readers.underrun_share(w),
               "wait_first_half_ms": 1e3 * sum(backlog[:len(first_half)]) / max(1, len(first_half)),
               "wait_second_half_ms": 1e3 * sum(backlog[len(first_half):]) / max(1, len(backlog) - len(first_half)),
               "late_p99_ms": 1e3 * (readers.percentile(w["late_s"], 0.99) or 0.0)})
    _forbidden_exit(harness)
    return 0


def calibrate(a, res, harness) -> int:
    """The check's numbers of the program and of the control on each seed."""
    import gc

    for seed in range(a.seed, a.seed + a.calibrate):
        out = harness.run_cell(res, seed, a.seconds, False, "cuda", time.perf_counter(), control=True)
        c = out["checks"]
        _emit({"seed": seed, "judged": c["judged"], "tokens": c["tokens"],
               "program": {k: d["value"] for k, d in c["numbers"].items()}, "control": c["control"],
               "failed": harness.attempted_failed(out["window"])[1]})
        del out
        gc.collect()
    _forbidden_exit(harness)
    return 0


if __name__ == "__main__":
    sys.exit(main())
