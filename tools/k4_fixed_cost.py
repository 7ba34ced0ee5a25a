#!/usr/bin/env python3
"""Where the int4 GEMV's (K4's) time goes on an NVIDIA GPU.

    python3 tools/k4_fixed_cost.py [--sweep] [--out FILE]

From the repository root, on a machine with a card and nvcc. Builds
tools/k4_fixed_cost.cu into build/tools/ and times, at M = 1, bf16 x, for
1024x1024, 3072x1024, 2048x6144 and 6144x2048 (I x O, group 32): K4 as this
tree launches it, probes with the geometry of a K4 design of 128-column
tiles in clusters of up to 8 (an empty launch with and without the
clusters' barriers; that design's loads in its staged order; the same bytes
issued at once, with and without the barriers) and
`torch._weight_int4pack_mm` on the same nibbles (its scale and zero in
bf16). `--sweep` also times every K4 launch `_int4_plan` could choose (path,
column tile, cluster with 100-264 CTAs) at the nine projection shapes of the
0.6B and 1.7B models and M = 1, 2, 4, 16, beside the plan's own choice and
the library call. Device us per call: CUDA-graph replay over operand copies
larger than L2 (chip_smoke.device_ms), two runs each. Prints one JSON line
per row; --out writes them all.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faster_qwen3_tts_tpu_torch.ops import kernels, quant  # noqa: E402

PROBE_SHAPES = ((1024, 1024), (3072, 1024), (2048, 6144), (6144, 2048))


def build_probes() -> ctypes.CDLL:
    src = REPO / "tools" / "k4_fixed_cost.cu"
    digest = hashlib.sha256(src.read_bytes() + (REPO / "faster_qwen3_tts_tpu_torch/csrc/common.cuh").read_bytes())
    out = REPO / "build" / "tools" / f"libk4probe-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k4p_empty.argtypes = [ci, ci, vp]
    lib.k4p_staged.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.k4p_at_once.argtypes = [ci] + [vp] * 5 + [ci] * 5 + [vp]
    return lib


def check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")


def staged_geometry(I: int, O: int, group: int = 32):
    """(grid, cluster, groups per CTA) of the staged design at M = 1: 128-column
    tiles, the cluster filling the card about twice."""
    tiles, n_groups = -(-O // 128), I // group
    cluster = max(1, min(8, n_groups, 264 // tiles))
    per = -(-n_groups // cluster)
    cluster = -(-n_groups // per)
    return tiles * cluster, cluster, per


def weights(I: int, O: int, rng):
    ql = quant.quantize_linear4(rng.standard_normal((I, O)).astype("float32") * I ** -0.5)
    packed, scale, wmin = (torch.from_numpy(a).cuda() for a in ql)
    n = cs._copies(packed.numel() + 2 * scale.numel() * 4)
    ops = [(packed, scale, wmin)] + [(packed.clone(), scale.clone(), wmin.clone()) for _ in range(n - 1)]
    lw = torch._convert_weight_to_int4pack(packed.t().contiguous(), 8)
    lws = [lw] + [lw.clone() for _ in range(n - 1)]
    sz = torch.stack([scale, wmin + 8 * scale], dim=-1).to(torch.bfloat16).contiguous()
    return ops, lws, sz, n


def us(fn, n) -> list:
    return [round(cs.device_ms(fn, n) * 1e3, 3) for _ in range(2)]


def fixed_cost(lib, rng) -> list:
    rows = []
    y = torch.zeros(1 << 20, dtype=torch.int32, device="cuda")
    for I, O in PROBE_SHAPES:
        ops, lws, sz, n = weights(I, O, rng)
        x = torch.randn(1, I, device="cuda").to(torch.bfloat16)
        grid, cluster, per = staged_geometry(I, O)
        st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        ptrs = lambda k: [x.data_ptr(), *(t.data_ptr() for t in ops[k]), y.data_ptr()]  # noqa: E731
        row = {"I": I, "O": O, "staged_grid": grid, "staged_cluster": cluster, "copies": n,
               "k4": us(lambda k: quant.int4_gemv(x, *ops[k]), n),
               "empty_1cta": us(lambda k: check(lib.k4p_empty(1, 1, st())), n),
               "empty_grid": us(lambda k: check(lib.k4p_empty(grid, 1, st())), n),
               "empty_grid_cluster": us(lambda k: check(lib.k4p_empty(grid, cluster, st())), n),
               "staged_loads": us(lambda k: check(lib.k4p_staged(*ptrs(k), I, O, 32, per, cluster, st())), n),
               "loads_at_once": us(lambda k: check(lib.k4p_at_once(0, *ptrs(k), I, O, 32, per, cluster, st())), n),
               "loads_at_once_cluster": us(lambda k: check(lib.k4p_at_once(1, *ptrs(k), I, O, 32, per, cluster,
                                                                           st())), n),
               "library": us(lambda k: torch._weight_int4pack_mm(x, lws[k], 32, sz), n)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def launch(x, w, plan):
    packed, scale, wmin = w
    M, I = x.shape
    O = packed.shape[1]
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    kernels.library().call(
        "fq3t_int4_gemv", kernels.dtype_code(x), x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        wmin.data_ptr(), y.data_ptr(), M, I, O, 32, plan.groups_per_cta, plan.cluster, plan.cols, plan.gpw,
        plan.xs_pitch, plan.mr, int(plan.mma), plan.smem, kernels.stream_handle(x.device))
    return y


def sweep(rng) -> list:
    rows = []
    for I, O in cs.K2_SHAPES:
        ops, lws, sz, n = weights(I, O, rng)
        for M in (1, 2, 4, 16):
            x = torch.randn(M, I, device="cuda").to(torch.bfloat16)
            ref = quant.int4_gemv_plain(x.float(), *ops[0])
            plan = quant._int4_plan(M, I, O, 32)
            row = {"I": I, "O": O, "M": M, "plan": f"{'mma' if plan.mma else 'cc'} {plan.cols} c{plan.cluster}",
                   "library": us(lambda k: torch._weight_int4pack_mm(x, lws[k], 32, sz), n)}
            for mma in (False, True):
                mr = (8 if M <= 8 else 16) if mma else (M if M <= 2 else 4)
                for cols in (32, 64, 128):
                    for c in range(1, 9):
                        p = quant._int4_candidate(M, I, O, 32, 2, mma, mr, cols, c)
                        if p is None or p.cluster != c or not 100 <= p.grid[0] * p.grid[1] * p.grid[2] <= 264:
                            continue
                        err = (launch(x, ops[0], p).float() - ref).abs().max().item()
                        if not err < 5e-2:
                            raise RuntimeError(f"{I}x{O} M={M} {p}: max abs err {err}")
                        row[f"{'mma' if mma else 'cc'} {cols} c{c} ({p.grid[0] * p.grid[1] * p.grid[2]})"] = us(
                            lambda k: launch(x, ops[k], p), n)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", action="store_true", help="also time every launch the plan could choose")
    parser.add_argument("--out", type=Path, help="write the rows to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k4_fixed_cost: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(1)
    report = {"nvidia_smi": smi, "fixed_cost": fixed_cost(build_probes(), rng)}
    if args.sweep:
        report["sweep"] = sweep(rng)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
