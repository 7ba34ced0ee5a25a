"""What the harness reads from the program while a run goes, from outside it.

`Taps` wraps a few of the port's functions for the length of a run (and
puts them back after): the host reads of a chunk (`engine.core.read_packed`,
`read_packed_batch`), which hand over the frames the engine emitted; a graph
set's prefill (`engine.graphs.GraphSet.prefill`); the K2 wrapper
(`ops.quant.int8_gemv`), which eager products of at most 16 rows go
through; the batcher's admission (`ContinuousBatcher._admit`) and a
stream's host vocoder (`model._StreamVocoder.vocode_new`). The wrappers only
record: the frames behind each read, and while the profiler is on, the K2
launches the traced window ran (from the packed rows' shape: frames and
lanes), so that the roofline share counts exactly the launches in the trace.
While the profiler is on they also mark their calls as `portbench.*` ranges,
which label the device's idle gaps.

`Tracer` runs one `torch.profiler` window and reduces it: the union of
device activity (busy seconds), the device operations that took most time,
the longest idle gaps by what the host was doing, K2's launches and device
seconds, and every device kernel's launches and device seconds by its short
name (`kernels`, which a new kernel's roofline metric reads through
`readers.kernel_roofline`).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import models, shapes

K2_NAME = "int8_gemv_kernel"


class Taps:
    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        self.mod = models.of(cfg)  # the configuration's yardstick: K2 launches from shapes
        self.current: Any = None  # the request whose B = 1 reads follow
        self.solo: Dict[Any, List[np.ndarray]] = defaultdict(list)
        self.last_batch: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.profiling = False
        self.k2: List[Tuple[int, int, int]] = []  # launches (rows, in, out) while profiling
        self._undo: List[Tuple[Any, str, Any]] = []

    def _span(self, name: str):
        if not self.profiling:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")

    def _patch(self, owner, name: str, make):
        orig = getattr(owner, name)
        wrapper = make(orig)
        if hasattr(orig, "launches"):  # the K2 wrapper counts its launches on itself
            wrapper.launches = orig.launches
        self._undo.append((owner, name, orig))
        setattr(owner, name, wrapper)

    def install(self, batcher=None) -> "Taps":
        from faster_qwen3_tts_tpu_torch import model as model_lib
        from faster_qwen3_tts_tpu_torch.engine import core, graphs
        from faster_qwen3_tts_tpu_torch.ops import quant

        taps = self

        def read_packed(orig):
            def f(packed):
                with taps._span("host_read"):
                    out = orig(packed)
                taps.solo[taps.current].append(out[0])
                if taps.profiling:
                    taps.k2 += taps.mod.frame_launches(taps.cfg, packed.shape[1]) * packed.shape[0]
                return out
            return f

        def read_packed_batch(orig):
            def f(packed):
                with taps._span("host_read"):
                    out = orig(packed)
                taps.last_batch = (out[0], out[1])
                if taps.profiling:
                    taps.k2 += taps.mod.frame_launches(taps.cfg, packed.shape[1]) * packed.shape[0]
                return out
            return f

        def prefill(orig):
            def f(gset, params, tie, *a, **k):
                if taps.profiling:
                    taps.k2 += taps.mod.prefill_launches(taps.cfg, tie.shape[0])
                return orig(gset, params, tie, *a, **k)
            return f

        def int8_gemv(orig):
            def f(x, q, scale):
                if taps.profiling and x.is_cuda:
                    taps.k2.append((x.numel() // x.shape[-1], q.shape[0], q.shape[1]))
                return orig(x, q, scale)
            return f

        def vocode_new(orig):
            def f(voc, frames):
                with taps._span("host_vocode"):
                    return orig(voc, frames)
            return f

        self._patch(core, "read_packed", read_packed)
        self._patch(core, "read_packed_batch", read_packed_batch)
        self._patch(graphs.GraphSet, "prefill", prefill)
        self._patch(quant, "int8_gemv", int8_gemv)
        self._patch(model_lib._StreamVocoder, "vocode_new", vocode_new)
        if batcher is not None:
            def admit(orig):
                def f(s, slot):
                    taps.current = s.sid
                    with taps._span("admit"):
                        return orig(s, slot)
                return f
            self._patch(batcher, "_admit", admit)
        return self

    def remove(self) -> None:
        for owner, name, orig in reversed(self._undo):
            if owner.__class__.__name__ == "ContinuousBatcher":
                delattr(owner, name)  # the instance attribute shadowed the method
            else:
                if hasattr(orig, "launches"):
                    orig.launches = getattr(owner, name).launches
                setattr(owner, name, orig)
        self._undo.clear()

    def take_solo(self, key) -> List[np.ndarray]:
        return self.solo.pop(key, [])


def _events(prof) -> Tuple[list, list]:
    """(device events, host events) as (name, start_us, end_us)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            start, dur = float(e.start_us()), float(e.duration_us())
        name = e.name()
        item = (name, start, start + dur)
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("portbench."):  # the ranges' copies on the device timeline
                dev.append(item)
        else:
            host.append(item)
    return dev, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without `void`, its parameter list and the deeper
    template arguments."""
    name = (name[5:] if name.startswith("void ") else name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    name = name.strip()
    return name if len(name) <= width else name[: width - 3] + "..."


def reduce_trace(dev: list, host: list, window_s: float, top: int = 10) -> Dict[str, Any]:
    """Device busy seconds (the union of device activity), the device
    operations that took most time, the longest idle gaps between device
    activity labelled by the host range or operation that overlapped each
    most (a `portbench.*` range first), K2's launches and seconds, and
    `kernels`: every device operation's launches and seconds by its short
    name."""
    busy = _union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    kernels: Dict[str, Dict[str, Any]] = {}
    for name, s, e in dev:
        k = kernels.setdefault(short_name(name), {"launches": 0, "s": 0.0})
        k["launches"] += 1
        k["s"] += (e - s) / 1e6
    ops = sorted(((n, k["s"]) for n, k in kernels.items()), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:top]
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = np.array([h[1] for h in host_sorted]) if host_sorted else np.zeros(0)
    labelled: Dict[str, float] = defaultdict(float)
    for g, s, e in gaps:
        best, best_key = "host (no profiled operation)", (-1.0, 0)
        for name, hs, he in host_sorted[: int(np.searchsorted(starts, e))]:
            ov = min(he, e) - max(hs, s)
            key = (1.0 if name.startswith("portbench.") else 0.0, ov)
            if ov > 0 and key > best_key:
                best, best_key = name, key
        labelled[best] += g / 1e6
    k2 = [(s, e) for name, s, e in dev if K2_NAME in name]
    return {"busy_s": busy_s, "window_s": window_s, "device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in sorted(labelled.items(), key=lambda kv: -kv[1])[:top]],
            "k2_launches": len(k2), "k2_s": sum(e - s for s, e in k2) / 1e6, "device_events": len(dev),
            "kernels": kernels}


class Tracer:
    """One profiler window, started and stopped by a driver at points where
    no device work of the program is in flight."""

    def __init__(self, taps: Taps):
        self.taps = taps
        self.prof = None
        self.t0 = self.t1 = None
        self.result: Optional[Dict[str, Any]] = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    @property
    def done(self) -> bool:
        return self.t1 is not None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self) -> None:
        """One profiled no-op, so that the window's start does not pay for
        loading the profiler."""
        import torch

        with self._profile():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof = self._profile()
        self.prof.start()
        self.taps.profiling = True
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.taps.profiling = False
        self.prof.stop()
        self.stop_s = time.perf_counter() - self.t1

    def reduce(self) -> Dict[str, Any]:
        t = time.perf_counter()
        dev, host = _events(self.prof)
        self.result = reduce_trace(dev, host, self.t1 - self.t0)
        self.result["k2_predicted"] = len(self.taps.k2)
        self.result["k2_bound_s"] = sum(self.taps.mod.k2_bytes(*x) for x in self.taps.k2) / shapes.HBM_BYTES_PER_S
        self.result["reduce_s"] = time.perf_counter() - t
        self.result["start_s"], self.result["stop_s"] = self.start_s, self.stop_s
        self.result["t0"], self.result["t1"] = self.t0, self.t1
        self.prof = None
        return self.result
