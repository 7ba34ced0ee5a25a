"""Build and load the port's hand-written Hopper kernels.

The CUDA sources under ``faster_qwen3_tts_tpu_torch/csrc/`` have a plain C
interface. At first use each is compiled with its own ``nvcc`` for
``sm_90a``, all at once, and the objects are linked into one shared library
under ``build/fq3t_torch/`` in the checkout (the file name carries a hash of
the sources, so an edit rebuilds), which is loaded with ``ctypes``. Nothing
here runs at import time: this module is imported on machines without
``nvcc`` or a card, where only the kernels' plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "fq3t_torch"
SOURCES = ("decode_attention.cu", "int8_gemv.cu", "int4_gemv.cu", "weight_stream.cu", "glue.cu", "runtime.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _float, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "fq3t_decode_attention": (
        [_int, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _float, _int, _int, _vp], _int,
    ),
    "fq3t_int8_gemv": ([_int, _vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp], _int),
    "fq3t_int4_gemv": ([_int, _vp, _vp, _vp, _vp, _vp] + [_int] * 12 + [_vp], _int),
    "fq3t_weight_stream": ([_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, _vp], _int),
    "fq3t_weight_stream_block_cols": ([], _int),
    "fq3t_weight_stream_row_step": ([], _int),
    "fq3t_add_rms_norm": ([_int, _vp, _ll, _vp, _vp, _vp, _vp, _int, _int, _int, _float, _vp], _int),
    "fq3t_qk_norm_rope_kv": ([_int, _vp, _ll, _vp, _ll, _vp, _ll] + [_vp] * 8 + [_int] * 5 + [_float, _vp], _int),
    "fq3t_silu_mul": ([_int, _vp, _ll, _vp, _ll, _vp, _int, _int, _vp], _int),
    "fq3t_cuda_versions": ([_vp, _vp], _int),
    "fq3t_graph_edges": ([_vp, _vp, _vp], _int),
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.cdll = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = restype
        self.stream_block_cols = self.cdll.fq3t_weight_stream_block_cols()
        self.stream_row_step = self.cdll.fq3t_weight_stream_row_step()

    def call(self, name: str, *args) -> None:
        """Call a launching entry point and raise on a CUDA error."""
        err = getattr(self.cdll, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUDA error {err}")

    def cuda_versions(self) -> dict:
        """The CUDA runtime's and driver's versions (1000 * major + 10 * minor)."""
        runtime, driver = ctypes.c_int(), ctypes.c_int()
        self.call("fq3t_cuda_versions", ctypes.byref(runtime), ctypes.byref(driver))
        return {"runtime": runtime.value, "driver": driver.value}

    def graph_edges(self, graph: int) -> Optional[Tuple[int, int]]:
        """(programmatic edges, all edges) of a cudaGraph_t (a captured
        `torch.cuda.CUDAGraph(keep_graph=True)`'s `raw_cuda_graph()`), or
        None where the library's runtime has no typed edges."""
        prog, total = ctypes.c_longlong(), ctypes.c_longlong()
        err = self.cdll.fq3t_graph_edges(ctypes.c_void_p(graph), ctypes.byref(prog), ctypes.byref(total))
        if err == 801:  # cudaErrorNotSupported
            return None
        if err != 0:
            raise RuntimeError(f"fq3t_graph_edges failed: CUDA error {err}")
        return prog.value, total.value


_LIB: Optional[KernelLibrary] = None
_LIB_LOCK = threading.Lock()  # the first launches may come from several threads (the server)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh"))):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:12]


def library() -> KernelLibrary:
    """Build (once per source version) and load the kernel library."""
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        return _LIB if _LIB is not None else _build()


def _build() -> KernelLibrary:
    global _LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libfq3t_kernels-{_source_hash()}.so"
    t0 = time.perf_counter()
    log = ""
    if not target.exists():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        outs = [proc.communicate()[0] for proc in procs]  # every nvcc ends before any raise
        for s, proc, out in zip(SOURCES, procs, outs):
            log += f"{s}:\n{out}"
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({proc.returncode}):\n{out}")
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout + proc.stderr}")
        for o in objs:
            o.unlink()
        os.replace(tmp, target)
    _LIB = KernelLibrary(target, time.perf_counter() - t0, log)
    return _LIB


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require_device(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel argument on {t.device}, expected a CUDA tensor")


def require_cuda(*tensors: torch.Tensor) -> None:
    require_device(*tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel argument must be contiguous")
