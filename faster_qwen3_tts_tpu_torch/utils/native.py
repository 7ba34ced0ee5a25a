"""ctypes binding of the port's host library (csrc/fq3t.cpp, libfq3t).

Counterpart of faster_qwen3_tts_tpu/utils/native.py with the same C ABI
(version 1) and the same entry points: `resample`, `float_to_pcm16`,
`write_wav` and `RingBuffer`, each with the numpy fallback of
`utils.audio`. The port keeps its own copy of the source and compiles it
with ``g++`` at first use, never at import, into ``build/fq3t_torch/`` in
the checkout (the file name carries a hash of the source, so an edit
rebuilds). `available()` says whether the library loaded; where it did not
(no compiler), every entry point takes its numpy fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import audio as audio_lib

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fq3t.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "fq3t_torch"
# the JAX package's native/Makefile flags, so both libraries are the same code
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native")
ABI_VERSION = 1

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
build_error: Optional[str] = None  # why the library is missing, when it is


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfq3t-{digest}.so"


def _build() -> Path:
    """Compile the source once per version -> the library's path."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout + proc.stderr}")
    os.replace(tmp, target)
    return target


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None if it cannot be
    built or loaded (`build_error` says why)."""
    global _LIB, _TRIED, build_error
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
            if lib.fq3t_abi_version() != ABI_VERSION:
                raise RuntimeError(f"ABI version {lib.fq3t_abi_version()}, expected {ABI_VERSION}")
            lib.fq3t_resample.restype = ctypes.c_int64
            lib.fq3t_resample_out_len.restype = ctypes.c_int64
            lib.fq3t_float_to_pcm16.restype = ctypes.c_int64
            lib.fq3t_write_wav.restype = ctypes.c_int32
            lib.fq3t_ring_new.restype = ctypes.c_void_p
            lib.fq3t_ring_write.restype = ctypes.c_int64
            lib.fq3t_ring_read.restype = ctypes.c_int64
            lib.fq3t_ring_available.restype = ctypes.c_int64
            _LIB = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            logger.info("host library unavailable (%s); using the numpy fallbacks", build_error)
        _TRIED = True
    return _LIB


def available() -> bool:
    return load_library() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Windowed-sinc resample (the library), numpy fallback."""
    lib = load_library()
    if lib is None:
        return audio_lib.resample(audio, sr_in, sr_out)
    x = np.ascontiguousarray(audio, np.float32)
    out = np.empty(lib.fq3t_resample_out_len(len(x), sr_in, sr_out), np.float32)
    produced = lib.fq3t_resample(_fp(x), len(x), sr_in, sr_out, _fp(out))
    return out[:produced]


def float_to_pcm16(audio: np.ndarray) -> bytes:
    lib = load_library()
    x = np.ascontiguousarray(audio, np.float32)
    if lib is None:
        return audio_lib.float_to_pcm16(x)
    out = np.empty(len(x), "<i2")
    lib.fq3t_float_to_pcm16(_fp(x), len(x), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out.tobytes()


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    lib = load_library()
    if lib is None:
        audio_lib.write_wav(path, audio, sample_rate)
        return
    x = np.ascontiguousarray(audio, np.float32)
    if lib.fq3t_write_wav(str(path).encode(), _fp(x), len(x), sample_rate) != 0:
        raise IOError(f"fq3t_write_wav failed for {path}")


class RingBuffer:
    """Single-producer single-consumer float ring buffer (the library),
    numpy fallback."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self.capacity = capacity
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.fq3t_ring_new(capacity))
            self._buf = None
        else:
            self._h = None
            self._buf = np.zeros(0, np.float32)

    def write(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        if self._h is not None:
            return int(self._lib.fq3t_ring_write(self._h, _fp(data), len(data)))
        take = min(len(data), self.capacity - len(self._buf))
        self._buf = np.concatenate([self._buf, data[:take]])
        return take

    def read(self, n: int) -> np.ndarray:
        if self._h is not None:
            out = np.empty(n, np.float32)
            return out[:int(self._lib.fq3t_ring_read(self._h, _fp(out), n))]
        got = self._buf[:n]
        self._buf = self._buf[n:]
        return got

    def available(self) -> int:
        if self._h is not None:
            return int(self._lib.fq3t_ring_available(self._h))
        return len(self._buf)

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.fq3t_ring_free(self._h)
