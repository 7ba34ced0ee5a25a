"""The port's host library binding (utils/native.py over csrc/fq3t.cpp)
against the JAX package's (utils/native.py over native/fq3t.cpp), case for
case as tests/test_native.py.

Both compile the same source with the same flags on this machine, so the
library's outputs are bitwise equal; the numpy fallbacks are held to the
port's `utils.audio`."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from faster_qwen3_tts_tpu.utils import native as jax_native
from faster_qwen3_tts_tpu_torch.utils import audio as audio_lib
from faster_qwen3_tts_tpu_torch.utils import native

REPO = Path(__file__).resolve().parent.parent
HAVE_TOOLCHAIN = shutil.which("g++") is not None and shutil.which("make") is not None
needs_toolchain = pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no g++ / make to build the host library")


def test_pcm16_roundtrip():
    x = np.linspace(-1, 1, 1000).astype(np.float32)
    pcm = native.float_to_pcm16(x)
    assert pcm == jax_native.float_to_pcm16(x)
    back = np.frombuffer(pcm, "<i2").astype(np.float32) / 32767.0
    assert np.abs(back - x).max() < 1e-3


def test_resample_tone_preserved():
    """A 440 Hz tone resampled 16k -> 24k stays a 440 Hz tone, bitwise as
    the JAX package's library resamples it."""
    sr_in, sr_out = 16000, 24000
    t = np.arange(sr_in) / sr_in
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    y = native.resample(x, sr_in, sr_out)
    np.testing.assert_array_equal(y, jax_native.resample(x, sr_in, sr_out))
    assert abs(len(y) - sr_out) <= 2
    spec = np.abs(np.fft.rfft(y[: sr_out // 2]))
    freq = np.fft.rfftfreq(sr_out // 2, 1 / sr_out)
    assert abs(freq[np.argmax(spec)] - 440) < 5


def test_wav_write_read(tmp_path):
    x = (np.sin(np.linspace(0, 40 * np.pi, 4800)) * 0.5).astype(np.float32)
    native.write_wav(tmp_path / "port.wav", x, 24000)
    jax_native.write_wav(tmp_path / "jax.wav", x, 24000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    back, sr = audio_lib.read_wav(tmp_path / "port.wav")
    assert sr == 24000
    assert np.abs(back - x).max() < 1e-3


@needs_toolchain
def test_native_matches_numpy_resample():
    assert native.available(), native.build_error
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8000).astype(np.float32) * 0.3
    x = np.convolve(x, np.ones(8) / 8, mode="same").astype(np.float32)  # band-limited content
    y_native = native.resample(x, 16000, 24000)
    np.testing.assert_array_equal(y_native, jax_native.resample(x, 16000, 24000))
    y_np = audio_lib.resample(x, 16000, 24000)
    n = min(len(y_native), len(y_np)) - 100
    assert np.abs(y_native[50:n] - y_np[50:n]).mean() < 0.01


@needs_toolchain
def test_ring_buffer():
    assert native.available(), native.build_error
    ours, theirs = native.RingBuffer(1024), jax_native.RingBuffer(1024)
    data = np.arange(300, dtype=np.float32)
    assert ours.write(data) == theirs.write(data) == 300
    assert ours.available() == theirs.available() == 300
    out = ours.read(100)
    np.testing.assert_array_equal(out, data[:100])
    np.testing.assert_array_equal(out, theirs.read(100))
    assert ours.available() == 200
    more = np.arange(800, dtype=np.float32)
    assert ours.write(more) == theirs.write(more)  # wraps around; both stop at the same fill
    assert ours.available() == theirs.available() <= 1024
    np.testing.assert_array_equal(ours.read(2000), theirs.read(2000))


@needs_toolchain
def test_native_builds_from_the_ports_own_source():
    """The library is built at first use from the port's copy of the source
    into build/fq3t_torch/, under a name that carries the source's hash
    (an edit rebuilds); the copy's code is the JAX package's, with its ABI
    version, and nothing is written under native/."""
    native_so = REPO / "native" / "libfq3t.so"
    before = native_so.stat().st_mtime if native_so.exists() else None
    assert native.available(), native.build_error
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "fq3t_torch"
    assert native.SOURCE == REPO / "faster_qwen3_tts_tpu_torch" / "csrc" / "fq3t.cpp"
    ours, theirs = native.SOURCE.read_text(), (REPO / "native" / "fq3t.cpp").read_text()
    body = "#include <cstdint>"
    assert ours[ours.index(body):] == theirs[theirs.index(body):]
    assert native.load_library().fq3t_abi_version() == native.ABI_VERSION == 1
    assert (native_so.stat().st_mtime if native_so.exists() else None) == before


def test_numpy_fallbacks_without_the_library(monkeypatch, tmp_path):
    """Where the library cannot load, every entry point takes the numpy
    version of `utils.audio`."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    x = (np.sin(np.arange(3000) / 7) * 0.4).astype(np.float32)
    np.testing.assert_array_equal(native.resample(x, 16000, 24000), audio_lib.resample(x, 16000, 24000))
    assert native.float_to_pcm16(x) == audio_lib.float_to_pcm16(x)
    native.write_wav(tmp_path / "a.wav", x, 16000)
    audio_lib.write_wav(tmp_path / "b.wav", x, 16000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    rb = native.RingBuffer(8)
    assert rb.write(np.arange(10, dtype=np.float32)) == 8 and rb.available() == 8
    np.testing.assert_array_equal(rb.read(3), [0, 1, 2])
