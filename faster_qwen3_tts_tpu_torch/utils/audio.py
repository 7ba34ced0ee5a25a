"""Audio I/O helpers: WAV read/write, mono mixdown, resampling, silence append.

The port's own copy of faster_qwen3_tts_tpu/utils/audio.py (same functions,
same results).

Replaces the reference's soundfile/librosa usage (reference model.py:287-293,
ggml_backend.py:42-65) with stdlib/scipy so the framework has no optional
audio dependencies.
"""
from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono [-1,1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def write_wav(path: Union[str, Path], audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1,1] mono audio as 16-bit PCM WAV."""
    pcm = np.clip(np.asarray(audio, np.float32).flatten(), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())


def wav_header(sample_rate: int, num_channels: int = 1, bits: int = 16, data_len: int = 0xFFFFFFFF - 44) -> bytes:
    """Streaming-friendly WAV header with unknown length (the reference's
    0xFFFFFFFF trick, openai_server.py:96-113)."""
    byte_rate = sample_rate * num_channels * bits // 8
    block_align = num_channels * bits // 8
    return b"RIFF" + struct.pack("<I", (data_len + 36) & 0xFFFFFFFF) + b"WAVE" + (
        b"fmt " + struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate, block_align, bits)
    ) + b"data" + struct.pack("<I", data_len & 0xFFFFFFFF)


def float_to_pcm16(audio: np.ndarray) -> bytes:
    return (np.clip(np.asarray(audio, np.float32), -1, 1) * 32767.0).astype("<i2").tobytes()


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample (scipy) with linear-interp fallback."""
    if sr_in == sr_out:
        return np.asarray(audio, np.float32)
    try:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(sr_in, sr_out)
        return resample_poly(np.asarray(audio, np.float64), sr_out // g, sr_in // g).astype(
            np.float32
        )
    except Exception:
        n_out = int(round(len(audio) * sr_out / sr_in))
        x = np.linspace(0.0, 1.0, num=len(audio), endpoint=False)
        xi = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
        return np.interp(xi, x, np.asarray(audio, np.float64)).astype(np.float32)


def load_ref_audio(
    path: Union[str, Path], silence_secs: float = 0.5
) -> Tuple[np.ndarray, int]:
    """Load reference audio, mix to mono, append trailing silence.

    The silence append prevents the reference audio's final phoneme from
    bleeding into the start of generated speech in ICL mode (the reference's
    documented fix, model.py:278-293 / BLOG 'ICL Phoneme Artifact').
    """
    audio, sr = read_wav(path)
    if silence_secs > 0:
        audio = np.concatenate([audio, np.zeros(int(silence_secs * sr), np.float32)])
    return audio, sr
