"""MP3 encoding where an encoder is installed (the JAX package's `utils.mp3`).

Backends, in order: `lameenc` (LAME bindings), then `pydub` (ffmpeg). With
neither, `encode_mp3` raises `Mp3Unavailable` and the server answers 501.
"""
from __future__ import annotations

import io

import numpy as np

from .audio import float_to_pcm16


class Mp3Unavailable(RuntimeError):
    """No MP3 encoder is installed."""


def encode_mp3(audio: np.ndarray, sample_rate: int, bitrate_kbps: int = 128) -> bytes:
    """float32 mono waveform in [-1, 1] -> MP3 bytes."""
    pcm = float_to_pcm16(np.asarray(audio, np.float32))
    try:
        import lameenc  # type: ignore

        enc = lameenc.Encoder()
        enc.set_bit_rate(bitrate_kbps)
        enc.set_in_sample_rate(sample_rate)
        enc.set_channels(1)
        enc.set_quality(2)
        return bytes(enc.encode(pcm)) + bytes(enc.flush())
    except ImportError:
        pass
    try:
        from pydub import AudioSegment  # type: ignore

        seg = AudioSegment(data=pcm, sample_width=2, frame_rate=sample_rate, channels=1)
        buf = io.BytesIO()
        seg.export(buf, format="mp3", bitrate=f"{bitrate_kbps}k")
        return buf.getvalue()
    except ImportError:
        pass
    raise Mp3Unavailable(
        "MP3 output requires an encoder: pip install lameenc, or pydub + ffmpeg. "
        "Use response_format 'wav' or 'pcm' otherwise."
    )
