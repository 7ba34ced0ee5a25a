"""Queue-backed streaming audio player (pull-model callback), for the
examples over the PyTorch port (a copy of examples/audio.py).

The streaming generators are pull-based (blocking in the consumer stalls
generation), so playback runs from a queue drained by an audio callback.
`sounddevice` is optional (absent on headless machines); without it the
player collects the chunks, which the caller writes to a wav file.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

try:
    import sounddevice as sd

    HAS_AUDIO = True
except Exception:  # pragma: no cover - headless
    sd = None
    HAS_AUDIO = False


class StreamPlayer:
    """Push audio chunks from the generation loop; a callback (or buffer)
    pulls at device rate."""

    def __init__(self, sample_rate: int = 24000, blocksize: int = 2048):
        self.sample_rate = sample_rate
        self.blocksize = blocksize
        self._q: queue.Queue = queue.Queue()
        self._buf = np.zeros(0, np.float32)
        self._done = threading.Event()
        self._collected = []  # headless fallback
        self._stream = None

    def _callback(self, outdata, frames, time_info, status):  # pragma: no cover
        need = frames
        out = np.zeros(need, np.float32)
        pos = 0
        while pos < need:
            if self._buf.size == 0:
                try:
                    self._buf = self._q.get_nowait()
                except queue.Empty:
                    break
            take = min(need - pos, self._buf.size)
            out[pos : pos + take] = self._buf[:take]
            self._buf = self._buf[take:]
            pos += take
        outdata[:, 0] = out

    def start(self) -> None:
        if HAS_AUDIO:  # pragma: no cover
            self._stream = sd.OutputStream(
                samplerate=self.sample_rate,
                channels=1,
                blocksize=self.blocksize,
                callback=self._callback,
            )
            self._stream.start()

    def push(self, audio: np.ndarray) -> None:
        audio = np.asarray(audio, np.float32)
        if HAS_AUDIO:  # pragma: no cover
            self._q.put(audio)
        else:
            self._collected.append(audio)

    def drain(self) -> None:
        """Block until queued audio has played (no-op headless)."""
        if HAS_AUDIO and self._stream is not None:  # pragma: no cover
            import time

            while not self._q.empty() or self._buf.size:
                time.sleep(0.05)
            self._stream.stop()
            self._stream.close()

    def collected(self) -> np.ndarray:
        return np.concatenate(self._collected) if self._collected else np.zeros(0, np.float32)
