"""NativeQwen3TTS: the port's engine with the native backend's host side.

Counterpart of faster_qwen3_tts_tpu/native_backend.py, selected by
`FasterQwen3TTS.from_pretrained(backend="native")`. The compute path is the
port's engine; what it adds is host work around it:

- a content-addressed voice-reference disk cache: sha256 over the audio's
  float32 bytes and `sr|model_size|model_type|xvec_only|silence|v1` names a
  `.spk` (x-vector) / `.rvq` (codec tokens) / `.json` (metadata) triplet,
  each file written to a temporary name and renamed. The key and the files
  are the JAX package's, so one directory serves both packages. The
  directory is `voice_ref_cache_dir`, else `FQ3TTS_REF_CACHE_DIR`, else
  ~/.cache/faster-qwen3-tts-tpu/voice_refs;
- the cached-reference inputs `ref_spk` (an `.spk` file) / `ref_rvq` (an
  `.rvq` file) / `ref_spk_emb` / `ref_codes` of the voice-clone methods,
  with the JAX package's mutual-exclusion checks. They resolve to prompt
  items that take the `voice_clone_prompt` route of any other request, so a
  streaming request keeps its device-assembled prompt and captured prefill;
- the host library (`utils/native.py`: resampling, WAV framing, a ring
  buffer).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .model import FasterQwen3TTS, VoiceClonePromptItem
from .utils import audio as audio_lib

logger = logging.getLogger(__name__)

_DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "faster-qwen3-tts-tpu", "voice_refs")


def _cache_dir(voice_ref_cache_dir) -> Path:
    return Path(voice_ref_cache_dir or os.environ.get("FQ3TTS_REF_CACHE_DIR") or _DEFAULT_CACHE_DIR)


class NativeQwen3TTS(FasterQwen3TTS):
    """FasterQwen3TTS plus the voice-reference cache and the host library."""

    def __init__(self, *args, voice_ref_cache_dir: Optional[Union[str, Path]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.voice_ref_cache_dir = _cache_dir(voice_ref_cache_dir)
        self._mem_ref_cache: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}

    @classmethod
    def from_pretrained(cls, model_name: str, voice_ref_cache_dir=None, **kwargs) -> "NativeQwen3TTS":
        """`FasterQwen3TTS.from_pretrained` with the same keyword arguments,
        plus the cache directory."""
        kwargs.pop("backend", None)
        base = FasterQwen3TTS.from_pretrained(model_name, backend="torch", **kwargs)
        obj = cls.__new__(cls)
        obj.__dict__.update(base.__dict__)
        obj.voice_ref_cache_dir = _cache_dir(voice_ref_cache_dir)
        obj._mem_ref_cache = {}
        return obj

    # -- content-addressed reference cache ------------------------------------

    def _ref_cache_key(self, audio: np.ndarray, sr: int, xvec_only: bool, silence: bool) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(audio, np.float32).tobytes())
        h.update(f"{sr}|{self.config.model_size}|{self.config.model_type}|{xvec_only}|{silence}|v1".encode())
        return h.hexdigest()

    def _cache_paths(self, key: str) -> Dict[str, Path]:
        d = self.voice_ref_cache_dir
        return {"spk": d / f"{key}.spk", "rvq": d / f"{key}.rvq", "meta": d / f"{key}.json"}

    def _load_cached_ref(self, key: str) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        if key in self._mem_ref_cache:
            return self._mem_ref_cache[key]
        p = self._cache_paths(key)
        if not (p["spk"].exists() and p["meta"].exists()):
            return None
        try:
            meta = json.loads(p["meta"].read_text())
            if meta.get("key") != key:
                return None
            xvec = np.fromfile(p["spk"], dtype=np.float32)
            codes = None
            if meta.get("has_rvq") and p["rvq"].exists():
                codes = np.fromfile(p["rvq"], dtype=np.int32).reshape(-1, meta["num_quantizers"])
        except (OSError, ValueError, KeyError):
            logger.warning("corrupt voice-ref cache entry %s; re-extracting", key)
            return None
        self._mem_ref_cache[key] = (xvec, codes)
        return xvec, codes

    def _store_cached_ref(self, key: str, xvec: np.ndarray, codes: Optional[np.ndarray]) -> None:
        """Write the triplet, each file to a temporary name then renamed."""
        d = self.voice_ref_cache_dir
        d.mkdir(parents=True, exist_ok=True)
        p = self._cache_paths(key)

        def atomic_write(path: Path, data: bytes) -> None:
            fd, tmp = tempfile.mkstemp(dir=str(d), suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

        atomic_write(p["spk"], np.ascontiguousarray(xvec, np.float32).tobytes())
        if codes is not None:
            atomic_write(p["rvq"], np.ascontiguousarray(codes, np.int32).tobytes())
        meta = {"key": key, "has_rvq": codes is not None,
                "num_quantizers": int(codes.shape[1]) if codes is not None else 0,
                "model_size": self.config.model_size, "model_type": self.config.model_type, "version": 1}
        atomic_write(p["meta"], json.dumps(meta).encode())
        self._mem_ref_cache[key] = (xvec, codes)

    # -- extraction with caching ----------------------------------------------

    def extract_voice_ref(
        self,
        ref_audio: Union[str, Path, Tuple[np.ndarray, int]],
        xvec_only: bool = False,
        append_silence: bool = True,
    ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[str, Any]]:
        """A recording (a wav path or (samples, sample_rate)) -> (x-vector,
        codec tokens or None, {"cache": "hit" | "miss", "prepare_ms"}),
        extracted once and then read from memory or disk. ICL extraction
        appends 0.5 s of silence unless append_silence is False."""
        if isinstance(ref_audio, (str, Path)):
            audio, sr = audio_lib.read_wav(ref_audio)
        else:
            audio, sr = ref_audio
            audio = np.asarray(audio, np.float32)
        if append_silence and not xvec_only:
            audio = np.concatenate([audio, np.zeros(int(0.5 * sr), np.float32)])
        key = self._ref_cache_key(audio, sr, xvec_only, append_silence)
        t0 = time.perf_counter()
        cached = self._load_cached_ref(key)
        if cached is not None:
            xvec, codes = cached
            return xvec, codes, {"cache": "hit", "prepare_ms": (time.perf_counter() - t0) * 1e3}
        extractor = self._get_voice_extractor()
        xvec = extractor.extract_xvector(audio, sr)
        codes = None if xvec_only else extractor.extract_codes(audio, sr)
        self._store_cached_ref(key, xvec, codes)
        return xvec, codes, {"cache": "miss", "prepare_ms": (time.perf_counter() - t0) * 1e3}

    # -- cached-reference keywords --------------------------------------------

    @staticmethod
    def _validate_cached_ref_args(ref_audio, ref_spk, ref_rvq, ref_spk_emb, ref_codes) -> None:
        provided = [name for name, v in (("ref_audio", ref_audio), ("ref_spk", ref_spk),
                                         ("ref_spk_emb", ref_spk_emb)) if v is not None]
        if len(provided) > 1:
            raise ValueError(f"Provide only one of ref_audio/ref_spk/ref_spk_emb, got {provided}")
        if ref_rvq is not None and ref_codes is not None:
            raise ValueError("Provide only one of ref_rvq/ref_codes")

    def _resolve_cached_reference(
        self, ref_audio, ref_text, xvec_only, append_silence,
        ref_spk=None, ref_rvq=None, ref_spk_emb=None, ref_codes=None,
    ) -> Optional[List[VoiceClonePromptItem]]:
        """The cached-reference keywords -> prompt items, or None where the
        plain `ref_audio` / `voice_clone_prompt` route should run."""
        self._validate_cached_ref_args(ref_audio, ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        if ref_spk is not None:
            ref_spk_emb = np.fromfile(ref_spk, dtype=np.float32)
        if ref_rvq is not None:
            ref_codes = np.fromfile(ref_rvq, dtype=np.int32).reshape(-1, self.config.codec.num_quantizers)
        if ref_spk_emb is None and ref_codes is None:
            if ref_audio is None:
                return None
            ref_spk_emb, ref_codes, _ = self.extract_voice_ref(ref_audio, xvec_only=xvec_only,
                                                               append_silence=append_silence)
        if ref_spk_emb is None:
            raise ValueError("ref_codes requires a speaker embedding (ref_spk/ref_spk_emb)")
        icl = ref_codes is not None and not xvec_only
        if icl and not ref_text:
            raise ValueError("ref_text is required for ICL cached references")
        return [VoiceClonePromptItem(
            ref_spk_embedding=np.asarray(ref_spk_emb, np.float32),
            ref_code=np.asarray(ref_codes, np.int32) if icl else None,
            icl_mode=icl, x_vector_only_mode=not icl, ref_text=ref_text if icl else "",
        )]

    # -- the voice-clone methods with the cached-reference keywords -----------

    def generate_voice_clone(
        self, text: str, language: str, ref_audio=None, ref_text: str = "",
        ref_spk=None, ref_rvq=None, ref_spk_emb=None, ref_codes=None,
        xvec_only: bool = False, append_silence: bool = True, **kwargs,
    ):
        items = self._resolve_cached_reference(ref_audio, ref_text, xvec_only, append_silence,
                                               ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        if items is not None:
            kwargs["voice_clone_prompt"] = items
            ref_audio = None
        return super().generate_voice_clone(text, language, ref_audio=ref_audio, ref_text=ref_text,
                                            xvec_only=xvec_only, append_silence=append_silence, **kwargs)

    def generate_voice_clone_streaming(
        self, text: str, language: str, ref_audio=None, ref_text: str = "",
        ref_spk=None, ref_rvq=None, ref_spk_emb=None, ref_codes=None,
        xvec_only: bool = False, append_silence: bool = True, **kwargs,
    ):
        items = self._resolve_cached_reference(ref_audio, ref_text, xvec_only, append_silence,
                                               ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        if items is not None:
            kwargs["voice_clone_prompt"] = items
            ref_audio = None
        return super().generate_voice_clone_streaming(text, language, ref_audio=ref_audio, ref_text=ref_text,
                                                      xvec_only=xvec_only, append_silence=append_silence,
                                                      **kwargs)
