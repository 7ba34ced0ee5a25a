"""FasterQwen3TTS on PyTorch: x-vector voice clone, streaming and not.

A subset of faster_qwen3_tts_tpu/model.py's public API over this port's
engine: `from_pretrained` (seeded random init at a published geometry; no
download), `warmup`, `generate_voice_clone` and
`generate_voice_clone_streaming` with precomputed x-vector prompts
(`voice_clone_prompt={"ref_spk_embedding": [xvec]}`). ICL prompts, reference
audio, CustomVoice / VoiceDesign and batching are not ported yet (ROADMAP
queue A).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from faster_qwen3_tts_tpu.config import Qwen3TTSConfig, get_config
from faster_qwen3_tts_tpu.utils.tokenizer import PromptTokenizer, load_tokenizer

from . import weights as weights_lib
from .engine import generate as gen_lib
from .engine.fused_stream import codec_deficit
from .models import codec as codec_lib
from .ops import quant as quant_lib
from .prompt import PromptBuilder

logger = logging.getLogger(__name__)

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp32": torch.float32,
           "float32": torch.float32}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP queue A)")


class SpeechTokenizerFacade:
    """Codec decode surface `decode({"audio_codes": [B, T, 16]})`. Every
    decode is padded to a power-of-two frame bucket (at least 32) by
    repeating the last frame and cut to the exact length, as in the JAX
    package, so both give the same samples."""

    def __init__(self, params, cfg: Qwen3TTSConfig):
        self._params = params
        self._cfg = cfg
        self.sample_rate = cfg.codec.sample_rate

    def decode(self, inputs: Dict[str, Any]) -> Tuple[List[np.ndarray], int]:
        codes = np.asarray(inputs["audio_codes"])
        if codes.ndim == 2:
            codes = codes[None]
        return [self._decode_one(c) for c in codes], self.sample_rate

    def _decode_one(self, codes: np.ndarray) -> np.ndarray:
        T = codes.shape[0]
        n = T * self._cfg.codec.total_upsample - codec_deficit(self._cfg.codec)
        bucket = 32
        while bucket < T:
            bucket *= 2
        codes = np.concatenate([codes, np.tile(codes[-1:], (bucket - T, 1))], axis=0)
        device = self._params["codec"]["code_embed"].device
        wav = codec_lib.decode_frames(
            self._params["codec"], self._cfg.codec, torch.as_tensor(codes[None], device=device)
        )
        return wav[0, :n].cpu().numpy()


class FasterQwen3TTS:
    """The PyTorch engine with the JAX package's voice-clone API."""

    def __init__(self, params: Dict[str, Any], config: Qwen3TTSConfig, tokenizer: PromptTokenizer,
                 max_seq_len: int = 2048):
        if params["talker"]["codec_embed"].device.type == "cuda":
            # Process-wide: float32 products and convolutions (the codec) in
            # full float32 (cuDNN defaults to TF32), bf16 products reduced in
            # float32, as the JAX package computes.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.sample_rate = config.codec.sample_rate
        self.prompt_builder = PromptBuilder(params, config)
        self._speech_tokenizer = SpeechTokenizerFacade(params, config)
        self.device_chunk = 32  # frames per chunk in non-streaming generation
        self._warmed_up = False

    @classmethod
    def from_pretrained(
        cls,
        model_name: str,
        device: str = "cuda",
        dtype: Union[str, torch.dtype] = "bfloat16",
        quant: str = "BF16",
        max_seq_len: int = 2048,
        seed: int = 0,
    ) -> "FasterQwen3TTS":
        """Random-init a model at the geometry `config.get_config(model_name)`
        names, from `seed` (no checkpoint is read or downloaded).

        device "cuda" needs a card and raises without one; "cpu" runs the
        kernels' plain versions. quant "BF16" / "Q8_0" (weight-only int8 for
        the talker and predictor projections)."""
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
        elif device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        if isinstance(dtype, str):
            dtype = _DTYPES[dtype.lower()]
        config = get_config(model_name)
        logger.warning("Random-initialized weights for %s (seed %d).", model_name, seed)
        params = weights_lib.init_all(
            config, seed=seed, dtype=dtype, device=device, quant=quant_lib.resolve_quant_name(quant)
        )
        return cls(params, config, PromptTokenizer(load_tokenizer(None)), max_seq_len=max_seq_len)

    def warmup(self, chunk_size: int = 8, first_chunk_size: int = 4) -> None:
        """Run one short greedy stream so that the kernels are built and
        loaded and the allocator is warm before the first request."""
        if self._warmed_up:
            return
        t0 = time.perf_counter()
        prompt = {"ref_spk_embedding": [np.zeros(2048, np.float32)]}
        for _ in self.generate_voice_clone_streaming(
            "Warm up the engine.", "English", voice_clone_prompt=prompt,
            max_new_tokens=first_chunk_size + chunk_size, chunk_size=chunk_size,
            first_chunk_size=first_chunk_size, do_sample=False, subtalker_dosample=False,
            seed=0,
        ):
            pass
        self._warmed_up = True
        logger.info("Warmup complete in %.1fs", time.perf_counter() - t0)

    @property
    def speech_tokenizer(self) -> SpeechTokenizerFacade:
        return self._speech_tokenizer

    # -- voice-clone prompt resolution ---------------------------------------

    def _resolve_precomputed(self, input_ids, voice_clone_prompt) -> List[np.ndarray]:
        """Validate a precomputed prompt -> one x-vector per item."""
        n = len(input_ids)
        if isinstance(voice_clone_prompt, list):
            voice_clone_prompt = {
                "ref_spk_embedding": [i.ref_spk_embedding for i in voice_clone_prompt],
                "x_vector_only_mode": [bool(i.x_vector_only_mode) for i in voice_clone_prompt],
                "icl_mode": [bool(i.icl_mode) for i in voice_clone_prompt],
                "ref_code": [i.ref_code for i in voice_clone_prompt],
            }
        if "ref_spk_embedding" not in voice_clone_prompt:
            raise ValueError("voice_clone_prompt missing required keys: ['ref_spk_embedding']")
        for key in ("ref_spk_embedding", "x_vector_only_mode", "icl_mode", "ref_code"):
            v = voice_clone_prompt.get(key)
            if v is not None and (not isinstance(v, list) or len(v) != n):
                raise ValueError(f"voice_clone_prompt[{key!r}] must be a list with length {n}")
        xvec_modes = [bool(v) for v in voice_clone_prompt.get("x_vector_only_mode", [True] * n)]
        icl_modes = [bool(v) for v in voice_clone_prompt.get("icl_mode", [not m for m in xvec_modes])]
        for i, (xm, im) in enumerate(zip(xvec_modes, icl_modes)):
            if xm == im:
                raise ValueError(
                    f"voice_clone_prompt has inconsistent mode flags at index {i}: "
                    "x_vector_only_mode and icl_mode must be opposites"
                )
        ref_codes = voice_clone_prompt.get("ref_code", [None] * n)
        if any(icl_modes) or any(rc is not None for rc in ref_codes):
            raise _not_ported("ICL voice clone (reference codes)")
        return voice_clone_prompt["ref_spk_embedding"]

    def _prepare_generation(self, text: str, language: str, ref_audio=None,
                            non_streaming_mode: bool = False, voice_clone_prompt=None,
                            instruct: Optional[str] = None):
        if voice_clone_prompt is None:
            if ref_audio is not None:
                raise _not_ported("Voice extraction from reference audio")
            raise ValueError("voice_clone_prompt (a precomputed x-vector) is required")
        input_ids = [self.tokenizer.assistant_ids(text)]
        xvectors = self._resolve_precomputed(input_ids, voice_clone_prompt)
        return self.prompt_builder.build(
            input_ids=input_ids, xvectors=xvectors,
            languages=[language if language is not None else "Auto"],
            non_streaming_mode=non_streaming_mode,
            instruct_ids=[self.tokenizer.instruct_ids(instruct) if instruct else None],
        )

    # -- generation ----------------------------------------------------------

    def generate_voice_clone(
        self,
        text: str,
        language: str,
        ref_audio=None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        non_streaming_mode: Optional[bool] = None,
        instruct: Optional[str] = None,
        voice_clone_prompt=None,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """Voice-clone TTS -> ([waveform], sample_rate)."""
        tie, tam, tth, tpe = self._prepare_generation(
            text, language, ref_audio, bool(non_streaming_mode), voice_clone_prompt, instruct
        )
        codec_ids, timing = gen_lib.fast_generate(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, do_sample=do_sample,
            repetition_penalty=repetition_penalty, seed=seed, device_chunk=self.device_chunk,
        )
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        audio, sr = self._speech_tokenizer.decode({"audio_codes": codec_ids[None]})
        return audio, sr

    def generate_voice_clone_streaming(
        self,
        text: str,
        language: str,
        ref_audio=None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        first_chunk_size: Optional[int] = None,
        instruct: Optional[str] = None,
        voice_clone_prompt=None,
        seed: Optional[int] = None,
        subtalker_dosample: Optional[bool] = None,
        subtalker_top_k: Optional[int] = None,
        subtalker_top_p: Optional[float] = None,
        subtalker_temperature: Optional[float] = None,
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming voice clone: yields (audio_chunk, sample_rate, timing)
        per chunk; chunks are sample-contiguous."""
        tie, tam, tth, tpe = self._prepare_generation(
            text, language, ref_audio, False, voice_clone_prompt, instruct
        )
        stream = gen_lib.fast_generate_streaming_fused(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, do_sample=do_sample,
            repetition_penalty=repetition_penalty, chunk_size=chunk_size, seed=seed,
            first_chunk_size=first_chunk_size, subtalker_dosample=subtalker_dosample,
            subtalker_top_k=subtalker_top_k, subtalker_top_p=subtalker_top_p,
            subtalker_temperature=subtalker_temperature,
        )
        yield from self._stream_decode(stream)

    def _stream_decode(self, stream):
        """Every chunk of an x-vector stream is vocoded on the device after
        its decode (engine/fused_stream.py), so this only relays the audio;
        the host-vocode regimes of the JAX package serve ICL prompts."""
        for _frames, audio, timing in stream:
            yield audio, self.sample_rate, timing
