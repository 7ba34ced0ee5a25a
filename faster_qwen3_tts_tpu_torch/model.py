"""FasterQwen3TTS on PyTorch: voice clone, CustomVoice and VoiceDesign,
streaming and not.

A subset of faster_qwen3_tts_tpu/model.py's public API over this port's
engine, with the JAX package's signatures: `from_pretrained` (seeded random
init at a published geometry, 0.6B or 1.7B; no download), `warmup`,
`create_voice_clone_prompt`, `generate_voice_clone[_streaming]` (Base
models: a voice from a reference recording, `ref_audio` + `ref_text` for ICL
mode or `xvec_only=True`, or from a precomputed `voice_clone_prompt`),
`generate_custom_voice[_streaming]` (CustomVoice models: a preset speaker,
`get_supported_speakers`) and `generate_voice_design[_streaming]`
(VoiceDesign models: the voice described by an instruction). CustomVoice and
VoiceDesign put the whole text into the prefill unless `non_streaming_mode`
is False. `parity_mode`, the native-backend cached-reference kwargs and
batching are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import Qwen3TTSConfig, get_config
from faster_qwen3_tts_tpu_torch.utils import audio as audio_lib
from faster_qwen3_tts_tpu_torch.utils.tokenizer import PromptTokenizer, load_tokenizer

from . import weights as weights_lib
from .engine import generate as gen_lib
from .engine.fused_stream import codec_deficit
from .models import codec as codec_lib
from .ops import quant as quant_lib
from .prompt import PromptBuilder

logger = logging.getLogger(__name__)

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp32": torch.float32,
           "float32": torch.float32}


@dataclasses.dataclass
class VoiceClonePromptItem:
    """One reference-voice prompt item, as `create_voice_clone_prompt` returns."""

    ref_spk_embedding: np.ndarray  # [2048] x-vector
    ref_code: Optional[np.ndarray] = None  # [T, 16] codec tokens (ICL only)
    icl_mode: bool = False
    x_vector_only_mode: bool = True
    ref_text: str = ""


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
    """The PyTorch engine with the JAX package's single-request API."""

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
        self._voice_prompt_cache: Dict[Any, Any] = {}
        self._voice_extractor = None

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

    @staticmethod
    def _resolve_non_streaming_mode(non_streaming_mode: Optional[bool], *, default: bool) -> bool:
        """None -> the method's default: voice clone False (text step-fed),
        CustomVoice and VoiceDesign True (the whole text in the prefill)."""
        return default if non_streaming_mode is None else non_streaming_mode

    def generate(self, *args, **kwargs):
        raise NotImplementedError(
            "Default voice generation not implemented. Use generate_voice_clone(), "
            "generate_custom_voice(), or generate_voice_design()."
        )

    def _validate_languages(self, languages: List[str]) -> None:
        known = self.config.talker.codec_language_id
        for lang in languages:
            if lang is not None and lang.lower() != "auto" and lang.lower() not in known:
                raise NotImplementedError(f"Language {lang} not implemented")

    def _validate_speakers(self, speakers: List[str]) -> None:
        for s in speakers:
            if s and s.lower() not in self.config.talker.spk_id:
                raise NotImplementedError(f"Speaker {s} not implemented")

    def get_supported_speakers(self) -> List[str]:
        return sorted(self.config.talker.spk_id.keys())

    @property
    def tts_model_type(self) -> str:
        return self.config.model_type

    @property
    def tts_model_size(self) -> str:
        return self.config.model_size

    # -- voice-clone prompts ---------------------------------------------------

    def create_voice_clone_prompt(
        self,
        ref_audio: Union[str, Path, Tuple[np.ndarray, int]],
        ref_text: str = "",
        x_vector_only_mode: bool = False,
    ) -> List[VoiceClonePromptItem]:
        """Extract a voice-clone prompt from reference audio (a wav path or
        (samples, sample_rate)): the x-vector, and in ICL mode the reference
        codec tokens."""
        if isinstance(ref_audio, (str, Path)):
            audio, sr = audio_lib.read_wav(ref_audio)
        else:
            audio, sr = ref_audio
            audio = np.asarray(audio, np.float32)
        extractor = self._get_voice_extractor()
        xvec = extractor.extract_xvector(audio, sr)
        if x_vector_only_mode:
            return [VoiceClonePromptItem(ref_spk_embedding=xvec, icl_mode=False,
                                         x_vector_only_mode=True, ref_text="")]
        ref_code = extractor.extract_codes(audio, sr)
        return [VoiceClonePromptItem(ref_spk_embedding=xvec, ref_code=ref_code, icl_mode=True,
                                     x_vector_only_mode=False, ref_text=ref_text)]

    def _get_voice_extractor(self):
        """The two reference-audio encoders, built at first use in float32
        on the model's device."""
        if self._voice_extractor is None:
            from .models.voice_extract import VoiceExtractor

            self._voice_extractor = VoiceExtractor(self.params, self.config)
        return self._voice_extractor

    @staticmethod
    def _prompt_items_to_voice_clone_prompt(items: List[VoiceClonePromptItem]) -> Dict[str, Any]:
        return dict(
            ref_code=[i.ref_code for i in items],
            ref_spk_embedding=[i.ref_spk_embedding for i in items],
            x_vector_only_mode=[bool(i.x_vector_only_mode) for i in items],
            icl_mode=[bool(i.icl_mode) for i in items],
        )

    def _resolve_voice_clone_prompt(self, input_ids, ref_audio, ref_text, xvec_only, append_silence,
                                    voice_clone_prompt):
        """-> (voice_clone_prompt dict of per-item lists, ref_ids, using_icl)."""
        if voice_clone_prompt is not None:
            return self._resolve_precomputed(input_ids, ref_text, voice_clone_prompt)
        if ref_audio is None:
            raise ValueError("ref_audio is required when voice_clone_prompt is not provided")
        return self._resolve_from_reference(input_ids, ref_audio, ref_text, xvec_only, append_silence)

    def _resolve_precomputed(self, input_ids, ref_text, voice_clone_prompt):
        n = len(input_ids)
        if isinstance(voice_clone_prompt, list):
            if len(voice_clone_prompt) != n:
                raise ValueError(f"voice_clone_prompt must have length {n}, got {len(voice_clone_prompt)}")
            vcp = self._prompt_items_to_voice_clone_prompt(voice_clone_prompt)
            ref_ids = []
            for item in voice_clone_prompt:
                if bool(item.icl_mode):
                    item_text = item.ref_text or ref_text
                    if not item_text:
                        raise ValueError("ref_text is required when voice_clone_prompt uses ICL mode.")
                    ref_ids.append(self.tokenizer.ref_ids(item_text))
                else:
                    ref_ids.append(None)
            return vcp, ref_ids, any(vcp["icl_mode"])

        if "ref_spk_embedding" not in voice_clone_prompt:
            raise ValueError("voice_clone_prompt missing required keys: ['ref_spk_embedding']")
        for key in ("ref_spk_embedding", "x_vector_only_mode", "icl_mode", "ref_code"):
            v = voice_clone_prompt.get(key)
            if key in voice_clone_prompt and (not isinstance(v, list) or len(v) != n):
                raise ValueError(f"voice_clone_prompt[{key!r}] must be a list with length {n}")
        xvec_modes = [bool(v) for v in voice_clone_prompt.get("x_vector_only_mode", [True] * n)]
        if "icl_mode" in voice_clone_prompt:
            icl_modes = [bool(v) for v in voice_clone_prompt["icl_mode"]]
            for i, (xm, im) in enumerate(zip(xvec_modes, icl_modes)):
                if xm == im:
                    raise ValueError(
                        f"voice_clone_prompt has inconsistent mode flags at index {i}: "
                        "x_vector_only_mode and icl_mode must be opposites"
                    )
        else:
            icl_modes = [not m for m in xvec_modes]
        ref_codes = voice_clone_prompt.get("ref_code", [None] * n)
        for i, (xm, im, rc) in enumerate(zip(xvec_modes, icl_modes, ref_codes)):
            if xm and rc is not None:
                raise ValueError(f"voice_clone_prompt index {i}: ref_code must be None in x_vector_only mode")
            if im and rc is None:
                raise ValueError(f"voice_clone_prompt index {i}: ref_code is required in ICL mode")
        vcp = dict(ref_code=ref_codes, ref_spk_embedding=voice_clone_prompt["ref_spk_embedding"],
                   x_vector_only_mode=xvec_modes, icl_mode=icl_modes)
        using_icl = any(icl_modes)
        if not using_icl:
            return vcp, [None] * n, False
        if not ref_text:
            raise ValueError("ref_text is required when voice_clone_prompt uses ICL mode.")
        rid = self.tokenizer.ref_ids(ref_text)
        return vcp, [rid if im else None for im in icl_modes], True

    def _resolve_from_reference(self, input_ids, ref_audio, ref_text, xvec_only, append_silence):
        """Extract (or take from the per-model cache) the prompt of a
        reference recording. ICL mode appends 0.5 s of silence unless
        append_silence is False."""
        using_icl = not xvec_only
        cache_key = (str(ref_audio), ref_text, xvec_only, append_silence)
        if cache_key in self._voice_prompt_cache:
            vcp, ref_ids = self._voice_prompt_cache[cache_key]
            return vcp, ref_ids, using_icl
        if xvec_only:
            items = self.create_voice_clone_prompt(str(ref_audio), ref_text="", x_vector_only_mode=True)
            ref_ids = [None] * len(input_ids)
        else:
            if not ref_text:
                raise ValueError("ref_text is required for ICL voice clone from ref_audio "
                                 "(or pass xvec_only=True)")
            audio, sr = audio_lib.load_ref_audio(ref_audio, silence_secs=0.5 if append_silence else 0.0)
            items = self.create_voice_clone_prompt((audio, sr), ref_text=ref_text)
            ref_ids = [self.tokenizer.ref_ids(items[0].ref_text)]
        vcp = self._prompt_items_to_voice_clone_prompt(items)
        self._voice_prompt_cache[cache_key] = (vcp, ref_ids)
        return vcp, ref_ids, using_icl

    def _prepare_generation(self, text: str, ref_audio=None, ref_text: str = "", language: str = "English",
                            xvec_only: bool = False, non_streaming_mode: bool = False,
                            append_silence: bool = True, voice_clone_prompt=None,
                            instruct: Optional[str] = None):
        """-> (tie, attention_mask, tth, tpe, ref_codes [R, 16] int32 or None)."""
        input_ids = [self.tokenizer.assistant_ids(text)]
        instruct_ids = [self.tokenizer.instruct_ids(instruct)] if instruct else [None]
        vcp, ref_ids, using_icl = self._resolve_voice_clone_prompt(
            input_ids, ref_audio, ref_text, xvec_only, append_silence, voice_clone_prompt
        )
        if instruct and not using_icl:
            logger.warning("Base-model instruct with x-vector-only voice cloning is experimental; "
                           "prefer xvec_only=False (ICL mode).")
        ref_codes = None
        if using_icl and vcp.get("ref_code") and vcp["ref_code"][0] is not None:
            ref_codes = np.asarray(vcp["ref_code"][0], np.int32)
        tie, tam, tth, tpe = self.prompt_builder.build(
            input_ids=input_ids, ref_ids=ref_ids, voice_clone_prompt=vcp,
            languages=[language if language is not None else "Auto"], speakers=None,
            non_streaming_mode=non_streaming_mode, instruct_ids=instruct_ids,
        )
        return tie, tam, tth, tpe, ref_codes

    def _prepare_generation_custom(self, text, language, speaker, instruct=None, non_streaming_mode=True):
        """Prompt of a CustomVoice (preset `speaker`) or VoiceDesign
        (speaker None, voice described by `instruct`) request -> (tie,
        attention_mask, tth, tpe)."""
        return self.prompt_builder.build(
            input_ids=[self.tokenizer.assistant_ids(text)], ref_ids=[None], voice_clone_prompt=None,
            languages=[language if language is not None else "Auto"], speakers=[speaker],
            non_streaming_mode=non_streaming_mode,
            instruct_ids=[self.tokenizer.instruct_ids(instruct) if instruct else None],
        )

    # -- codec decode helpers --------------------------------------------------

    def _decode_audio(self, codec_ids: np.ndarray, ref_codes: Optional[np.ndarray]):
        """Whole-sequence codec decode; ICL reference codes are prepended and
        their share of the samples is cut off proportionally."""
        codes = codec_ids if ref_codes is None else np.concatenate([ref_codes, codec_ids], axis=0)
        audio_list, sr = self._speech_tokenizer.decode({"audio_codes": codes[None]})
        ref_len = 0 if ref_codes is None else ref_codes.shape[0]
        outs = []
        for a in audio_list:
            a = np.asarray(a).flatten()
            if ref_len > 0:
                a = a[int(ref_len / max(codes.shape[0], 1) * len(a)):]
            outs.append(a)
        return outs, sr

    def _log_rtf(self, timing: Dict[str, Any]) -> None:
        audio_s = timing["steps"] / self.config.frame_rate
        total = timing["prefill_ms"] / 1000 + timing["decode_s"]
        logger.info("Generated %.2fs audio in %.2fs (%.1fms/step, RTF: %.2f)", audio_s, total,
                    timing["ms_per_step"], audio_s / total if total > 0 else 0)

    # -- generation ----------------------------------------------------------

    @staticmethod
    def _reject_unported(parity_mode: bool, ref_spk=None, ref_rvq=None, ref_spk_emb=None,
                         ref_codes=None) -> None:
        """The cached-reference kwargs belong to the native backend; the JAX
        package accepts them in its signature and rejects them at call time,
        and so does the port. parity_mode's eager engine is not ported."""
        if any(v is not None for v in (ref_spk, ref_rvq, ref_spk_emb, ref_codes)):
            raise NotImplementedError(
                "ref_spk/ref_rvq cached references require backend='native'. "
                "Use voice_clone_prompt for precomputed prompts."
            )
        if parity_mode:
            raise NotImplementedError(
                "parity_mode (engine/parity.py) is not ported to the PyTorch package yet (ROADMAP queue A)")

    def generate_voice_clone(
        self,
        text: str,
        language: str,
        ref_audio: Optional[Union[str, Path]] = None,
        ref_text: str = "",
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        xvec_only: bool = False,
        non_streaming_mode: Optional[bool] = None,
        append_silence: bool = True,
        parity_mode: bool = False,
        instruct: Optional[str] = None,
        ref_spk: Optional[Union[str, Path]] = None,
        ref_rvq: Optional[Union[str, Path]] = None,
        ref_spk_emb: Optional[np.ndarray] = None,
        ref_codes: Optional[np.ndarray] = None,
        voice_clone_prompt=None,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """Voice-clone TTS -> ([waveform], sample_rate)."""
        self._reject_unported(parity_mode, ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=False)
        tie, tam, tth, tpe, ref_codes = self._prepare_generation(
            text=text, ref_audio=ref_audio, ref_text=ref_text, language=language, xvec_only=xvec_only,
            non_streaming_mode=nsm, append_silence=append_silence,
            voice_clone_prompt=voice_clone_prompt, instruct=instruct,
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
        audio, sr = self._decode_audio(codec_ids, ref_codes)
        self._log_rtf(timing)
        return audio, sr

    def generate_voice_clone_streaming(
        self,
        text: str,
        language: str,
        ref_audio: Optional[Union[str, Path]] = None,
        ref_text: str = "",
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        first_chunk_size: Optional[int] = None,
        xvec_only: bool = False,
        non_streaming_mode: Optional[bool] = None,
        append_silence: bool = True,
        parity_mode: bool = False,
        instruct: Optional[str] = None,
        ref_spk: Optional[Union[str, Path]] = None,
        ref_rvq: Optional[Union[str, Path]] = None,
        ref_spk_emb: Optional[np.ndarray] = None,
        ref_codes: Optional[np.ndarray] = None,
        voice_clone_prompt=None,
        seed: Optional[int] = None,
        subtalker_dosample: Optional[bool] = None,
        subtalker_top_k: Optional[int] = None,
        subtalker_top_p: Optional[float] = None,
        subtalker_temperature: Optional[float] = None,
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming voice clone: yields (audio_chunk, sample_rate, timing)
        per chunk; chunks are sample-contiguous (up to the proportional cut
        of a short ICL reference)."""
        self._reject_unported(parity_mode, ref_spk, ref_rvq, ref_spk_emb, ref_codes)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=False)
        tie, tam, tth, tpe, ref_codes = self._prepare_generation(
            text=text, ref_audio=ref_audio, ref_text=ref_text, language=language, xvec_only=xvec_only,
            non_streaming_mode=nsm, append_silence=append_silence,
            voice_clone_prompt=voice_clone_prompt, instruct=instruct,
        )
        stream = gen_lib.fast_generate_streaming_fused(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, do_sample=do_sample,
            repetition_penalty=repetition_penalty, chunk_size=chunk_size, seed=seed,
            first_chunk_size=first_chunk_size, subtalker_dosample=subtalker_dosample,
            subtalker_top_k=subtalker_top_k, subtalker_top_p=subtalker_top_p,
            subtalker_temperature=subtalker_temperature,
            # x-vector streams and ICL streams with >= 24 reference frames
            # vocode every chunk on the device; a shorter reference keeps the
            # host decode that prepends it until 24 frames were generated
            fuse_first_chunk=ref_codes is None, ref_codes=ref_codes,
        )
        yield from self._stream_decode(stream, ref_codes)

    def _stream_decode(self, stream, ref_codes: Optional[np.ndarray]):
        """Relays a stream's audio in three regimes:
        1. fused chunks: audio already vocoded on the device;
        2. plain chunks before 24 context frames exist: accumulated decode
           through the bucketed codec facade, ICL reference codes prepended and
           their share of the samples cut off proportionally;
        3. plain chunks after that: a fixed 24-frame left-context window,
           emitting the window-local samples [ctx*up - D, (ctx+n)*up - D).
        The JAX package vocodes regimes 2-3 on a worker thread; here they run
        inline, giving the same samples in the same order."""
        ctx = gen_lib.CONTEXT_FRAMES
        up = self.config.codec.total_upsample
        D = codec_deficit(self.config.codec)
        all_codes: List[np.ndarray] = []
        prev_len = 0  # samples emitted, in generated-audio coordinates
        for codec_chunk, fused_audio, timing in stream:
            all_codes.append(codec_chunk)
            if fused_audio is not None:
                prev_len += len(fused_audio)
                yield fused_audio, self.sample_rate, timing
                continue
            all_flat = np.concatenate(all_codes, axis=0)
            n_new = codec_chunk.shape[0]
            if all_flat.shape[0] - n_new >= ctx:
                (audio,), _ = self._speech_tokenizer.decode({"audio_codes": all_flat[-(ctx + n_new):][None]})
                new_audio = audio[ctx * up - D:(ctx + n_new) * up - D]
                prev_len += len(new_audio)
            else:
                codes_in = all_flat if ref_codes is None else np.concatenate([ref_codes, all_flat], axis=0)
                (audio,), _ = self._speech_tokenizer.decode({"audio_codes": codes_in[None]})
                if ref_codes is not None:
                    audio = audio[int(ref_codes.shape[0] / max(codes_in.shape[0], 1) * len(audio)):]
                new_audio = audio[prev_len:]
                prev_len = len(audio)
            yield new_audio, self.sample_rate, timing

    # -- CustomVoice and VoiceDesign -------------------------------------------

    def _generate_custom(self, text, language, speaker, instruct, nsm, **sampling):
        """Non-streaming CustomVoice / VoiceDesign -> ([waveform], sample_rate)."""
        tie, tam, tth, tpe = self._prepare_generation_custom(
            text, language, speaker, instruct=instruct, non_streaming_mode=nsm
        )
        codec_ids, timing = gen_lib.fast_generate(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            device_chunk=self.device_chunk, **sampling,
        )
        if codec_ids is None:
            logger.warning("Generation returned no tokens")
            return [np.zeros(1, np.float32)], self.sample_rate
        audio, sr = self._decode_audio(codec_ids, None)
        self._log_rtf(timing)
        return audio, sr

    def _generate_custom_streaming(self, text, language, speaker, instruct, nsm, **sampling):
        """Streaming CustomVoice / VoiceDesign: every chunk, the first
        included, is vocoded on the device."""
        tie, tam, tth, tpe = self._prepare_generation_custom(
            text, language, speaker, instruct=instruct, non_streaming_mode=nsm
        )
        stream = gen_lib.fast_generate_streaming_fused(
            self.params, self.config, tie, tam, tth, tpe, max_seq_len=self.max_seq_len,
            fuse_first_chunk=True, **sampling,
        )
        yield from self._stream_decode(stream, None)

    def _custom_voice_request(self, speaker, language, instruct):
        """Checks of a CustomVoice request -> the instruction it keeps (a
        0.6B model takes none)."""
        if self.tts_model_type != "custom_voice":
            raise ValueError("Loaded model does not support custom voice generation")
        self._validate_languages([language])
        self._validate_speakers([speaker])
        # a substring test on the size name, as in the JAX package
        return None if self.tts_model_size in "0b6" else instruct

    def _voice_design_request(self, language):
        if self.tts_model_type != "voice_design":
            raise ValueError("Loaded model does not support voice design generation")
        self._validate_languages([language])

    def generate_custom_voice(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        non_streaming_mode: Optional[bool] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """CustomVoice TTS with a preset speaker -> ([waveform], sample_rate)."""
        instruct = self._custom_voice_request(speaker, language, instruct)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        return self._generate_custom(
            text, language, speaker, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, seed=seed,
        )

    def generate_custom_voice_streaming(
        self,
        text: str,
        speaker: str,
        language: str,
        instruct: Optional[str] = None,
        non_streaming_mode: Optional[bool] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        first_chunk_size: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming CustomVoice: yields (audio_chunk, sample_rate, timing)."""
        instruct = self._custom_voice_request(speaker, language, instruct)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        yield from self._generate_custom_streaming(
            text, language, speaker, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, chunk_size=chunk_size,
            first_chunk_size=first_chunk_size, seed=seed,
        )

    def generate_voice_design(
        self,
        text: str,
        instruct: str,
        language: str,
        non_streaming_mode: Optional[bool] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        seed: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], int]:
        """VoiceDesign TTS, the voice described by `instruct` -> ([waveform], sample_rate)."""
        self._voice_design_request(language)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        return self._generate_custom(
            text, language, None, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, seed=seed,
        )

    def generate_voice_design_streaming(
        self,
        text: str,
        instruct: str,
        language: str,
        non_streaming_mode: Optional[bool] = None,
        max_new_tokens: int = 2048,
        min_new_tokens: int = 2,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        do_sample: bool = True,
        repetition_penalty: float = 1.05,
        chunk_size: int = 12,
        first_chunk_size: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Generator[Tuple[np.ndarray, int, Dict[str, Any]], None, None]:
        """Streaming VoiceDesign: yields (audio_chunk, sample_rate, timing)."""
        self._voice_design_request(language)
        nsm = self._resolve_non_streaming_mode(non_streaming_mode, default=True)
        yield from self._generate_custom_streaming(
            text, language, None, instruct, nsm, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
            do_sample=do_sample, repetition_penalty=repetition_penalty, chunk_size=chunk_size,
            first_chunk_size=first_chunk_size, seed=seed,
        )
