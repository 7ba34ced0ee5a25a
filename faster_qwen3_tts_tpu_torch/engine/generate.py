"""Host-side generation drivers over the device engine.

Port of the single-stream parts of faster_qwen3_tts_tpu/engine/generate.py:
prompt padding buckets, `GenerationSession`, `fast_generate` (non-streaming)
and `fast_generate_streaming_fused` (streaming; chunks vocoded on the device
after their decode, or left to the caller's host vocode while an ICL stream
with a short reference warms in). The host reads the device once per chunk.

Timing dicts keep the JAX package's keys:
  non-streaming: {prefill_ms, decode_s, steps, ms_per_step, steps_per_s}
  streaming:     {chunk_index, chunk_steps, prefill_ms, decode_ms,
                  total_steps_so_far, is_final}
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import Qwen3TTSConfig

from ..ops.sampling import SamplingParams
from . import core, fused_stream

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

# Steady-state vocoder left context (frames), as in the JAX package.
CONTEXT_FRAMES = 24


def predictor_sampling(
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
) -> SamplingParams:
    """Code-predictor sampling: samples by default (top-k 50, temperature
    0.9), independently of the talker's sampling arguments."""
    return SamplingParams(
        0.9 if subtalker_temperature is None else subtalker_temperature,
        50 if subtalker_top_k is None else subtalker_top_k,
        1.0 if subtalker_top_p is None else subtalker_top_p,
        True if subtalker_dosample is None else subtalker_dosample,
        1.0,
    )


def prefill_bucket(n: int, max_seq: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b <= max_seq:
            return b
    if n <= max_seq:
        return max_seq
    raise ValueError(f"prefill length {n} exceeds max_seq_len {max_seq}")


def tth_bucket(n: int) -> int:
    """Trailing-text bucket: one size (FQ3T_TTH_BUCKET, default 256) for every
    text up to it, powers of two above. Positions past the text resolve to
    the pad embedding, so the bucket does not change the result; the JAX
    package reads the same variable, so both run the same shapes."""
    cap = int(os.environ.get("FQ3T_TTH_BUCKET", "256"))
    b = cap
    while b < n:
        b *= 2
    return b


def _pad_left(tie: np.ndarray, mask: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    B, P, H = tie.shape
    if P == bucket:
        return tie, mask
    out = np.zeros((B, bucket, H), tie.dtype)
    m = np.zeros((B, bucket), mask.dtype)
    out[:, bucket - P :] = tie
    m[:, bucket - P :] = mask
    return out, m


def _pad_trailing(tth: np.ndarray, tpe: np.ndarray, bucket: int) -> np.ndarray:
    B, T, H = tth.shape
    if T == bucket:
        return tth
    out = np.tile(np.asarray(tpe).reshape(1, 1, H), (B, bucket, 1)).astype(tth.dtype)
    out[:, :T] = tth
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GenerationSession:
    """One request's device state and chunk pump (single device)."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: Qwen3TTSConfig,
        tie: np.ndarray,
        attention_mask: np.ndarray,
        trailing_text: np.ndarray,
        tts_pad_embed: np.ndarray,
        max_seq_len: int,
        sampling: SamplingParams,
        pred_sampling: SamplingParams,
        min_new_tokens: int,
        seed: Optional[int] = None,
    ):
        self.params = params
        self.cfg = cfg
        self.sampling = sampling
        self.pred_sampling = pred_sampling
        self.min_new_tokens = min_new_tokens
        embed = params["talker"]["codec_embed"]
        self.device, dtype = embed.device, embed.dtype
        bucket = prefill_bucket(tie.shape[1], max_seq_len)
        tie_b, mask_b = _pad_left(tie, attention_mask, bucket)
        tth_b = _pad_trailing(trailing_text, tts_pad_embed, tth_bucket(trailing_text.shape[1]))
        put = lambda a, dt: torch.as_tensor(np.asarray(a)).to(self.device, dt)
        self.tie = put(tie_b, dtype)
        self.mask = put(mask_b, torch.int32)
        self.tth = put(tth_b, dtype)
        self.tpe = put(tts_pad_embed, dtype)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.max_seq_len = max_seq_len
        self.state: Optional[core.DecodeState] = None
        self.prefill_ms = 0.0

    def prefill(self, block: bool = True) -> None:
        """Run the prefill; with block=False its time folds into the first
        chunk's (prefill_ms stays 0)."""
        t0 = time.perf_counter()
        self.state, _ = core.start_state(
            self.params["talker"], self.cfg.talker, self.tie, self.mask, self.generator,
            self.max_seq_len, self.sampling, self.min_new_tokens,
        )
        if block:
            _sync(self.device)
            self.prefill_ms = (time.perf_counter() - t0) * 1000.0

    def decode_chunk_packed(self, chunk_size: int) -> torch.Tensor:
        """Run one chunk; returns the packed device tensor without reading it."""
        self.state, packed = core.decode_chunk(
            self.params["talker"], self.params["predictor"], self.cfg.talker,
            self.cfg.predictor, self.state, self.tth, self.tpe, chunk_size, self.sampling,
            self.pred_sampling, self.min_new_tokens,
        )
        return packed

    def decode_chunk(self, chunk_size: int) -> Tuple[np.ndarray, bool]:
        """One chunk, read once -> (valid frames [n, 16] int32, done)."""
        return core.read_packed(self.decode_chunk_packed(chunk_size))

    def decode_chunk_fused(self, chunk_size: int, ctx: int, history: List[np.ndarray]):
        """One chunk plus its window vocode, read once -> (audio [1, chunk * up],
        frames [n, 16], done). `history` holds the frames before this chunk
        (an ICL stream's reference codes first); the last `ctx` of them are
        the vocoder's left context."""
        hist = None
        if ctx > 0:
            hist = torch.as_tensor(np.concatenate(history, axis=0)[-ctx:][None]).to(self.device)
        packed = self.decode_chunk_packed(chunk_size)
        audio = fused_stream._vocode_window(
            self.params["codec"], self.cfg.talker, self.cfg.codec, hist, packed, chunk_size, ctx,
        )
        return fused_stream.split_fused_output(audio, packed)


def fast_generate(
    params,
    cfg: Qwen3TTSConfig,
    tie,
    attention_mask,
    trailing_text,
    tts_pad_embed,
    max_seq_len: int = 2048,
    max_new_tokens: int = 2048,
    min_new_tokens: int = 2,
    temperature: float = 0.9,
    top_k: int = 50,
    top_p: float = 1.0,
    do_sample: bool = True,
    repetition_penalty: float = 1.05,
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
    seed: Optional[int] = None,
    device_chunk: int = 32,
) -> Tuple[Optional[np.ndarray], Dict[str, Any]]:
    """Non-streaming generation -> ([T, 16] codes or None, timing)."""
    sess = GenerationSession(
        params, cfg, tie, attention_mask, trailing_text, tts_pad_embed, max_seq_len,
        SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty),
        predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                           subtalker_temperature),
        min_new_tokens, seed,
    )
    sess.prefill()
    t0 = time.perf_counter()
    chunks, steps = [], 0
    while steps < max_new_tokens:
        frames, done = sess.decode_chunk(device_chunk)
        frames = frames[: max_new_tokens - steps]
        if frames.shape[0]:
            chunks.append(frames)
            steps += frames.shape[0]
        if done:
            break
    decode_s = time.perf_counter() - t0
    timing = {
        "prefill_ms": sess.prefill_ms,
        "decode_s": decode_s,
        "steps": steps,
        "ms_per_step": (decode_s / steps * 1000.0) if steps else 0.0,
        "steps_per_s": (steps / decode_s) if decode_s > 0 else 0.0,
    }
    return (np.concatenate(chunks, axis=0) if chunks else None), timing


def fast_generate_streaming_fused(
    params,
    cfg: Qwen3TTSConfig,
    tie,
    attention_mask,
    trailing_text,
    tts_pad_embed,
    max_seq_len: int = 2048,
    max_new_tokens: int = 2048,
    min_new_tokens: int = 2,
    temperature: float = 0.9,
    top_k: int = 50,
    top_p: float = 1.0,
    do_sample: bool = True,
    repetition_penalty: float = 1.05,
    chunk_size: int = 12,
    seed: Optional[int] = None,
    context_frames: int = CONTEXT_FRAMES,
    fuse_first_chunk: bool = False,
    first_chunk_size: Optional[int] = None,
    ref_codes: Optional[np.ndarray] = None,
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
) -> Generator[Tuple[np.ndarray, Optional[np.ndarray], Dict[str, Any]], None, None]:
    """Streaming generation; yields (frames [n, 16], audio [m] f32 or None,
    timing). Each chunk is one of three kinds:

    - fused0 (chunk 0 with fuse_first_chunk): decode, then vocode the chunk
      alone; emits its first n * up - D samples;
    - fused: decode, then vocode a window whose left context is the last
      `ctx` frames of the history; emits the window-local samples
      [ctx*up - D, (ctx+n)*up - D), so fused chunks are sample-contiguous;
    - plain: decode only (audio None); the caller vocodes on the host.

    Without reference codes the context grows min(total, context_frames):
    0, first, first + chunk, ... With ICL reference codes ref_codes [R, 16]
    and R >= context_frames, every chunk, chunk 0 included, is fused with
    ctx = context_frames over the last frames of ref_codes + history, so the
    reference audio is never emitted. With R < context_frames (and
    fuse_first_chunk False) chunks stay plain until context_frames frames
    were generated, for the caller's reference-prepending host decode; then
    fused with ctx = min(total, context_frames) over generated frames only."""
    sess = GenerationSession(
        params, cfg, tie, attention_mask, trailing_text, tts_pad_embed, max_seq_len,
        SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty),
        predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                           subtalker_temperature),
        min_new_tokens, seed,
    )
    up = cfg.codec.total_upsample
    D = fused_stream.codec_deficit(cfg.codec)
    first_cs = first_chunk_size or chunk_size
    icl_fused = ref_codes is not None and ref_codes.shape[0] >= context_frames
    history: List[np.ndarray] = []
    total = chunk_index = 0
    t0 = time.perf_counter()
    sess.prefill(block=False)  # its time folds into chunk 0's decode_ms
    while total < max_new_tokens:
        cs = first_cs if total == 0 else chunk_size
        if icl_fused:
            kind, ctx, window = "fused", context_frames, [np.asarray(ref_codes)] + history
        elif total == 0:
            kind, ctx, window = ("fused0" if fuse_first_chunk else "plain"), 0, history
        elif not fuse_first_chunk and total < context_frames:
            kind, ctx, window = "plain", 0, history  # ICL warm-in: the caller prepends the reference
        else:
            kind, ctx, window = "fused", min(total, context_frames), history
        if kind == "plain":
            frames, done = sess.decode_chunk(cs)
            audio = None
            frames = frames[: max_new_tokens - total]
        else:
            audio_full, frames, done = sess.decode_chunk_fused(cs, ctx, window)
            # clip to the token budget before slicing audio, so audio stops at the last frame
            frames = frames[: max_new_tokens - total]
            v = frames.shape[0]
            audio = audio_full[0, : (max(v * up - D, 0) if kind == "fused0" else v * up)]
        decode_ms = (time.perf_counter() - t0) * 1000.0
        v = frames.shape[0]
        stream_done = done or total + v >= max_new_tokens
        if v:
            history.append(frames)
            total += v
            yield frames, audio, {
                "chunk_index": chunk_index,
                "chunk_steps": int(v),
                "prefill_ms": sess.prefill_ms if chunk_index == 0 else 0.0,
                "decode_ms": decode_ms,
                "total_steps_so_far": total,
                "is_final": bool(stream_done),
            }
            chunk_index += 1
        elif not done:
            raise RuntimeError(
                f"decode chunk {chunk_index} returned 0 valid frames without EOS "
                f"(kind={kind}, total={total}): the engine state is not advancing"
            )
        if stream_done:
            break
        t0 = time.perf_counter()
