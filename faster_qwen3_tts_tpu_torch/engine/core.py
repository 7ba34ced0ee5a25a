"""The decode engine: prefill, then chunks of frames generated on the device.

Port of faster_qwen3_tts_tpu/engine/core.py. One frame is: the code
predictor's 15-codebook loop, the talker's single-token step, codec-head
logits, repetition penalty and sampling of the next codebook-0 token.
`decode_chunk` runs `chunk_size` frames; the stream position, current token,
done flags, history mask and frame counts stay on the device, so the host
reads the device once per chunk, on the packed result. The KV cache is
written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import PredictorConfig, TalkerConfig

from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models.layers import KVCache
from ..ops.sampling import (
    SamplingParams,
    apply_repetition_penalty,
    make_suppress_mask,
    sample_logits,
)


@dataclasses.dataclass
class DecodeState:
    """Everything the device needs to generate the next frame."""

    cache: KVCache  # talker static KV cache [L, B, S_max, kv, hd]
    pos: torch.Tensor  # [B] int32 next cache write position
    num_pads: torch.Tensor  # [B] int32 left-pad counts (mask + rope offset)
    token: torch.Tensor  # [B] int32 current codebook-0 token (already sampled)
    past_hidden: torch.Tensor  # [B, 1, H] last talker hidden state
    gen_step: torch.Tensor  # [B] int32 index into the trailing text hiddens
    seen: torch.Tensor  # [B, V] bool token history for the repetition penalty
    generator: Optional[torch.Generator]  # sampling noise source
    done: torch.Tensor  # [B] bool EOS (or length bound) reached
    n_frames: torch.Tensor  # [B] int32 frames emitted so far


def expand_cache(cache: KVCache, max_seq: int) -> KVCache:
    """Embed a length-P prefill cache at offset 0 of a length-max_seq cache."""
    L, B, P, KV, HD = cache.k.shape
    if P > max_seq:
        raise ValueError(f"prefill length {P} exceeds max_seq_len {max_seq}")
    full = KVCache.zeros(L, B, max_seq, KV, HD, cache.k.dtype, cache.k.device)
    full.k[:, :, :P] = cache.k
    full.v[:, :, :P] = cache.v
    return full


def start_state(
    talker_params,
    talker_cfg: TalkerConfig,
    embeds: torch.Tensor,
    pad_mask: torch.Tensor,
    generator: Optional[torch.Generator],
    max_seq: int,
    sampling: SamplingParams,
    min_new_tokens: int,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[DecodeState, torch.Tensor]:
    """Prefill + first-token sampling -> (initial state, prefill logits [B, V]).

    embeds [B, P, H] left-padded prompt; pad_mask [B, P] int. `noise` [B, V]
    replaces the first draw (tests)."""
    B, P, _ = embeds.shape
    device = embeds.device
    past_hidden, logits, cache_p = talker_lib.prefill(talker_params, talker_cfg, embeds, pad_mask)
    cache = expand_cache(cache_p, max_seq)
    V, eos = talker_cfg.vocab_size, talker_cfg.codec_eos_token_id
    suppress = make_suppress_mask(V, eos, device)
    extra = (torch.arange(V, device=device) == eos) if min_new_tokens > 0 else None
    token = sample_logits(logits, sampling, suppress, extra, generator=generator, noise=noise)
    state = DecodeState(
        cache=cache,
        pos=torch.full((B,), P, dtype=torch.int32, device=device),
        num_pads=(1 - pad_mask).sum(dim=-1).to(torch.int32),
        token=token,
        past_hidden=past_hidden,
        gen_step=torch.zeros((B,), dtype=torch.int32, device=device),
        seen=torch.zeros((B, V), dtype=torch.bool, device=device),
        generator=generator,
        done=torch.zeros((B,), dtype=torch.bool, device=device),
        n_frames=torch.zeros((B,), dtype=torch.int32, device=device),
    )
    return state, logits


def _decode_frame(
    talker_params,
    pred_params,
    talker_cfg: TalkerConfig,
    pred_cfg: PredictorConfig,
    state: DecodeState,
    trailing_text: torch.Tensor,  # [B, T, H]
    tts_pad_embed: torch.Tensor,  # [B or 1, 1, H]
    sampling: SamplingParams,
    pred_sampling: SamplingParams,
    min_new_tokens: int,
    suppress_mask: torch.Tensor,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[DecodeState, torch.Tensor, torch.Tensor]:
    """One frame -> (new state, frame [B, 16] int32, valid [B] bool).

    `noise` = (predictor noise [15, B, Vp], talker noise [B, V]) replaces the
    generator's draws (tests)."""
    device = state.token.device
    eos = talker_cfg.codec_eos_token_id
    max_seq = state.cache.max_seq
    V = talker_cfg.vocab_size

    eos_now = state.token == eos
    valid = ~(state.done | eos_now)  # live at loop top: the frame is emitted
    done = state.done | eos_now

    # code predictor
    tok_embed = talker_lib.embed_codec(talker_params, state.token)[:, None, :]  # [B, 1, H]
    pred_input = torch.cat([state.past_hidden, tok_embed], dim=1)
    cbs = predictor_lib.predict_codebooks(
        pred_params, pred_cfg, pred_input, pred_sampling, state.generator,
        None if noise is None else noise[0],
    )
    frame = torch.cat([state.token[:, None], cbs], dim=1)

    # talker input: sum of the 16 codec embeds + this step's text hidden
    embeds = tok_embed[:, 0, :].float() + predictor_lib.embed_frame_sum(pred_params, cbs).float()
    T = trailing_text.shape[1]
    idx = state.gen_step.clamp(max=T - 1).long()
    text_h = trailing_text[torch.arange(idx.shape[0], device=device), idx]
    text_h = torch.where((state.gen_step < T)[:, None], text_h, tts_pad_embed[:, 0, :])
    embeds = (embeds + text_h.float()).to(tok_embed.dtype)[:, None, :]

    # talker step
    s_ids = torch.arange(max_seq, device=device)[None, :]
    length_mask = ((s_ids <= state.pos[:, None]) & (s_ids >= state.num_pads[:, None])).to(torch.int32)
    rope_pos = state.pos - state.num_pads
    hidden = talker_lib.decode_step(
        talker_params, talker_cfg, embeds, state.pos, rope_pos, state.cache, length_mask
    )
    logits = talker_lib.codec_logits(talker_params, hidden[:, 0, :])

    # next codebook-0 token
    seen = state.seen | torch.nn.functional.one_hot(state.token.long(), V).bool()
    logits = apply_repetition_penalty(logits, seen, sampling.repetition_penalty)
    n_frames = state.n_frames + valid.to(torch.int32)
    extra = (n_frames < min_new_tokens)[:, None] & (torch.arange(V, device=device) == eos)[None, :]
    next_token = sample_logits(
        logits, sampling, suppress_mask, extra, generator=state.generator,
        noise=None if noise is None else noise[1],
    )

    # length bound: the boundary frame is emitted, then the stream stops
    done = done | (state.pos >= max_seq - 1)

    new_state = DecodeState(
        cache=state.cache,
        pos=torch.where(valid, state.pos + 1, state.pos),
        num_pads=state.num_pads,
        token=torch.where(valid, next_token, state.token),
        past_hidden=torch.where(valid[:, None, None], hidden, state.past_hidden),
        gen_step=torch.where(valid, state.gen_step + 1, state.gen_step),
        seen=torch.where(valid[:, None], seen, state.seen),
        generator=state.generator,
        done=done,
        n_frames=torch.where(valid, n_frames, state.n_frames),
    )
    return new_state, frame, valid


def decode_chunk(
    talker_params,
    pred_params,
    talker_cfg: TalkerConfig,
    pred_cfg: PredictorConfig,
    state: DecodeState,
    trailing_text: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    chunk_size: int,
    sampling: SamplingParams,
    pred_sampling: SamplingParams,
    min_new_tokens: int,
) -> Tuple[DecodeState, torch.Tensor]:
    """Generate `chunk_size` frames on the device.

    Returns (state, packed [chunk, B, num_code_groups + 2] int32): the frame
    tokens, then the valid flag and the done flag. Invalid rows carry no
    information; the host trims them. There is no early exit: frames after
    EOS in the last chunk compute masked garbage, so the loop never waits
    for the host (the JAX package keeps the same rule for its own reasons)."""
    suppress = make_suppress_mask(
        talker_cfg.vocab_size, talker_cfg.codec_eos_token_id, state.token.device
    )
    frames, valids = [], []
    for _ in range(chunk_size):
        state, frame, valid = _decode_frame(
            talker_params, pred_params, talker_cfg, pred_cfg, state, trailing_text,
            tts_pad_embed, sampling, pred_sampling, min_new_tokens, suppress,
        )
        frames.append(frame)
        valids.append(valid)
    frames_t = torch.stack(frames)  # [chunk, B, 16]
    valid_t = torch.stack(valids).to(torch.int32)[:, :, None]
    done_t = state.done.to(torch.int32)[None, :, None].expand_as(valid_t)
    return state, torch.cat([frames_t, valid_t, done_t], dim=-1)


def read_packed(packed: torch.Tensor) -> Tuple[np.ndarray, bool]:
    """One device->host read of a `decode_chunk` result -> (valid frames
    [n, 16] int32 of stream 0, done)."""
    arr = packed.cpu().numpy()
    valid = arr[:, 0, -2].astype(bool)
    return arr[valid, 0, :-2].astype(np.int32), bool(arr[0, 0, -1])
