"""The decode engine: prefill, then chunks of frames generated on the device.

Port of faster_qwen3_tts_tpu/engine/core.py. One frame is: the code
predictor's 15-codebook loop, the talker's single-token step, codec-head
logits, repetition penalty and sampling of the next codebook-0 token.
`decode_chunk` runs `chunk_size` frames; the stream position, current token,
done flags, history mask and frame counts stay on the device, so the host
reads the device once per chunk, on the packed result. The KV cache is
written in place. Continuous batching writes a B=1 stream into one lane of a
running batch (`insert_slot`) and ends a lane (`release_slot`) with device
writes only. Under a (dp, tp) mesh these functions run one dp group: its
parameters' talker and predictor are `Ranks` of the tp ranks' subtrees, its
state one `DecodeState` whose KV cache is a `Ranks` of per-rank caches
(kv_heads / tp heads each, `mesh.kv_cache_spec`), and every sampling draws
once for the group from the gathered logits. In a process mesh a process
runs its own rank of the group: one subtree, the KV cache of its own rank,
and the same draws as its group's other ranks (the same gathered logits
and a generator seeded alike).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import PredictorConfig, TalkerConfig

from ..models import predictor as predictor_lib
from ..models import talker as talker_lib
from ..models import layers
from ..models.layers import KVCache
from ..parallel.mesh import as_ranks, group, kv_cache_spec, shard_shape
from ..ops.sampling import (
    SamplingParams,
    apply_repetition_penalty,
    make_suppress_mask,
    sample_logits,
)


@dataclasses.dataclass
class DecodeState:
    """Everything the device needs to generate the next frame."""

    cache: KVCache  # talker static KV cache [L, B, S_max, kv, hd] (a tp group: Ranks of [.., kv / tp, hd])
    pos: torch.Tensor  # [B] int32 next cache write position
    num_pads: torch.Tensor  # [B] int32 left-pad counts (mask + rope offset)
    token: torch.Tensor  # [B] int32 current codebook-0 token (already sampled)
    past_hidden: torch.Tensor  # [B, 1, H] last talker hidden state
    gen_step: torch.Tensor  # [B] int32 index into the trailing text hiddens
    seen: torch.Tensor  # [B, V] bool token history for the repetition penalty
    generator: Optional[torch.Generator]  # sampling noise source
    done: torch.Tensor  # [B] bool EOS (or length bound) reached
    n_frames: torch.Tensor  # [B] int32 frames emitted so far


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
    into: Optional[DecodeState] = None,
) -> Tuple[DecodeState, torch.Tensor]:
    """Prefill + first-token sampling -> (initial state, prefill logits [B, V]).

    embeds [B, P, H] left-padded prompt; pad_mask [B, P] int. `noise` [B, V]
    replaces the first draw (tests). `into`: a state of the same batch and
    max_seq whose tensors take the result in place (a graph set's static
    state), its cache rows past the prompt zeroed; it is returned. The body
    reads nothing back to the host, branches on no tensor's value and sizes
    every allocation from shapes, so a graph set captures it once per prompt
    bucket (`graphs.GraphSet.prepare_prefill`). `start_state.eager_cuda`
    counts the calls that ran eagerly on the card (capture warm-ups
    included)."""
    B, P, _ = embeds.shape
    device = embeds.device
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        start_state.eager_cuda += 1
    past_hidden, logits, cache_p = talker_lib.prefill(talker_params, talker_cfg, embeds, pad_mask)
    V, eos = talker_cfg.vocab_size, talker_cfg.codec_eos_token_id
    suppress = make_suppress_mask(V, eos, device)
    extra = (torch.arange(V, device=device) == eos) if min_new_tokens > 0 else None
    token = sample_logits(logits, sampling, suppress, extra, generator=generator, noise=noise)
    if into is not None:
        slots = layers.cache_max_seq(into.cache)
        if slots != max_seq or into.token.shape[0] != B or P > max_seq:
            raise ValueError(f"prefill of {B} x {P} rows into a state of {into.token.shape[0]} lanes, "
                             f"max_seq {slots} (asked {max_seq})")
        for dst, src in zip(as_ranks(into.cache), as_ranks(cache_p)):
            for buf, part in ((dst.k, src.k), (dst.v, src.v)):
                buf[:, :, :P].copy_(part)
                buf[:, :, P:].zero_()
        into.pos.fill_(P)
        into.num_pads.copy_((1 - pad_mask).sum(dim=-1))
        into.token.copy_(token)
        into.past_hidden.copy_(past_hidden)
        for t in (into.gen_step, into.seen, into.done, into.n_frames):
            t.zero_()
        into.generator = generator
        return into, logits
    cache = layers.expand_cache(cache_p, max_seq)
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


start_state.eager_cuda = 0


def zeros_state(
    talker_cfg: TalkerConfig, batch: int, max_seq: int, dtype: torch.dtype, device: torch.device,
    generator: Optional[torch.Generator], tp: int = 1, ranks: Optional[int] = None,
) -> DecodeState:
    """An empty pool of `batch` lanes, every one done (masked) until a stream
    is inserted. A done lane still runs the frame on its frozen position; its
    frames are invalid and its cache lane is overwritten on insertion. With
    tp > 1 the cache holds `ranks` caches (default tp; one in a process
    mesh, its own rank's), each a tp rank's shard by `mesh.kv_cache_spec`
    (kv_heads / tp heads): a `Ranks` of several, one plain."""
    L, KV, HD = talker_cfg.num_hidden_layers, talker_cfg.num_key_value_heads, talker_cfg.head_dim
    i32 = dict(dtype=torch.int32, device=device)
    shape = shard_shape((L, batch, max_seq, KV, HD), kv_cache_spec(), {"tp": tp})
    cache = group(KVCache.zeros(*shape, dtype, device) for _ in range(tp if ranks is None else ranks))
    return DecodeState(
        cache=cache,
        pos=torch.zeros((batch,), **i32),
        num_pads=torch.zeros((batch,), **i32),
        token=torch.zeros((batch,), **i32),
        past_hidden=torch.zeros((batch, 1, talker_cfg.hidden_size), dtype=dtype, device=device),
        gen_step=torch.zeros((batch,), **i32),
        seen=torch.zeros((batch, talker_cfg.vocab_size), dtype=torch.bool, device=device),
        generator=generator,
        done=torch.ones((batch,), dtype=torch.bool, device=device),
        n_frames=torch.zeros((batch,), **i32),
    )


_LANE_FIELDS = ("pos", "num_pads", "token", "past_hidden", "gen_step", "seen", "done", "n_frames")


def insert_slot(state: DecodeState, slot_state: DecodeState, slot: int) -> DecodeState:
    """Write a prefilled B=1 stream into lane `slot` of a running batch state
    (the continuous-batching primitive): device copies into the pool's own
    tensors, the KV cache lane included, with no second cache and no host
    read. `slot_state` must have the pool's max_seq. The pool keeps its own
    generator, as the JAX pool keeps its key. Returns `state`."""
    if layers.cache_max_seq(slot_state.cache) != layers.cache_max_seq(state.cache):
        raise ValueError(f"slot cache max_seq {layers.cache_max_seq(slot_state.cache)} != pool "
                         f"{layers.cache_max_seq(state.cache)}")
    for dst, src in zip(as_ranks(state.cache), as_ranks(slot_state.cache)):
        dst.k[:, slot].copy_(src.k[:, 0])
        dst.v[:, slot].copy_(src.v[:, 0])
    for name in _LANE_FIELDS:
        getattr(state, name)[slot].copy_(getattr(slot_state, name)[0])
    return state


def release_slot(state: DecodeState, slot: int) -> DecodeState:
    """Mark lane `slot` done (its frames are invalid until it is reused): a
    device write, no host read. Returns `state`."""
    state.done[slot] = True
    return state


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
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        _decode_frame.eager_cuda += 1
    eos = talker_cfg.codec_eos_token_id
    max_seq = layers.cache_max_seq(state.cache)
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


_decode_frame.eager_cuda = 0


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


def read_packed_batch(packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One device->host read of a `decode_chunk` result, every lane ->
    (frames [chunk, B, 16] int32, valid [chunk, B] bool, done [B] bool)."""
    arr = packed.cpu().numpy()
    return arr[:, :, :-2].astype(np.int32), arr[:, :, -2].astype(bool), arr[0, :, -1].astype(bool)
