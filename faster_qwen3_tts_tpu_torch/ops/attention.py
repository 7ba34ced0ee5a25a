"""Attention ops: prefill attention in plain PyTorch, decode attention as K1.

Counterpart of faster_qwen3_tts_tpu/ops/attention.py, same layouts:
q/k/v are [B, S, H, D] (heads after sequence) and masks are boolean or int
with 1 = attendable. Scores, softmax and the probability-weighted sum run in
float32 and the result is rounded once to q's dtype, as the JAX version does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import kernels

_NEG_INF = -1e30  # large finite negative, as the JAX version


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, Sq, Hq, D], k: [B, Sk, Hkv, D] -> scores [B, Hq, Sq, Sk] (f32)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    return scores.reshape(B, Hq, Sq, k.shape[1]) * (D**-0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B, Hq, Sq, Sk] f32, v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D] f32."""
    B, Hq, Sq, Sk = probs.shape
    Hkv = v.shape[2]
    pg = probs.reshape(B, Hkv, Hq // Hkv, Sq, Sk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v.float())
    return out.reshape(B, Sq, Hq, v.shape[3])


def prefill_mask(pad_mask: torch.Tensor, sliding_window: Optional[int] = None) -> torch.Tensor:
    """[B, S] pad mask (1 = real token) -> [B, S, S] bool: causal, pad-aware,
    optionally limited to kv positions > q - sliding_window (HF rule)."""
    S = pad_mask.shape[1]
    idx = torch.arange(S, device=pad_mask.device)
    qpos, kpos = idx[:, None], idx[None, :]
    allowed = kpos <= qpos
    if sliding_window is not None:
        allowed = allowed & (kpos > (qpos - sliding_window))
    return allowed[None, :, :] & (pad_mask[:, None, :] > 0)


def prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Full-sequence attention under a [B, S, S] boolean mask -> [B, S, Hq, D]."""
    scores = _gqa_scores(q, k)
    scores = torch.where(mask[:, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v).to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length_mask: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K1 (the JAX `decode_attention_xla`): a masked
    softmax over the whole static cache.

    q: [B, 1, Hq, D]; k_cache/v_cache: [B, S_max, Hkv, D]; length_mask:
    [B, S_max] (1 = attendable). Returns [B, 1, Hq, D] in q.dtype."""
    scores = _gqa_scores(q, k_cache)
    scores = torch.where(length_mask[:, None, None, :] > 0, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v_cache).to(q.dtype)


# launch geometry of K1 (csrc/decode_attention.cu)
_TILE = 32            # cache slots per tile
_STAGES = 4           # K/V tiles in flight per CTA
_THREADS = 128
_MAX_G = 8            # query heads per kv head
_MAX_CLUSTER = 8      # CTAs per cluster (the portable maximum; 16 measured slower)
_MAX_TILES = 1024     # S_max <= 32768
_TILES_PER_CTA = 4    # at a full cache
_MAX_SMEM = 232448    # dynamic shared memory of an H100 block (227 KB)


class DecodePlan(NamedTuple):
    """One K1 launch: grid (cluster, Hkv, B), clusters of `cluster` CTAs along
    x, `smem` bytes of dynamic shared memory per CTA."""

    grid: Tuple[int, int, int]
    cluster: int
    smem: int


def _row_pitch(row: int) -> int:
    """A K/V row in shared memory, padded so slot rows start 16 banks apart."""
    return row + ((16 - (row // 4) % 32) % 32) * 4


def _decode_plan(B: int, S: int, Hq: int, Hkv: int, D: int, elt: int) -> DecodePlan:
    """K1's launch for a [B, S, Hkv, D] cache of `elt`-byte elements and Hq
    query heads. The cluster splits the live tiles of one (kv head, batch):
    one CTA per 4 tiles of a full cache, at most 8, so the predictor's 17
    slots take 1 CTA and the talker's 2048 take 8 (8 kv heads x 8 = 64 CTAs;
    16 a cluster was measured slower on the short live ranges the talker
    mostly has, faster only near a full cache). Shared memory is csrc/decode_attention.cu's
    `smem_bytes`, which the launch checks. Raises ValueError on a geometry
    the kernel does not take."""
    G = Hq // Hkv if Hkv > 0 else 0
    row = D * elt
    n_tiles = -(-S // _TILE)
    if (B < 1 or S < 1 or Hkv < 1 or Hq % Hkv or G not in (1, 2, 4, 8) or row not in (64, 128, 256, 512)
            or D > 256 or G * D > 2048 or n_tiles > _MAX_TILES):
        raise ValueError(f"decode_attention: no K1 launch for B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                         f"({elt}-byte elements)")
    cluster = max(1, min(_MAX_CLUSTER, -(-n_tiles // _TILES_PER_CTA)))
    ring = _STAGES * 2 * _TILE * _row_pitch(row)
    red = (_THREADS // (row // 16)) * G * D * 4
    smem = (max(ring, red) + G * D * 4 + (G * D + _MAX_CLUSTER) * 4 + 2 * _MAX_G * _TILE * 4
            + 4 * _MAX_G * 4 + 3 * _MAX_CLUSTER * _MAX_G * 4 + 2 * (-(-n_tiles * 4 // 16) * 16) + 16)
    if smem > _MAX_SMEM:
        raise ValueError(f"decode_attention: {smem} bytes of shared memory for D={D}")
    return DecodePlan((cluster, Hkv, B), cluster, smem)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length_mask: torch.Tensor
) -> torch.Tensor:
    """Single-token decode attention; same contract as `decode_attention_plain`.

    A CUDA tensor launches K1 (csrc/decode_attention.cu: one launch, a
    cluster of CTAs per kv head merging through distributed shared memory)
    and counts the launch in `decode_attention.launches`; a CPU tensor takes
    the plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length_mask)
    B, one, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    if one != 1 or k_cache.shape != v_cache.shape or length_mask.shape != (B, S):
        raise ValueError(
            f"decode_attention shapes: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"mask {tuple(length_mask.shape)}"
        )
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q and the caches must share a dtype")
    mask = length_mask if length_mask.dtype == torch.int32 else length_mask.to(torch.int32)
    kernels.require_cuda(q, k_cache, v_cache, mask)
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention needs 16-byte aligned caches")
    plan = _decode_plan(B, S, Hq, Hkv, D, q.element_size())
    lib = kernels.library()
    out = torch.empty_like(q)
    lib.call(
        "fq3t_decode_attention",
        kernels.dtype_code(q), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, S, Hq, Hkv, D, float(D**-0.5), plan.cluster, plan.smem,
        kernels.stream_handle(q.device),
    )
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
