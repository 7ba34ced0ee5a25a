"""Attention ops: prefill attention in plain PyTorch, decode attention as K1.

Counterpart of faster_qwen3_tts_tpu/ops/attention.py, same layouts:
q/k/v are [B, S, H, D] (heads after sequence) and masks are boolean or int
with 1 = attendable. Scores, softmax and the probability-weighted sum run in
float32 and the result is rounded once to q's dtype, as the JAX version does.
"""
from __future__ import annotations

from typing import Optional

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


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length_mask: torch.Tensor
) -> torch.Tensor:
    """Single-token decode attention; same contract as `decode_attention_plain`.

    A CUDA tensor launches K1 (csrc/decode_attention.cu) and counts the launch
    in `decode_attention.launches`; a CPU tensor takes the plain version."""
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
    lib = kernels.library()
    n_split = -(-S // lib.attn_tile)
    part_m = torch.empty((B, Hq, n_split), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hq, n_split, D), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib.call(
        "fq3t_decode_attention",
        kernels.dtype_code(q), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        mask.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, S, Hq, Hkv, D, float(D**-0.5), kernels.stream_handle(q.device),
    )
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
