"""Talker: the Qwen3-style decoder that emits codebook-0 tokens.

Port of faster_qwen3_tts_tpu/models/talker.py over the same parameter dict:
text_embed / text_proj, codec_embed / codec_head, spk_proj, stacked layers
and final_norm. Under a mesh `params` may be a tp group's `Ranks` of
per-rank subtrees: the replicated leaves are read from rank 0, the layers
run per rank, and the column-sharded codec head's logits are gathered.
"""
from __future__ import annotations

from typing import Tuple

import torch

from faster_qwen3_tts_tpu_torch.config import TalkerConfig

from ..ops.quant import dot
from ..parallel.mesh import per_rank, replica
from . import layers
from .layers import KVCache, LayerShape


def layer_shape(cfg: TalkerConfig) -> LayerShape:
    return LayerShape(
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        rms_eps=cfg.rms_norm_eps,
        sliding_window=cfg.sliding_window,
        layer_types=cfg.layer_types,
    )


def embed_text(params, ids: torch.Tensor) -> torch.Tensor:
    """Raw text-embedding lookup, [.., S] -> [.., S, text_hidden]."""
    return replica(params)["text_embed"][ids]


def text_project(params, x: torch.Tensor) -> torch.Tensor:
    p = replica(params)["text_proj"]
    return (dot(x, p["w"]).float() + p["b"].float()).to(x.dtype)


def text_hidden(params, ids: torch.Tensor) -> torch.Tensor:
    """text ids -> projected talker-width embeddings."""
    return text_project(params, embed_text(params, ids))


def embed_codec(params, ids: torch.Tensor) -> torch.Tensor:
    return replica(params)["codec_embed"][ids]


def codec_logits(params, h: torch.Tensor) -> torch.Tensor:
    return layers.column_gathered(params, h, lambda p: p["codec_head"]).float()


def speaker_project(params, xvec: torch.Tensor) -> torch.Tensor:
    """2048-d x-vector -> talker hidden, in f32, rounded to the weight dtype."""
    p = replica(params)["spk_proj"]
    y = torch.matmul(xvec.float(), p["w"].float()) + p["b"].float()
    return y.to(p["w"].dtype)


def prefill(params, cfg: TalkerConfig, embeds: torch.Tensor, pad_mask: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Prefill over a left-padded prompt. embeds [B, P, H]; pad_mask [B, P].
    Returns (last hidden [B, 1, H], logits [B, V] f32, cache with seq dim P).
    Rope positions start at 0 on the first real token."""
    num_pads = (1 - pad_mask).sum(dim=-1)
    positions = torch.arange(embeds.shape[1], device=embeds.device)[None, :] - num_pads[:, None]
    h, cache = layers.stack_prefill(
        per_rank(params, "layers"), embeds, positions.clamp(min=0), pad_mask, layer_shape(cfg),
        cfg.rope_theta, replica(params)["final_norm"],
    )
    last = h[:, -1:, :]
    return last, codec_logits(params, last[:, 0, :]), cache


def decode_step(params, cfg: TalkerConfig, x, pos, rope_pos, cache: KVCache, length_mask
                ) -> torch.Tensor:
    """One decode step; writes the cache in place and returns hidden [B, 1, H]."""
    return layers.stack_decode(
        per_rank(params, "layers"), x, pos, rope_pos, cache, length_mask, layer_shape(cfg),
        cfg.rope_theta, replica(params)["final_norm"],
    )
