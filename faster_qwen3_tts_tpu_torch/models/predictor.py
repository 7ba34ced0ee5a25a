"""Code predictor: the MTP transformer that emits codebooks 1..15 per frame.

Port of faster_qwen3_tts_tpu/models/predictor.py. `predict_codebooks` runs
the whole 15-codebook loop (projection, 2-token prefill, 14 single-token
decode steps against a 17-slot static cache, per-codebook head, sampling) as
a Python loop. Sampling draws from a `torch.Generator` instead of JAX's
per-step folded keys; `noise` [15, B, V] replaces the draws in tests.
Under a mesh `params` may be a tp group's `Ranks` of per-rank subtrees:
each rank runs its heads with its own 17-slot cache, and the column-sharded
heads' logits are gathered before sampling.
"""
from __future__ import annotations

from typing import Optional

import torch

from faster_qwen3_tts_tpu_torch.config import PredictorConfig

from ..ops.quant import QuantizedLinear, QuantizedLinear4, dot
from ..ops.sampling import SamplingParams, sample_logits
from ..parallel.mesh import per_rank, replica
from . import layers
from .layers import LayerShape


def layer_shape(cfg: PredictorConfig) -> LayerShape:
    return LayerShape(
        num_heads=cfg.num_attention_heads,
        num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim,
        rms_eps=cfg.rms_norm_eps,
        sliding_window=cfg.sliding_window,
        layer_types=cfg.layer_types,
    )


def mtp_project(params, x: torch.Tensor) -> torch.Tensor:
    p = replica(params)["mtp_proj"]
    return (dot(x, p["w"]).float() + p["b"].float()).to(x.dtype)


def embed_codebook(params, cb_index: int, token_ids: torch.Tensor) -> torch.Tensor:
    """Embed tokens of codebook `cb_index` (0..14) at the talker width."""
    return replica(params)["codec_embeds"][cb_index][token_ids]


def embed_frame_sum(params, codebook_tokens: torch.Tensor) -> torch.Tensor:
    """Sum of the 15 per-codebook embeddings: [B, 15] -> [B, talker_hidden]."""
    tables = replica(params)["codec_embeds"]  # [15, V, H]
    idx = torch.arange(tables.shape[0], device=tables.device)
    gathered = tables[idx[None, :], codebook_tokens.long()]  # [B, 15, H]
    return gathered.float().sum(dim=1).to(tables.dtype)


def _head(heads, cb_index: int):
    if isinstance(heads, (QuantizedLinear, QuantizedLinear4)):
        return type(heads)(*(f[cb_index] for f in heads))
    return heads[cb_index]


def _head_logits(params, cb_index: int, h: torch.Tensor) -> torch.Tensor:
    """lm_head[cb_index] over h [B, pred_hidden] -> [B, V] f32 (a tp group's
    vocab slices gathered)."""
    return layers.column_gathered(params, h, lambda p: _head(p["lm_heads"], cb_index)).float()


def predict_codebooks(
    params,
    cfg: PredictorConfig,
    pred_input: torch.Tensor,
    sampling: SamplingParams,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """pred_input [B, 2, talker_hidden] = (past hidden, codebook-0 embed).
    Returns codebook tokens [B, 15] int32."""
    B = pred_input.shape[0]
    device = pred_input.device
    shape = layer_shape(cfg)
    h = mtp_project(params, pred_input)

    positions = torch.arange(2, device=device)[None, :].expand(B, 2)
    pad_mask = torch.ones((B, 2), dtype=torch.int32, device=device)
    stack, final_norm = per_rank(params, "layers"), replica(params)["final_norm"]
    hs, cache_p = layers.stack_prefill(stack, h, positions, pad_mask, shape, cfg.rope_theta, final_norm)
    cache = layers.expand_cache(cache_p, cfg.max_seq)

    def draw(step: int, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(
            logits, sampling, generator=generator, noise=None if noise is None else noise[step]
        )

    tok = draw(0, _head_logits(params, 0, hs[:, -1, :]))
    toks = [tok]
    s_ids = torch.arange(cfg.max_seq, device=device)[None, :]
    for step in range(1, cfg.num_codebooks):
        x = mtp_project(params, embed_codebook(params, step - 1, tok)[:, None, :])
        pos = torch.full((B,), step + 1, dtype=torch.int32, device=device)
        length_mask = (s_ids <= step + 1).to(torch.int32).expand(B, cfg.max_seq).contiguous()
        hd = layers.stack_decode(stack, x, pos, pos, cache, length_mask, shape, cfg.rope_theta, final_norm)
        tok = draw(step, _head_logits(params, step, hd[:, 0, :]))
        toks.append(tok)
    return torch.stack(toks, dim=1)
