"""Decoder-stack building blocks shared by the talker and the code predictor.

Port of faster_qwen3_tts_tpu/models/layers.py. Parameters are dicts of
tensors with every per-layer weight stacked along a leading layer axis (the
JAX layout, so trees convert leaf for leaf); the layer loop is a plain Python
loop over views of those stacks. Every product accumulates in f32 and is
rounded back to the activation dtype right after, where the JAX code rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import decode_attention, prefill_attention, prefill_mask
from ..ops.quant import QuantizedLinear, QuantizedLinear4, dot


@dataclasses.dataclass
class KVCache:
    """Static KV cache [num_layers, batch, max_seq, num_kv_heads, head_dim].
    Decode steps write into it in place."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, num_layers, batch, max_seq, num_kv_heads, head_dim, dtype, device):
        shape = (num_layers, batch, max_seq, num_kv_heads, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (w.float() * y).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> cos, sin [..., S, head_dim] (HF 'cat' layout)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D] (broadcast over heads)."""
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Static attention geometry of one decoder stack."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_eps: float
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None

    def sliding_flags(self, num_layers: int) -> Tuple[bool, ...]:
        """Per-layer 'uses the sliding-window mask' flags (HF derivation)."""
        if self.sliding_window is None:
            return (False,) * num_layers
        if self.layer_types is None:
            return (True,) * num_layers
        if len(self.layer_types) != num_layers:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for {num_layers} layers"
            )
        return tuple(t == "sliding_attention" for t in self.layer_types)


def unstack_layers(stacked: Dict[str, object]) -> List[Dict[str, object]]:
    """Stacked per-layer params -> one dict of views per layer."""

    def pick(w, i):
        if isinstance(w, (QuantizedLinear, QuantizedLinear4)):
            return type(w)(*(f[i] for f in w))
        return w[i]

    n = _num_layers(stacked)
    return [{k: pick(w, i) for k, w in stacked.items()} for i in range(n)]


def _num_layers(stacked) -> int:
    w = next(iter(stacked.values()))  # every leaf is stacked on the layer axis, in either layout
    return (w[0] if isinstance(w, (QuantizedLinear, QuantizedLinear4)) else w).shape[0]


def _qkv(lp, x: torch.Tensor, shape: LayerShape):
    B, S, _ = x.shape
    qd = shape.num_heads * shape.head_dim
    kd = shape.num_kv_heads * shape.head_dim
    if "wqkv" in lp:
        # the fused layout (ops.quant.fuse_layer_weights): one product, split
        # into views; the norms and RoPE below write new tensors, and the
        # cache write copies v, so no split is made contiguous
        y = dot(x, lp["wqkv"])
        q, k, v = y[..., :qd], y[..., qd:qd + kd], y[..., qd + kd:]
    else:
        q, k, v = dot(x, lp["wq"]), dot(x, lp["wk"]), dot(x, lp["wv"])
    q = q.reshape(B, S, shape.num_heads, shape.head_dim)
    k = k.reshape(B, S, shape.num_kv_heads, shape.head_dim)
    v = v.reshape(B, S, shape.num_kv_heads, shape.head_dim)
    # Qwen3 per-head q/k RMSNorm
    return rms_norm(lp["q_norm"], q, shape.rms_eps), rms_norm(lp["k_norm"], k, shape.rms_eps), v


def _mlp(lp, x: torch.Tensor) -> torch.Tensor:
    if "w_gateup" in lp:
        y = dot(x, lp["w_gateup"])
        inter = y.shape[-1] // 2
        gate, up = y[..., :inter], y[..., inter:]
    else:
        gate = dot(x, lp["w_gate"])
        up = dot(x, lp["w_up"])
    return dot(F.silu(gate.float()).to(x.dtype) * up, lp["w_down"])


def layer_prefill(lp, x, cos, sin, mask, shape: LayerShape):
    """One layer over a padded sequence. x: [B, S, H]; mask [B, S, S] bool.
    Returns (y, (k, v)) with k/v [B, S, kv, hd] for the cache."""
    h = rms_norm(lp["ln1"], x, shape.rms_eps)
    q, k, v = _qkv(lp, h, shape)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = prefill_attention(q, k, v, mask)
    B, S = attn.shape[:2]
    x = x + dot(attn.reshape(B, S, -1), lp["wo"])
    x = x + _mlp(lp, rms_norm(lp["ln2"], x, shape.rms_eps))
    return x, (k, v)


def layer_decode(lp, x, cos, sin, k_cache, v_cache, write_pos, length_mask, shape: LayerShape):
    """One layer for one token. x: [B, 1, H]; k_cache/v_cache [B, S_max, kv,
    hd] are written IN PLACE at `write_pos` [B]; length_mask [B, S_max]."""
    h = rms_norm(lp["ln1"], x, shape.rms_eps)
    q, k, v = _qkv(lp, h, shape)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, write_pos] = k[:, 0]
    v_cache[rows, write_pos] = v[:, 0]
    attn = decode_attention(q, k_cache, v_cache, length_mask)
    x = x + dot(attn.reshape(x.shape[0], 1, -1), lp["wo"])
    x = x + _mlp(lp, rms_norm(lp["ln2"], x, shape.rms_eps))
    return x


def stack_prefill(layers, x, positions, pad_mask, shape: LayerShape, rope_theta, final_norm):
    """Full stack over a padded sequence. positions [B, S] (already offset for
    left pads). Returns (normed hidden [B, S, H], KVCache with seq dim S)."""
    cos, sin = rope_cos_sin(positions, shape.head_dim, rope_theta)
    per_layer = unstack_layers(layers)
    flags = shape.sliding_flags(len(per_layer))
    full = prefill_mask(pad_mask)
    slide = prefill_mask(pad_mask, shape.sliding_window) if any(flags) else None
    ks, vs = [], []
    for lp, is_slide in zip(per_layer, flags):
        x, (k, v) = layer_prefill(lp, x, cos, sin, slide if is_slide else full, shape)
        ks.append(k)
        vs.append(v)
    return rms_norm(final_norm, x, shape.rms_eps), KVCache(k=torch.stack(ks), v=torch.stack(vs))


def stack_decode(layers, x, pos, rope_pos, cache: KVCache, length_mask, shape: LayerShape,
                 rope_theta, final_norm):
    """One token through the stack, updating `cache` in place.

    pos [B]: cache write position; rope_pos [B]: rope position (pos minus the
    left pads); length_mask [B, S_max]. Sliding layers also drop slots at or
    below pos - sliding_window. A position past the cache end (a finished
    stream's masked frame) writes the last slot, as XLA clamps its update."""
    cos, sin = rope_cos_sin(rope_pos[:, None], shape.head_dim, rope_theta)
    per_layer = unstack_layers(layers)
    flags = shape.sliding_flags(len(per_layer))
    if any(flags):
        s_ids = torch.arange(length_mask.shape[-1], device=x.device)[None, :]
        slide_mask = length_mask * (s_ids > (pos[:, None] - shape.sliding_window))
    write_pos = pos.clamp(max=cache.max_seq - 1)
    for i, (lp, is_slide) in enumerate(zip(per_layer, flags)):
        mask = slide_mask if is_slide else length_mask
        x = layer_decode(lp, x, cos, sin, cache.k[i], cache.v[i], write_pos, mask, shape)
    return rms_norm(final_norm, x, shape.rms_eps)
