"""Decoder-stack building blocks shared by the talker and the code predictor.

Port of faster_qwen3_tts_tpu/models/layers.py. Parameters are dicts of
tensors with every per-layer weight stacked along a leading layer axis (the
JAX layout, so trees convert leaf for leaf); the layer loop is a plain Python
loop over views of those stacks. Every product accumulates in f32 and is
rounded back to the activation dtype right after, where the JAX code rounds.

Under a (dp, tp) mesh (`parallel.mesh`) a tp group's stacks come as `Ranks`
of per-rank dicts: each rank runs `LayerShape(num_heads / tp, num_kv_heads
/ tp, ...)` on its column slices (q / k / v, gate / up) with its own KV
cache, and the row-parallel partials (wo, w_down) are summed in rank order.
Inside, every function works on the ranks this process holds
(`mesh.as_ranks`; a plain dict is one rank, whose products are the
unsharded ones): all of a one-process group's, or in a process mesh one
rank, whose reductions and gathers go through its tp process group
(`Ranks.group`). What a function returns per rank is put back by
`mesh.group` (one rank plain, several a `Ranks`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.attention import decode_attention, prefill_attention, prefill_mask
# rms_norm stays importable from here, where callers outside the decoder find it
from ..ops.glue import add_rms_norm, apply_rope, qk_norm_rope_kv, rms_norm, silu_mul  # noqa: F401
from ..ops.quant import QuantizedLinear, QuantizedLinear4, dot
from ..parallel.mesh import all_gather, all_reduce, as_ranks, group, like


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


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> cos, sin [..., S, head_dim] (HF 'cat' layout)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


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


def rank_shape(shape: LayerShape, tp: int) -> LayerShape:
    """The geometry one of `tp` ranks runs: its share of the heads."""
    if tp == 1:
        return shape
    return dataclasses.replace(shape, num_heads=shape.num_heads // tp, num_kv_heads=shape.num_kv_heads // tp)


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


def cache_max_seq(cache) -> int:
    """The slots of a KV cache, or of a tp group's per-rank caches."""
    return as_ranks(cache)[0].max_seq


def expand_cache(cache, max_seq: int):
    """A length-P prefill cache (or each rank's of a tp group) at offset 0 of
    a zeroed length-max_seq cache."""
    full = []
    for c in as_ranks(cache):
        L, B, P, KV, HD = c.k.shape
        if P > max_seq:
            raise ValueError(f"prefill length {P} exceeds max_seq_len {max_seq}")
        full.append(KVCache.zeros(L, B, max_seq, KV, HD, c.k.dtype, c.k.device))
        full[-1].k[:, :, :P] = c.k
        full[-1].v[:, :, :P] = c.v
    return group(full)


def _column(lps, x: torch.Tensor, name: str) -> List[torch.Tensor]:
    """A column-parallel projection of x (replicated over the ranks) -> each
    held rank's output columns. A replicated int4 weight
    (`mesh.shard_params` keeps QuantizedLinear4 whole) runs whole, once a
    process, with no collective; each rank takes its columns."""
    w = lps[0][name]
    if lps.size > 1 and isinstance(w, QuantizedLinear4):
        return list(dot(x, w).chunk(lps.size, dim=-1))[lps.rank:lps.rank + len(lps)]
    return [dot(x, lp[name]) for lp in lps]


def _row(lps, parts: List[torch.Tensor], name: str) -> torch.Tensor:
    """A row-parallel projection of the ranks' input slices, reduced: one
    rank's product as it is; over tp ranks the float32 partials summed
    (`mesh.all_reduce`: in rank order, over the tp process group in a
    process mesh) and rounded once (an int8 weight's partials in float32:
    K2 takes float32 rows and applies the scale in its epilogue); a
    replicated int4 weight runs whole, once, on the gathered input (the
    unsharded product)."""
    w = lps[0][name]
    if lps.size == 1:
        return dot(parts[0], w)
    if isinstance(w, QuantizedLinear4):
        return dot(all_gather(parts, -1, lps.group), w)
    dtype = parts[0].dtype
    if isinstance(w, QuantizedLinear):
        parts = [p.float() for p in parts]
    return all_reduce([dot(p, lp[name]) for p, lp in zip(parts, lps)], lps.group).to(dtype)


def column_gathered(params, x: torch.Tensor, weight) -> torch.Tensor:
    """x @ weight(params) over a plain subtree or a tp group's `Ranks`: the
    column shards' products gathered in rank order (`mesh.all_gather`,
    before any sampling, over the tp process group in a process mesh); a
    replicated int4 weight runs whole, once."""
    ranks = as_ranks(params)
    w = weight(ranks[0])
    if ranks.size == 1 or isinstance(w, QuantizedLinear4):
        return dot(x, w)
    return all_gather([dot(x, weight(r)) for r in ranks], -1, ranks.group)


def _qkv(lps, x: torch.Tensor, shape: LayerShape):
    """-> per rank (q, k, v) [B, S, heads, head_dim] of the rank's heads
    (`shape` is the rank's), as the projections give them: the per-head
    q / k norms are the caller's (K6 at decode, K5 at prefill)."""
    B, S, _ = x.shape
    qd = shape.num_heads * shape.head_dim
    kd = shape.num_kv_heads * shape.head_dim
    if "wqkv" in lps[0]:
        # the fused layout (ops.quant.fuse_layer_weights; never sharded): one product, split into views that
        # K5 / K6 read with their row stride, so no split is made contiguous
        y = dot(x, lps[0]["wqkv"])
        parts = [(y[..., :qd], y[..., qd:qd + kd], y[..., qd + kd:])]
    else:
        parts = zip(_column(lps, x, "wq"), _column(lps, x, "wk"), _column(lps, x, "wv"))
    return [(q.reshape(B, S, shape.num_heads, shape.head_dim), k.reshape(B, S, shape.num_kv_heads, shape.head_dim),
             v.reshape(B, S, shape.num_kv_heads, shape.head_dim)) for q, k, v in parts]


def _mlp(lps, x: torch.Tensor) -> torch.Tensor:
    if "w_gateup" in lps[0]:
        y = dot(x, lps[0]["w_gateup"])
        inter = y.shape[-1] // 2
        gates, ups = [y[..., :inter]], [y[..., inter:]]
    else:
        gates, ups = _column(lps, x, "w_gate"), _column(lps, x, "w_up")
    return _row(lps, [silu_mul(g, u) for g, u in zip(gates, ups)], "w_down")


# A layer returns its hidden state as a pair (x, m): the residual stream x
# and the MLP's output m not yet added to it. The next layer's ln1 (or the
# stack's final norm) adds them in the same launch as its norm (K5); the
# values are the unfused order's, x + m rounded, then normed.


def layer_prefill(lps, x, m, cos, sin, mask, shape: LayerShape):
    """One layer over a padded sequence. The hidden state is x + m (m None:
    x): [B, S, H]; mask [B, S, S] bool; `lps` the layer's dict of each rank.
    Returns (x, m) of the layer's output and per rank (k, v) with k/v
    [B, S, kv / tp, hd] for the cache: each rank attends with its heads."""
    x, h = add_rms_norm(x, m, lps[0]["ln1"], shape.rms_eps)
    attn, kv = [], []
    for lp, (q, k, v) in zip(lps, _qkv(lps, h, rank_shape(shape, lps.size))):
        q = apply_rope(add_rms_norm(q, None, lp["q_norm"], shape.rms_eps)[1], cos, sin)
        k = apply_rope(add_rms_norm(k, None, lp["k_norm"], shape.rms_eps)[1], cos, sin)
        a = prefill_attention(q, k, v, mask)
        attn.append(a.reshape(a.shape[0], a.shape[1], -1))
        kv.append((k, v))
    x, h = add_rms_norm(_row(lps, attn, "wo"), x, lps[0]["ln2"], shape.rms_eps)
    return x, _mlp(lps, h), kv


def layer_decode(lps, x, m, cos, sin, k_caches, v_caches, write_pos, length_mask, shape: LayerShape):
    """One layer for one token. The hidden state is x + m (m None: x):
    [B, 1, H]; `lps` the layer's dict of each rank, and k_caches / v_caches
    each rank's [B, S_max, kv / tp, hd], written IN PLACE at `write_pos` [B]
    (K6, with the q / k norms and RoPE); length_mask [B, S_max]. Each rank
    writes and reads its own heads' cache (K1 at kv / tp heads). Returns
    (x, m) of the layer's output."""
    x, h = add_rms_norm(x, m, lps[0]["ln1"], shape.rms_eps)
    attn = []
    for lp, (q, k, v), kc, vc in zip(lps, _qkv(lps, h, rank_shape(shape, lps.size)), k_caches, v_caches):
        q = qk_norm_rope_kv(q, k, v, lp["q_norm"], lp["k_norm"], cos, sin, kc, vc, write_pos, shape.rms_eps)
        attn.append(decode_attention(q, kc, vc, length_mask).reshape(x.shape[0], 1, -1))
    x, h = add_rms_norm(_row(lps, attn, "wo"), x, lps[0]["ln2"], shape.rms_eps)
    return x, _mlp(lps, h)


def _per_layer(layers) -> List[tuple]:
    """A stack, or a tp group's `Ranks` of stacks -> per layer, each held
    rank's dict of views (as `Ranks` of the same group)."""
    ranks = as_ranks(layers)
    return [like(ranks, lps) for lps in zip(*(unstack_layers(s) for s in ranks))]


def stack_prefill(layers, x, positions, pad_mask, shape: LayerShape, rope_theta, final_norm):
    """Full stack over a padded sequence. positions [B, S] (already offset for
    left pads). Returns (normed hidden [B, S, H], KVCache with seq dim S;
    for a tp group's `Ranks` of stacks, a `Ranks` of each rank's KVCache)."""
    cos, sin = rope_cos_sin(positions, shape.head_dim, rope_theta)
    per_layer = _per_layer(layers)
    flags = shape.sliding_flags(len(per_layer))
    full = prefill_mask(pad_mask)
    slide = prefill_mask(pad_mask, shape.sliding_window) if any(flags) else None
    kvs = []
    m = None
    for lps, is_slide in zip(per_layer, flags):
        x, m, kv = layer_prefill(lps, x, m, cos, sin, slide if is_slide else full, shape)
        kvs.append(kv)
    caches = [KVCache(k=torch.stack([layer[r][0] for layer in kvs]), v=torch.stack([layer[r][1] for layer in kvs]))
              for r in range(len(kvs[0]))]
    return add_rms_norm(x, m, final_norm, shape.rms_eps)[1], group(caches)


def stack_decode(layers, x, pos, rope_pos, cache, length_mask, shape: LayerShape,
                 rope_theta, final_norm):
    """One token through the stack, updating `cache` in place (a tp group's
    `Ranks` of stacks takes a `Ranks` of caches).

    pos [B]: cache write position; rope_pos [B]: rope position (pos minus the
    left pads); length_mask [B, S_max]. Sliding layers also drop slots at or
    below pos - sliding_window. A position past the cache end (a finished
    stream's masked frame) writes the last slot, as XLA clamps its update."""
    cos, sin = rope_cos_sin(rope_pos[:, None], shape.head_dim, rope_theta)
    per_layer = _per_layer(layers)
    flags = shape.sliding_flags(len(per_layer))
    if any(flags):
        s_ids = torch.arange(length_mask.shape[-1], device=x.device)[None, :]
        slide_mask = length_mask * (s_ids > (pos[:, None] - shape.sliding_window))
    write_pos = pos.clamp(max=cache_max_seq(cache) - 1)
    caches = as_ranks(cache)
    m = None
    for i, (lps, is_slide) in enumerate(zip(per_layer, flags)):
        mask = slide_mask if is_slide else length_mask
        x, m = layer_decode(lps, x, m, cos, sin, [c.k[i] for c in caches], [c.v[i] for c in caches], write_pos,
                            mask, shape)
    return add_rms_norm(x, m, final_norm, shape.rms_eps)[1]
