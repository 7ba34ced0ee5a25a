"""The benchmark's own weight maker: a parameter tree drawn from a seed.

The tree has the shapes the configuration file states, in the port's tree
layout (stacked decoder layers [L, ...], codec convolutions as
`conv1d` [Cout, Cin/groups, K] and `conv_transpose1d` [Cin, Cout, K]
weights), in the types they are served in: talker and code predictor in
bfloat16, codec in float32. Each type is drawn by one `torch.Generator` call
on the tree's device, then cut into leaves, each scaled into a tensor of its
own; constant
leaves (norm weights, biases, layer scales) are filled. The same seed and
device give the same tree.

The init scales follow the published recipe the port's own random init uses
(1/sqrt(fan-in) projections, 0.02 embeddings, codec convolutions at gain 0.5),
so activations keep realistic magnitudes on random weights.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

_RES_DILATIONS = (1, 3, 9)


class _Spec:
    """Leaves to draw: (path, shape, scale) per dtype; constants apart."""

    def __init__(self):
        self.random: Dict[torch.dtype, List[Tuple[tuple, tuple, float]]] = {}
        self.const: List[Tuple[tuple, tuple, torch.dtype, float]] = []

    def rand(self, path, shape, scale, dtype):
        self.random.setdefault(dtype, []).append((path, tuple(shape), float(scale)))

    def fill(self, path, shape, value, dtype):
        self.const.append((path, tuple(shape), dtype, float(value)))


def _stack(spec: _Spec, base: tuple, L: int, hidden: int, q: int, kv: int, head: int, inter: int, dtype):
    for name, (i, o) in (("wq", (hidden, q)), ("wk", (hidden, kv)), ("wv", (hidden, kv)), ("wo", (q, hidden)),
                         ("w_gate", (hidden, inter)), ("w_up", (hidden, inter)), ("w_down", (inter, hidden))):
        spec.rand(base + (name,), (L, i, o), i ** -0.5, dtype)
    for name, n in (("q_norm", head), ("k_norm", head), ("ln1", hidden), ("ln2", hidden)):
        spec.fill(base + (name,), (L, n), 1.0, dtype)


def tree_spec(cfg: Dict[str, Any], dtype=torch.bfloat16) -> _Spec:
    """Every leaf of the tree a configuration file describes."""
    t, p, c = cfg["talker"], cfg["predictor"], cfg["codec"]
    s = _Spec()
    H, Th = t["hidden_size"], t["text_hidden_size"]
    s.rand(("talker", "text_embed"), (t["text_vocab_size"], Th), 0.02, dtype)
    s.rand(("talker", "text_proj", "w"), (Th, H), Th ** -0.5, dtype)
    s.fill(("talker", "text_proj", "b"), (H,), 0.0, dtype)
    s.rand(("talker", "codec_embed"), (t["vocab_size"], H), 0.02, dtype)
    s.rand(("talker", "codec_head"), (H, t["vocab_size"]), H ** -0.5, dtype)
    s.rand(("talker", "spk_proj", "w"), (2048, H), 2048 ** -0.5, dtype)
    s.fill(("talker", "spk_proj", "b"), (H,), 0.0, dtype)
    _stack(s, ("talker", "layers"), t["num_hidden_layers"], H, t["num_attention_heads"] * t["head_dim"],
           t["num_key_value_heads"] * t["head_dim"], t["head_dim"], t["intermediate_size"], dtype)
    s.fill(("talker", "final_norm"), (H,), 1.0, dtype)

    Hp, ncb = p["hidden_size"], p["num_code_groups"] - 1
    s.rand(("predictor", "mtp_proj", "w"), (H, Hp), H ** -0.5, dtype)
    s.fill(("predictor", "mtp_proj", "b"), (Hp,), 0.0, dtype)
    s.rand(("predictor", "codec_embeds"), (ncb, p["vocab_size"], H), 0.02, dtype)
    s.rand(("predictor", "lm_heads"), (ncb, Hp, p["vocab_size"]), Hp ** -0.5, dtype)
    _stack(s, ("predictor", "layers"), p["num_hidden_layers"], Hp, p["num_attention_heads"] * p["head_dim"],
           p["num_key_value_heads"] * p["head_dim"], p["head_dim"], p["intermediate_size"], dtype)
    s.fill(("predictor", "final_norm"), (Hp,), 1.0, dtype)

    f32 = torch.float32
    C, L = c["hidden_size"], c["num_hidden_layers"]
    qd, kd = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    s.rand(("codec", "code_embed"), (c["codebook_size"] * c["num_quantizers"], C), 0.02, f32)
    pt = ("codec", "pre_transformer", "layers")
    for name, (i, o) in (("wq", (C, qd)), ("wk", (C, kd)), ("wv", (C, kd)), ("wo", (qd, C)),
                         ("w_gate", (C, c["intermediate_size"])), ("w_up", (C, c["intermediate_size"])),
                         ("w_down", (c["intermediate_size"], C))):
        s.rand(pt + (name,), (L, i, o), i ** -0.5, f32)
    for name, v in (("ln1", 1.0), ("ln2", 1.0), ("scale_attn", c["layer_scale_initial_scale"]),
                    ("scale_mlp", c["layer_scale_initial_scale"])):
        s.fill(pt + (name,), (L, C), v, f32)
    s.fill(("codec", "pre_transformer", "final_norm"), (C,), 1.0, f32)

    def conv(path, cin, cout, k, groups=1, transposed=False):
        shape = (cin, cout, k) if transposed else (cout, cin // groups, k)
        s.rand(path + ("w",), shape, 0.5 / math.sqrt(max(cin // groups * k, 1)), f32)
        s.fill(path + ("b",), (cout,), 0.0, f32)

    for i, factor in enumerate(c["upsampling_ratios"]):
        base = ("codec", "upsample", i)
        conv(base + ("up",), C, C, factor, transposed=True)
        cn = base + ("convnext",)
        conv(cn + ("dw",), C, C, 7, groups=C)
        s.fill(cn + ("ln_w",), (C,), 1.0, f32)
        s.fill(cn + ("ln_b",), (C,), 0.0, f32)
        s.rand(cn + ("pw1_w",), (C, 4 * C), C ** -0.5, f32)
        s.fill(cn + ("pw1_b",), (4 * C,), 0.0, f32)
        s.rand(cn + ("pw2_w",), (4 * C, C), (4 * C) ** -0.5, f32)
        s.fill(cn + ("pw2_b",), (C,), 0.0, f32)
        s.fill(cn + ("gamma",), (C,), 1e-6, f32)
    D = c["decoder_dim"]
    conv(("codec", "dec_in"), C, D, 7)
    for i, rate in enumerate(c["upsample_rates"]):
        din, dout = D // 2 ** i, D // 2 ** (i + 1)
        base = ("codec", "blocks", i)
        s.fill(base + ("a",), (din,), 0.0, f32)
        s.fill(base + ("b",), (din,), 0.0, f32)
        conv(base + ("up",), din, dout, 2 * rate, transposed=True)
        for j, _ in enumerate(_RES_DILATIONS):
            u = base + ("units", j)
            for name in ("a1", "b1", "a2", "b2"):
                s.fill(u + (name,), (dout,), 0.0, f32)
            conv(u + ("c1",), dout, dout, 7)
            conv(u + ("c2",), dout, dout, 1)
    out = D // 2 ** len(c["upsample_rates"])
    s.fill(("codec", "out_a"), (out,), 0.0, f32)
    s.fill(("codec", "out_b"), (out,), 0.0, f32)
    conv(("codec", "dec_out"), out, 1, 7)
    return s


# conv paths end in ("w",) / ("b",); the port names them <prefix>_w / <prefix>_b
def _key(path: tuple) -> tuple:
    if path[-1] in ("w", "b") and path[-2] in ("up", "dw", "dec_in", "dec_out", "c1", "c2"):
        return path[:-2] + (f"{path[-2]}_{path[-1]}",)
    return path


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def make_tree(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The parameter tree of `cfg` drawn from `seed` on `device`: one draw a
    dtype, cut into leaves, each scaled into a tensor of its own (aligned,
    and the draw is freed once cut)."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    spec = tree_spec(cfg, dtype)
    tree: Dict[str, Any] = {}
    for dt in sorted(spec.random, key=str):
        leaves = spec.random[dt]
        flat = torch.randn(sum(math.prod(sh) for _, sh, _ in leaves), generator=gen, device=device, dtype=dt)
        at = 0
        for path, shape, scale in leaves:
            n = math.prod(shape)
            _put(tree, _key(path), flat[at:at + n].view(shape).mul(scale))
            at += n
        del flat
    for path, shape, dt, value in spec.const:
        _put(tree, _key(path), torch.full(shape, value, dtype=dt, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tree


def voices(seed: int, n: int, device) -> torch.Tensor:
    """n x-vector voice prompts [n, 2048] float32 drawn from the seed (unit
    variance a dimension, as a speaker encoder's output roughly has)."""
    gen = torch.Generator("cpu").manual_seed((int(seed) + 7919) % (2 ** 63))
    return torch.randn(n, 2048, generator=gen).to(device)
