"""A toy model module for the benchmark's tests: Qwen3-TTS with a
mixture-of-experts talker MLP, to show that a configuration of another
architecture comes as files alone (`portbench/models`).

Each talker layer's MLP is a softmax router over `num_experts` experts, the
top `num_experts_per_tok` of them weighted by their renormalized
probabilities, plus a shared expert scaled by a sigmoid gate; every expert
is a SiLU-gated MLP of its own width. The code predictor, the codec, the
prompt and the judge's logit processing are Qwen3-TTS's. Plain torch in
float32 with Q8_0 projections, as the Qwen3-TTS reference. The port has no
expert layer, so `quantize` refuses.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench import maker
from portbench.models import qwen3_tts as base
from portbench.reference import model as ref_lib

processed = base.processed
prefill_launches = base.prefill_launches
window_flops = base.window_flops
prompt_rows = base.prompt_rows
k2_bytes = base.k2_bytes


def _sizes(cfg: Dict[str, Any]) -> Tuple[int, int, int, int, int, int]:
    t = cfg["talker"]
    return (t["num_hidden_layers"], t["hidden_size"], t["num_experts"], t["num_experts_per_tok"],
            t["moe_intermediate_size"], t["shared_expert_intermediate_size"])


def make_tree(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Qwen3-TTS's tree with each talker layer's dense MLP replaced by the
    router, the experts [L, E, ...], the shared expert and its gate, drawn
    by a generator of their own."""
    tree = maker.make_tree(cfg, seed, device, dtype)
    L, H, E, _, Fe, Fs = _sizes(cfg)
    gen = torch.Generator(torch.device(device)).manual_seed((int(seed) + 1) % (2 ** 63))
    layers = tree["talker"]["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]

    def draw(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * fan_in ** -0.5

    layers["router"] = draw((L, H, E), H)
    layers["experts_gate"], layers["experts_up"] = draw((L, E, H, Fe), H), draw((L, E, H, Fe), H)
    layers["experts_down"] = draw((L, E, Fe, H), Fe)
    layers["shared_gate"] = draw((L, H, 1), H)
    layers["shared_w_gate"], layers["shared_w_up"] = draw((L, H, Fs), H), draw((L, H, Fs), H)
    layers["shared_w_down"] = draw((L, Fs, H), Fs)
    return tree


def quantize(tree):
    raise NotImplementedError("the port has no expert layer: this configuration is the reference's only")


def moe_mlp(h: torch.Tensor, w: Dict[str, torch.Tensor], k: int, act) -> torch.Tensor:
    """h [..., H] -> the routed experts' weighted sum plus the gated shared
    expert."""
    probs = torch.softmax(h @ w["router"], dim=-1)
    top_w, top_i = probs.topk(k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(w["router"].shape[-1]):
        weight = (top_w * (top_i == e)).sum(dim=-1, keepdim=True)
        y = act(F.silu(h @ w["experts_gate"][e]) * (h @ w["experts_up"][e])) @ w["experts_down"][e]
        out = out + weight * y
    shared = act(F.silu(h @ w["shared_w_gate"]) * (h @ w["shared_w_up"])) @ w["shared_w_down"]
    return out + torch.sigmoid(h @ w["shared_gate"]) * shared


class _MoEDecoder:
    """The Qwen3 decoder of the reference with `moe_mlp` as its MLP."""

    def __init__(self, layers: Dict[str, torch.Tensor], final_norm, sub: Dict[str, Any]):
        q8 = ("wq", "wk", "wv", "wo", "experts_gate", "experts_up", "experts_down", "shared_w_gate",
              "shared_w_up", "shared_w_down")
        self.w = {k: ref_lib.q8_0(layers[k]) for k in q8}
        self.w.update(router=layers["router"].float(), shared_gate=layers["shared_gate"].float())
        self.n = {k: layers[k].float() for k in ("q_norm", "k_norm", "ln1", "ln2")}
        self.final = final_norm.float()
        self.nh, self.nkv, self.hd = sub["num_attention_heads"], sub["num_key_value_heads"], sub["head_dim"]
        self.eps, self.theta, self.k = sub["rms_norm_eps"], sub["rope_theta"], sub["num_experts_per_tok"]

    def __call__(self, x: torch.Tensor, act) -> torch.Tensor:
        B, S, _ = x.shape
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        rep = self.nh // self.nkv
        for i in range(self.w["wq"].shape[0]):
            w = {k: v[i] for k, v in self.w.items()}
            h = act(ref_lib._rms(self.n["ln1"][i], x, self.eps))
            q = ref_lib._rope(ref_lib._rms(self.n["q_norm"][i], (h @ w["wq"]).view(B, S, self.nh, self.hd),
                                           self.eps), self.theta)
            k = ref_lib._rope(ref_lib._rms(self.n["k_norm"][i], (h @ w["wk"]).view(B, S, self.nkv, self.hd),
                                           self.eps), self.theta)
            v = (h @ w["wv"]).view(B, S, self.nkv, self.hd)
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
            scores = torch.einsum("bshd,bthd->bhst", q, k) * self.hd ** -0.5
            probs = torch.softmax(torch.where(causal, scores, ref_lib._NEG), dim=-1)
            x = x + act(torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, -1)) @ w["wo"]
            x = x + moe_mlp(act(ref_lib._rms(self.n["ln2"][i], x, self.eps)), w, self.k, act)
        return ref_lib._rms(self.final, x, self.eps)


class Reference(ref_lib.Reference):
    """Qwen3-TTS's reference with the expert talker. The base class builds a
    dense talker from the tree, here from the shared expert's weights, and
    that talker is then replaced."""

    def __init__(self, tree: Dict[str, Any], cfg: Dict[str, Any]):
        t = tree["talker"]
        dense = dict(t["layers"], w_gate=t["layers"]["shared_w_gate"], w_up=t["layers"]["shared_w_up"],
                     w_down=t["layers"]["shared_w_down"])
        super().__init__(dict(tree, talker=dict(t, layers=dense)), cfg)
        self.talker = _MoEDecoder(t["layers"], t["final_norm"], cfg["talker"])


def frame_launches(cfg: Dict[str, Any], B: int) -> List[Tuple[int, int, int]]:
    """Qwen3-TTS's frame with each talker MLP's three launches replaced by
    the router's, a routed GEMV of one row for each (lane, chosen expert)
    and projection, the shared expert's three and its gate's."""
    L, H, E, k, Fe, Fs = _sizes(cfg)
    dense = base.frame_launches(cfg, B)  # per talker layer q, k, v, o, gate, up, down; then the rest
    mlp = [(B, H, E)] + [(1, H, Fe), (1, H, Fe), (1, Fe, H)] * (B * k)
    mlp += [(B, H, Fs), (B, H, Fs), (B, Fs, H), (B, H, 1)]
    out = []
    for layer in range(L):
        out += dense[7 * layer: 7 * layer + 4] + mlp
    return out + dense[7 * L:]


def expert_bytes(cfg: Dict[str, Any]) -> int:
    """One routed expert's bytes as a layer's routed GEMV needs them once,
    however many lanes chose it: its gate, up and down int8 weights and
    float32 scale rows."""
    _, H, _, _, Fe, _ = _sizes(cfg)
    return 2 * (H * Fe + 4 * Fe) + Fe * H + 4 * H


def frame_flops(cfg: Dict[str, Any], context: int) -> float:
    """Qwen3-TTS's frame with the dense talker MLP's operations replaced by
    the router's, k experts' and the shared expert's and its gate's."""
    t = cfg["talker"]
    L, H, E, k, Fe, Fs = _sizes(cfg)
    moe = H * E + k * 3 * H * Fe + 3 * H * Fs + H
    return base.frame_flops(cfg, context) + 2.0 * L * (moe - 3 * H * t["intermediate_size"])
