"""Code2Wav codec decoder: [B, T, 16] RVQ codes -> 24 kHz waveform.

Port of faster_qwen3_tts_tpu/models/codec.py. The public function keeps the
JAX layouts (codes [B, T, 16] in, waveform [B, n] out). Inside, the
pre-transformer and the ConvNeXt stages work channels-last [B, T, C] as in
JAX, and every convolution runs channels-first [B, C, T] through
`torch.nn.functional.conv1d` / `conv_transpose1d` (the JAX package leaves
its convolutions to XLA as well).

Conv weights are already in PyTorch's layouts here: `weights.params_from_numpy`
turns the JAX [K, Cin/groups, Cout] weights into [Cout, Cin/groups, K], and
the transposed-conv weights into [Cin, Cout, K] FLIPPED along K, because
`jax.lax.conv_transpose` (without transpose_kernel) does not flip the kernel
while `conv_transpose1d` does.

The codec runs in float32. On a card, float32 convolutions must not run in
TF32 (cuDNN's default); `model.FasterQwen3TTS` turns TF32 off for cuDNN and
cuBLAS when its weights are on a card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from faster_qwen3_tts_tpu_torch.config import CodecConfig

from ..ops.glue import apply_rope, rms_norm
from .layers import rope_cos_sin

_NEG_INF = -1e30
_RES_DILATIONS = (1, 3, 9)  # per decoder block (structural constant)


def causal_conv1d(x, w, b, stride=1, dilation=1, groups=1):
    """Causal conv. x: [B, Cin, T]; w: [Cout, Cin/groups, K] -> [B, Cout, T']."""
    k = w.shape[-1]
    k_eff = (k - 1) * dilation + 1
    pad_left = k_eff - stride
    length = x.shape[-1]
    n_frames = (length - k_eff + pad_left) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - pad_left)
    extra = int(ideal - length)
    x = F.pad(x, (pad_left, max(extra, 0)))
    return F.conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups)


def causal_trans_conv1d(x, w, b, stride):
    """Causal transposed conv. x: [B, Cin, T]; w: [Cin, Cout, K] (flipped).
    Produces (T-1)*stride + K samples, then trims K - stride from each side."""
    k = w.shape[-1]
    y = F.conv_transpose1d(x, w, b, stride=stride)
    pad = k - stride
    if pad > 0:
        y = y[..., pad : y.shape[-1] - pad]
    return y


def snake_beta(x, alpha, beta):
    """SnakeBeta over channels-first x [B, C, T]: x + sin^2(x e^alpha) / (e^beta + eps)."""
    a = torch.exp(alpha.float())[:, None]
    bno = (torch.exp(beta.float()) + 1e-9)[:, None]
    xf = x.float()
    return (xf + torch.sin(xf * a).square() / bno).to(x.dtype)


def layer_norm(x, w, b, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def convnext_block(p, x):
    """x [B, T, C]: depthwise conv7 -> LN -> pw1 -> GELU -> pw2 -> gamma."""
    h = causal_conv1d(x.transpose(1, 2), p["dw_w"], p["dw_b"], groups=x.shape[-1]).transpose(1, 2)
    h = layer_norm(h, p["ln_w"], p["ln_b"])
    h = torch.matmul(h.float(), p["pw1_w"].float()) + p["pw1_b"].float()
    h = F.gelu(h)
    h = torch.matmul(h.to(x.dtype).float(), p["pw2_w"].float()) + p["pw2_b"].float()
    return x + (p["gamma"].float() * h).to(x.dtype)


def residual_unit(p, x, dilation):
    h = snake_beta(x, p["a1"], p["b1"])
    h = causal_conv1d(h, p["c1_w"], p["c1_b"], dilation=dilation)
    h = snake_beta(h, p["a2"], p["b2"])
    return x + causal_conv1d(h, p["c2_w"], p["c2_b"])


def decoder_block(p, x, upsample_rate):
    h = snake_beta(x, p["a"], p["b"])
    h = causal_trans_conv1d(h, p["up_w"], p["up_b"], stride=upsample_rate)
    for unit, dilation in zip(p["units"], _RES_DILATIONS):
        h = residual_unit(unit, h, dilation)
    return h


def _linear(x, w):
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _pre_transformer_layer(p, x, cos, sin, mask, cfg: CodecConfig):
    B, T, _ = x.shape
    H, D = cfg.num_attention_heads, cfg.head_dim
    h = rms_norm(p["ln1"], x, cfg.rms_norm_eps)
    q = apply_rope(_linear(h, p["wq"]).reshape(B, T, H, D), cos, sin)
    k = apply_rope(_linear(h, p["wk"]).reshape(B, T, H, D), cos, sin)
    v = _linear(h, p["wv"]).reshape(B, T, H, D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D**-0.5)
    probs = torch.softmax(torch.where(mask, scores, _NEG_INF), dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).reshape(B, T, H * D)
    x = x + p["scale_attn"].to(x.dtype) * _linear(attn.to(x.dtype), p["wo"])
    h = rms_norm(p["ln2"], x, cfg.rms_norm_eps)
    gate = torch.matmul(h.float(), p["w_gate"].float())
    up = torch.matmul(h.float(), p["w_up"].float())
    mlp = _linear((F.silu(gate) * up).to(x.dtype), p["w_down"])
    return x + p["scale_mlp"].to(x.dtype) * mlp


def pre_transformer(p, x, cfg: CodecConfig):
    """Sliding-window causal transformer over frames, x [B, T, C]."""
    B, T, _ = x.shape
    idx = torch.arange(T, device=x.device)
    cos, sin = rope_cos_sin(idx[None, :].expand(B, T), cfg.head_dim, cfg.rope_theta)
    qpos, kpos = idx[:, None], idx[None, :]
    mask = ((kpos <= qpos) & (kpos > qpos - cfg.sliding_window))[None, None]
    layers = p["layers"]
    for i in range(layers["wq"].shape[0]):
        x = _pre_transformer_layer({k: w[i] for k, w in layers.items()}, x, cos, sin, mask, cfg)
    return rms_norm(p["final_norm"], x, cfg.rms_norm_eps)


def decode_frames(params, cfg: CodecConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, 16] int -> waveform [B, n_samples] f32 in [-1, 1]."""
    offsets = torch.arange(cfg.num_quantizers, device=codes.device) * cfg.codebook_size
    emb = params["code_embed"][codes.long() + offsets]  # [B, T, Q, C]
    h = emb.float().mean(dim=2).to(emb.dtype)
    h = pre_transformer(params["pre_transformer"], h, cfg)
    for stage, factor in zip(params["upsample"], cfg.upsampling_ratios):
        h = causal_trans_conv1d(h.transpose(1, 2), stage["up_w"], stage["up_b"], stride=factor)
        h = convnext_block(stage["convnext"], h.transpose(1, 2))
    h = causal_conv1d(h.transpose(1, 2), params["dec_in_w"], params["dec_in_b"])
    for i, blk in enumerate(params["blocks"]):
        h = decoder_block(blk, h, cfg.upsample_rates[i])
    h = snake_beta(h, params["out_a"], params["out_b"])
    h = causal_conv1d(h, params["dec_out_w"], params["dec_out_b"])
    return torch.clamp(h[:, 0, :].float(), -1.0, 1.0)
