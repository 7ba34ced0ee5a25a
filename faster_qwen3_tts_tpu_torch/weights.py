"""Parameter trees: seeded random init and the bridge from host numpy trees.

- `init_numpy(cfg, seed)` draws exactly the numpy streams of the JAX
  package's `weights.init_all` (talker `seed`, talker layers `seed + 1`,
  predictor `seed + 1000` and its layers `seed + 1001`, codec `seed + 2000`),
  in float32 and in the JAX layouts.
- `params_from_numpy(tree, device)` turns such a tree, or one made by the JAX
  package (`weights.init_all(cfg, device_put=False)`, optionally quantized),
  into this port's tree of torch tensors. bfloat16 leaves of the JAX package
  (ml_dtypes) convert bit for bit. Conv weights of the codec and of the
  two reference-audio encoders change layout here, once: see `_LAYOUTS`.
- `init_speaker_encoder(seed, cfg)` / `init_codec_encoder(seed, cfg)` draw
  the reference-audio encoders as the JAX package's `VoiceExtractor` does
  (seeds 7 and 8 there).
- `init_all(cfg, seed, dtype, device, quant)` = init_numpy -> round to dtype
  -> optional host int8 quantization -> params_from_numpy -> device. Rounding
  float32 to bfloat16 is round-to-nearest-even in both torch and ml_dtypes,
  so every leaf equals the JAX package's.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import (CodecConfig, PredictorConfig, Qwen3TTSConfig,
                                               SpeakerEncoderConfig, TalkerConfig)

from .ops import quant as quant_lib

_RES_DILATIONS = (1, 3, 9)


def _init_stacked_layers(seed, num_layers, hidden, q_dim, kv_dim, head_dim, intermediate):
    rng = np.random.default_rng(seed)

    def init(*shape):
        scale = (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
        return rng.standard_normal((num_layers,) + shape, dtype=np.float32) * scale

    ones = lambda *shape: np.ones((num_layers,) + shape, np.float32)
    return {
        "wq": init(hidden, q_dim),
        "wk": init(hidden, kv_dim),
        "wv": init(hidden, kv_dim),
        "wo": init(q_dim, hidden),
        "w_gate": init(hidden, intermediate),
        "w_up": init(hidden, intermediate),
        "w_down": init(intermediate, hidden),
        "q_norm": ones(head_dim),
        "k_norm": ones(head_dim),
        "ln1": ones(hidden),
        "ln2": ones(hidden),
    }


def _init_talker(seed: int, cfg: TalkerConfig):
    rng = np.random.default_rng(seed)

    def init(*shape, scale=None):
        scale = scale if scale is not None else (shape[0] if len(shape) >= 2 else shape[-1]) ** -0.5
        return rng.standard_normal(shape, dtype=np.float32) * scale

    zeros = lambda *shape: np.zeros(shape, np.float32)
    return {
        "text_embed": init(cfg.text_vocab_size, cfg.text_hidden_size, scale=0.02),
        "text_proj": {"w": init(cfg.text_hidden_size, cfg.hidden_size), "b": zeros(cfg.hidden_size)},
        "codec_embed": init(cfg.vocab_size, cfg.hidden_size, scale=0.02),
        "codec_head": init(cfg.hidden_size, cfg.vocab_size),
        "spk_proj": {"w": init(2048, cfg.hidden_size), "b": zeros(cfg.hidden_size)},
        "layers": _init_stacked_layers(
            seed + 1, cfg.num_hidden_layers, cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
            cfg.head_dim, cfg.intermediate_size,
        ),
        "final_norm": np.ones((cfg.hidden_size,), np.float32),
    }


def _init_predictor(seed: int, cfg: PredictorConfig, talker_hidden: int):
    rng = np.random.default_rng(seed)

    def init(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
        return rng.standard_normal(shape, dtype=np.float32) * scale

    return {
        "mtp_proj": {
            "w": init(talker_hidden, cfg.hidden_size),
            "b": np.zeros((cfg.hidden_size,), np.float32),
        },
        "codec_embeds": init(cfg.num_codebooks, cfg.vocab_size, talker_hidden, scale=0.02),
        "lm_heads": init(cfg.num_codebooks, cfg.hidden_size, cfg.vocab_size),
        "layers": _init_stacked_layers(
            seed + 1, cfg.num_hidden_layers, cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
            cfg.head_dim, cfg.intermediate_size,
        ),
        "final_norm": np.ones((cfg.hidden_size,), np.float32),
    }


def _conv_init(rng, cin, cout, k, groups=1):
    """Codec conv weight [K, Cin/groups, Cout] at 0.5x gain, zero bias."""
    w = rng.standard_normal((k, cin // groups, cout), dtype=np.float32)
    return w * (0.5 / math.sqrt(max(cin // groups * k, 1))), np.zeros(cout, np.float32)


def _lin_init(rng, cin, cout):
    return rng.standard_normal((cin, cout), dtype=np.float32) * cin**-0.5


def _convnext_init(rng, dim):
    dw_w, dw_b = _conv_init(rng, dim, dim, 7, groups=dim)
    pw1_w = _lin_init(rng, dim, 4 * dim)
    pw2_w = _lin_init(rng, 4 * dim, dim)
    return {
        "dw_w": dw_w, "dw_b": dw_b, "ln_w": np.ones(dim, np.float32), "ln_b": np.zeros(dim, np.float32),
        "pw1_w": pw1_w, "pw1_b": np.zeros(4 * dim, np.float32), "pw2_w": pw2_w,
        "pw2_b": np.zeros(dim, np.float32), "gamma": np.full((dim,), 1e-6, np.float32),
    }


def _res_unit_init(rng, dim):
    c1_w, c1_b = _conv_init(rng, dim, dim, 7)
    c2_w, c2_b = _conv_init(rng, dim, dim, 1)
    zeros = lambda: np.zeros(dim, np.float32)
    return {"a1": zeros(), "b1": zeros(), "c1_w": c1_w, "c1_b": c1_b,
            "a2": zeros(), "b2": zeros(), "c2_w": c2_w, "c2_b": c2_b}


def _init_codec(seed: int, cfg: CodecConfig, rng=None):
    rng = np.random.default_rng(seed) if rng is None else rng
    zeros = lambda *shape: np.zeros(shape, np.float32)
    ones = lambda *shape: np.ones(shape, np.float32)
    full = lambda shape, v: np.full(shape, v, np.float32)
    lin = lambda cin, cout: _lin_init(rng, cin, cout)
    C = cfg.hidden_size

    def tlayer():
        return {
            "wq": lin(C, cfg.num_attention_heads * cfg.head_dim),
            "wk": lin(C, cfg.num_key_value_heads * cfg.head_dim),
            "wv": lin(C, cfg.num_key_value_heads * cfg.head_dim),
            "wo": lin(cfg.num_attention_heads * cfg.head_dim, C),
            "w_gate": lin(C, cfg.intermediate_size),
            "w_up": lin(C, cfg.intermediate_size),
            "w_down": lin(cfg.intermediate_size, C),
            "ln1": ones(C), "ln2": ones(C),
            "scale_attn": full((C,), cfg.layer_scale_initial_scale),
            "scale_mlp": full((C,), cfg.layer_scale_initial_scale),
        }

    layer_list = [tlayer() for _ in range(cfg.num_hidden_layers)]
    stacked = {k: np.stack([lay[k] for lay in layer_list]) for k in layer_list[0]}

    upsample = []
    for factor in cfg.upsampling_ratios:
        up_w, up_b = _conv_init(rng, C, C, factor)
        upsample.append({"up_w": up_w, "up_b": up_b, "convnext": _convnext_init(rng, C)})

    blocks = []
    for i, rate in enumerate(cfg.upsample_rates):
        in_dim, out_dim = cfg.decoder_dim // (2**i), cfg.decoder_dim // (2 ** (i + 1))
        up_w, up_b = _conv_init(rng, in_dim, out_dim, 2 * rate)
        blocks.append({"a": zeros(in_dim), "b": zeros(in_dim), "up_w": up_w, "up_b": up_b,
                       "units": [_res_unit_init(rng, out_dim) for _ in _RES_DILATIONS]})

    out_dim = cfg.decoder_dim // (2 ** len(cfg.upsample_rates))
    dec_in_w, dec_in_b = _conv_init(rng, C, cfg.decoder_dim, 7)
    dec_out_w, dec_out_b = _conv_init(rng, out_dim, 1, 7)
    embed = rng.standard_normal((cfg.codebook_size * cfg.num_quantizers, C), dtype=np.float32) * 0.02
    return {
        "code_embed": embed,
        "pre_transformer": {"layers": stacked, "final_norm": ones(C)},
        "upsample": upsample,
        "dec_in_w": dec_in_w, "dec_in_b": dec_in_b,
        "blocks": blocks,
        "out_a": zeros(out_dim), "out_b": zeros(out_dim),
        "dec_out_w": dec_out_w, "dec_out_b": dec_out_b,
    }


def init_numpy(cfg: Qwen3TTSConfig, seed: int = 0) -> Dict[str, Any]:
    """float32 host tree, leaf for leaf the JAX package's float32 init."""
    return {
        "talker": _init_talker(seed, cfg.talker),
        "predictor": _init_predictor(seed + 1000, cfg.predictor, cfg.talker.hidden_size),
        "codec": _init_codec(seed + 2000, cfg.codec),
    }


def init_speaker_encoder(seed: int, cfg: SpeakerEncoderConfig) -> Dict[str, Any]:
    """ECAPA-TDNN tree, draw for draw the JAX package's
    `voice_extract.init_speaker_params`: TDNN convs {"w" [K, Cin, Cout], "b"},
    linears (w [Cin, Cout], b) tuples."""
    rng = np.random.default_rng(seed)
    C, S = cfg.channels, cfg.res2net_scale
    if C % S:
        raise ValueError(f"speaker encoder channels {C} must divide by res2net_scale {S}")
    W = C // S

    def tdnn(cin, cout, k):
        w = rng.standard_normal((k, cin, cout), dtype=np.float32) / math.sqrt(cin * k)
        return {"w": w, "b": np.zeros(cout, np.float32)}

    def lin(cin, cout):
        w = rng.standard_normal((cin, cout), dtype=np.float32) / math.sqrt(cin)
        return w, np.zeros(cout, np.float32)

    params: Dict[str, Any] = {"in": tdnn(cfg.mel_bins, C, 5)}
    for i in range(cfg.num_blocks):
        params[f"block{i}"] = {
            "tdnn1": tdnn(C, C, 1),
            "res2": [tdnn(W, W, 3) for _ in range(S - 1)],
            "tdnn2": tdnn(C, C, 1),
            "se1": lin(C, cfg.se_channels),
            "se2": lin(cfg.se_channels, C),
        }
    params["mfa"] = tdnn(cfg.num_blocks * C, cfg.mfa_dim, 1)
    params["att_tdnn"] = tdnn(3 * cfg.mfa_dim, cfg.attention_channels, 1)
    params["att_proj"] = lin(cfg.attention_channels, cfg.mfa_dim)
    params["out"] = lin(2 * cfg.mfa_dim, cfg.embedding_dim)
    return params


def init_codec_encoder(seed: int, cfg: CodecConfig) -> Dict[str, Any]:
    """Codec-encoder tree (the decoder's mirror), draw for draw the JAX
    package's `voice_extract.init_encoder_params`. Its pre_transformer is the
    one of a whole codec init that continues the same rng stream."""
    rng = np.random.default_rng(seed)
    zeros = lambda n: np.zeros(n, np.float32)
    dims = encoder_dims(cfg)
    C = cfg.hidden_size
    params: Dict[str, Any] = {}
    params["enc_in_w"], params["enc_in_b"] = _conv_init(rng, 1, dims[0], 7)
    params["blocks"] = [
        {"units": [_res_unit_init(rng, dims[i]) for _ in _RES_DILATIONS],
         "a": zeros(dims[i]), "b": zeros(dims[i]),
         "down_w": _conv_init(rng, dims[i], dims[i + 1], 2 * rate)[0], "down_b": zeros(dims[i + 1])}
        for i, rate in enumerate(reversed(cfg.upsample_rates))
    ]
    params["enc_mid_w"], params["enc_mid_b"] = _conv_init(rng, dims[-1], C, 7)
    params["downsample"] = [
        {"convnext": _convnext_init(rng, C), "down_w": _conv_init(rng, C, C, 2 * factor)[0],
         "down_b": zeros(C)}
        for factor in reversed(cfg.upsampling_ratios)
    ]
    params["pre_transformer"] = _init_codec(seed + 1, cfg, rng=rng)["pre_transformer"]
    return params


def encoder_dims(cfg: CodecConfig):
    """Codec-encoder channel plan: from the decoder's narrowest width
    (decoder_dim / 2^n) doubling back up to decoder_dim."""
    n = len(cfg.upsample_rates)
    base = cfg.decoder_dim // (2**n)
    return tuple(base * (2**i) for i in range(n + 1))


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes leaf of the JAX package
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_convert(v, device) for v in node]
    fields = getattr(node, "_fields", None)
    if fields == ("q", "scale"):
        return quant_lib.QuantizedLinear(*(_to_tensor(x).to(device) for x in node))
    if fields == ("packed", "scale", "wmin"):
        return quant_lib.QuantizedLinear4(*(_to_tensor(x).to(device) for x in node))
    if isinstance(node, tuple):  # (w, b) linears of the speaker encoder
        return tuple(_convert(v, device) for v in node)
    return _to_tensor(node).to(device)


def _conv_weight(w: torch.Tensor) -> torch.Tensor:
    """JAX conv [K, Cin/groups, Cout] -> torch conv1d [Cout, Cin/groups, K]."""
    return w.permute(2, 1, 0).contiguous()


def _trans_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """JAX conv_transpose [K, Cin, Cout] -> torch conv_transpose1d [Cin, Cout, K],
    flipped along K: lax.conv_transpose does not flip its kernel, torch does."""
    return w.flip(0).permute(1, 2, 0).contiguous()


def _codec_layout(codec: dict) -> dict:
    """The one place where codec conv weights change layout (see models/codec.py)."""
    out = dict(codec)
    out["upsample"] = [
        {**st, "up_w": _trans_conv_weight(st["up_w"]),
         "convnext": {**st["convnext"], "dw_w": _conv_weight(st["convnext"]["dw_w"])}}
        for st in codec["upsample"]
    ]
    out["blocks"] = [
        {**blk, "up_w": _trans_conv_weight(blk["up_w"]),
         "units": [{**u, "c1_w": _conv_weight(u["c1_w"]), "c2_w": _conv_weight(u["c2_w"])}
                   for u in blk["units"]]}
        for blk in codec["blocks"]
    ]
    out["dec_in_w"] = _conv_weight(codec["dec_in_w"])
    out["dec_out_w"] = _conv_weight(codec["dec_out_w"])
    return out


def _speaker_encoder_layout(spk: dict) -> dict:
    """TDNN conv weights {"w": [K, Cin, Cout]} -> [Cout, Cin, K]; the (w, b)
    linears keep their [Cin, Cout] layout."""
    def tdnn(node):
        return {**node, "w": _conv_weight(node["w"])}

    out = {}
    for name, node in spk.items():
        if name.startswith("block"):
            out[name] = {**node, "tdnn1": tdnn(node["tdnn1"]), "tdnn2": tdnn(node["tdnn2"]),
                         "res2": [tdnn(r) for r in node["res2"]]}
        else:
            out[name] = tdnn(node) if isinstance(node, dict) else node
    return out


def _codec_encoder_layout(enc: dict) -> dict:
    """Every conv weight of the codec encoder -> [Cout, Cin/groups, K]."""
    out = dict(enc)
    out["enc_in_w"] = _conv_weight(enc["enc_in_w"])
    out["enc_mid_w"] = _conv_weight(enc["enc_mid_w"])
    out["blocks"] = [
        {**blk, "down_w": _conv_weight(blk["down_w"]),
         "units": [{**u, "c1_w": _conv_weight(u["c1_w"]), "c2_w": _conv_weight(u["c2_w"])}
                   for u in blk["units"]]}
        for blk in enc["blocks"]
    ]
    out["downsample"] = [
        {**st, "down_w": _conv_weight(st["down_w"]),
         "convnext": {**st["convnext"], "dw_w": _conv_weight(st["convnext"]["dw_w"])}}
        for st in enc["downsample"]
    ]
    return out


_LAYOUTS = {"codec": _codec_layout, "speaker_encoder": _speaker_encoder_layout,
            "codec_encoder": _codec_encoder_layout}


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Host tree (numpy leaves, QuantizedLinear / QuantizedLinear4 nodes of
    either package) -> the port's tree on `device` (the card unless the
    caller asks for "cpu"). Conv weights of the codec and of the two
    reference-audio encoders change layout here."""
    out = _convert(tree, device)
    for name, layout in _LAYOUTS.items():
        if name in out:
            out[name] = layout(out[name])
    return out


def _cast_floats(node, dtype):
    if isinstance(node, dict):
        return {k: _cast_floats(v, dtype) for k, v in node.items()}
    if isinstance(node, torch.Tensor) and node.is_floating_point():
        return node.to(dtype)
    return node


def _round_to(node, dtype):
    """Round every float leaf of a numpy tree to `dtype`, kept as float32."""
    if isinstance(node, dict):
        return {k: _round_to(v, dtype) for k, v in node.items()}
    return torch.from_numpy(node).to(dtype).float().numpy()


def init_all(cfg: Qwen3TTSConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda",
             quant: str = "none") -> Dict[str, Any]:
    """Seeded random-init tree on `device` (the card unless the caller asks
    for "cpu"): talker and predictor in `dtype` (int8 projections when
    quant == "int8"), codec in float32."""
    tree = init_numpy(cfg, seed)
    if dtype != torch.float32:
        for sub in ("talker", "predictor"):
            tree[sub] = _round_to(tree[sub], dtype)
    if quant != "none":
        tree = quant_lib.quantize_model_params(tree, quant)
    params = params_from_numpy(tree, "cpu")
    for sub in ("talker", "predictor"):
        params[sub] = _cast_floats(params[sub], dtype)
    return _to_device(params, device)


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    if isinstance(node, tuple):
        return type(node)(*(x.to(device) for x in node))
    return node.to(device)
