"""Parameter trees: seeded random init, checkpoints, and the bridge to torch.

Host trees are numpy in the JAX package's layouts (float32; a bfloat16
value is kept as the float32 of the same value). Every way of getting one
ends in the same `materialize`:

- `init_numpy(cfg, seed)` draws exactly the numpy streams of the JAX
  package's `weights.init_all` (talker `seed`, talker layers `seed + 1`,
  predictor `seed + 1000` and its layers `seed + 1001`, codec `seed + 2000`).
  `init_speaker_encoder` / `init_codec_encoder` draw the reference-audio
  encoders as its `VoiceExtractor` does (seeds 7 and 8 there).
- `save_pretrained` / `is_own_checkpoint` / `load_pretrained`: the own
  format of both packages (`model.safetensors` with '/'-joined tree paths,
  bfloat16 leaves as uint16 bits under `@bf16`, plus `config.json`).
- `load_hf_checkpoint`: upstream HF Qwen3-TTS safetensors through the JAX
  package's name maps, strict or not, with per-submodel coverage; missing
  tensors (non-strict) are drawn as its `_finalize` draws them on the host.
  `export_hf_layout` writes a tree back out in that layout.
- `materialize(tree, dtype, quant, device)`: round the talker and predictor
  to `dtype`, optional host quantization (int8, int4 or mixed; scales and
  mins stay float32), `params_from_numpy` (torch,
  the conv layouts of `_LAYOUTS`), cast, move to `device`. Rounding float32
  to bfloat16 is round-to-nearest-even in both torch and ml_dtypes, so every
  leaf equals the JAX package's. `init_all` = materialize(init_numpy(...)).
- `params_from_numpy(tree, device)` also takes trees made by the JAX package
  (`weights.init_all(cfg, device_put=False)`, optionally quantized);
  bfloat16 leaves of the JAX package (ml_dtypes) convert bit for bit.
  `host_tree` is its inverse (the JAX layouts, CPU tensors, bf16 kept).
- Deploy bundles, the JAX package's format byte for byte:
  `save_deploy_bundle` / `is_deploy_bundle` / `read_deploy_bundle` (into
  pinned memory) / `load_deploy_bundle`; `_device_unpack` is the device
  half (one copy a dtype section, one allocation a leaf) and
  `pack_transfer` ships a host tree the same way.
- `init_all_device(cfg, seed, dtype, device)`: random init drawn on the
  device from the sentinel skeleton (the JAX package's `init_all_device`).

Files are read and written by `utils.safetensors`, which needs neither the
`safetensors` package nor ml_dtypes.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import (CodecConfig, PredictorConfig, Qwen3TTSConfig,
                                               SpeakerEncoderConfig, TalkerConfig, config_from_dict)

from .ops import quant as quant_lib
from .utils import safetensors as st

logger = logging.getLogger(__name__)

_RES_DILATIONS = (1, 3, 9)


def _init_stacked_layers(seed, num_layers, hidden, q_dim, kv_dim, head_dim, intermediate, rng=None):
    rng = np.random.default_rng(seed) if rng is None else rng

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


def _init_talker(seed: int, cfg: TalkerConfig, rng=None):
    layers_rng = rng  # a given rng (the loader's skeleton) draws every leaf
    rng = np.random.default_rng(seed) if rng is None else rng

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
            cfg.head_dim, cfg.intermediate_size, rng=layers_rng,
        ),
        "final_norm": np.ones((cfg.hidden_size,), np.float32),
    }


def _init_predictor(seed: int, cfg: PredictorConfig, talker_hidden: int, rng=None):
    layers_rng = rng
    rng = np.random.default_rng(seed) if rng is None else rng

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
            cfg.head_dim, cfg.intermediate_size, rng=layers_rng,
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
    stacked = {k: _stack_host([lay[k] for lay in layer_list]) for k in layer_list[0]}

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


def init_speaker_encoder(seed: int, cfg: SpeakerEncoderConfig, rng=None) -> Dict[str, Any]:
    """ECAPA-TDNN tree, draw for draw the JAX package's
    `voice_extract.init_speaker_params`: TDNN convs {"w" [K, Cin, Cout], "b"},
    linears (w [Cin, Cout], b) tuples."""
    rng = np.random.default_rng(seed) if rng is None else rng
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


def init_codec_encoder(seed: int, cfg: CodecConfig, rng=None) -> Dict[str, Any]:
    """Codec-encoder tree (the decoder's mirror), draw for draw the JAX
    package's `voice_extract.init_encoder_params`. Its pre_transformer is the
    one of a whole codec init that continues the same rng stream."""
    rng = np.random.default_rng(seed) if rng is None else rng
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
    if isinstance(a, torch.Tensor):  # a leaf of `host_tree`
        return a
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


def _jax_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """Inverse of `_conv_weight`: torch conv1d [Cout, Cin/groups, K] -> JAX [K, Cin/groups, Cout]."""
    return w.permute(2, 1, 0).contiguous()


def _jax_trans_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """Inverse of `_trans_conv_weight`: torch [Cin, Cout, K] -> JAX [K, Cin, Cout], unflipped."""
    return w.permute(2, 0, 1).flip(0).contiguous()


def _codec_layout(codec: dict, conv=_conv_weight, tconv=_trans_conv_weight) -> dict:
    """The one place where codec conv weights change layout (see models/codec.py);
    with the `_jax_*` transforms, the way back."""
    out = dict(codec)
    out["upsample"] = [
        {**st, "up_w": tconv(st["up_w"]),
         "convnext": {**st["convnext"], "dw_w": conv(st["convnext"]["dw_w"])}}
        for st in codec["upsample"]
    ]
    out["blocks"] = [
        {**blk, "up_w": tconv(blk["up_w"]),
         "units": [{**u, "c1_w": conv(u["c1_w"]), "c2_w": conv(u["c2_w"])}
                   for u in blk["units"]]}
        for blk in codec["blocks"]
    ]
    out["dec_in_w"] = conv(codec["dec_in_w"])
    out["dec_out_w"] = conv(codec["dec_out_w"])
    return out


def _speaker_encoder_layout(spk: dict, conv=_conv_weight, tconv=None) -> dict:
    """TDNN conv weights {"w": [K, Cin, Cout]} -> [Cout, Cin, K]; the (w, b)
    linears keep their [Cin, Cout] layout."""
    def tdnn(node):
        return {**node, "w": conv(node["w"])}

    out = {}
    for name, node in spk.items():
        if name.startswith("block"):
            out[name] = {**node, "tdnn1": tdnn(node["tdnn1"]), "tdnn2": tdnn(node["tdnn2"]),
                         "res2": [tdnn(r) for r in node["res2"]]}
        else:
            out[name] = tdnn(node) if isinstance(node, dict) else node
    return out


def _codec_encoder_layout(enc: dict, conv=_conv_weight, tconv=None) -> dict:
    """Every conv weight of the codec encoder -> [Cout, Cin/groups, K]."""
    out = dict(enc)
    out["enc_in_w"] = conv(enc["enc_in_w"])
    out["enc_mid_w"] = conv(enc["enc_mid_w"])
    out["blocks"] = [
        {**blk, "down_w": conv(blk["down_w"]),
         "units": [{**u, "c1_w": conv(u["c1_w"]), "c2_w": conv(u["c2_w"])}
                   for u in blk["units"]]}
        for blk in enc["blocks"]
    ]
    out["downsample"] = [
        {**st, "down_w": conv(st["down_w"]),
         "convnext": {**st["convnext"], "dw_w": conv(st["convnext"]["dw_w"])}}
        for st in enc["downsample"]
    ]
    return out


_LAYOUTS = {"codec": _codec_layout, "speaker_encoder": _speaker_encoder_layout,
            "codec_encoder": _codec_encoder_layout}


def _port_layouts(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX layouts -> the port's, on the leaves' device."""
    out = dict(tree)
    for name, layout in _LAYOUTS.items():
        if name in out:
            out[name] = layout(out[name])
    return out


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Host tree (numpy leaves, QuantizedLinear / QuantizedLinear4 nodes of
    either package, or the CPU tensors of `host_tree`) -> the port's tree on
    `device` (the card unless the caller asks for "cpu"). Conv weights of
    the codec and of the two reference-audio encoders change layout here."""
    return _port_layouts(_convert(tree, device))


def host_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: the port's tree (on any device)
    -> a host tree in the JAX layouts whose leaves are CPU tensors of the
    same dtypes (bfloat16 stays bfloat16), QuantizedLinear(4) nodes kept,
    fused `wqkv` / `w_gateup` leaves kept under their names.
    `params_from_numpy(host_tree(p))` equals `p` bit for bit."""
    out = _to_device(params, "cpu")
    for name, layout in _LAYOUTS.items():
        if name in out:
            out[name] = layout(out[name], conv=_jax_conv_weight, tconv=_jax_trans_conv_weight)
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
    return torch.from_numpy(np.ascontiguousarray(node, np.float32)).to(dtype).float().numpy()


def materialize(tree: Dict[str, Any], dtype=torch.bfloat16, quant: str = "none", device="cuda",
                mark: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """A host tree in the JAX layouts (float32 numpy: `init_numpy`,
    `load_pretrained`, `load_hf_checkpoint`) -> the port's tree on `device`:
    talker and predictor rounded to `dtype` (their projections quantized
    when quant is "int8", "int4" or "mixed": `quant.quantize_model_params`,
    scales and mins kept in float32), the codec and the encoders in float32. A random tree and a
    loaded one are quantized and laid out by this same code. `mark(name)`
    is called after the "quantize" step, so that a caller can time it apart
    from the conversion and the transfer."""
    tree = dict(tree)
    if dtype != torch.float32:
        for sub in ("talker", "predictor"):
            if sub in tree:
                tree[sub] = _round_to(tree[sub], dtype)
    if quant != "none":
        tree = quant_lib.quantize_model_params(tree, quant)
    if mark is not None:
        mark("quantize")
    params = params_from_numpy(tree, "cpu")
    for sub in ("talker", "predictor"):
        if sub in params:
            params[sub] = _cast_floats(params[sub], dtype)
    return _to_device(params, device)


def init_all(cfg: Qwen3TTSConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda",
             quant: str = "none") -> Dict[str, Any]:
    """Seeded random-init tree on `device` (the card unless the caller asks
    for "cpu"): `materialize(init_numpy(cfg, seed), ...)`."""
    return materialize(init_numpy(cfg, seed), dtype, quant, device)


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    if isinstance(node, tuple):  # QuantizedLinear(4) nodes, the speaker encoder's (w, b) pairs
        items = [_to_device(x, device) for x in node]
        return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
    return node.to(device)


# -- the port's own checkpoint format (the JAX package's save_pretrained) --------------------------


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """'/'-joined tree paths -> leaves; bfloat16 leaves (ml_dtypes) are
    stored as their uint16 bits under `<path>@bf16`, as the JAX package does."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":
            out[prefix[:-1] + "@bf16"] = arr.view(np.uint16)
        else:
            out[prefix[:-1]] = arr
    return out


def _set_deep(tree: Any, keys, value):
    k = keys[0]
    if isinstance(tree, list):
        k = int(k)
        while len(tree) <= k:
            tree.append({})
    if len(keys) == 1:
        tree[k] = value
        return
    if isinstance(tree, list):
        if not isinstance(tree[k], (dict, list)):
            tree[k] = {} if not keys[1].isdigit() else []
        _set_deep(tree[k], keys[1:], value)
    else:
        if k not in tree:
            tree[k] = [] if keys[1].isdigit() else {}
        _set_deep(tree[k], keys[1:], value)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bits -> the same values in float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild the host tree. bfloat16 leaves come back as float32 arrays of
    the same values (the port has no ml_dtypes); `materialize` rounds them
    to bfloat16 again without change."""
    root: Dict[str, Any] = {}
    for name, arr in flat.items():
        if name.endswith("@bf16"):
            name = name[: -len("@bf16")]
            arr = _bf16_bits_to_f32(arr)
        _set_deep(root, name.split("/"), arr)
    return root


def _config_to_dict(cfg: Qwen3TTSConfig) -> dict:
    def enc(x):
        if dataclasses.is_dataclass(x):
            return {k: enc(v) for k, v in dataclasses.asdict(x).items()}
        if isinstance(x, dict):
            return {k: enc(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return list(x)
        return x

    return {
        "model_type": cfg.model_type,
        "model_size": cfg.model_size,
        "tts_bos_token_id": cfg.tts_bos_token_id,
        "tts_eos_token_id": cfg.tts_eos_token_id,
        "tts_pad_token_id": cfg.tts_pad_token_id,
        "talker_config": enc(cfg.talker),
        "predictor_config": enc(cfg.predictor),
        "codec_config": enc(cfg.codec),
        "speaker_encoder_config": enc(cfg.speaker_encoder),
    }


def save_pretrained(path, params: Dict[str, Any], cfg: Qwen3TTSConfig) -> None:
    """Write a host tree in the JAX layouts (numpy leaves) and its config as
    the own format: `model.safetensors` with '/'-joined tree paths plus
    `config.json`, the files the JAX package's `save_pretrained` writes."""
    os.makedirs(path, exist_ok=True)
    st.save_file(_flatten(params), os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_config_to_dict(cfg), f, indent=2)


def is_own_checkpoint(path) -> bool:
    """True if `path` holds the own format. An upstream single-file
    checkpoint may also be named model.safetensors; the key style tells
    them apart ('/' tree paths here, '.' module paths upstream)."""
    f = os.path.join(path, "model.safetensors")
    if not os.path.exists(f):
        return False
    keys = sorted(st.read_header(f)[0])
    return bool(keys) and "/" in keys[0]


def load_pretrained(path):
    """Own-format checkpoint -> (host tree in the JAX layouts, config)."""
    flat = st.load_file(os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    return _unflatten(flat), cfg


# -- upstream HF Qwen3-TTS safetensors -------------------------------------------------------------
#
# The importer fills a tree in the JAX layouts, as the JAX package's does,
# and leaves the port's layouts to `materialize`. Upstream module-path
# suffixes of one decoder layer -> the stacked-layer keys. Linear weights
# transpose torch's [out, in] -> [in, out]; per-layer tensors stack into the
# leading layer axis.

_TALKER_LAYER_MAP = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
    "input_layernorm.weight": "ln1",
    "post_attention_layernorm.weight": "ln2",
}

_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# Code2Wav pre-transformer layers: no q/k norms, a LayerScale per sublayer
_CODEC_LAYER_MAP = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
    "input_layernorm.weight": "ln1",
    "post_attention_layernorm.weight": "ln2",
    "self_attn_layer_scale.scale": "scale_attn",
    "mlp_layer_scale.scale": "scale_mlp",
}

_SUBMODELS = ("talker", "predictor", "codec", "speaker_encoder", "codec_encoder")


class StrictLoadError(RuntimeError):
    """Raised in strict mode when an expected tensor is missing or mismatched."""


class _RawStore:
    """Lazy reader over every *.safetensors of a directory; tensors come
    out as float32 numpy (BF16 and F16 checkpoints widen exactly)."""

    def __init__(self, path):
        self._files: List[st.SafetensorsFile] = []
        self._index: Dict[str, int] = {}
        for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
            h = st.SafetensorsFile(f)
            for k in h.keys():
                self._index[k] = len(self._files)
            self._files.append(h)

    def __bool__(self):
        return bool(self._index)

    def keys(self):
        return self._index.keys()

    def __contains__(self, name):
        return name in self._index

    def get(self, name: str) -> np.ndarray:
        return self._files[self._index[name]].float32(name)


def _find_prefix(raw, suffix: str, hint: str = "") -> Optional[str]:
    """The key prefix P such that P + suffix is a checkpoint tensor (the
    shortest; `hint` breaks ties). Upstream packagings differ in their root
    ("talker." vs "model.talker." vs none), so the import anchors on
    distinctive suffixes."""
    cands = [k[: -len(suffix)] for k in raw.keys() if k.endswith(suffix)]
    if not cands:
        return None
    if len(cands) > 1 and hint:
        hinted = [c for c in cands if hint in c]
        if len(hinted) == 1:
            return hinted[0]
    return sorted(cands, key=len)[0]


class _Importer:
    """Tensor assignments into the tree, with missing / mismatch accounting."""

    def __init__(self, raw: _RawStore):
        self.raw = raw
        self.used: set = set()
        self.missing: list = []
        self.mismatched: list = []

    def fetch(self, name: str, transform: Optional[str] = None) -> Optional[np.ndarray]:
        if name not in self.raw:
            return None
        a = self.raw.get(name)
        self.used.add(name)
        if transform == "lin":  # torch Linear [out, in] -> [in, out]
            a = a.T
        elif transform == "conv":  # torch Conv1d [out, in/g, k] -> [k, in/g, out]
            a = np.transpose(a, (2, 1, 0))
        elif transform == "tconv":
            # torch ConvTranspose1d [in, out, k] -> [k, in, out], flipped along
            # k: the JAX layout is lax.conv_transpose's, which does not flip
            # (`_trans_conv_weight` flips it back for torch)
            a = np.transpose(a, (2, 0, 1))[::-1]
        return np.ascontiguousarray(a, np.float32)

    def put(self, dst, key, name: str, transform: Optional[str] = None):
        """One tensor into dst[key] (a dict key or a list index)."""
        a = self.fetch(name, transform)
        label = f"{name} -> {key}"
        if a is None:
            self.missing.append(label)
            return
        cur = dst[key]
        if tuple(cur.shape) != tuple(a.shape):
            self.mismatched.append(f"{label}: ckpt {a.shape} vs model {tuple(cur.shape)}")
            return
        dst[key] = a

    def put_stacked(self, dst, key, names, transform: Optional[str] = None):
        """Per-layer / per-codebook tensors stacked into dst[key]'s leading axis."""
        per = [self.fetch(n, transform) for n in names]
        label = f"{names[0]}.. ({len(names)}) -> {key}"
        if any(p is None for p in per):
            self.missing.extend(n for n, p in zip(names, per) if p is None)
            return
        a = np.stack(per)
        cur = dst[key]
        if tuple(cur.shape) != tuple(a.shape):
            self.mismatched.append(f"{label}: ckpt {a.shape} vs model {tuple(cur.shape)}")
            return
        dst[key] = a

    def put_pair(self, dst, key, names):
        """(weight, bias) tuple leaves of the speaker encoder. 3-D weights
        arrive as torch Conv1d [out, in/g, k]; a k=1 conv used as a linear
        becomes [in, out]; 2-D linear weights are taken as [in, out]."""
        w_name, b_name = names
        w = self.fetch(w_name)
        b = self.fetch(b_name)
        if w is None or b is None:
            self.missing.extend(n for n, v in ((w_name, w), (b_name, b)) if v is None)
            return
        cur_w, cur_b = dst[key]
        if w.ndim == 3 and cur_w.ndim == 2 and w.shape[-1] == 1:
            w = w[:, :, 0].T
        elif w.ndim == 3:
            w = np.transpose(w, (2, 1, 0))
        elif w.ndim == 2 and tuple(cur_w.shape) != tuple(w.shape):
            w = w.T
        if tuple(cur_w.shape) != tuple(w.shape) or tuple(cur_b.shape) != tuple(b.shape):
            self.mismatched.append(
                f"{w_name} -> {key}: ckpt {w.shape}/{b.shape} vs model "
                f"{tuple(cur_w.shape)}/{tuple(cur_b.shape)}"
            )
            return
        dst[key] = (np.ascontiguousarray(w), b)


def _import_talker(imp: _Importer, t: Dict, cfg: Qwen3TTSConfig):
    """Talker tensors (upstream `model.talker`)."""
    root = _find_prefix(imp.raw, "codec_head.weight", hint="talker") or "talker."
    m = root + "model."
    imp.put(t, "text_embed", f"{m}text_embedding.weight")
    imp.put(t, "codec_embed", f"{m}codec_embedding.weight")
    imp.put(t, "codec_head", f"{root}codec_head.weight", "lin")
    imp.put(t["text_proj"], "w", f"{root}text_projection.weight", "lin")
    imp.put(t["text_proj"], "b", f"{root}text_projection.bias")
    imp.put(t["spk_proj"], "w", f"{m}spk_projection.weight", "lin")
    imp.put(t["spk_proj"], "b", f"{m}spk_projection.bias")
    imp.put(t, "final_norm", f"{m}norm.weight")
    L = cfg.talker.num_hidden_layers
    for name, key in _TALKER_LAYER_MAP.items():
        tr = "lin" if key in _LINEAR_KEYS else None
        imp.put_stacked(t["layers"], key, [f"{m}layers.{i}.{name}" for i in range(L)], tr)


def _import_predictor(imp: _Importer, p: Dict, cfg: Qwen3TTSConfig):
    """Code-predictor tensors (upstream `talker.code_predictor`)."""
    cp = _find_prefix(imp.raw, "small_to_mtp_projection.weight") or "talker.code_predictor."
    imp.put(p["mtp_proj"], "w", f"{cp}small_to_mtp_projection.weight", "lin")
    imp.put(p["mtp_proj"], "b", f"{cp}small_to_mtp_projection.bias")
    imp.put(p, "final_norm", f"{cp}model.norm.weight")
    Lp = cfg.predictor.num_hidden_layers
    for name, key in _TALKER_LAYER_MAP.items():
        tr = "lin" if key in _LINEAR_KEYS else None
        imp.put_stacked(p["layers"], key, [f"{cp}model.layers.{i}.{name}" for i in range(Lp)], tr)
    n = cfg.predictor.num_codebooks
    imp.put_stacked(p, "lm_heads", [f"{cp}lm_head.{i}.weight" for i in range(n)], "lin")
    imp.put_stacked(p, "codec_embeds", [f"{cp}model.codec_embedding.{i}.weight" for i in range(n)])


def _put_res_unit(imp: _Importer, unit: Dict, base: str):
    imp.put(unit, "a1", f"{base}act1.alpha")
    imp.put(unit, "b1", f"{base}act1.beta")
    imp.put(unit, "c1_w", f"{base}conv1.conv.weight", "conv")
    imp.put(unit, "c1_b", f"{base}conv1.conv.bias")
    imp.put(unit, "a2", f"{base}act2.alpha")
    imp.put(unit, "b2", f"{base}act2.beta")
    imp.put(unit, "c2_w", f"{base}conv2.conv.weight", "conv")
    imp.put(unit, "c2_b", f"{base}conv2.conv.bias")


def _put_convnext(imp: _Importer, cn: Dict, base: str):
    imp.put(cn, "dw_w", f"{base}dwconv.conv.weight", "conv")
    imp.put(cn, "dw_b", f"{base}dwconv.conv.bias")
    imp.put(cn, "ln_w", f"{base}norm.weight")
    imp.put(cn, "ln_b", f"{base}norm.bias")
    imp.put(cn, "pw1_w", f"{base}pwconv1.weight", "lin")
    imp.put(cn, "pw1_b", f"{base}pwconv1.bias")
    imp.put(cn, "pw2_w", f"{base}pwconv2.weight", "lin")
    imp.put(cn, "pw2_b", f"{base}pwconv2.bias")
    imp.put(cn, "gamma", f"{base}gamma")


def _put_transformer(imp: _Importer, pt: Dict, base: str, num_layers: int):
    imp.put(pt, "final_norm", f"{base}pre_transformer.norm.weight")
    for name, key in _CODEC_LAYER_MAP.items():
        tr = "lin" if key in _LINEAR_KEYS else None
        imp.put_stacked(pt["layers"], key,
                        [f"{base}pre_transformer.layers.{i}.{name}" for i in range(num_layers)], tr)


def _import_codec(imp: _Importer, c: Dict, cfg: Qwen3TTSConfig):
    """Code2Wav decoder tensors (the public Qwen3OmniMoeCode2Wav layout);
    the root is detected, so `speech_tokenizer.model.decoder.`,
    `code2wav.` and none all load."""
    d = _find_prefix(imp.raw, "code_embedding.weight", hint="2wav")
    if d is None:
        d = _find_prefix(imp.raw, "code_embedding.weight", hint="tokenizer") or "code2wav."
    imp.put(c, "code_embed", f"{d}code_embedding.weight")
    _put_transformer(imp, c["pre_transformer"], d, cfg.codec.num_hidden_layers)
    for j, stage in enumerate(c["upsample"]):
        imp.put(stage, "up_w", f"{d}upsample.{j}.0.conv.weight", "tconv")
        imp.put(stage, "up_b", f"{d}upsample.{j}.0.conv.bias")
        _put_convnext(imp, stage["convnext"], f"{d}upsample.{j}.1.")
    imp.put(c, "dec_in_w", f"{d}decoder.0.conv.weight", "conv")
    imp.put(c, "dec_in_b", f"{d}decoder.0.conv.bias")
    for i, blk in enumerate(c["blocks"]):
        base = f"{d}decoder.{i + 1}.block."
        imp.put(blk, "a", f"{base}0.alpha")
        imp.put(blk, "b", f"{base}0.beta")
        imp.put(blk, "up_w", f"{base}1.conv.weight", "tconv")
        imp.put(blk, "up_b", f"{base}1.conv.bias")
        for u, unit in enumerate(blk["units"]):
            _put_res_unit(imp, unit, f"{base}{u + 2}.")
    nb = len(cfg.codec.upsample_rates)
    imp.put(c, "out_a", f"{d}decoder.{nb + 1}.alpha")
    imp.put(c, "out_b", f"{d}decoder.{nb + 1}.beta")
    imp.put(c, "dec_out_w", f"{d}decoder.{nb + 2}.conv.weight", "conv")
    imp.put(c, "dec_out_b", f"{d}decoder.{nb + 2}.conv.bias")


def _put_tdnn(imp: _Importer, dst: Dict, base: str):
    """One TimeDelayNetBlock: Conv1d weight and bias."""
    imp.put(dst, "w", f"{base}.conv.weight", "conv")
    imp.put(dst, "b", f"{base}.conv.bias")


def _import_speaker_encoder(imp: _Importer, s: Dict, cfg: Qwen3TTSConfig):
    """ECAPA speaker encoder, under the tensor names of the public Qwen
    module (transformers qwen2_5_omni ECAPA_TimeDelayNet): blocks.0 stem,
    SE-Res2Net blocks, mfa, asp.tdnn + asp.conv attention, fc."""
    sc = cfg.speaker_encoder
    root = _find_prefix(imp.raw, "asp.tdnn.conv.weight", hint="spk") or "speaker_encoder."
    _put_tdnn(imp, s["in"], f"{root}blocks.0")
    for i in range(sc.num_blocks):
        blk = s[f"block{i}"]
        base = f"{root}blocks.{i + 1}"
        _put_tdnn(imp, blk["tdnn1"], f"{base}.tdnn1")
        for j in range(sc.res2net_scale - 1):
            _put_tdnn(imp, blk["res2"][j], f"{base}.res2net_block.blocks.{j}")
        _put_tdnn(imp, blk["tdnn2"], f"{base}.tdnn2")
        imp.put_pair(blk, "se1", (f"{base}.se_block.conv1.weight", f"{base}.se_block.conv1.bias"))
        imp.put_pair(blk, "se2", (f"{base}.se_block.conv2.weight", f"{base}.se_block.conv2.bias"))
    _put_tdnn(imp, s["mfa"], f"{root}mfa")
    _put_tdnn(imp, s["att_tdnn"], f"{root}asp.tdnn")
    imp.put_pair(s, "att_proj", (f"{root}asp.conv.weight", f"{root}asp.conv.bias"))
    imp.put_pair(s, "out", (f"{root}fc.weight", f"{root}fc.bias"))


def _import_codec_encoder(imp: _Importer, e: Dict, cfg: Qwen3TTSConfig):
    """Codec (speech-tokenizer) encoder, the declared mirror of the decoder:
    the encoder.N conv / block stack, the downsample ConvNeXt stages, the
    pre-quantizer transformer."""
    ccfg = cfg.codec
    root = _find_prefix(imp.raw, "encoder.0.conv.weight", hint="encoder") or "speech_tokenizer.encoder."
    imp.put(e, "enc_in_w", f"{root}encoder.0.conv.weight", "conv")
    imp.put(e, "enc_in_b", f"{root}encoder.0.conv.bias")
    nb = len(ccfg.upsample_rates)
    for i in range(nb):
        blk = e["blocks"][i]
        base = f"{root}encoder.{i + 1}.block."
        for u in range(len(blk["units"])):
            _put_res_unit(imp, blk["units"][u], f"{base}{u}.")
        nu = len(blk["units"])
        imp.put(blk, "a", f"{base}{nu}.alpha")
        imp.put(blk, "b", f"{base}{nu}.beta")
        imp.put(blk, "down_w", f"{base}{nu + 1}.conv.weight", "conv")
        imp.put(blk, "down_b", f"{base}{nu + 1}.conv.bias")
    imp.put(e, "enc_mid_w", f"{root}encoder.{nb + 1}.conv.weight", "conv")
    imp.put(e, "enc_mid_b", f"{root}encoder.{nb + 1}.conv.bias")
    for j in range(len(ccfg.upsampling_ratios)):
        stage = e["downsample"][j]
        _put_convnext(imp, stage["convnext"], f"{root}downsample.{j}.0.")
        imp.put(stage, "down_w", f"{root}downsample.{j}.1.conv.weight", "conv")
        imp.put(stage, "down_b", f"{root}downsample.{j}.1.conv.bias")
    _put_transformer(imp, e["pre_transformer"], root, ccfg.num_hidden_layers)


_IMPORTERS = {"talker": _import_talker, "predictor": _import_predictor, "codec": _import_codec,
              "speaker_encoder": _import_speaker_encoder, "codec_encoder": _import_codec_encoder}


def load_hf_checkpoint(path, cfg: Qwen3TTSConfig, dtype=torch.bfloat16, strict: bool = False,
                       coverage: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Import an upstream HF Qwen3-TTS checkpoint directory -> host tree in
    the JAX layouts (float32; `materialize` makes the port's tree of it).

    Every submodel the engine runs is mapped: talker, code predictor,
    Code2Wav codec, speaker encoder and codec encoder. strict=False: missing
    tensors take a random init (host RNG, seed 0, at each leaf's init scale,
    as the JAX package's `_finalize` draws them), with a warning. strict=True:
    StrictLoadError listing every missing or mismatched tensor, a sample of
    the unconsumed keys and the per-submodel coverage (also on the error's
    `.coverage`). `dtype` is the talker and predictor dtype the JAX package
    loads them in; a regenerated leaf's init scale is read back in it, as
    there. The two encoders are optional: a checkpoint with no tensor of
    one passes strict (x-vector serving never runs them). `coverage`, a
    dict, receives the coverage strings ("matched/expected" per submodel)."""
    raw = _RawStore(path)
    optional = ("speaker_encoder", "codec_encoder")

    # a skeleton of the tree: every random leaf holds the init sentinel,
    # imported tensors replace leaves, and what is still a skeleton leaf
    # afterwards is drawn at its init scale (_finalize). The skeleton's
    # leaves stay referenced until then, so that no id is reused.
    params = _skeleton(cfg)
    skeleton_leaves = _leaves(params)
    skeleton_ids = {id(leaf) for leaf in skeleton_leaves}

    if not raw:
        if strict:
            raise StrictLoadError(f"no safetensors found under {path}")
        logger.warning("no safetensors found under %s; using random init", path)
        return _finalize(params, skeleton_ids, dtype)

    imp = _Importer(raw)
    cov: Dict[str, str] = {} if coverage is None else coverage
    for name in _SUBMODELS:
        before_missing, before_used = len(imp.missing), len(imp.used)
        _IMPORTERS[name](imp, params[name], cfg)
        absent = False
        if name in optional and len(imp.missing) > before_missing:
            # an optional submodel with no tensor at all: tolerated, strict too
            if len(imp.missing) - before_missing >= _leaf_count(name, cfg):
                del imp.missing[before_missing:]
                absent = True
                logger.info("checkpoint has no %s tensors; keeping random init", name)
        matched = len(imp.used) - before_used
        missed = len(imp.missing) - before_missing
        cov[name] = (f"absent ({matched}/{matched + _leaf_count(name, cfg)})" if absent
                     else f"{matched}/{matched + missed}")

    cov_line = "Per-submodel coverage: " + ", ".join(f"{k} {v}" for k, v in cov.items())
    logger.info("%s", cov_line)
    if imp.missing or imp.mismatched:
        unconsumed = sorted(set(raw.keys()) - imp.used)
        msg = (
            f"checkpoint import incomplete: {len(imp.missing)} missing, "
            f"{len(imp.mismatched)} mismatched.\n{cov_line}"
            + "\nMissing (first 20): " + "\n  ".join(imp.missing[:20])
            + "\nMismatched: " + "\n  ".join(imp.mismatched[:20])
            + f"\nUnconsumed checkpoint keys ({len(unconsumed)}, first 20): "
            + "\n  ".join(unconsumed[:20])
        )
        if strict:
            err = StrictLoadError(msg)
            err.coverage = dict(cov)
            raise err
        logger.warning("%s", msg)
    out = _finalize(params, skeleton_ids, dtype)
    del skeleton_leaves  # identity checks are done
    return out


# -- the loader's skeleton: lazy constant leaves that encode their init scale -----------------------

# Small enough that (sentinel * any init scale) cannot be a real value, large
# enough to stay a normal number in bfloat16.
_INIT_SENTINEL = 1e-30


class _SentinelArray:
    """Lazy constant array of the skeleton: every random leaf of the inits
    is `standard_normal(shape) * scale` (or `/ x`), so supporting `*`, `/`
    and `__array__` (a broadcast view) covers them all at O(1) cost."""

    def __init__(self, shape, value):
        self.shape = tuple(shape)
        self.value = float(value)

    def __mul__(self, scale):
        return _SentinelArray(self.shape, self.value * float(scale))

    __rmul__ = __mul__

    def __truediv__(self, x):
        return _SentinelArray(self.shape, self.value / float(x))

    def __array__(self, dtype=None, copy=None):
        return np.broadcast_to(np.asarray(self.value, dtype or np.float32), self.shape)


class _SentinelRng:
    """Stub RNG of the skeleton: standard_normal -> a lazy `_INIT_SENTINEL`."""

    def standard_normal(self, shape, dtype=None):
        return _SentinelArray(shape, _INIT_SENTINEL)


def _stack_host(xs):
    """np.stack that keeps equal constant broadcast views a broadcast view
    (the skeleton's stacked codec layers cost nothing)."""
    x0 = np.asarray(xs[0])
    views = [np.asarray(x) for x in xs]
    if x0.size and not any(x0.strides) and all(
            v.shape == x0.shape and v.dtype == x0.dtype and not any(v.strides) and v.flat[0] == x0.flat[0]
            for v in views[1:]):
        return np.broadcast_to(x0.flat[0], (len(xs),) + x0.shape)
    return np.stack(views)


def _tree_map(fn, node):
    """Apply fn to every leaf, in the JAX package's leaf order (dict keys
    sorted, lists and tuples in order)."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, node[k]) for k in sorted(node)}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    if isinstance(node, tuple):
        return tuple(_tree_map(fn, v) for v in node)
    return fn(node)


def _leaves(node) -> list:
    out: list = []
    _tree_map(out.append, node)
    return out


def _skeleton(cfg: Qwen3TTSConfig) -> Dict[str, Any]:
    """The tree of the five submodels with every random leaf a sentinel
    (value = sentinel x its init scale) and every constant leaf exact;
    milliseconds at any geometry. Seeds as in the JAX package's."""
    rng = _SentinelRng()
    makers = {
        "talker": lambda: _init_talker(0, cfg.talker, rng=rng),
        "predictor": lambda: _init_predictor(1000, cfg.predictor, cfg.talker.hidden_size, rng=rng),
        "codec": lambda: _init_codec(2000, cfg.codec, rng=rng),
        "speaker_encoder": lambda: init_speaker_encoder(7, cfg.speaker_encoder, rng=rng),
        "codec_encoder": lambda: init_codec_encoder(8, cfg.codec, rng=rng),
    }
    return {name: _tree_map(np.asarray, make()) for name, make in makers.items()}


def _finalize(params: Dict[str, Any], skeleton_ids: set, dtype, seed: int = 0) -> Dict[str, Any]:
    """Draw every leaf that still holds the init sentinel: host RNG `seed`,
    one standard normal array per leaf in the JAX leaf order, times the
    leaf's init scale. The scale is read back from the sentinel as the JAX
    package reads it: rounded to `dtype` in the talker and predictor."""
    host = np.random.default_rng(seed)

    def regen(sub):
        def fn(leaf):
            if id(leaf) not in skeleton_ids:
                return leaf  # imported: never read back
            a = np.asarray(leaf)
            scale = _sentinel_scale(a, sub, dtype)
            if scale == 0.0:
                return leaf  # a constant leaf (ones, zeros, fills)
            return host.standard_normal(a.shape, dtype=np.float32) * scale
        return fn

    return {sub: _tree_map(regen(sub), params[sub]) for sub in sorted(params)}


def _leaf_count(submodel: str, cfg: Qwen3TTSConfig) -> int:
    """Leaves an encoder submodel maps (the all-absent test of an optional
    submodel)."""
    if submodel == "speaker_encoder":
        sc = cfg.speaker_encoder
        per_block = 2 + (sc.res2net_scale - 1) * 2 + 2 + 4  # tdnn1, res2, tdnn2, se
        return 2 + sc.num_blocks * per_block + 2 + 2 + 2 + 2  # stem, mfa, asp.tdnn, asp.conv, fc
    if submodel == "codec_encoder":
        ccfg = cfg.codec
        nb = len(ccfg.upsample_rates)
        per_block = 3 * 8 + 2 + 2  # units, snake, down conv
        per_stage = 9 + 2  # convnext, down conv
        transformer = 11 * ccfg.num_hidden_layers + 1
        return 2 + nb * per_block + 2 + len(ccfg.upsampling_ratios) * per_stage + transformer
    raise ValueError(f"no leaf count for {submodel!r}")


def export_hf_layout(params: Dict[str, Any], cfg: Qwen3TTSConfig, path) -> None:
    """Write a host tree in the JAX layouts as an upstream HF checkpoint
    (`model.safetensors`, float32): the inverse of `load_hf_checkpoint`,
    the file the JAX package's `export_hf_layout` writes."""
    out: Dict[str, np.ndarray] = {}

    def rev(a, transform=None):
        a = np.asarray(a, np.float32)
        if transform == "lin":
            a = a.T
        elif transform == "conv":
            a = np.transpose(a, (2, 1, 0))
        elif transform == "tconv":
            a = np.transpose(a[::-1], (1, 2, 0))
        return np.ascontiguousarray(a)  # a view's stale strides must not reach the file

    def layers(dst_base, src, layer_map, n):
        for name, key in layer_map.items():
            tr = "lin" if key in _LINEAR_KEYS else None
            for i in range(n):
                out[f"{dst_base}{i}.{name}"] = rev(src[key][i], tr)

    def convnext(cn, base):
        out[f"{base}dwconv.conv.weight"] = rev(cn["dw_w"], "conv")
        out[f"{base}dwconv.conv.bias"] = rev(cn["dw_b"])
        out[f"{base}norm.weight"] = rev(cn["ln_w"])
        out[f"{base}norm.bias"] = rev(cn["ln_b"])
        out[f"{base}pwconv1.weight"] = rev(cn["pw1_w"], "lin")
        out[f"{base}pwconv1.bias"] = rev(cn["pw1_b"])
        out[f"{base}pwconv2.weight"] = rev(cn["pw2_w"], "lin")
        out[f"{base}pwconv2.bias"] = rev(cn["pw2_b"])
        out[f"{base}gamma"] = rev(cn["gamma"])

    def res_unit(unit, base):
        for k in ("1", "2"):
            out[f"{base}act{k}.alpha"] = rev(unit[f"a{k}"])
            out[f"{base}act{k}.beta"] = rev(unit[f"b{k}"])
            out[f"{base}conv{k}.conv.weight"] = rev(unit[f"c{k}_w"], "conv")
            out[f"{base}conv{k}.conv.bias"] = rev(unit[f"c{k}_b"])

    t = params["talker"]
    out["talker.codec_head.weight"] = rev(t["codec_head"], "lin")
    out["talker.text_projection.weight"] = rev(t["text_proj"]["w"], "lin")
    out["talker.text_projection.bias"] = rev(t["text_proj"]["b"])
    out["talker.model.text_embedding.weight"] = rev(t["text_embed"])
    out["talker.model.codec_embedding.weight"] = rev(t["codec_embed"])
    out["talker.model.spk_projection.weight"] = rev(t["spk_proj"]["w"], "lin")
    out["talker.model.spk_projection.bias"] = rev(t["spk_proj"]["b"])
    out["talker.model.norm.weight"] = rev(t["final_norm"])
    layers("talker.model.layers.", t["layers"], _TALKER_LAYER_MAP, cfg.talker.num_hidden_layers)

    p = params["predictor"]
    cp = "talker.code_predictor."
    out[f"{cp}small_to_mtp_projection.weight"] = rev(p["mtp_proj"]["w"], "lin")
    out[f"{cp}small_to_mtp_projection.bias"] = rev(p["mtp_proj"]["b"])
    out[f"{cp}model.norm.weight"] = rev(p["final_norm"])
    layers(f"{cp}model.layers.", p["layers"], _TALKER_LAYER_MAP, cfg.predictor.num_hidden_layers)
    for i in range(cfg.predictor.num_codebooks):
        out[f"{cp}lm_head.{i}.weight"] = rev(p["lm_heads"][i], "lin")
        out[f"{cp}model.codec_embedding.{i}.weight"] = rev(p["codec_embeds"][i])

    c = params["codec"]
    d = "speech_tokenizer.model.decoder."
    out[f"{d}code_embedding.weight"] = rev(c["code_embed"])
    out[f"{d}pre_transformer.norm.weight"] = rev(c["pre_transformer"]["final_norm"])
    layers(f"{d}pre_transformer.layers.", c["pre_transformer"]["layers"], _CODEC_LAYER_MAP,
           cfg.codec.num_hidden_layers)
    for j, stage in enumerate(c["upsample"]):
        out[f"{d}upsample.{j}.0.conv.weight"] = rev(stage["up_w"], "tconv")
        out[f"{d}upsample.{j}.0.conv.bias"] = rev(stage["up_b"])
        convnext(stage["convnext"], f"{d}upsample.{j}.1.")
    out[f"{d}decoder.0.conv.weight"] = rev(c["dec_in_w"], "conv")
    out[f"{d}decoder.0.conv.bias"] = rev(c["dec_in_b"])
    for i, blk in enumerate(c["blocks"]):
        base = f"{d}decoder.{i + 1}.block."
        out[f"{base}0.alpha"] = rev(blk["a"])
        out[f"{base}0.beta"] = rev(blk["b"])
        out[f"{base}1.conv.weight"] = rev(blk["up_w"], "tconv")
        out[f"{base}1.conv.bias"] = rev(blk["up_b"])
        for u, unit in enumerate(blk["units"]):
            res_unit(unit, f"{base}{u + 2}.")
    nb = len(cfg.codec.upsample_rates)
    out[f"{d}decoder.{nb + 1}.alpha"] = rev(c["out_a"])
    out[f"{d}decoder.{nb + 1}.beta"] = rev(c["out_b"])
    out[f"{d}decoder.{nb + 2}.conv.weight"] = rev(c["dec_out_w"], "conv")
    out[f"{d}decoder.{nb + 2}.conv.bias"] = rev(c["dec_out_b"])

    if "speaker_encoder" in params:
        s = params["speaker_encoder"]
        root = "speaker_encoder."

        def tdnn(td, base):
            out[f"{base}.conv.weight"] = rev(td["w"], "conv")
            out[f"{base}.conv.bias"] = rev(td["b"])

        def pair_as_conv1(pair, base):  # a linear [in, out] -> torch k=1 Conv1d [out, in, 1]
            w, b = pair
            out[f"{base}.weight"] = rev(w, "lin")[:, :, None]
            out[f"{base}.bias"] = rev(b)

        tdnn(s["in"], f"{root}blocks.0")
        for i in range(cfg.speaker_encoder.num_blocks):
            blk = s[f"block{i}"]
            base = f"{root}blocks.{i + 1}"
            tdnn(blk["tdnn1"], f"{base}.tdnn1")
            for j, td in enumerate(blk["res2"]):
                tdnn(td, f"{base}.res2net_block.blocks.{j}")
            tdnn(blk["tdnn2"], f"{base}.tdnn2")
            pair_as_conv1(blk["se1"], f"{base}.se_block.conv1")
            pair_as_conv1(blk["se2"], f"{base}.se_block.conv2")
        tdnn(s["mfa"], f"{root}mfa")
        tdnn(s["att_tdnn"], f"{root}asp.tdnn")
        pair_as_conv1(s["att_proj"], f"{root}asp.conv")
        pair_as_conv1(s["out"], f"{root}fc")

    if "codec_encoder" in params:
        e = params["codec_encoder"]
        root = "speech_tokenizer.encoder."
        out[f"{root}encoder.0.conv.weight"] = rev(e["enc_in_w"], "conv")
        out[f"{root}encoder.0.conv.bias"] = rev(e["enc_in_b"])
        for i in range(nb):
            blk = e["blocks"][i]
            base = f"{root}encoder.{i + 1}.block."
            for u, unit in enumerate(blk["units"]):
                res_unit(unit, f"{base}{u}.")
            nu = len(blk["units"])
            out[f"{base}{nu}.alpha"] = rev(blk["a"])
            out[f"{base}{nu}.beta"] = rev(blk["b"])
            out[f"{base}{nu + 1}.conv.weight"] = rev(blk["down_w"], "conv")
            out[f"{base}{nu + 1}.conv.bias"] = rev(blk["down_b"])
        out[f"{root}encoder.{nb + 1}.conv.weight"] = rev(e["enc_mid_w"], "conv")
        out[f"{root}encoder.{nb + 1}.conv.bias"] = rev(e["enc_mid_b"])
        for j, stage in enumerate(e["downsample"]):
            convnext(stage["convnext"], f"{root}downsample.{j}.0.")
            out[f"{root}downsample.{j}.1.conv.weight"] = rev(stage["down_w"], "conv")
            out[f"{root}downsample.{j}.1.conv.bias"] = rev(stage["down_b"])
        pt = e["pre_transformer"]
        out[f"{root}pre_transformer.norm.weight"] = rev(pt["final_norm"])
        layers(f"{root}pre_transformer.layers.", pt["layers"], _CODEC_LAYER_MAP, cfg.codec.num_hidden_layers)

    os.makedirs(path, exist_ok=True)
    st.save_file(out, os.path.join(path, "model.safetensors"))


# -- random init on the device ------------------------------------------------------------------------


def _sentinel_scale(leaf: np.ndarray, sub: str, dtype) -> float:
    """The init scale a skeleton leaf encodes, read back as the JAX package
    reads it (the talker and predictor skeletons are built in `dtype`, so
    their sentinels are rounded to it); 0.0 for a constant leaf (ones,
    zeros, fills), which never holds 0 < |x| < 1e-20."""
    v = float(abs(np.float32(leaf.flat[0]))) if leaf.size else 0.0
    if sub in ("talker", "predictor") and dtype != torch.float32:
        v = abs(torch.tensor(v, dtype=torch.float32).to(dtype).float().item())
    return v / _INIT_SENTINEL if 0.0 < v < 1e-20 else 0.0


def init_all_device(cfg: Qwen3TTSConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Random init of talker, predictor and codec drawn on `device` (the
    card unless the caller asks for "cpu"; the JAX package's
    `init_all_device`): the host builds the sentinel skeleton only
    (milliseconds), and every random leaf is drawn by a `torch.Generator`
    of `device` seeded with `seed`, at the init scale its sentinel encodes,
    one leaf at a time (its float32 draw is rounded to `dtype` and dropped
    before the next). Constant leaves are exact. The tree, its shapes and
    dtypes and the port's layouts are those of `init_all(cfg, seed, dtype)`;
    the random values are not (another generator), as in the JAX package."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    rng = _SentinelRng()
    skeleton = {
        "talker": _init_talker(seed, cfg.talker, rng=rng),
        "predictor": _init_predictor(seed + 1000, cfg.predictor, cfg.talker.hidden_size, rng=rng),
        "codec": _init_codec(seed + 2000, cfg.codec, rng=rng),
    }
    gen = torch.Generator(device).manual_seed(seed)

    def draw(sub):
        leaf_dtype = dtype if sub in ("talker", "predictor") else torch.float32

        def fn(leaf):
            a = np.asarray(leaf)
            scale = _sentinel_scale(a, sub, dtype)
            if scale == 0.0:
                return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(leaf_dtype)
            x = torch.randn(a.shape, generator=gen, dtype=torch.float32, device=device)
            return x.mul_(scale).to(leaf_dtype)
        return fn

    params = _port_layouts({sub: _tree_map(draw(sub), skeleton[sub]) for sub in sorted(skeleton)})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params


# -- deploy bundles: the packed form of a tree ---------------------------------------------------------
#
# The JAX package's format byte for byte, so that a bundle written by
# either package loads in the other: `bundle.bin` holds one section per
# dtype (sorted by name, each 128-byte aligned), every leaf's bytes back to
# back in its section; `bundle.json` holds the version, the quant mode, the
# sections ({dtype: [byte offset, elements]}), the manifest entries ([key,
# dtype, shape, element offset], plus the dtype to upcast to in a compact
# bundle) and the config. Keys are '/'-joined tree paths in the JAX
# layouts; quantized nodes carry `@ql8` / `@ql4` in their path. A restart
# from a bundle is one file read into pinned memory, one copy to the card
# per section and one device-to-device copy per leaf: no name mapping, no
# host quantization.

_QL8_MARK = "@ql8"
_QL4_MARK = "@ql4"
_BUNDLE_VERSION = 2
_BUNDLE_ALIGN = 128

# the format's dtype names (numpy's) -> torch, for the dtypes a tree of either
# package holds; the card has no ml_dtypes, so bfloat16 goes through torch
_BUNDLE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8,
                  "uint8": torch.uint8}
_DTYPE_NAMES = {v: k for k, v in _BUNDLE_DTYPES.items()}


def _flatten_typed(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tree -> {'/'-joined path: contiguous CPU tensor}, dict keys sorted,
    quantized nodes (of either package) marked in the path. Leaves may be
    numpy (ml_dtypes bfloat16 too) or tensors on any device."""
    fields = getattr(tree, "_fields", None)
    if fields == ("q", "scale"):
        base = prefix[:-1] + _QL8_MARK
        return {**_flatten_typed(tree.q, f"{base}/q/"), **_flatten_typed(tree.scale, f"{base}/scale/")}
    if fields == ("packed", "scale", "wmin"):
        base = prefix[:-1] + _QL4_MARK
        return {**_flatten_typed(tree.packed, f"{base}/packed/"), **_flatten_typed(tree.scale, f"{base}/scale/"),
                **_flatten_typed(tree.wmin, f"{base}/wmin/")}
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_typed(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_typed(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: _to_tensor(tree).detach().to("cpu").contiguous()}


def _rebuild_typed(flat: Dict[str, Any]) -> Any:
    """Inverse of `_flatten_typed` (lists where the source had tuples, as in
    the JAX package)."""
    root: Dict[str, Any] = {}
    for name, leaf in flat.items():
        _set_deep(root, name.split("/"), leaf)

    def convert(node):
        if isinstance(node, list):
            return [convert(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            v = convert(v)
            if k.endswith(_QL8_MARK):
                out[k[: -len(_QL8_MARK)]] = quant_lib.QuantizedLinear(q=v["q"], scale=v["scale"])
            elif k.endswith(_QL4_MARK):
                out[k[: -len(_QL4_MARK)]] = quant_lib.QuantizedLinear4(packed=v["packed"], scale=v["scale"],
                                                                       wmin=v["wmin"])
            else:
                out[k] = v
        return out

    return convert(root)


def _pack_blobs(flat: Dict[str, torch.Tensor]):
    """-> (blobs {dtype name: 1-D CPU tensor}, manifest of (key, dtype name,
    shape, element offset)): one blob per dtype, in the order the dtypes
    first appear, each leaf's elements back to back."""
    order: Dict[str, list] = {}
    for key, t in flat.items():
        order.setdefault(_DTYPE_NAMES[t.dtype], []).append(key)
    entries, blobs = [], {}
    for dt, keys in order.items():
        offset = 0
        for key in keys:
            t = flat[key]
            entries.append((key, dt, tuple(int(s) for s in t.shape), offset))
            offset += t.numel()
        blobs[dt] = torch.cat([flat[k].reshape(-1) for k in keys])
    return blobs, tuple(entries)


def _norm_manifest(manifest):
    """Entries -> (key, store dtype, shape, offset, out dtype); a 4-field
    entry (the uncompacted form) is stored as it comes out."""
    return tuple((e[0], e[1], tuple(e[2]), e[3], e[4] if len(e) > 4 else e[1]) for e in manifest)


def _device_unpack(blobs: Dict[str, torch.Tensor], manifest, device="cuda") -> Dict[str, Any]:
    """The device half of a bundle load: per dtype section one host-to-device
    copy (asynchronous from pinned memory), then each leaf copied out of its
    section into an allocation of its own (reshaped; upcast where the
    manifest's out dtype differs, in a compact bundle), then the section is
    dropped; so every leaf is aligned for K2 / K4 and keeps no section alive.
    The port's layouts are made on the device. Synchronizes before it
    returns, so that a caller's timing holds the copies. -> the port's tree."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    manifest = _norm_manifest(manifest)
    flat: Dict[str, torch.Tensor] = {}
    for dt in sorted(blobs):
        section = blobs[dt].to(device, non_blocking=True)
        for key, store_dt, shape, off, out_dt in manifest:
            if store_dt != dt:
                continue
            n = math.prod(shape)
            seg = section[off:off + n].view(shape)
            flat[key] = seg.clone() if out_dt == dt else seg.to(_BUNDLE_DTYPES[out_dt])
        del section
    params = _port_layouts(_rebuild_typed({e[0]: flat.pop(e[0]) for e in manifest}))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params


def pack_transfer(params: Any, sharding=None, device="cuda") -> Dict[str, Any]:
    """A host tree in the JAX layouts -> the port's tree on `device` (the
    card unless the caller asks for "cpu") through the bundle's packed form:
    one pinned host-to-device copy per dtype and one copy a leaf, bit for
    bit `params_from_numpy(params, device)`. `sharding` takes None only: the
    port runs on one card."""
    if sharding is not None:
        raise ValueError("pack_transfer: sharding takes None only (the port runs on one card)")
    device = torch.device(device)
    blobs, manifest = _pack_blobs(_flatten_typed(params))
    if device.type == "cuda":
        blobs = {dt: b.pin_memory() for dt, b in blobs.items()}
    return _device_unpack(blobs, manifest, device)


def is_deploy_bundle(path) -> bool:
    return os.path.exists(os.path.join(path, "bundle.bin")) and os.path.exists(os.path.join(path, "bundle.json"))


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor's bytes as a uint8 numpy view (bfloat16
    through an int16 view)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def save_deploy_bundle(path, params: Any, cfg: Qwen3TTSConfig, quant_mode: str = "none",
                       compact_f32: bool = False) -> None:
    """Write a host tree in the JAX layouts (`host_tree` of a model's
    parameters, or a host tree of either package, quantized or not) as a
    deploy bundle, the JAX package's files byte for byte. compact_f32 stores
    the float32 leaves as bfloat16 (rounded to nearest even) and upcasts
    them at the unpack: exact for leaves that came from bfloat16, as a real
    checkpoint's do; a random float32 leaf, and the float32 scales and mins
    of quantized weights, lose their low mantissa bits."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten_typed(params)
    out_dt = {}
    if compact_f32:
        for k, t in flat.items():
            if t.dtype == torch.float32:
                flat[k] = t.to(torch.bfloat16)
                out_dt[k] = "float32"
    blobs, manifest = _pack_blobs(flat)
    del flat
    if out_dt:
        manifest = tuple((k, dt, sh, off, out_dt.get(k, dt)) for (k, dt, sh, off) in manifest)
    sections = {}
    offset = 0
    with open(os.path.join(path, "bundle.bin"), "wb") as f:
        for dt in sorted(blobs):
            pad = (-offset) % _BUNDLE_ALIGN
            f.write(b"\0" * pad)
            offset += pad
            raw = _raw_bytes(blobs[dt])
            sections[dt] = [offset, int(blobs[dt].numel())]
            f.write(raw.data)
            offset += raw.size
    with open(os.path.join(path, "bundle.json"), "w") as f:
        json.dump({
            "version": _BUNDLE_VERSION,
            "quant": quant_mode,
            "sections": sections,
            "entries": [list(e) for e in manifest],
            "config": _config_to_dict(cfg),
        }, f)


def _read_into(path: str, out: np.ndarray) -> None:
    """Fill `out` (uint8) with the file's bytes, read straight into it."""
    view = memoryview(out)
    with open(path, "rb", buffering=0) as f:
        pos = 0
        while pos < out.size:
            n = f.readinto(view[pos:])
            if not n:
                raise ValueError(f"{path}: {out.size} bytes expected, the file ended after {pos}")
            pos += n


def read_deploy_bundle(path, pin_memory: bool = False, mark: Optional[Callable[[str], None]] = None):
    """The host half of a bundle load -> (blobs {dtype name: 1-D CPU
    tensor}, manifest, cfg, quant mode). The file is read straight into one
    buffer, pinned when `pin_memory` (for a copy to the card; a failed
    pinning raises), and each section is a typed view of it. `mark("pin")`
    is called after the allocation, so that a caller can time it apart from
    the read."""
    with open(os.path.join(path, "bundle.json")) as f:
        meta = json.load(f)
    if meta.get("version") != _BUNDLE_VERSION:
        raise ValueError(f"unsupported bundle version {meta.get('version')}")
    cfg = config_from_dict(meta["config"])
    manifest = _norm_manifest(meta["entries"])
    fname = os.path.join(path, "bundle.bin")
    buf = torch.empty(os.path.getsize(fname), dtype=torch.uint8, pin_memory=pin_memory)
    if mark is not None:
        mark("pin")
    _read_into(fname, buf.numpy())
    blobs = {}
    for dt, (byte_off, n) in meta["sections"].items():
        dtype = _BUNDLE_DTYPES[dt]
        blobs[dt] = buf[byte_off:byte_off + n * dtype.itemsize].view(dtype)
    return blobs, manifest, cfg, meta.get("quant", "none")


def load_deploy_bundle(path, device="cuda"):
    """-> (the port's tree on `device`, cfg, quant mode): one file read into
    pinned memory, one copy to the card per dtype section, one copy a leaf.
    With device "cuda" and no card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
    blobs, manifest, cfg, mode = read_deploy_bundle(path, pin_memory=device.type == "cuda")
    return _device_unpack(blobs, manifest, device), cfg, mode
