"""Weight-only int8 quantization and the projection product, with K2.

Counterpart of faster_qwen3_tts_tpu/ops/quant.py for the Q8_0 mode: the same
per-output-channel absmax scheme, computed by the same host numpy code, so
both packages hold bit-identical int8 weights. `dot` routes by shape: a
product with at most `GEMV_MAX_ROWS` rows (every decode projection) goes to
the int8 GEMV kernel K2; a larger one (the talker prefill, prompt text
projection) is a matrix product that the JAX package leaves to XLA and this
port leaves to `torch.matmul`.

Int4 (Q4_K_M / Q8_4) and the fused wqkv / w_gateup layout are not ported yet:
`QuantizedLinear4` exists only so that parameter trees convert.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels

GEMV_MAX_ROWS = 16  # the JAX kernel's eligibility bound (matvec_pallas.eligible)


class QuantizedLinear(NamedTuple):
    """Weight-only int8 linear: y = (x @ q) * scale.

    q: int8 [..., in, out]; scale: f32 [..., 1, out] (absmax / 127)."""

    q: torch.Tensor
    scale: torch.Tensor


class QuantizedLinear4(NamedTuple):
    """Group-wise int4 container (layout of the JAX package); no product yet."""

    packed: torch.Tensor
    scale: torch.Tensor
    wmin: torch.Tensor


def quantize_linear(w) -> QuantizedLinear:
    """Host numpy quantization, the JAX package's code line for line.
    Returns numpy leaves (`weights.params_from_numpy` moves them)."""
    wf = np.asarray(w, np.float32)
    scale = np.max(np.abs(wf), axis=-2, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(wf / scale), -127, 127).astype(np.int8)
    return QuantizedLinear(q=q, scale=scale.astype(np.float32))


_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_model_params(params: dict, mode: str = "int8") -> dict:
    """Quantize the talker and predictor projections of a host numpy tree
    (int8 only). Embeddings, norms, the speaker projection and the codec keep
    their dtype, as in the JAX package."""
    if mode != "int8":
        raise NotImplementedError(f"quant mode {mode!r} is not ported yet (int8 only)")

    def quant_layers(layers: dict) -> dict:
        new = dict(layers)
        for k in _LAYER_WEIGHTS:
            new[k] = quantize_linear(layers[k])
        return new

    out = dict(params)
    t = dict(params["talker"])
    t["layers"] = quant_layers(t["layers"])
    t["codec_head"] = quantize_linear(t["codec_head"])
    t["text_proj"] = {"w": quantize_linear(t["text_proj"]["w"]), "b": t["text_proj"]["b"]}
    out["talker"] = t
    p = dict(params["predictor"])
    p["layers"] = quant_layers(p["layers"])
    p["lm_heads"] = quantize_linear(p["lm_heads"])
    p["mtp_proj"] = {"w": quantize_linear(p["mtp_proj"]["w"]), "b": p["mtp_proj"]["b"]}
    out["predictor"] = p
    return out


def resolve_quant_name(quant: str) -> str:
    """Map the public quant names onto modes ("none" or "int8" here)."""
    key = (quant or "BF16").lower()
    if key in ("bf16", "f32", "fp32", "none", "float32", "bfloat16"):
        return "none"
    if key in ("q8_0", "int8", "q8"):
        return "int8"
    if key in ("q4_k_m", "q4_k", "int4", "q4", "q4_0", "q8_4", "mixed"):
        raise NotImplementedError(f"quant {quant!r} is not ported yet; use BF16 or Q8_0")
    raise ValueError(f"Unsupported quant {quant!r}. Expected BF16/F32 or Q8_0/int8.")


def int8_gemv_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (x @ q) * scale with f32 accumulation,
    rounded once to x.dtype (the JAX int8 branch of `quant.dot`)."""
    y = torch.matmul(x.float(), q.float())
    return (y * scale.float().reshape(scale.shape[-1])).to(x.dtype)


_TARGET_BLOCKS = 264  # two blocks per SM of an H100


def int8_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ q) * scale for x [..., I] (at most 16 rows), q int8 [I, O],
    scale f32 [1, O]. A CUDA tensor launches K2 (csrc/int8_gemv.cu) and
    counts it in `int8_gemv.launches`; a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return int8_gemv_plain(x, q, scale)
    I, O = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, I).contiguous()
    M = x2.shape[0]
    if x.shape[-1] != I or M > GEMV_MAX_ROWS or scale.numel() != O:
        raise ValueError(f"int8_gemv shapes: x {tuple(x.shape)}, q {tuple(q.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_gemv takes int8 q and float32 scale")
    kernels.require_cuda(x2, q, scale)
    if O % 16 or q.data_ptr() % 16:
        raise ValueError("int8_gemv needs O % 16 == 0 and a 16-byte aligned q")
    lib = kernels.library()
    n_tiles = -(-O // lib.gemv_block_cols)
    n_groups = -(-M // lib.gemv_rows_per_block)
    ksplit = max(1, min(-(-I // 32), -(-_TARGET_BLOCKS // (n_tiles * n_groups))))
    rows_per_split = -(-I // (ksplit * 32)) * 32
    ksplit = -(-I // rows_per_split)
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    partial = torch.empty((ksplit * M * O,) if ksplit > 1 else (1,), dtype=torch.float32,
                          device=x.device)
    counters = lib.gemv_counters(x.device, n_tiles * n_groups)
    lib.call(
        "fq3t_int8_gemv",
        kernels.dtype_code(x), x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        partial.data_ptr(), counters.data_ptr(), M, I, O, rows_per_split, ksplit,
        kernels.stream_handle(x.device),
    )
    int8_gemv.launches += 1
    return y.reshape(*lead, O)


int8_gemv.launches = 0


def _int8_matmul(x: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """Many-row int8 product (prefill, prompt text): a plain matrix product
    with f32 accumulation, as the JAX package leaves it to XLA."""
    y = torch.matmul(x.float(), w.q.float())
    return (y * w.scale.reshape(w.scale.shape[-1])).to(x.dtype)


def dot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with f32 accumulation, result in x.dtype; w is a plain tensor
    [in, out] or a QuantizedLinear."""
    if isinstance(w, QuantizedLinear):
        if x.numel() // x.shape[-1] <= GEMV_MAX_ROWS:
            return int8_gemv(x, w.q, w.scale)
        return _int8_matmul(x, w)
    if isinstance(w, QuantizedLinear4):
        raise NotImplementedError("int4 weights are not ported yet")
    # cuBLAS and the CPU accumulate in f32 and round the output once
    return torch.matmul(x, w.to(x.dtype))
