"""The decoder layer's elementwise glue: plain PyTorch, and K5 / K6 / K7.

Between a decoder layer's products (K2 / K4 projections, K1 attention) sit
norms, RoPE, the KV-cache write, residual adds and SiLU * up. Written as
PyTorch operators they were ~59 launches a layer, ~6,700 a 0.6B frame, each
moving kilobytes: launch latency, not bytes, bounded the frame. The
kernels (csrc/glue.cu) do each group in one launch:

- K5 `add_rms_norm`: the residual add folded into the next RMSNorm (ln1,
  ln2, the final norm) and the per-head q / k norms of a prefill;
- K6 `qk_norm_rope_kv`: a decode step's per-head q / k RMSNorm, RoPE of
  both and the K / V cache write;
- K7 `silu_mul`: the MLP's SiLU(gate) * up.

None replaces a TPU kernel (XLA fuses this code on the TPU by itself). A CUDA
tensor launches the kernel and counts it in the wrapper's `launches`; a CPU
tensor takes the plain version, which is the composition the decoder ran
before (`rms_norm`, `apply_rope`, the `index_put_` cache write, `F.silu`),
bit for bit. `rms_norm` and `apply_rope` are also the codec's, which stays on
them: it runs in float32 under a tight audio limit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (w.float() * y).to(x.dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D] (broadcast over heads)."""
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    xf = x.float()
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def _head_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """x [..., H, W] -> (x, rows, H, stride between groups of H rows) where
    x's rows of W are heads laid side by side with a stride between groups
    (q / k cut from the fused projection's output), else (contiguous x,
    rows, 1, W): a copy only where another layout comes in (the many-row int4
    product's output)."""
    W = x.shape[-1]
    if not x.is_contiguous() and x.dim() >= 2 and x.stride(-1) == 1 and x.stride(-2) == W:
        try:
            v = x.view(-1, x.shape[-2], W)
            return x, v.shape[0] * v.shape[1], v.shape[1], v.stride(0)
        except RuntimeError:
            pass
    x = x.contiguous()
    return x, x.numel() // W, 1, W


def _rows(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """x [..., I] -> (x, rows, row stride) where x's rows are dense and
    evenly spaced (a column view of a wider product), else (contiguous x,
    rows, I)."""
    if x.dim() >= 2 and x.stride(-1) == 1:
        try:
            v = x.view(-1, x.shape[-1])
            return x, v.shape[0], v.stride(0)
        except RuntimeError:
            pass
    x = x.contiguous()
    return x, x.numel() // x.shape[-1], x.shape[-1]


def add_rms_norm_plain(x: torch.Tensor, residual: Optional[torch.Tensor], w: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: (s, rms_norm(w, s, eps)) with s = x + residual
    rounded to x's dtype (s = x without a residual)."""
    s = x if residual is None else x + residual
    return s, rms_norm(w, s, eps)


def add_rms_norm(x: torch.Tensor, residual: Optional[torch.Tensor], w: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + residual, RMSNorm of it) over the last dim, of width W <= 2048;
    without a residual (x, RMSNorm of x). x, residual: [..., W], w: [W],
    one dtype (float32 or bfloat16). The kernel reads x as it comes where its
    rows are heads of W side by side with a stride between groups (q [B, S,
    H, D] cut from the fused projection's output); other layouts are made
    contiguous first. Returns the sum (x itself without a residual) and the
    normed rows, contiguous. A CUDA tensor launches K5 (csrc/glue.cu) and
    counts it in `add_rms_norm.launches`; a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, residual, w, eps)
    W = x.shape[-1]
    kernels.require_device(x, w, *(() if residual is None else (residual,)))
    if tuple(w.shape) != (W,) or w.dtype != x.dtype:
        raise ValueError(f"add_rms_norm: weight {tuple(w.shape)} {w.dtype} for rows of {W} {x.dtype}")
    if residual is None:
        x, N, heads, ld = _head_rows(x)
        s = x
    else:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(f"add_rms_norm: residual {tuple(residual.shape)} {residual.dtype} for x "
                             f"{tuple(x.shape)} {x.dtype}")
        x, residual = x.contiguous(), residual.contiguous()
        N, heads, ld = x.numel() // W, 1, W
        s = torch.empty_like(x)
    w = w.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    kernels.library().call(
        "fq3t_add_rms_norm", kernels.dtype_code(x), x.data_ptr(), ld,
        None if residual is None else residual.data_ptr(), None if residual is None else s.data_ptr(),
        w.data_ptr(), out.data_ptr(), N, heads, W, float(eps), kernels.stream_handle(x.device),
    )
    add_rms_norm.launches += 1
    return s, out


add_rms_norm.launches = 0


def qk_norm_rope_kv_plain(q, k, v, q_w, k_w, cos, sin, k_cache, v_cache, write_pos, eps):
    """Plain version of K6: the per-head RMSNorm of q and k, RoPE of both,
    k and v written into the caches at [lane, write_pos] in place. Returns q."""
    q = apply_rope(rms_norm(q_w, q, eps), cos, sin)
    k = apply_rope(rms_norm(k_w, k, eps), cos, sin)
    rows = torch.arange(q.shape[0], device=q.device)
    k_cache[rows, write_pos] = k[:, 0]
    v_cache[rows, write_pos] = v[:, 0]
    return q


def _lane_rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A [B, 1, H, D] decode tensor -> (t, its row stride) where its heads
    are dense (the fused projection's column views too), else (contiguous t,
    H * D)."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        t = t.contiguous()
    return t, t.stride(0)


def qk_norm_rope_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_w: torch.Tensor, k_w: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    write_pos: torch.Tensor, eps: float) -> torch.Tensor:
    """One decode token a lane: q [B, 1, Hq, D], k / v [B, 1, Hkv, D] (read
    as they come where their heads are dense, as in the fused projection's
    column views; other layouts are made contiguous first), RMSNormed per
    head by q_w / k_w [D], RoPE by cos / sin [B, 1, D] (float32), k and v
    written into k_cache / v_cache [B, S, Hkv, D] at [b, write_pos[b]] in
    place. Returns q (contiguous). A CUDA tensor launches K6 (csrc/glue.cu)
    and counts it in `qk_norm_rope_kv.launches`; a CPU tensor takes the
    plain version."""
    if q.device.type == "cpu":
        return qk_norm_rope_kv_plain(q, k, v, q_w, k_w, cos, sin, k_cache, v_cache, write_pos, eps)
    B, one, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    if (one != 1 or tuple(k.shape) != (B, 1, Hkv, D) or v.shape != k.shape or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != B or tuple(cos.shape) != (B, 1, D) or sin.shape != cos.shape
            or tuple(q_w.shape) != (D,) or tuple(k_w.shape) != (D,) or tuple(write_pos.shape) != (B,)
            or D % 2 or D > 256):
        raise ValueError(f"qk_norm_rope_kv shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"cache {tuple(k_cache.shape)}, cos {tuple(cos.shape)}, write_pos {tuple(write_pos.shape)}")
    if any(t.dtype != q.dtype for t in (k, v, q_w, k_w, k_cache, v_cache)) or cos.dtype != torch.float32 \
            or sin.dtype != torch.float32:
        raise TypeError("qk_norm_rope_kv: q, k, v, the weights and the caches share a dtype; cos / sin are float32")
    pos = write_pos if write_pos.dtype == torch.int32 else write_pos.to(torch.int32)
    kernels.require_device(q, k, v, q_w, k_w, cos, sin, k_cache, v_cache, pos)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("qk_norm_rope_kv: the caches are written in place and must be contiguous")
    (q, ldq), (k, ldk), (v, ldv) = _lane_rows(q), _lane_rows(k), _lane_rows(v)
    q_w, k_w, cos, sin, pos = (t.contiguous() for t in (q_w, k_w, cos, sin, pos))
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    kernels.library().call(
        "fq3t_qk_norm_rope_kv", kernels.dtype_code(q), q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv,
        q_w.data_ptr(), k_w.data_ptr(), cos.data_ptr(), sin.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, S, float(eps), kernels.stream_handle(q.device),
    )
    qk_norm_rope_kv.launches += 1
    return out


qk_norm_rope_kv.launches = 0


def silu_mul_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: SiLU of g in float32, rounded to g's dtype, times u."""
    return F.silu(g.float()).to(g.dtype) * u


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """SiLU(g) * u for g, u [..., I] of one dtype (float32 or bfloat16),
    read as they come where their rows are dense and evenly spaced (the
    halves of the fused gate / up output); other layouts are made
    contiguous first. Returns a contiguous [..., I]. A CUDA tensor launches
    K7 (csrc/glue.cu) and counts it in `silu_mul.launches`; a CPU tensor
    takes the plain version."""
    if g.device.type == "cpu":
        return silu_mul_plain(g, u)
    if g.shape != u.shape or g.dtype != u.dtype:
        raise ValueError(f"silu_mul: g {tuple(g.shape)} {g.dtype}, u {tuple(u.shape)} {u.dtype}")
    kernels.require_device(g, u)
    out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    (g, N, ldg), (u, _, ldu) = _rows(g), _rows(u)
    kernels.library().call("fq3t_silu_mul", kernels.dtype_code(g), g.data_ptr(), ldg, u.data_ptr(), ldu,
                           out.data_ptr(), N, g.shape[-1], kernels.stream_handle(g.device))
    silu_mul.launches += 1
    return out


silu_mul.launches = 0
