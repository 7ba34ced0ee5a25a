"""Operations and bytes from shapes: the yardstick of the per-layer shares.

K2 (the int8 GEMV) is launched for every Q8_0 projection of at most 16 rows.
A frame of B lanes launches, per talker layer, q/k/v/o and gate/up/down at
B rows and the codec head at B rows; the code predictor's first pass runs
its input projection and its layers at 2B rows (two inputs a lane), its 14
further passes at B rows, and each of its 15 heads at B rows. A prefill
launches K2 once, for the codec head over the last hidden. A launch needs
the int8 weight and its float32 scales once, and its bfloat16 input and
output rows. The least time of a launch is its bytes over the HBM rate.

A frame's operations count 2 a multiply-add: every projection, the
attention over the context, the predictor's 16 positions; a window vocode's
are the codec decoder's products and convolutions over the window's frames.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_DENSE_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate, NVIDIA's data sheet
K2_MAX_ROWS = 16


def _proj(sub: Dict[str, Any]) -> List[Tuple[int, int]]:
    """(in, out) of a decoder layer's seven projections."""
    h, q = sub["hidden_size"], sub["num_attention_heads"] * sub["head_dim"]
    kv, f = sub["num_key_value_heads"] * sub["head_dim"], sub["intermediate_size"]
    return [(h, q), (h, kv), (h, kv), (q, h), (h, f), (h, f), (f, h)]


def frame_launches(cfg: Dict[str, Any], B: int) -> List[Tuple[int, int, int]]:
    """K2 launches of one frame at B lanes as (rows, in, out)."""
    t, p = cfg["talker"], cfg["predictor"]
    out = [(B, i, o) for i, o in _proj(t)] * t["num_hidden_layers"]
    out.append((B, t["hidden_size"], t["vocab_size"]))
    H, Hp, Vp = t["hidden_size"], p["hidden_size"], p["vocab_size"]
    for rows in [2 * B] + [B] * (p["num_code_groups"] - 2):
        out.append((rows, H, Hp))
        out += [(rows, i, o) for i, o in _proj(p)] * p["num_hidden_layers"]
        out.append((B, Hp, Vp))
    return out


def prefill_launches(cfg: Dict[str, Any], B: int) -> List[Tuple[int, int, int]]:
    return [(B, cfg["talker"]["hidden_size"], cfg["talker"]["vocab_size"])]


def k2_bytes(rows: int, i: int, o: int) -> int:
    """int8 weight, float32 scale row, bfloat16 input and output rows."""
    return i * o + 4 * o + 2 * rows * i + 2 * rows * o


def k2_bound_s(launches: Iterable[Tuple[int, int, int]]) -> float:
    return sum(k2_bytes(*x) for x in launches) / HBM_BYTES_PER_S


def frame_flops(cfg: Dict[str, Any], context: int) -> float:
    """One lane's frame: the talker step at `context` positions (projections,
    attention, codec head), the code predictor's 16 positions (input
    projection, layers, attention, 15 heads) and the frame's embedding sum."""
    t, p = cfg["talker"], cfg["predictor"]
    proj = sum(i * o for i, o in _proj(t)) * t["num_hidden_layers"] + t["hidden_size"] * t["vocab_size"]
    attn = 4 * t["num_attention_heads"] * t["head_dim"] * context * t["num_hidden_layers"]
    P = p["num_code_groups"]  # 16 positions: [past hidden, cb0, cb1..cb14]
    pproj = P * (t["hidden_size"] * p["hidden_size"] + sum(i * o for i, o in _proj(p)) * p["num_hidden_layers"])
    pattn = sum(4 * p["num_attention_heads"] * p["head_dim"] * (s + 1) for s in range(P)) * p["num_hidden_layers"]
    heads = (P - 1) * p["hidden_size"] * p["vocab_size"]
    return 2.0 * (proj + pproj + heads) + attn + pattn


def window_flops(cfg: Dict[str, Any], frames: int) -> float:
    """The codec decoder over a window of `frames` frames."""
    c = cfg["codec"]
    C, T = c["hidden_size"], frames
    q, kv, f = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"], c["intermediate_size"]
    w = min(T, c["sliding_window"])
    total = c["num_hidden_layers"] * (2 * T * (C * (q + 2 * kv) + q * C + 3 * C * f) + 4 * q * T * w)
    L = T
    for r in c["upsampling_ratios"]:
        total += 2 * L * C * C * r  # transposed conv
        L *= r
        total += 2 * L * C * 7 + 2 * L * (8 * C * C)  # depthwise conv, two pointwise products
    D = c["decoder_dim"]
    total += 2 * L * C * D * 7
    for i, r in enumerate(c["upsample_rates"]):
        din, dout = D // 2 ** i, D // 2 ** (i + 1)
        total += 2 * L * din * dout * 2 * r
        L *= r
        total += 3 * 2 * L * dout * dout * (7 + 1)  # three residual units: conv 7 and conv 1
    total += 2 * L * (D // 2 ** len(c["upsample_rates"])) * 7
    return float(total)


def prompt_rows(req: Dict[str, Any]) -> int:
    """The prompt's rows: role (3) + codec control block (7 with a voice) -
    1 + the first text token row (x-vector, streaming layout), or + the text
    and its end (whole-text layout of a preset speaker) + 1."""
    if req.get("speaker"):
        return 3 + 6 + len(req["text"]) + 1 + 1
    return 3 + 6 + 1
