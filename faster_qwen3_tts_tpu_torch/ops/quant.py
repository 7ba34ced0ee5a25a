"""Weight-only int8 and int4 quantization and the projection product, with
K2 and K4.

Counterpart of faster_qwen3_tts_tpu/ops/quant.py: Q8_0 (int8, per-output-
channel absmax), Q4_K_M (int4, group-wise scale and min, two nibbles a
byte) and Q8_4 (talker int8, predictor int4), computed by the same host
numpy code, so both packages hold bit-identical quantized weights (a tree
of tensors, after a bundle unpack or a device init, is quantized on its
device by `quantize_linear_torch` / `quantize_linear4_torch`, the same
bits). `dot`
routes by shape: a product with at most `GEMV_MAX_ROWS` rows (every decode
projection) goes to the int8 GEMV kernel K2 or the int4 GEMV kernel K4; a
larger one (the talker prefill, prompt text projection) is a plain matrix
product, which the JAX package leaves to XLA.

`fuse_layer_weights` gives the fused layout of the JAX package's opt-in
`FQ3T_FUSE_QKV` (here `from_pretrained(fuse_qkv=True)`): a layer's q/k/v and
gate/up projections concatenated along the output axis into `wqkv` and
`w_gateup`, so a decode layer makes 4 projection launches instead of 7.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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
    """Weight-only int4 linear with group-wise asymmetric (scale, min)
    quantization, the Q4_K_M-class mode: w ~= nibble * scale + wmin.

    packed: uint8 [..., in/2, out], two 4-bit values a byte along the
            reduction dim (high nibble = even row, low nibble = odd row);
    scale:  f32 [..., in/group, out];
    wmin:   f32 [..., in/group, out] (the group's minimum)."""

    packed: torch.Tensor
    scale: torch.Tensor
    wmin: torch.Tensor

    @property
    def group(self) -> int:
        return 2 * self.packed.shape[-2] // self.scale.shape[-2]


def quantize_linear(w) -> QuantizedLinear:
    """Host numpy quantization, the JAX package's code line for line.
    Returns numpy leaves (`weights.params_from_numpy` moves them)."""
    wf = np.asarray(w, np.float32)
    scale = np.max(np.abs(wf), axis=-2, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(wf / scale), -127, 127).astype(np.int8)
    return QuantizedLinear(q=q, scale=scale.astype(np.float32))


def quantize_linear4(w, group: int = 32) -> QuantizedLinear4:
    """Host numpy asymmetric int4 quantization with group-wise scale and min,
    the JAX package's code line for line (a layer whose input width is not a
    multiple of `group` is one group). Returns numpy leaves."""
    wf = np.asarray(w, np.float32)
    I, O = wf.shape[-2], wf.shape[-1]
    if I % group:
        group = I  # tiny layers: one group
    g = wf.reshape(*wf.shape[:-2], I // group, group, O)
    wmin = np.min(g, axis=-2)  # [..., n_groups, O]
    scale = (np.max(g, axis=-2) - wmin) / 15.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round((g - wmin[..., None, :]) / scale[..., None, :]), 0, 15)
    q = q.astype(np.uint8).reshape(*wf.shape[:-2], I, O)
    hi, lo = q[..., 0::2, :], q[..., 1::2, :]
    packed = ((hi << 4) | lo).astype(np.uint8)
    return QuantizedLinear4(packed=packed, scale=scale.astype(np.float32), wmin=wmin.astype(np.float32))


def _f32(x: float, device) -> torch.Tensor:
    """A float32 divisor on the dividend's device: CUDA multiplies by the
    reciprocal of a Python or CPU scalar, which can miss the quotient by an
    ulp; a device tensor is divided by."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def quantize_linear_torch(w: torch.Tensor) -> QuantizedLinear:
    """`quantize_linear` on a tensor, on the tensor's device (the JAX
    package's `quantize_linear_jnp`): the same float32 arithmetic (IEEE
    division, round half to even, the 1e-12 floor), so `q` and `scale` are
    the numpy version's bit for bit."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True) / _f32(127.0, w.device), 1e-12)
    t = wf / scale
    del wf
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedLinear(q=q, scale=scale)


def quantize_linear4_torch(w: torch.Tensor, group: int = 32) -> QuantizedLinear4:
    """`quantize_linear4` on a tensor, on the tensor's device (the JAX
    package's `quantize_linear4_jnp`, plus the numpy version's one group
    for a layer whose input width is not a multiple of `group`); bit for bit
    the numpy version's."""
    wf = w.float()
    I, O = wf.shape[-2], wf.shape[-1]
    if I % group:
        group = I  # tiny layers: one group
    g = wf.reshape(*wf.shape[:-2], I // group, group, O)
    wmin = g.amin(dim=-2)  # [..., n_groups, O]
    scale = torch.clamp_min((g.amax(dim=-2) - wmin) / _f32(15.0, w.device), 1e-12)
    t = (g - wmin[..., None, :]) / scale[..., None, :]
    del wf, g
    q = t.round_().clamp_(0, 15).to(torch.uint8).reshape(*w.shape[:-2], I, O)
    packed = (q[..., 0::2, :] << 4) | q[..., 1::2, :]
    return QuantizedLinear4(packed=packed, scale=scale, wmin=wmin)


def dequantize(w) -> torch.Tensor:
    """QuantizedLinear / QuantizedLinear4 / plain weight -> float32 tensor on
    the weight's device (the parity path, quality checks); the JAX package's
    arithmetic, so the values are the same bits."""
    if isinstance(w, QuantizedLinear):
        return torch.as_tensor(w.q).float() * torch.as_tensor(w.scale).float()
    if isinstance(w, QuantizedLinear4):
        p = torch.as_tensor(w.packed)
        q = torch.stack([p >> 4, p & 0xF], dim=-2).reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1])
        I, O = q.shape[-2:]
        scale = torch.as_tensor(w.scale).float()
        wmin = torch.as_tensor(w.wmin).float()
        n_groups = scale.shape[-2]
        g = q.reshape(*q.shape[:-2], n_groups, I // n_groups, O).float()
        return (g * scale[..., None, :] + wmin[..., None, :]).reshape(q.shape)
    return torch.as_tensor(w).float()


_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# mode -> (talker, predictor) quantizer; "mixed" is Q8_4: the predictor
# streams its weights 15 times a frame, so int4 there cuts the largest byte
# term while the talker stays int8
_MODES = {"int8": (quantize_linear, quantize_linear), "int4": (quantize_linear4, quantize_linear4),
          "mixed": (quantize_linear, quantize_linear4)}
_TORCH_MODES = {"int8": (quantize_linear_torch, quantize_linear_torch),
                "int4": (quantize_linear4_torch, quantize_linear4_torch),
                "mixed": (quantize_linear_torch, quantize_linear4_torch)}


def quantize_model_params(params: dict, mode: str = "int8") -> dict:
    """Quantize the talker and predictor projections: mode "int8" (Q8_0),
    "int4" (Q4_K_M) or "mixed" (Q8_4). A host numpy tree is quantized on the
    host; a tree of tensors (the port's, after a bundle unpack or a device
    init) on its tensors' device by the torch quantizers, with the same
    bits. Embeddings, norms, the speaker projection and the codec keep their
    dtype, as in the JAX package."""
    on_device = isinstance(params["talker"]["codec_head"], torch.Tensor)
    quantize_talker, quantize_pred = (_TORCH_MODES if on_device else _MODES)[mode]

    def quant_layers(layers: dict, quantize) -> dict:
        new = dict(layers)
        for k in _LAYER_WEIGHTS:
            new[k] = quantize(layers[k])
        return new

    out = dict(params)
    t = dict(params["talker"])
    t["layers"] = quant_layers(t["layers"], quantize_talker)
    t["codec_head"] = quantize_talker(t["codec_head"])
    t["text_proj"] = {"w": quantize_talker(t["text_proj"]["w"]), "b": t["text_proj"]["b"]}
    out["talker"] = t
    p = dict(params["predictor"])
    p["layers"] = quant_layers(p["layers"], quantize_pred)
    p["lm_heads"] = quantize_pred(p["lm_heads"])
    p["mtp_proj"] = {"w": quantize_pred(p["mtp_proj"]["w"]), "b": p["mtp_proj"]["b"]}
    out["predictor"] = p
    return out


def infer_quant_mode(params: dict) -> str:
    """The `quantize_model_params` mode of a tree, from its leaf types;
    raises on a combination that function never produces."""

    def kind(x) -> str:
        if isinstance(x, QuantizedLinear):
            return "int8"
        if isinstance(x, QuantizedLinear4):
            return "int4"
        return "none"

    def probe(layers: dict):
        return layers["wqkv"] if "wqkv" in layers else layers["wq"]  # fused layout

    kt = kind(probe(params["talker"]["layers"]))
    kp = kind(probe(params["predictor"]["layers"]))
    if kt == kp:
        return kt
    if (kt, kp) == ("int8", "int4"):
        return "mixed"
    raise ValueError(f"unrecognized quantization layout: talker={kt}, predictor={kp}")


def _concat_out(ws):
    """Linears concatenated along the output axis: plain, QuantizedLinear or
    QuantizedLinear4 leaves (their scales and mins are per output column, so
    each column keeps its values), torch tensors or host numpy arrays."""

    def cat(xs):
        return torch.cat(list(xs), dim=-1) if isinstance(xs[0], torch.Tensor) else np.concatenate(xs, axis=-1)

    w0 = ws[0]
    if isinstance(w0, (QuantizedLinear, QuantizedLinear4)):
        return type(w0)(*(cat([w[i] for w in ws]) for i in range(len(w0))))
    return cat(ws)


def _fuse_layers(layers: dict) -> None:
    """Replace wq/wk/wv by wqkv and w_gate/w_up by w_gateup in `layers`, in
    place: each group's leaves are dropped as soon as their concatenation
    exists, so a tree the caller does not keep never holds both layouts."""
    layers["wqkv"] = _concat_out([layers.pop("wq"), layers.pop("wk"), layers.pop("wv")])
    layers["w_gateup"] = _concat_out([layers.pop("w_gate"), layers.pop("w_up")])


def fuse_layer_weights(params: dict) -> dict:
    """The fused projection layout of the talker and predictor layers (the
    JAX package's `fuse_layer_weights`): `wqkv` replaces wq/wk/wv and
    `w_gateup` replaces w_gate/w_up, concatenated along the output axis.
    Every output column is the same dot product with the same scale, so the
    values do not change; on the card K2 and K4 split the longer rows
    differently, so their sums may run in another order. Returns a new tree;
    `params` is left as it was (its leaves are shared)."""
    out = dict(params)
    for sub in ("talker", "predictor"):
        m = dict(out[sub])
        m["layers"] = dict(m["layers"])
        _fuse_layers(m["layers"])
        out[sub] = m
    return out


def resolve_quant_name(quant: str) -> str:
    """Map the public quant names onto modes, as the JAX package does."""
    key = (quant or "BF16").lower()
    if key in ("bf16", "f32", "fp32", "none", "float32", "bfloat16"):
        return "none"
    if key in ("q8_0", "int8", "q8"):
        return "int8"
    if key in ("q4_k_m", "q4_k", "int4", "q4", "q4_0"):
        return "int4"
    if key in ("q8_4", "mixed"):
        return "mixed"
    raise ValueError(
        f"Unsupported quant {quant!r}. Expected BF16/F32, Q8_0/int8, Q4_K_M/int4, "
        "or Q8_4/mixed (talker int8 + predictor int4)."
    )


def int8_gemv_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (x @ q) * scale with f32 accumulation,
    rounded once to x.dtype (the JAX int8 branch of `quant.dot`)."""
    y = torch.matmul(x.float(), q.float())
    return (y * scale.float().reshape(scale.shape[-1])).to(x.dtype)


# launch geometry of K2 (csrc/int8_gemv.cu)
_COLS = 128           # output columns per tile
_CHUNK_ROWS = 64      # rows per TMA box and ring stage
_STAGES = 8
_MAX_ROWS = 4         # rows of x per CTA; grid.y covers more
_MAX_CLUSTER = 8      # CTAs per cluster (the portable maximum; 16 measured slower)
_TARGET_CTAS = 264    # two CTAs on each of an H100's 132 SMs
_MAX_SMEM = 232448    # dynamic shared memory of an H100 block (227 KB)


class GemvPlan(NamedTuple):
    """One K2 launch: grid (tiles * cluster, row groups), clusters of
    `cluster` CTAs along x, each reducing `rows_per_cta` rows of I, with
    `smem` bytes of dynamic shared memory; `mr` rows of x per CTA."""

    grid: Tuple[int, int]
    cluster: int
    rows_per_cta: int
    smem: int
    mr: int


def _gemv_plan(M: int, I: int, O: int, elt: int) -> GemvPlan:
    """K2's launch for x [M, I] of `elt`-byte elements and q [I, O]. The
    cluster of each 128-column tile splits I into slabs of whole 64-row
    stages, as many as fill the card about twice (tiles x row groups x
    cluster <= 264 CTAs, cluster <= 8); the cluster is then shrunk so that
    every CTA has rows. Shared memory is csrc/int8_gemv.cu's `smem_bytes`,
    which the launch checks. Raises ValueError on a shape the kernel does not
    take."""
    if not 1 <= M <= GEMV_MAX_ROWS or I < 1 or O < 16 or O % 16:
        raise ValueError(f"int8_gemv: no K2 launch for M={M} I={I} O={O}")
    mr = M if M <= 2 else _MAX_ROWS
    tiles, groups = -(-O // _COLS), -(-M // mr)
    chunks = -(-I // _CHUNK_ROWS)
    cluster = max(1, min(_MAX_CLUSTER, chunks, _TARGET_CTAS // (tiles * groups)))
    rows_per_cta = -(-chunks // cluster) * _CHUNK_ROWS
    cluster = -(-I // rows_per_cta)
    smem = (128 + _STAGES * _CHUNK_ROWS * _COLS + (mr * _COLS + _MAX_CLUSTER) * 4 + _STAGES * 8
            + -(-mr * rows_per_cta * elt // 16) * 16)
    if smem > _MAX_SMEM:
        raise ValueError(f"int8_gemv: {smem} bytes of shared memory for I={I}")
    return GemvPlan((tiles * cluster, groups), cluster, rows_per_cta, smem, mr)


def int8_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ q) * scale for x [..., I] (at most 16 rows), q int8 [I, O],
    scale f32 [1, O]. A CUDA tensor launches K2 (csrc/int8_gemv.cu: one
    launch, a cluster of CTAs per column tile summing through distributed
    shared memory) and counts it in `int8_gemv.launches`; a CPU tensor takes
    the plain version."""
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
    plan = _gemv_plan(M, I, O, x2.element_size())
    lib = kernels.library()
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    lib.call(
        "fq3t_int8_gemv",
        kernels.dtype_code(x), x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), M, I, O,
        plan.rows_per_cta, plan.cluster, plan.smem, kernels.stream_handle(x.device),
    )
    int8_gemv.launches += 1
    return y.reshape(*lead, O)


int8_gemv.launches = 0


def _int8_matmul(x: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """Many-row int8 product (prefill, prompt text): a plain matrix product
    with f32 accumulation, as the JAX package leaves it to XLA."""
    y = torch.matmul(x.float(), w.q.float())
    return (y * w.scale.reshape(w.scale.shape[-1])).to(x.dtype)


def int4_gemv_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    wmin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4, the JAX package's `_dot4` formulation:
    per group, x_even @ hi + x_odd @ lo, times the group's scale, plus the
    group's sum of x times its min; f32 accumulation, rounded once to
    x.dtype. packed [I/2, O] uint8, scale / wmin [I/group, O]."""
    I2, O = packed.shape[-2:]
    n_groups = scale.shape[-2]
    G2 = I2 // n_groups  # packed rows per group
    lead = x.shape[:-1]
    xf = x.float()
    xr = xf.reshape(*lead, I2, 2)  # [..., j, 0] = x[2j], [..., j, 1] = x[2j + 1]
    x_even = xr[..., 0].reshape(*lead, n_groups, G2)
    x_odd = xr[..., 1].reshape(*lead, n_groups, G2)
    hi = (packed >> 4).reshape(n_groups, G2, O).float()
    lo = (packed & 0xF).reshape(n_groups, G2, O).float()
    yg = torch.einsum("...gi,gio->...go", x_even, hi) + torch.einsum("...gi,gio->...go", x_odd, lo)
    y = torch.einsum("...go,go->...o", yg, scale.float())
    xsum = xf.reshape(*lead, n_groups, -1).sum(dim=-1)
    y = y + torch.einsum("...g,go->...o", xsum, wmin.float())
    return y.to(x.dtype)


# launch geometry of K4 (csrc/int4_gemv.cu)
_SMS = 132                # an H100's SMs
_K4_COLS = (128, 64, 32)  # column tiles (one TMA swizzle mode each), widest first
_K4_WARPS = 8             # 256 threads
_K4_PAIR_SMEM = _MAX_SMEM // 2 - 1024  # a CTA's share when two run on an SM
_K4_MMA_MIN_ROWS = 2      # bf16 rows from which K4 runs on the tensor cores (measured: PERF.md)


class Int4GemvPlan(NamedTuple):
    """One K4 launch: grid (cluster, column tiles, row groups); each CTA
    takes `cols` output columns, `mr` rows of x and `groups_per_cta`
    quantization groups of I (the `cluster` CTAs of a column tile split I),
    copied whole into `smem` bytes of dynamic shared memory, x at `xs_pitch`
    elements a row; each of its warps along I reduces `gpw` of the groups;
    `mma`: the tensor-core path."""

    grid: Tuple[int, int, int]
    cluster: int
    groups_per_cta: int
    smem: int
    mr: int
    cols: int
    gpw: int
    xs_pitch: int
    mma: bool


def _k4_warps_along_i(mma: bool, cols: int) -> int:
    return _K4_WARPS // (cols // 32) if mma else _K4_WARPS


def _int4_smem(plan: Int4GemvPlan, group: int, elt: int) -> int:
    """csrc/int4_gemv.cu's `layout(...).total`: the slab's packed rows, its
    groups' scale and min rows, x's slice, the warps' partial sums, the
    cluster's, the merge's mbarrier and the alignment of the base to 1024
    bytes."""
    def up(v: int, a: int) -> int:
        return -(-v // a) * a

    per = plan.groups_per_cta
    slots = -(-plan.mr * plan.cols // plan.cluster)
    return (up(per * (group // 2) * plan.cols, 1024) + 2 * per * plan.cols * 4
            + up(plan.mr * plan.xs_pitch * elt, 128) + _k4_warps_along_i(plan.mma, plan.cols) * plan.mr * plan.cols * 4
            + up(plan.cluster * slots * 4, 16) + 16 + 1024)


def _int4_candidate(M: int, I: int, O: int, group: int, elt: int, mma: bool, mr: int, cols: int,
                    cluster: int):
    """The launch with `cols`-column tiles and at most `cluster` CTAs a tile,
    or None where its slab does not fit in shared memory."""
    n_groups = I // group
    per = -(-n_groups // cluster)
    cluster = -(-n_groups // per)
    gpw = -(-per // _k4_warps_along_i(mma, cols))
    words = -(-per * group * elt // 16) * 4  # x's row in 32-bit words, 16-byte aligned
    words += (4 - words % 32) % 32           # = 4 mod 32: the tensor-core path's x reads hit 32 banks
    plan = Int4GemvPlan((cluster, -(-O // cols), -(-M // mr)), cluster, per, 0, mr, cols, gpw,
                        words * 4 // elt, mma)
    smem = _int4_smem(plan, group, elt)
    return None if smem > _MAX_SMEM else plan._replace(smem=smem)


@functools.lru_cache(maxsize=None)  # a decode step asks for the same few launches hundreds of times
def _int4_plan(M: int, I: int, O: int, group: int, elt: int = 2) -> Int4GemvPlan:
    """K4's launch for x [M, I] of `elt`-byte elements (2: bf16, 4: f32) and
    a [I/2, O] packed weight in groups of `group` rows.

    Path: the tensor cores for bf16 x from `_K4_MMA_MIN_ROWS` rows when the
    group is a multiple of 16 (one weight pass for up to 16 rows), else the
    CUDA cores (up to 4 rows a CTA). Tiles: among column widths of 128, 64
    and 32 and clusters of 1-8 CTAs splitting I, the launches whose slabs fit
    in shared memory; of those, one whose CTAs are all resident at once
    (within a CTA's share of an SM when there are more CTAs than SMs), then
    one with at least 132 CTAs (every SM busy), then the fewest CTAs a
    cluster (its barrier costs ~0.5 us), then the widest tile. Where no slab
    of 16 rows of x fits (a very long I), the tensor cores take 8 rows a
    CTA. A CTA holds its whole slab, so I is bounded (at group 32: 65536 at
    one row, 40960 at 16). Shared memory is csrc/int4_gemv.cu's layout,
    which the launch checks. Raises ValueError on a shape the kernel does
    not take."""
    if (not 1 <= M <= GEMV_MAX_ROWS or I < 2 or O < 16 or O % 16 or group < 2 or group % 2
            or I % group or elt not in (2, 4)):
        raise ValueError(f"int4_gemv: no K4 launch for M={M} I={I} O={O} group={group}")
    mma = elt == 2 and group % 16 == 0 and M >= _K4_MMA_MIN_ROWS
    rows = ((8 if M <= 8 else 16), 8) if mma else ((M if M <= 2 else _MAX_ROWS),)
    for mr in rows:
        best, best_key = None, None
        for cols in _K4_COLS:
            for cluster in range(1, min(_MAX_CLUSTER, I // group) + 1):
                plan = _int4_candidate(M, I, O, group, elt, mma, mr, cols, cluster)
                if plan is None or plan.cluster != cluster:
                    continue
                ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
                resident = ctas <= _SMS or (ctas <= 2 * _SMS and plan.smem <= _K4_PAIR_SMEM)
                key = (not resident, ctas < _SMS, cluster, -cols)
                if best_key is None or key < best_key:
                    best, best_key = plan, key
        if best is not None:
            return best
    raise ValueError(f"int4_gemv: no K4 launch fits shared memory for I={I} group={group}")


def int4_gemv(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, wmin: torch.Tensor) -> torch.Tensor:
    """The int4 product of `int4_gemv_plain` for x [..., I] (at most 16
    rows), packed uint8 [I/2, O], scale and wmin f32 [I/group, O]. A CUDA
    tensor launches K4 (csrc/int4_gemv.cu: one launch; every weight byte
    copied into shared memory at the start, one round trip; CUDA cores or,
    for 2-16 bf16 rows, the tensor cores; a cluster of CTAs per column tile
    summing through distributed shared memory where the column tiles alone
    do not fill the card) and counts it in `int4_gemv.launches`; a CPU
    tensor takes the plain version."""
    if x.device.type == "cpu":
        return int4_gemv_plain(x, packed, scale, wmin)
    I2, O = packed.shape
    I = 2 * I2
    lead = x.shape[:-1]
    M = x.numel() // x.shape[-1]
    if (x.shape[-1] != I or M > GEMV_MAX_ROWS or scale.dim() != 2 or scale.shape[-1] != O
            or wmin.shape != scale.shape or I % scale.shape[0]):
        raise ValueError(f"int4_gemv shapes: x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}, wmin {tuple(wmin.shape)}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32 or wmin.dtype != torch.float32:
        raise TypeError("int4_gemv takes uint8 packed, float32 scale and float32 wmin")
    x2 = x.reshape(M, I).contiguous()
    kernels.require_cuda(x2, packed, scale, wmin)
    if O % 16 or any(t.data_ptr() % 16 for t in (packed, scale, wmin)):
        raise ValueError("int4_gemv needs O % 16 == 0 and 16-byte aligned packed, scale and wmin")
    group = I // scale.shape[0]
    plan = _int4_plan(M, I, O, group, x2.element_size())
    lib = kernels.library()
    y = torch.empty((M, O), dtype=x.dtype, device=x.device)
    lib.call(
        "fq3t_int4_gemv",
        kernels.dtype_code(x), x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), wmin.data_ptr(),
        y.data_ptr(), M, I, O, group, plan.groups_per_cta, plan.cluster, plan.cols, plan.gpw, plan.xs_pitch,
        plan.mr, int(plan.mma), plan.smem, kernels.stream_handle(x.device),
    )
    int4_gemv.launches += 1
    return y.reshape(*lead, O)


int4_gemv.launches = 0


def _int4_matmul(x: torch.Tensor, w: QuantizedLinear4) -> torch.Tensor:
    """Many-row int4 product (prefill, prompt text): the plain grouped
    product, as the JAX package leaves `_dot4` to XLA."""
    return int4_gemv_plain(x, w.packed, w.scale, w.wmin)


def dot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with f32 accumulation, result in x.dtype; w is a plain tensor
    [in, out], a QuantizedLinear or a QuantizedLinear4."""
    rows = x.numel() // x.shape[-1]
    if isinstance(w, QuantizedLinear):
        if rows <= GEMV_MAX_ROWS:
            return int8_gemv(x, w.q, w.scale)
        return _int8_matmul(x, w)
    if isinstance(w, QuantizedLinear4):
        if rows <= GEMV_MAX_ROWS:
            return int4_gemv(x, w.packed, w.scale, w.wmin)
        return _int4_matmul(x, w)
    # cuBLAS and the CPU accumulate in f32 and round the output once
    return torch.matmul(x, w.to(x.dtype))
