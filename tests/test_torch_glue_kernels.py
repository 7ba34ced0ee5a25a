"""K5, K6 and K7 (csrc/glue.cu) on the card against their plain versions.

These need an NVIDIA GPU (CUDA kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on a machine without it:

    python -m pytest tests/test_torch_glue_kernels.py --noconftest -q

Each kernel is held against its plain PyTorch version called on the same
CUDA tensors. Bit for bit: K5's residual sums, K6's V cache writes, K7 (bf16
and float32: the same float32 SiLU, rounded where PyTorch rounds). Within one
ulp of the dtype: K5's normed rows and K6's q and written K rows (the float32
sum of squares is taken in another order than PyTorch's reduction). K6 leaves
every cache slot but each lane's write position untouched. Shapes: the hidden
widths 1024 / 2048 and the 128-wide heads, B = 1, 2, 8, 16 rows, 16 / 8 heads
and a tp = 2 rank's 8 / 4, the fused projection layout's column views, write
positions at 0, mid-cache and the clamped last slot. Last, a 0.6B frame
captured at full depth reports the glue launches its config implies.
"""
import pytest
import torch

from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import get_config
from faster_qwen3_tts_tpu_torch.engine import graphs
from faster_qwen3_tts_tpu_torch.models.layers import rope_cos_sin
from faster_qwen3_tts_tpu_torch.ops import glue, quant
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between a and b in steps of their dtype."""
    assert a.dtype == b.dtype and a.shape == b.shape

    def key(t):
        if t.dtype == torch.bfloat16:
            i, sign = t.contiguous().view(torch.int16).to(torch.int64), 0x7FFF
        else:
            i, sign = t.contiguous().view(torch.int32).to(torch.int64), 0x7FFFFFFF
        return torch.where(i < 0, -(i & sign), i)

    return int((key(a) - key(b)).abs().max().item()) if a.numel() else 0


def _randn(g, *shape, scale=1.0, dtype=torch.bfloat16, device="cuda"):
    return (torch.randn(*shape, generator=g) * scale).to(device, dtype)


def _norm_weight(g, W, dtype, device):
    return (1.0 + 0.1 * torch.randn(W, generator=g)).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1024, 2048, 128])
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("residual", [True, False], ids=["add", "norm"])
def test_add_rms_norm_kernel(cuda_device, W, B, residual):
    g = torch.Generator().manual_seed(W + B)
    x = _randn(g, B, 1, W, scale=3.0)
    res = _randn(g, B, 1, W) if residual else None
    w = _norm_weight(g, W, torch.bfloat16, cuda_device)
    before = glue.add_rms_norm.launches
    s, y = glue.add_rms_norm(x, res, w, 1e-6)
    assert glue.add_rms_norm.launches == before + 1
    ps, py = glue.add_rms_norm_plain(x, res, w, 1e-6)
    assert torch.equal(s, ps)
    assert y.is_contiguous() and _ulps(y, py) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("heads, S", [(16, 1), (8, 1), (16, 24), (4, 256)])
@pytest.mark.parametrize("B", [1, 8])
def test_add_rms_norm_kernel_fused_head_views(cuda_device, heads, S, B):
    """The per-head q / k norms of a prefill on the fused projection's
    output: [B, S, heads, 128] column views with the fused row's stride."""
    g = torch.Generator().manual_seed(heads * S + B)
    D = 128
    y = _randn(g, B, S, heads * D + 2 * 4 * D, scale=2.0)  # q columns, then k / v of 4 kv heads
    q = y[..., :heads * D].reshape(B, S, heads, D)
    k = y[..., heads * D:heads * D + 4 * D].reshape(B, S, 4, D)
    assert q.is_contiguous() == (B * S == 1)
    w = _norm_weight(g, D, torch.bfloat16, cuda_device)
    for t in (q, k):
        s, out = glue.add_rms_norm(t, None, w, 1e-6)
        assert s is t and out.is_contiguous() and out.shape == t.shape
        assert _ulps(out, glue.add_rms_norm_plain(t, None, w, 1e-6)[1]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1024, 128, 96])
def test_add_rms_norm_kernel_float32(cuda_device, W):
    g = torch.Generator().manual_seed(W)
    x = _randn(g, 5, W, scale=3.0, dtype=torch.float32)
    res = _randn(g, 5, W, dtype=torch.float32)
    w = _norm_weight(g, W, torch.float32, cuda_device)
    s, y = glue.add_rms_norm(x, res, w, 1e-6)
    ps, py = glue.add_rms_norm_plain(x, res, w, 1e-6)
    assert torch.equal(s, ps)
    torch.testing.assert_close(y, py, atol=1e-6, rtol=1e-6)


def _k6_inputs(device, B, Hq, Hkv, S, fused, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    D = 128
    if fused:  # column views of one [B, 1, (Hq + 2 Hkv) D] product
        y = _randn(g, B, 1, (Hq + 2 * Hkv) * D, scale=2.0, dtype=dtype)
        q = y[..., :Hq * D].reshape(B, 1, Hq, D)
        k = y[..., Hq * D:(Hq + Hkv) * D].reshape(B, 1, Hkv, D)
        v = y[..., (Hq + Hkv) * D:].reshape(B, 1, Hkv, D)
    else:
        q = _randn(g, B, 1, Hq * D, scale=2.0, dtype=dtype).reshape(B, 1, Hq, D)
        k = _randn(g, B, 1, Hkv * D, scale=2.0, dtype=dtype).reshape(B, 1, Hkv, D)
        v = _randn(g, B, 1, Hkv * D, dtype=dtype).reshape(B, 1, Hkv, D)
    qw, kw = _norm_weight(g, D, dtype, device), _norm_weight(g, D, dtype, device)
    rope_pos = torch.randint(0, 3000, (B,), generator=g).to(device, torch.int32)
    cos, sin = rope_cos_sin(rope_pos[:, None], D, 1e6)
    kc = _randn(g, B, S, Hkv, D, dtype=dtype)
    vc = _randn(g, B, S, Hkv, D, dtype=dtype)
    return q, k, v, qw, kw, cos, sin, kc, vc


def _write_pos(kind, B, S, device):
    """Lanes' write positions: all at 0, mid-cache (a different slot a lane),
    or mixed with finished lanes clamped to the last slot."""
    if kind == "zero":
        pos = [0] * B
    elif kind == "mid":
        pos = [(S // 2 + 3 * b) % S for b in range(B)]
    else:
        pos = [S - 1 if b % 2 == 0 else (5 * b) % S for b in range(B)]
    return torch.tensor(pos, dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("Hq, Hkv", [(16, 8), (8, 4)], ids=["tp1", "tp2-rank"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("kind, S", [("zero", 2048), ("mid", 2048), ("clamped", 2048), ("mid", 17),
                                     ("clamped", 17)])
def test_qk_norm_rope_kv_kernel(cuda_device, B, Hq, Hkv, fused, kind, S):
    q, k, v, qw, kw, cos, sin, kc, vc = _k6_inputs(cuda_device, B, Hq, Hkv, S, fused, seed=B * 31 + Hq)
    wp = _write_pos(kind, B, S, cuda_device)
    kc0, vc0 = kc.clone(), vc.clone()
    pk, pv = kc.clone(), vc.clone()
    before = glue.qk_norm_rope_kv.launches
    out = glue.qk_norm_rope_kv(q, k, v, qw, kw, cos, sin, kc, vc, wp, 1e-6)
    assert glue.qk_norm_rope_kv.launches == before + 1
    ref = glue.qk_norm_rope_kv_plain(q, k, v, qw, kw, cos, sin, pk, pv, wp, 1e-6)
    assert out.is_contiguous() and _ulps(out, ref) <= 1
    lanes = torch.arange(B, device=cuda_device)
    written = torch.zeros(B, S, dtype=torch.bool, device=cuda_device)
    written[lanes, wp.long()] = True
    assert torch.equal(vc, pv)
    assert _ulps(kc[written], pk[written]) <= 1
    assert torch.equal(kc[~written], kc0[~written]) and torch.equal(vc[~written], vc0[~written])


@pytest.mark.cuda
def test_qk_norm_rope_kv_kernel_float32(cuda_device):
    q, k, v, qw, kw, cos, sin, kc, vc = _k6_inputs(cuda_device, 3, 16, 8, 64, True, dtype=torch.float32)
    wp = _write_pos("mid", 3, 64, cuda_device)
    pk, pv = kc.clone(), vc.clone()
    out = glue.qk_norm_rope_kv(q, k, v, qw, kw, cos, sin, kc, vc, wp, 1e-6)
    ref = glue.qk_norm_rope_kv_plain(q, k, v, qw, kw, cos, sin, pk, pv, wp, 1e-6)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(kc, pk, atol=1e-5, rtol=1e-5)
    assert torch.equal(vc, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("I", [3072, 6144, 1536])
@pytest.mark.parametrize("rows", [1, 2, 8, 16, 256])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_silu_mul_kernel(cuda_device, I, rows, fused):
    g = torch.Generator().manual_seed(I + rows)
    if fused:  # the halves of one gate / up product
        y = _randn(g, rows, 1, 2 * I, scale=4.0)
        gate, up = y[..., :I], y[..., I:]
    else:
        gate, up = _randn(g, rows, 1, I, scale=4.0), _randn(g, rows, 1, I, scale=4.0)
    before = glue.silu_mul.launches
    out = glue.silu_mul(gate, up)
    assert glue.silu_mul.launches == before + 1
    assert out.is_contiguous() and torch.equal(out, glue.silu_mul_plain(gate, up))


@pytest.mark.cuda
def test_silu_mul_kernel_float32(cuda_device):
    g = torch.Generator().manual_seed(1)
    gate, up = (_randn(g, 4, 1, 3072, scale=6.0, dtype=torch.float32) for _ in range(2))
    assert torch.equal(glue.silu_mul(gate, up), glue.silu_mul_plain(gate, up))


@pytest.mark.cuda
def test_glue_kernels_take_other_layouts(cuda_device):
    """Inputs whose last dim is not the dense one (a many-row int4 product's
    output can come so) are made contiguous by the wrapper first."""
    g = torch.Generator().manual_seed(11)
    x = _randn(g, 1024, 24, scale=3.0).t()[None]  # [1, 24, 1024], last-dim stride 24
    res = _randn(g, 1024, 24).t()[None]
    w = _norm_weight(g, 1024, torch.bfloat16, cuda_device)
    s, y = glue.add_rms_norm(x, res, w, 1e-6)
    ps, py = glue.add_rms_norm_plain(x, res, w, 1e-6)
    assert torch.equal(s, ps) and _ulps(y, py) <= 1
    q = _randn(g, 128, 24 * 16, scale=2.0).t().reshape(1, 24, 16, 128)
    wq = _norm_weight(g, 128, torch.bfloat16, cuda_device)
    _, y = glue.add_rms_norm(q, None, wq, 1e-6)
    assert _ulps(y, glue.add_rms_norm_plain(q, None, wq, 1e-6)[1]) <= 1
    gate, up = _randn(g, 3072, 24, scale=4.0).t(), _randn(g, 3072, 24, scale=4.0).t()
    assert torch.equal(glue.silu_mul(gate, up), glue.silu_mul_plain(gate, up))
    qq, k, v, qw, kw, cos, sin, kc, vc = _k6_inputs(cuda_device, 2, 16, 8, 32, False)
    qt = qq.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)  # heads not dense
    wp = _write_pos("mid", 2, 32, cuda_device)
    pk, pv = kc.clone(), vc.clone()
    out = glue.qk_norm_rope_kv(qt, k, v, qw, kw, cos, sin, kc, vc, wp, 1e-6)
    ref = glue.qk_norm_rope_kv_plain(qt, k, v, qw, kw, cos, sin, pk, pv, wp, 1e-6)
    assert _ulps(out, ref) <= 1 and torch.equal(vc, pv)


@pytest.mark.cuda
def test_glue_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(2, 1024, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        glue.add_rms_norm(x, None, torch.ones(512, dtype=torch.bfloat16, device=cuda_device), 1e-6)
    with pytest.raises(ValueError):
        glue.add_rms_norm(x, x[:1], torch.ones(1024, dtype=torch.bfloat16, device=cuda_device), 1e-6)
    wide = torch.ones(4096, dtype=torch.bfloat16, device=cuda_device)  # wider than any hidden row: refused in C
    with pytest.raises(RuntimeError):
        glue.add_rms_norm(wide[None], None, wide, 1e-6)
    with pytest.raises(TypeError):
        glue.silu_mul(x.half(), x.half())
    q, k, v, qw, kw, cos, sin, kc, vc = _k6_inputs(cuda_device, 2, 16, 8, 32, False)
    with pytest.raises(TypeError):
        glue.qk_norm_rope_kv(q, k, v, qw, kw, cos.to(torch.bfloat16), sin.to(torch.bfloat16), kc, vc,
                             _write_pos("zero", 2, 32, cuda_device), 1e-6)


def _frame_glue(t, p):
    """The glue launches of one frame of a stack of t talker and p predictor
    layers, from the config: K6 and K7 once a decode layer pass (the talker's
    t, the predictor's 14 decode steps of p), K7 also once a predictor
    prefill layer; K5 at ln1 and ln2 of every layer pass, once a stack call
    for the final norm (1 talker, 14 + 1 predictor), and twice a predictor
    prefill layer for its per-head q / k norms."""
    return {"K5": (2 * t + 1) + 14 * (2 * p + 1) + (2 * p + 1) + 2 * p, "K6": t + 14 * p, "K7": t + 15 * p}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_captured_06b_frame_launches_the_glue_kernels(cuda_device, B):
    cfg = get_config("Qwen/Qwen3-TTS-12Hz-0.6B-Base")
    params = weights.init_all_device(cfg, seed=0, dtype=torch.bfloat16, device=cuda_device)
    params = quant.quantize_model_params(params, "int8")
    greedy = SamplingParams(do_sample=False)
    key = graphs.make_key(params, B, 2048, 32, greedy, SamplingParams(do_sample=False, repetition_penalty=1.0), 2)
    reg = graphs.registry_for(params)
    gset = reg.lease(params, cfg, key)
    try:
        n = gset.frame_launches
        expect = _frame_glue(cfg.talker.num_hidden_layers, cfg.predictor.num_hidden_layers)
        assert {k: n[k] for k in ("K5", "K6", "K7")} == expect
        assert n["K6"] == n["K1"] == 98
    finally:
        reg.release(gset)
