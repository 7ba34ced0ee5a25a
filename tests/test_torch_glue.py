"""The decoder's glue on the CPU: the plain versions of K5 / K6 / K7
(`ops/glue.py`) and the stacks built on them, against the composition the
decoder ran before, bit for bit.

`add_rms_norm_plain`, `qk_norm_rope_kv_plain` and `silu_mul_plain` are what a
CPU tensor runs; each must give the bits of the old `rms_norm` /
`apply_rope` / `index_put_` / `F.silu` code, written out here. The stacks now
carry the MLP's output to the next layer's norm (K5 adds it there); at the
tiny geometry, split and fused layouts, float32 and bf16, plain and int8
weights, `stack_prefill` and `stack_decode` give the old layer loop's hidden
states and caches exactly. A frame calls each glue wrapper as often as its
config implies, and K6 as often as K1. The kernels themselves are held to
these plain versions on the card (tests/test_torch_glue_kernels.py).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.engine import core
from faster_qwen3_tts_tpu_torch.models import layers, predictor, talker
from faster_qwen3_tts_tpu_torch.ops import glue, quant
from faster_qwen3_tts_tpu_torch.ops.attention import decode_attention_plain, prefill_attention, prefill_mask
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams, make_suppress_mask
from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6


# -- the old composition, written out -------------------------------------------------------------

def _old_rms_norm(w, x, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (w.float() * y).to(x.dtype)


def _old_rope(x, cos, sin):
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, :, None, :].float() + rot * sin[:, :, None, :].float()).to(x.dtype)


def _old_qkv(lp, x, shape):
    B, S, _ = x.shape
    qd, kd = shape.num_heads * shape.head_dim, shape.num_kv_heads * shape.head_dim
    if "wqkv" in lp:
        y = quant.dot(x, lp["wqkv"])
        q, k, v = y[..., :qd], y[..., qd:qd + kd], y[..., qd + kd:]
    else:
        q, k, v = quant.dot(x, lp["wq"]), quant.dot(x, lp["wk"]), quant.dot(x, lp["wv"])
    q = q.reshape(B, S, shape.num_heads, shape.head_dim)
    k = k.reshape(B, S, shape.num_kv_heads, shape.head_dim)
    v = v.reshape(B, S, shape.num_kv_heads, shape.head_dim)
    return _old_rms_norm(lp["q_norm"], q, shape.rms_eps), _old_rms_norm(lp["k_norm"], k, shape.rms_eps), v


def _old_mlp(lp, x):
    if "w_gateup" in lp:
        y = quant.dot(x, lp["w_gateup"])
        g, u = y[..., :y.shape[-1] // 2], y[..., y.shape[-1] // 2:]
    else:
        g, u = quant.dot(x, lp["w_gate"]), quant.dot(x, lp["w_up"])
    return quant.dot(F.silu(g.float()).to(x.dtype) * u, lp["w_down"])


def _old_stack_prefill(stack, x, positions, pad_mask, shape, theta, final_norm):
    cos, sin = layers.rope_cos_sin(positions, shape.head_dim, theta)
    mask = prefill_mask(pad_mask)
    ks, vs = [], []
    for lp in layers.unstack_layers(stack):
        q, k, v = _old_qkv(lp, _old_rms_norm(lp["ln1"], x, shape.rms_eps), shape)
        q, k = _old_rope(q, cos, sin), _old_rope(k, cos, sin)
        a = prefill_attention(q, k, v, mask)
        x = x + quant.dot(a.reshape(a.shape[0], a.shape[1], -1), lp["wo"])
        x = x + _old_mlp(lp, _old_rms_norm(lp["ln2"], x, shape.rms_eps))
        ks.append(k)
        vs.append(v)
    return _old_rms_norm(final_norm, x, shape.rms_eps), torch.stack(ks), torch.stack(vs)


def _old_stack_decode(stack, x, pos, rope_pos, kc, vc, length_mask, shape, theta, final_norm):
    cos, sin = layers.rope_cos_sin(rope_pos[:, None], shape.head_dim, theta)
    write_pos = pos.clamp(max=kc.shape[2] - 1)
    rows = torch.arange(x.shape[0])
    for i, lp in enumerate(layers.unstack_layers(stack)):
        q, k, v = _old_qkv(lp, _old_rms_norm(lp["ln1"], x, shape.rms_eps), shape)
        q, k = _old_rope(q, cos, sin), _old_rope(k, cos, sin)
        kc[i][rows, write_pos] = k[:, 0]
        vc[i][rows, write_pos] = v[:, 0]
        a = decode_attention_plain(q, kc[i], vc[i], length_mask)
        x = x + quant.dot(a.reshape(x.shape[0], 1, -1), lp["wo"])
        x = x + _old_mlp(lp, _old_rms_norm(lp["ln2"], x, shape.rms_eps))
    return _old_rms_norm(final_norm, x, shape.rms_eps)


# -- the plain versions ---------------------------------------------------------------------------

def _rand(g, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False], ids=["add", "norm"])
@pytest.mark.parametrize("shape", [(2, 1, 128), (3, 7, 96), (1, 1, 2048)])
def test_plain_add_rms_norm_is_the_old_composition(dtype, residual, shape):
    g = torch.Generator().manual_seed(sum(shape))
    x = _rand(g, *shape, dtype=dtype, scale=3.0)
    r = _rand(g, *shape, dtype=dtype) if residual else None
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g)).to(dtype)
    s, y = glue.add_rms_norm(x, r, w, EPS)
    expect_s = x + r if residual else x
    assert torch.equal(s, expect_s) and torch.equal(y, _old_rms_norm(w, expect_s, EPS))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_add_rms_norm_on_fused_head_views(dtype):
    g = torch.Generator().manual_seed(3)
    y = _rand(g, 2, 5, 8 * 32, dtype=dtype, scale=2.0)
    q = y[..., :4 * 32].reshape(2, 5, 4, 32)  # a column view with the fused row's stride
    w = (1 + 0.1 * torch.randn(32, generator=g)).to(dtype)
    s, out = glue.add_rms_norm(q, None, w, EPS)
    assert s is q and torch.equal(out, _old_rms_norm(w, q, EPS))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_plain_qk_norm_rope_kv_is_the_old_composition(dtype, B, fused):
    g = torch.Generator().manual_seed(B)
    Hq, Hkv, D, S = 4, 2, 32, 9
    if fused:
        y = _rand(g, B, 1, (Hq + 2 * Hkv) * D, dtype=dtype, scale=2.0)
        q, k, v = (y[..., :Hq * D].reshape(B, 1, Hq, D), y[..., Hq * D:(Hq + Hkv) * D].reshape(B, 1, Hkv, D),
                   y[..., (Hq + Hkv) * D:].reshape(B, 1, Hkv, D))
    else:
        q, k, v = (_rand(g, B, 1, H, D, dtype=dtype, scale=2.0) for H in (Hq, Hkv, Hkv))
    qw, kw = ((1 + 0.1 * torch.randn(D, generator=g)).to(dtype) for _ in range(2))
    cos, sin = layers.rope_cos_sin(torch.tensor([[3], [11], [40]])[:B], D, 1e6)
    kc, vc = _rand(g, B, S, Hkv, D, dtype=dtype), _rand(g, B, S, Hkv, D, dtype=dtype)
    ok, ov = kc.clone(), vc.clone()
    wp = torch.tensor([0, 4, S - 1], dtype=torch.int32)[:B]
    out = glue.qk_norm_rope_kv(q, k, v, qw, kw, cos, sin, kc, vc, wp, EPS)
    rows = torch.arange(B)
    expect_q = _old_rope(_old_rms_norm(qw, q, EPS), cos, sin)
    ok[rows, wp] = _old_rope(_old_rms_norm(kw, k, EPS), cos, sin)[:, 0]
    ov[rows, wp] = v[:, 0]
    assert torch.equal(out, expect_q) and torch.equal(kc, ok) and torch.equal(vc, ov)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_plain_silu_mul_is_the_old_composition(dtype, fused):
    g = torch.Generator().manual_seed(5)
    if fused:
        y = _rand(g, 3, 1, 2 * 256, dtype=dtype, scale=4.0)
        gate, up = y[..., :256], y[..., 256:]
    else:
        gate, up = _rand(g, 3, 1, 256, dtype=dtype, scale=4.0), _rand(g, 3, 1, 256, dtype=dtype, scale=4.0)
    assert torch.equal(glue.silu_mul(gate, up), F.silu(gate.float()).to(dtype) * up)


# -- the stacks -----------------------------------------------------------------------------------

def _tree(dtype, mode, fused):
    cfg = tiny_test_config()
    params = weights.materialize(weights.init_numpy(cfg, seed=0), dtype, mode, "cpu")
    return (quant.fuse_layer_weights(params) if fused else params), cfg


STACKS = [(torch.float32, "none", False), (torch.float32, "int8", True), (torch.bfloat16, "int8", False),
          (torch.bfloat16, "int8", True), (torch.bfloat16, "none", True)]
STACK_IDS = ["f32", "f32-int8-fused", "bf16-int8", "bf16-int8-fused", "bf16-fused"]


@pytest.mark.parametrize("dtype, mode, fused", STACKS, ids=STACK_IDS)
@pytest.mark.parametrize("sub", ["talker", "predictor"])
def test_stack_prefill_and_decode_keep_the_old_bits(dtype, mode, fused, sub):
    params, cfg = _tree(dtype, mode, fused)
    lib, scfg = (talker, cfg.talker) if sub == "talker" else (predictor, cfg.predictor)
    shape = lib.layer_shape(scfg)
    stack, final = params[sub]["layers"], params[sub]["final_norm"]
    H = params[sub]["final_norm"].shape[0]
    g = torch.Generator().manual_seed(7)
    B, P, S_max = 2, 5, 12
    x = _rand(g, B, P, H, dtype=dtype)
    pad = torch.ones(B, P, dtype=torch.int32)
    pad[1, :2] = 0
    positions = (torch.arange(P)[None, :] - (1 - pad).sum(-1)[:, None]).clamp(min=0)

    h_new, cache = layers.stack_prefill(stack, x, positions, pad, shape, scfg.rope_theta, final)
    h_old, k_old, v_old = _old_stack_prefill(stack, x, positions, pad, shape, scfg.rope_theta, final)
    assert torch.equal(h_new, h_old) and torch.equal(cache.k, k_old) and torch.equal(cache.v, v_old)

    full = layers.expand_cache(cache, S_max)
    kc, vc = full.k.clone(), full.v.clone()
    for step, pos in enumerate(([P, P], [P + 1, S_max + 3])):  # the second: lane 1 past the end (clamped)
        pos = torch.tensor(pos, dtype=torch.int32)
        rope_pos = pos - (1 - pad).sum(-1).to(torch.int32)
        s_ids = torch.arange(S_max)[None, :]
        mask = ((s_ids <= pos[:, None]) & (s_ids >= (1 - pad).sum(-1)[:, None])).to(torch.int32)
        xt = _rand(g, B, 1, H, dtype=dtype)
        new = layers.stack_decode(stack, xt, pos, rope_pos, full, mask, shape, scfg.rope_theta, final)
        old = _old_stack_decode(stack, xt, pos, rope_pos, kc, vc, mask, shape, scfg.rope_theta, final)
        assert torch.equal(new, old), f"decode step {step}"
        assert torch.equal(full.k, kc) and torch.equal(full.v, vc), f"decode step {step}: caches"


def _frame_glue(t, p, tp=1):
    """Glue calls of one frame of t talker and p predictor layers on tp
    ranks: K6 (and K1) once a rank a decode layer pass (the talker's t, the
    predictor's 14 decode steps of p); K7 once a rank a layer pass, the
    predictor's prefill included; K5 at ln1 and ln2 of every layer pass and
    once a stack call (the replicated hidden state: once), and once a rank
    for each per-head q / k norm of the predictor's prefill."""
    return {"K5": (2 * t + 1) + 15 * (2 * p + 1) + tp * 2 * p, "K6": tp * (t + 14 * p), "K7": tp * (t + 15 * p)}


@pytest.mark.parametrize("tp", [1, 2])
def test_frame_calls_each_glue_wrapper_as_its_config_implies(monkeypatch, tp):
    """At the tiny geometry, unsharded and as one tp = 2 group; K6 as often
    as K1. At the 0.6B depth (28 / 5 layers, tp = 1) the count is K5 232,
    K6 98, K7 103."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, talker=dataclasses.replace(cfg.talker, num_key_value_heads=2),
                              predictor=dataclasses.replace(cfg.predictor, num_key_value_heads=2))
    params = weights.materialize(weights.init_numpy(cfg, seed=0), torch.float32, "none", "cpu")
    if tp > 1:
        mesh = mesh_lib.make_mesh(tp, dp=1, tp=tp, devices=["cpu"] * tp)
        params = mesh_lib.group_params(mesh_lib.shard_params(params, mesh), 0)
    calls = {"K1": 0, "K5": 0, "K6": 0, "K7": 0}

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    for name, attr in (("K1", "decode_attention"), ("K5", "add_rms_norm"), ("K6", "qk_norm_rope_kv"),
                       ("K7", "silu_mul")):
        monkeypatch.setattr(layers, attr, counted(name, getattr(layers, attr)))
    g = torch.Generator().manual_seed(0)
    H = cfg.talker.hidden_size
    state = core.zeros_state(cfg.talker, 1, 32, torch.float32, torch.device("cpu"), torch.Generator(), tp, tp)
    greedy = SamplingParams(do_sample=False)
    core._decode_frame(params["talker"], params["predictor"], cfg.talker, cfg.predictor, state, _rand(g, 1, 4, H),
                       _rand(g, 1, 1, H), greedy, SamplingParams(do_sample=False, repetition_penalty=1.0), 2,
                       make_suppress_mask(cfg.talker.vocab_size, cfg.talker.codec_eos_token_id, "cpu"))
    t, p = cfg.talker.num_hidden_layers, cfg.predictor.num_hidden_layers
    assert {k: calls[k] for k in ("K5", "K6", "K7")} == _frame_glue(t, p, tp)
    assert calls["K6"] == calls["K1"]
    assert _frame_glue(28, 5) == {"K5": 232, "K6": 98, "K7": 103}


def test_glue_wrappers_refuse_tensors_that_are_neither_cpu_nor_cuda():
    before = (glue.add_rms_norm.launches, glue.qk_norm_rope_kv.launches, glue.silu_mul.launches)
    meta = torch.device("meta")
    x = torch.empty(2, 1, 64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        glue.add_rms_norm(x, x, torch.empty(64, device=meta), EPS)
    with pytest.raises(ValueError, match="CUDA"):
        glue.silu_mul(x, x)
    q = torch.empty(2, 1, 4, 32, device=meta)
    k = torch.empty(2, 1, 2, 32, device=meta)
    cache = torch.empty(2, 8, 2, 32, device=meta)
    cos = torch.empty(2, 1, 32, device=meta)
    w = torch.empty(32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        glue.qk_norm_rope_kv(q, k, k, w, w, cos, cos, cache, cache,
                             torch.zeros(2, dtype=torch.int32, device=meta), EPS)
    assert (glue.add_rms_norm.launches, glue.qk_norm_rope_kv.launches, glue.silu_mul.launches) == before


def test_codec_keeps_the_plain_norm_and_rope():
    """The codec runs in float32 under its audio limit and stays on the plain
    `rms_norm` / `apply_rope`, not on the decoder's kernels."""
    from faster_qwen3_tts_tpu_torch.models import codec

    assert codec.rms_norm is glue.rms_norm and codec.apply_rope is glue.apply_rope
    assert not hasattr(codec, "add_rms_norm") and not hasattr(codec, "qk_norm_rope_kv")
