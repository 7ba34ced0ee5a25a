"""Port ops against the JAX package's ops, on the same numpy inputs.

Float32 throughout; tolerances atol 1e-5 / rtol 1e-5 (different summation
orders of f32 sums). On the CPU the K1 and K2 wrappers run the plain versions
tested below; the kernels themselves are tested in test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu.models import layers as jax_layers
from faster_qwen3_tts_tpu.ops import attention as jax_attn
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.ops import sampling as jax_sampling
from faster_qwen3_tts_tpu_torch.models import layers
from faster_qwen3_tts_tpu_torch.ops import attention, quant, sampling

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), _np(ref), **(tol or TOL))


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(layers.rms_norm(torch.tensor(w), torch.tensor(x), 1e-6),
           jax_layers.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6))
    pos = np.array([[0, 1, 2, 3, 4], [0, 0, 0, 1, 2]], np.int32)
    cos, sin = layers.rope_cos_sin(torch.tensor(pos), 16, 1_000_000.0)
    jcos, jsin = jax_layers.rope_cos_sin(jnp.asarray(pos), 16, 1_000_000.0)
    _close(cos, jcos)
    _close(sin, jsin)
    _close(layers.apply_rope(torch.tensor(x), cos, sin), jax_layers.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("window", [None, 3])
def test_prefill_attention(window):
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv, D = 2, 7, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))
    pad = np.ones((B, S), np.int32)
    pad[1, :3] = 0  # left pads
    mask = attention.prefill_mask(torch.tensor(pad), window)
    jmask = jax_attn.prefill_mask(jnp.asarray(pad), window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _close(attention.prefill_attention(*(torch.tensor(a) for a in (q, k, v)), mask),
           jax_attn.prefill_attention(*(jnp.asarray(a) for a in (q, k, v)), jmask))


@pytest.mark.parametrize(
    "S, lo, hi",
    [(40, 0, 9), (40, 6, 23), (40, 11, 40), (17, 0, 3), (17, 0, 17)],
    ids=["prefix", "left-pads", "hi-at-S_max", "predictor-start", "predictor-full"],
)
def test_decode_attention_plain(S, lo, hi):
    rng = np.random.default_rng(2)
    B, Hq, Hkv, D = 2, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    s = np.arange(S)
    mask = np.stack([(s >= lo) & (s < hi), (s >= max(lo - 1, 0)) & (s < hi)]).astype(np.int32)
    args = (q, k, v, mask)
    port = attention.decode_attention(*(torch.tensor(a) for a in args))  # CPU -> plain version
    _close(port, jax_attn.decode_attention(*(jnp.asarray(a) for a in args)))
    assert attention.decode_attention.launches == 0


@pytest.mark.parametrize("rows", [1, 2, 16, 17, 40])
def test_quant_dot(rows):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, rows, 48)).astype(np.float32)
    w = rng.standard_normal((48, 80)).astype(np.float32)
    _close(quant.dot(torch.tensor(x), torch.tensor(w)), jax_quant.dot(jnp.asarray(x), jnp.asarray(w)))
    jq = jax_quant.quantize_linear(w)
    pq = quant.quantize_linear(w)
    np.testing.assert_array_equal(pq.q, jq.q)
    np.testing.assert_array_equal(pq.scale, jq.scale)
    port_w = quant.QuantizedLinear(torch.tensor(pq.q), torch.tensor(pq.scale))
    jax_w = jax_quant.QuantizedLinear(jnp.asarray(jq.q), jnp.asarray(jq.scale))
    _close(quant.dot(torch.tensor(x), port_w), jax_quant.dot(jnp.asarray(x), jax_w), atol=1e-4, rtol=1e-5)


def test_repetition_penalty_and_suppress_mask():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 3072)).astype(np.float32)
    seen = rng.random((2, 3072)) < 0.1
    _close(sampling.apply_repetition_penalty(torch.tensor(logits), torch.tensor(seen), 1.05),
           jax_sampling.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), 1.05))
    np.testing.assert_array_equal(sampling.make_suppress_mask(3072, 2150).numpy(),
                                  np.asarray(jax_sampling.make_suppress_mask(3072, 2150)))


@pytest.mark.parametrize(
    "params",
    [
        dict(do_sample=False),
        dict(do_sample=True, top_k=50, temperature=0.9),
        dict(do_sample=True, top_k=50, top_p=0.8, temperature=0.7),
    ],
    ids=["greedy", "top-k-50", "top-k-top-p"],
)
def test_sample_logits_with_shared_gumbel_noise(params):
    V, B = 3072, 4
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[:, 2150] += 8.0  # a strong EOS that the extra mask must hide
    logits[0, 100] = logits[0, 101] = logits[0, 102] = 20.0  # ties at the top
    suppress = np.asarray(jax_sampling.make_suppress_mask(V, 2150))
    extra = np.zeros((B, V), bool)
    extra[:, 2150] = True
    key = jax.random.PRNGKey(7)
    jp = jax_sampling.SamplingParams(**params)
    ref = jax_sampling.sample_logits(key, jnp.asarray(logits), jp, jnp.asarray(suppress), jnp.asarray(extra))
    noise = np.asarray(jax.random.gumbel(key, (B, V)), np.float32)
    port = sampling.sample_logits(
        torch.tensor(logits), sampling.SamplingParams(**params), torch.tensor(suppress),
        torch.tensor(extra), noise=torch.tensor(noise),
    )
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert not np.isin(port.numpy(), np.flatnonzero(suppress | extra[0])).any()


def test_sample_logits_from_generator_is_seeded():
    logits = torch.randn(3, 2048, generator=torch.Generator().manual_seed(0))
    p = sampling.SamplingParams()
    a = sampling.sample_logits(logits, p, generator=torch.Generator().manual_seed(11))
    b = sampling.sample_logits(logits, p, generator=torch.Generator().manual_seed(11))
    assert torch.equal(a, b) and a.dtype == torch.int32
    # top-k 50: every draw stays inside the 50 largest logits
    top50 = torch.topk(logits, 50, dim=-1).indices
    assert all(int(a[i]) in top50[i].tolist() for i in range(3))
    g = sampling.gumbel_noise((200_000,), torch.Generator().manual_seed(1), torch.device("cpu"))
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01  # Euler-Mascheroni constant
