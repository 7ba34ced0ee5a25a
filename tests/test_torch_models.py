"""Port models (talker, code predictor, codec) against the JAX package's, on
the same weights (`params_from_numpy` of the JAX init) and numpy inputs.

Float32 at the tiny test geometry. Hidden states and logits: atol 1e-4 /
rtol 1e-4 (f32 sums in another order, through several layers); greedy
tokens: exactly equal; codec waveform: atol 1e-4 (it also pins the
transposed-conv orientation, which is off by O(1) when wrong).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.models import codec as jax_codec
from faster_qwen3_tts_tpu.models import layers as jax_layers
from faster_qwen3_tts_tpu.models import predictor as jax_predictor
from faster_qwen3_tts_tpu.models import talker as jax_talker
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.models import codec, layers, predictor, talker
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


def _trees(cfg, quant):
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    if quant:
        host = jax_quant.quantize_model_params(host, "int8")
    return jax.device_put(host), weights.params_from_numpy(host, device="cpu")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sliding", [False, True], ids=["full", "sliding"])
def test_talker_prefill_and_decode_step(tiny_config, quant, sliding):
    tcfg = tiny_config.talker
    if sliding:
        tcfg = dataclasses.replace(tcfg, sliding_window=3, layer_types=("full_attention", "sliding_attention"))
    cfg = dataclasses.replace(tiny_config, talker=tcfg)
    jparams, port = _trees(cfg, quant)
    rng = np.random.default_rng(0)
    B, P, S_max, H = 2, 6, 12, tcfg.hidden_size
    embeds = rng.standard_normal((B, P, H)).astype(np.float32)
    pad = np.ones((B, P), np.int32)
    pad[1, :2] = 0

    j_last, j_logits, j_cache = jax_talker.prefill(jparams["talker"], tcfg, jnp.asarray(embeds), jnp.asarray(pad))
    p_last, p_logits, p_cache = talker.prefill(port["talker"], tcfg, torch.tensor(embeds), torch.tensor(pad))
    _close(p_last, j_last)
    _close(p_logits, j_logits)
    _close(p_cache.k, j_cache.k)

    # one decode step at pos P against the expanded cache
    def expand(c):
        full = np.zeros(c.shape[:2] + (S_max,) + c.shape[3:], np.float32)
        full[:, :, :P] = np.asarray(c)
        return full

    jk, jv = expand(j_cache.k), expand(j_cache.v)
    x = rng.standard_normal((B, 1, H)).astype(np.float32)
    pos = np.full((B,), P, np.int32)
    num_pads = pad.shape[1] - pad.sum(-1)
    s = np.arange(S_max)[None, :]
    mask = ((s <= pos[:, None]) & (s >= num_pads[:, None])).astype(np.int32)
    j_h, j_new = jax_talker.decode_step(
        jparams["talker"], tcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(pos - num_pads),
        jax_layers.KVCache(jnp.asarray(jk), jnp.asarray(jv)), jnp.asarray(mask),
    )
    cache = layers.KVCache(torch.tensor(jk), torch.tensor(jv))
    p_h = talker.decode_step(
        port["talker"], tcfg, torch.tensor(x), torch.tensor(pos),
        torch.tensor((pos - num_pads).astype(np.int32)), cache, torch.tensor(mask),
    )
    _close(p_h, j_h)
    _close(cache.k, j_new.k)  # written in place at pos
    _close(cache.v, j_new.v)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_predictor_greedy_tokens(tiny_config, quant):
    jparams, port = _trees(tiny_config, quant)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, tiny_config.talker.hidden_size)).astype(np.float32)
    ref = jax_predictor.predict_codebooks(
        jparams["predictor"], tiny_config.predictor, jnp.asarray(x), jax.random.PRNGKey(0),
        JaxSamplingParams(do_sample=False),
    )
    out = predictor.predict_codebooks(
        port["predictor"], tiny_config.predictor, torch.tensor(x), SamplingParams(do_sample=False)
    )
    assert out.shape == (3, 15) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    codes = rng.integers(0, 2048, (3, 15)).astype(np.int32)
    _close(predictor.embed_frame_sum(port["predictor"], torch.tensor(codes)),
           jax_predictor.embed_frame_sum(jparams["predictor"], jnp.asarray(codes)), atol=1e-6, rtol=1e-5)


def test_codec_decode_frames(tiny_config):
    jparams, port = _trees(tiny_config, False)
    codes = np.random.default_rng(2).integers(0, 2048, (2, 5, 16)).astype(np.int32)
    ref = jax_codec.decode_frames(jparams["codec"], tiny_config.codec, jnp.asarray(codes))
    out = codec.decode_frames(port["codec"], tiny_config.codec, torch.tensor(codes))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
