"""Port engine (start_state, decode_chunk, window vocode) against the JAX
engine on the same weights, greedy, float32, tiny geometry.

Frames, valid and done flags must be exactly equal; prefill logits and
audio agree at atol 1e-4 (f32 sums in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import core as jax_core
from faster_qwen3_tts_tpu.engine import fused_stream as jax_fused
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import core, fused_stream
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

torch.set_num_threads(1)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_start_state_and_three_chunks_match_jax(tiny_config, quant):
    host = jax_weights.init_all(tiny_config, seed=4, dtype=jnp.float32, device_put=False)
    if quant:
        host = jax_quant.quantize_model_params(host, "int8")
    jparams, port = jax.device_put(host), weights.params_from_numpy(host)
    rng = np.random.default_rng(0)
    H = tiny_config.talker.hidden_size
    B, P, T = 2, 8, 5
    embeds = (rng.standard_normal((B, P, H)) * 0.5).astype(np.float32)
    pad = np.ones((B, P), np.int32)
    pad[1, :3] = 0  # left-padded row
    embeds[1, :3] = 0.0
    tth = (rng.standard_normal((B, T, H)) * 0.5).astype(np.float32)
    tpe = (rng.standard_normal((1, 1, H)) * 0.5).astype(np.float32)
    # max_seq 19: the length bound ends both streams inside the third chunk
    max_seq, min_new, chunk = 19, 3, 4
    greedy = dict(do_sample=False, repetition_penalty=1.05)
    js, jps = JaxSamplingParams(**greedy), JaxSamplingParams(do_sample=False, repetition_penalty=1.0)
    ps, pps = SamplingParams(**greedy), SamplingParams(do_sample=False, repetition_penalty=1.0)

    jstate, jlogits = jax_core.start_state(
        jparams["talker"], tiny_config.talker, jnp.asarray(embeds), jnp.asarray(pad),
        jax.random.PRNGKey(0), max_seq, js, min_new,
    )
    pstate, plogits = core.start_state(
        port["talker"], tiny_config.talker, torch.tensor(embeds), torch.tensor(pad), None,
        max_seq, ps, min_new,
    )
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(pstate.token.numpy(), np.asarray(jstate.token))

    for i in range(3):
        jstate, jpacked = jax_core.decode_chunk(
            jparams["talker"], jparams["predictor"], tiny_config.talker, tiny_config.predictor,
            jstate, jnp.asarray(tth), jnp.asarray(tpe), chunk, js, jps, min_new,
        )
        pstate, ppacked = core.decode_chunk(
            port["talker"], port["predictor"], tiny_config.talker, tiny_config.predictor,
            pstate, torch.tensor(tth), torch.tensor(tpe), chunk, ps, pps, min_new,
        )
        assert ppacked.dtype == torch.int32 and ppacked.shape == (chunk, B, 18)
        np.testing.assert_array_equal(ppacked.numpy(), np.asarray(jpacked), err_msg=f"chunk {i}")
    assert ppacked[-1, :, -1].tolist() == [1, 1]  # both streams done
    assert ppacked[:, :, -2].sum().item() < chunk * B  # and their last frames masked
    np.testing.assert_array_equal(pstate.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(pstate.n_frames.numpy(), np.asarray(jstate.n_frames))


@pytest.mark.parametrize("ctx", [0, 4])
def test_vocode_window_matches_jax(tiny_config, ctx):
    host = jax_weights.init_all(tiny_config, seed=6, dtype=jnp.float32, device_put=False)
    jparams, port = jax.device_put(host), weights.params_from_numpy(host)
    rng = np.random.default_rng(1)
    chunk, up = 3, tiny_config.codec.total_upsample
    packed = np.concatenate(
        [rng.integers(0, 2048, (chunk, 1, 16)), np.ones((chunk, 1, 2), np.int64)], axis=-1
    ).astype(np.int32)
    hist = rng.integers(0, 2048, (1, max(ctx, 1), 16)).astype(np.int32)
    _, flat = jax_fused._vocode_window(
        jparams["codec"], tiny_config.talker, tiny_config.codec, jnp.asarray(hist),
        jnp.asarray(packed), chunk, ctx,
    )
    flat = np.asarray(flat)
    audio = fused_stream._vocode_window(
        port["codec"], tiny_config.talker, tiny_config.codec, torch.tensor(hist),
        torch.tensor(packed), chunk, ctx,
    )
    D = fused_stream.codec_deficit(tiny_config.codec)
    assert D == jax_fused.codec_deficit(tiny_config.codec)
    np.testing.assert_allclose(audio.numpy().reshape(-1), flat[: chunk * up], atol=1e-4, rtol=0)
    if ctx == 0:  # the first window is D samples short, zero-padded
        assert int(flat[-1]) == chunk * up - D and not audio[0, chunk * up - D :].any()
