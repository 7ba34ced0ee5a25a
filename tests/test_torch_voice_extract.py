"""The port's reference-audio encoders against the JAX package's on the same
weights and inputs: tiny codec geometry, default ECAPA widths, float32.

Weights are equal leaf for leaf; mel 1e-5, x-vectors and latents 1e-4
(f32 sums in another order); RVQ codes exactly equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.models import voice_extract as vx
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.models import voice_extract as pvx

torch.set_num_threads(1)


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], f"{prefix}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, node


def _clip(secs, seed=0, sr=24000):
    """A seeded synthetic recording: two tones plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * secs)) / sr
    wave = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1330.0 * t)
    return (wave + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def encoders(tiny_config):
    """(JAX trees, port trees) of the two encoders, as VoiceExtractor draws them."""
    jtree = {"speaker_encoder": vx.init_speaker_params(7, tiny_config.speaker_encoder),
             "codec_encoder": vx.init_encoder_params(8, tiny_config.codec)}
    return jtree, weights.params_from_numpy(jtree, device="cpu")


@pytest.mark.parametrize("name", ["speaker_encoder", "codec_encoder"])
def test_encoder_init_matches_jax(tiny_config, encoders, name):
    jtree, port = encoders
    mine = (weights.init_speaker_encoder(7, tiny_config.speaker_encoder) if name == "speaker_encoder"
            else weights.init_codec_encoder(8, tiny_config.codec))
    jleaves, leaves = list(_leaves(jtree[name])), list(_leaves(mine))
    assert [k for k, _ in leaves] == [k for k, _ in jleaves]
    for (key, a), (_, b) in zip(leaves, jleaves):
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    converted = weights.params_from_numpy({name: mine}, device="cpu")[name]
    for (key, a), (_, b) in zip(_leaves(converted), _leaves(port[name])):
        assert torch.equal(a, b), key
    if name == "codec_encoder":
        assert weights.encoder_dims(tiny_config.codec) == vx.encoder_dims(tiny_config.codec)


@pytest.mark.parametrize("sr", [16000, 24000])
def test_mel_matches_jax(sr):
    audio = _clip(0.8, seed=1, sr=sr)
    np.testing.assert_allclose(pvx.mel_spectrogram(audio, sr), vx.mel_spectrogram(audio, sr),
                               atol=1e-5, rtol=0)


def test_speaker_forward_matches_jax_at_two_buckets(tiny_config, encoders):
    jtree, port = encoders
    mel = vx.mel_spectrogram(_clip(0.75, seed=2), 24000)
    T = mel.shape[0]
    outs = []
    for bucket in (128, 256):
        padded = np.zeros((1, bucket, mel.shape[1]), np.float32)
        padded[0, :T] = mel
        mask = np.zeros((1, bucket), np.float32)
        mask[0, :T] = 1.0
        ref = np.asarray(vx.speaker_forward(jtree["speaker_encoder"], tiny_config.speaker_encoder,
                                            jnp.asarray(padded), jnp.asarray(mask)))
        out = pvx.speaker_forward(port["speaker_encoder"], tiny_config.speaker_encoder,
                                  torch.from_numpy(padded), torch.from_numpy(mask)).numpy()
        assert out.shape == (1, tiny_config.speaker_encoder.embedding_dim)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
        outs.append(out)
    # bucket padding leaves the embedding unchanged
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4, rtol=1e-4)


def test_encode_latents_and_rvq_match_jax(tiny_config, encoders):
    jtree, port = encoders
    ccfg = tiny_config.codec
    host = jax_weights.init_all(tiny_config, seed=0, dtype=jnp.float32, device_put=False)
    audio = _clip(32 * ccfg.total_upsample / 24000, seed=3)[None]
    ref = np.array(vx.encode_latents(jtree["codec_encoder"], ccfg, jnp.asarray(audio[..., None])))
    out = pvx.encode_latents(port["codec_encoder"], ccfg, torch.from_numpy(audio)).numpy()
    assert out.shape == ref.shape == (1, 32, ccfg.hidden_size)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    code_embed = host["codec"]["code_embed"]
    jcodes = np.asarray(vx._rvq_encode(jnp.asarray(code_embed), jnp.asarray(ref), ccfg.num_quantizers,
                                       ccfg.codebook_size))
    codes = pvx.rvq_encode(torch.from_numpy(code_embed), torch.from_numpy(ref), ccfg.num_quantizers,
                           ccfg.codebook_size).numpy()
    assert codes.dtype == np.int32 and codes.shape == (1, 32, ccfg.num_quantizers)
    np.testing.assert_array_equal(codes, jcodes)


@pytest.mark.parametrize("secs", [0.6, 1.9], ids=["mel64", "mel256"])
def test_extractor_end_to_end_matches_jax(tiny_config, secs):
    """VoiceExtractor from the model trees alone: the encoders are drawn
    lazily on both sides, then the x-vector and the codes of one clip."""
    host = jax_weights.init_all(tiny_config, seed=0, dtype=jnp.float32, device_put=False)
    jx = vx.VoiceExtractor(jax.device_put(host), tiny_config)
    px = pvx.VoiceExtractor(weights.params_from_numpy(host, device="cpu"), tiny_config)
    audio = _clip(secs, seed=4)
    xvec = px.extract_xvector(audio, 24000)
    assert xvec.shape == (2048,) and xvec.dtype == np.float32
    np.testing.assert_allclose(xvec, jx.extract_xvector(audio, 24000), atol=1e-4, rtol=1e-4)
    codes = px.extract_codes(audio, 24000)
    assert codes.dtype == np.int32 and codes.shape == (round(secs * 12.5), 16)
    np.testing.assert_array_equal(codes, jx.extract_codes(audio, 24000))
