"""ICL voice clone through the port's public API against the JAX model on the
same weights: tiny geometry, float32, greedy talker and code predictor.

Prompts agree at 1e-5, token frames exactly, audio at atol 1e-4 with equal
lengths. The cases follow tests/test_icl_streaming.py: a 30-frame reference
(>= 24 frames: every chunk vocoded on the device), a 12-frame reference (host
prepend until 24 frames were generated), non-streaming, and a reference
recording read from a wav file."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.utils import audio as audio_lib
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

torch.set_num_threads(1)
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=3)
REF_TEXT = "reference words"


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = dataclasses.replace(
        tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302
    )
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=160)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=160)
    return jax_model, port


def _icl_prompt(frames, seed):
    rng = np.random.default_rng(seed)
    return {
        "ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
        "x_vector_only_mode": [False],
        "icl_mode": [True],
        "ref_code": [rng.integers(0, 2048, (frames, 16)).astype(np.int32)],
    }


def _stream(model, text, **kw):
    """-> (token frames, [(audio, sr, timing), ...]) of one streaming call."""
    frames = []
    relay = model._stream_decode

    def tap(stream, *args):
        def recorded():
            for item in stream:
                frames.append(np.asarray(item[0]))
                yield item

        return relay(recorded(), *args)

    model._stream_decode = tap
    try:
        chunks = list(model.generate_voice_clone_streaming(text, "English", **kw))
    finally:
        model._stream_decode = relay
    return np.concatenate(frames), chunks


def _assert_streams_equal(out, ref):
    (frames, chunks), (jframes, jchunks) = out, ref
    np.testing.assert_array_equal(frames, jframes)
    assert len(chunks) == len(jchunks)
    for (a, sr, t), (ja, jsr, jt) in zip(chunks, jchunks):
        assert sr == jsr == 24000
        assert a.dtype == np.float32 and a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
        for key in ("chunk_index", "chunk_steps", "total_steps_so_far", "is_final"):
            assert t[key] == jt[key], key


@pytest.mark.parametrize("non_streaming_mode", [False, True], ids=["streaming", "non_streaming"])
def test_icl_prompt_build_matches_jax(models, non_streaming_mode):
    jax_model, port = models
    prompt = _icl_prompt(20, seed=5)
    input_ids = [port.tokenizer.assistant_ids("Prompt layout text.")]
    ref_ids = [port.tokenizer.ref_ids(REF_TEXT)]
    kw = dict(input_ids=input_ids, ref_ids=ref_ids, voice_clone_prompt=prompt, languages=["English"],
              speakers=None, non_streaming_mode=non_streaming_mode, instruct_ids=[None])
    ref = jax_model.prompt_builder.build(**kw)
    out = port.prompt_builder.build(**kw)
    again = port.prompt_builder.build(**kw)  # from the reference-prompt cache
    assert len(port.prompt_builder._ref_prompt_cache) >= 1
    for a, b, c in zip(out, ref, again):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("ref_frames", [30, 12], ids=["fused_30f", "host_prepend_12f"])
def test_icl_stream_matches_jax(models, ref_frames):
    jax_model, port = models
    kw = dict(ref_text=REF_TEXT, voice_clone_prompt=_icl_prompt(ref_frames, seed=ref_frames),
              max_new_tokens=40, chunk_size=8, first_chunk_size=4, **GREEDY)
    out = _stream(port, "icl streaming text", **kw)
    _assert_streams_equal(out, _stream(jax_model, "icl streaming text", **kw))
    frames, chunks = out
    up = port.config.codec.total_upsample
    samples = sum(a.size for a, _, _ in chunks)
    if ref_frames >= 24:  # window emission: exactly the generated frames' samples
        assert samples == frames.shape[0] * up
    else:  # proportional cut of the prepended reference
        assert abs(samples - frames.shape[0] * up) <= 2 * up


def test_icl_non_streaming_matches_jax(models, monkeypatch):
    """generate_voice_clone with the non-streaming ICL prompt layout; the
    predictor is made greedy on both sides (the public method does not
    expose its sampling)."""
    jax_model, port = models
    jax_sampling, port_sampling = jax_gen.predictor_sampling, gen.predictor_sampling
    monkeypatch.setattr(jax_gen, "predictor_sampling", lambda *a: jax_sampling(False))
    monkeypatch.setattr(gen, "predictor_sampling", lambda *a: port_sampling(False))
    prompt = _icl_prompt(16, seed=6)
    kw = dict(ref_text=REF_TEXT, voice_clone_prompt=prompt, max_new_tokens=20, do_sample=False,
              non_streaming_mode=True, seed=3)
    (ja,), jsr = jax_model.generate_voice_clone("non streaming icl", "English", **kw)
    (a,), sr = port.generate_voice_clone("non streaming icl", "English", **kw)
    assert sr == jsr == 24000 and a.dtype == np.float32 and a.shape == ja.shape
    np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
    # the reference's share of the samples is cut off: about 20 frames remain
    assert abs(a.size - 20 * port.config.codec.total_upsample) <= 2 * port.config.codec.total_upsample


@pytest.mark.parametrize("xvec_only", [False, True], ids=["icl", "xvec_only"])
def test_ref_audio_stream_matches_jax(models, tmp_path, xvec_only):
    """ref_audio + ref_text from a wav file: extraction, prompt and stream;
    a second request for the voice comes from the voice-prompt cache."""
    jax_model, port = models
    rng = np.random.default_rng(11)
    t = np.arange(24000) / 24000
    clip = 0.3 * np.sin(2 * np.pi * 180.0 * t) + 0.05 * rng.standard_normal(t.size)
    path = tmp_path / "ref.wav"
    audio_lib.write_wav(path, clip.astype(np.float32), 24000)
    kw = dict(ref_audio=str(path), ref_text=REF_TEXT, xvec_only=xvec_only, max_new_tokens=30,
              chunk_size=8, first_chunk_size=4, **GREEDY)
    out = _stream(port, "from a recording", **kw)
    _assert_streams_equal(out, _stream(jax_model, "from a recording", **kw))
    key = (str(path), REF_TEXT, xvec_only, True)
    vcp, _ = port._voice_prompt_cache[key]
    assert (vcp["ref_code"][0] is None) == xvec_only
    if not xvec_only:  # 1.0 s + 0.5 s of appended silence
        assert vcp["ref_code"][0].shape == (19, 16)

    def no_extraction():
        raise AssertionError("the cached voice was extracted again")

    port._get_voice_extractor = no_extraction
    try:
        again = _stream(port, "from a recording", **kw)
    finally:
        del port._get_voice_extractor
    np.testing.assert_array_equal(again[0], out[0])
