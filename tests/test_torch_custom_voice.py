"""CustomVoice and VoiceDesign through the port's public API against the JAX
model on the same weights: tiny geometry, float32, greedy talker and code
predictor.

The preset speakers are those of tests/test_model_api.py ("aiden", and
"dylan", who speaks the Beijing dialect). Prompts agree at 1e-5, token frames
exactly, audio at atol 1e-4 with equal lengths."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import faster_qwen3_tts_tpu.config as config_mod
from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

torch.set_num_threads(1)
INSTRUCT = "Speak slowly, in a calm and warm low voice."
DESIGN = "A bright young voice, quick and cheerful, with clear diction."
TEXT = "Custom voice text."
STREAM = dict(max_new_tokens=30, chunk_size=8, first_chunk_size=4, do_sample=False, seed=3)
METHODS = ["generate_custom_voice", "generate_custom_voice_streaming", "generate_voice_design",
           "generate_voice_design_streaming"]


@pytest.fixture(scope="module")
def make(tiny_config):
    """(model_type, model_size) -> (JAX model, port model), on one host tree."""
    cfg0 = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301,
                               tts_pad_token_id=302)
    host = jax_weights.init_all(cfg0, seed=0, dtype=jnp.float32, device_put=False)
    jax_params, port_params = jax.device_put(host), weights.params_from_numpy(host, device="cpu")
    built = {}

    def build(model_type, size="1b7"):
        if (model_type, size) not in built:
            cfg = dataclasses.replace(cfg0, model_type=model_type, model_size=size)
            if model_type == "custom_voice":
                cfg = dataclasses.replace(cfg, talker=dataclasses.replace(
                    cfg.talker,
                    spk_id=config_mod._freeze({"aiden": 2180, "dylan": 2182}),
                    spk_is_dialect=config_mod._freeze({"aiden": False, "dylan": "beijing_dialect"}),
                ))
            jax_model = JaxTTS(jax_params, cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=160)
            jax_model._warmed_up = True
            port = FasterQwen3TTS(port_params, cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=160)
            built[model_type, size] = (jax_model, port)
        return built[model_type, size]

    return build


@pytest.fixture
def greedy_predictor(monkeypatch):
    """The CustomVoice / VoiceDesign methods leave the code predictor
    sampling; make it greedy on both sides so the tokens are comparable."""
    jax_sampling, port_sampling = jax_gen.predictor_sampling, gen.predictor_sampling
    monkeypatch.setattr(jax_gen, "predictor_sampling", lambda *a: jax_sampling(False))
    monkeypatch.setattr(gen, "predictor_sampling", lambda *a: port_sampling(False))


class _PromptBuilt(Exception):
    pass


def _prompt_of(model, method, *args, **kw):
    """Call a public method until its prompt is built -> (prompt arrays, the
    instruct it was built with)."""
    seen = {}
    build = model._prepare_generation_custom

    def spy(*a, **k):
        seen["instruct"] = k.get("instruct")
        seen["prompt"] = build(*a, **k)
        raise _PromptBuilt

    model._prepare_generation_custom = spy
    try:
        with pytest.raises(_PromptBuilt):
            out = getattr(model, method)(*args, **kw)
            if inspect.isgenerator(out):
                next(out)
    finally:
        del model._prepare_generation_custom
    return [np.asarray(a) for a in seen["prompt"]], seen["instruct"]


PROMPT_CASES = {
    "plain_speaker": ("custom_voice", "1b7", "generate_custom_voice", (TEXT, "aiden", "English"), {}),
    "dialect_chinese": ("custom_voice", "1b7", "generate_custom_voice_streaming",
                        (TEXT, "dylan", "Chinese"), {}),
    "dialect_auto": ("custom_voice", "1b7", "generate_custom_voice", (TEXT, "Dylan", "Auto"), {}),
    "dialect_step_fed": ("custom_voice", "1b7", "generate_custom_voice_streaming",
                         (TEXT, "dylan", "Chinese"), {"non_streaming_mode": False}),
    "instruct_1b7": ("custom_voice", "1b7", "generate_custom_voice_streaming",
                     (TEXT, "aiden", "English"), {"instruct": INSTRUCT}),
    "instruct_0b6": ("custom_voice", "0b6", "generate_custom_voice", (TEXT, "aiden", "English"),
                     {"instruct": INSTRUCT}),
    "voice_design": ("voice_design", "1b7", "generate_voice_design", (TEXT, DESIGN, "English"), {}),
    "voice_design_auto": ("voice_design", "1b7", "generate_voice_design_streaming",
                          (TEXT, DESIGN, "Auto"), {}),
}


@pytest.mark.parametrize("case", list(PROMPT_CASES))
def test_prompt_matches_jax(make, case):
    model_type, size, method, args, kw = PROMPT_CASES[case]
    jax_model, port = make(model_type, size)
    out, instruct = _prompt_of(port, method, *args, **kw)
    _, jinstruct = _prompt_of(jax_model, method, *args, **kw)
    assert instruct == jinstruct
    # the JAX package's host builder, with what its public method resolved
    # (its streaming-layout requests take a device builder that pads to a bucket)
    ref = jax_model._prepare_generation_custom(
        args[0], args[2], None if model_type == "voice_design" else args[1], instruct=jinstruct,
        non_streaming_mode=kw.get("non_streaming_mode", True), prefer_device=False)
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_instruct_kept_at_1b7_and_dropped_at_0b6(make):
    """`tts_model_size in "0b6"` drops a CustomVoice instruction; the
    prompt then equals the one without it."""
    for size, kept in (("1b7", True), ("0b6", False)):
        _, port = make("custom_voice", size)
        with_instruct, instruct = _prompt_of(port, "generate_custom_voice", TEXT, "aiden", "English",
                                             instruct=INSTRUCT)
        without, _ = _prompt_of(port, "generate_custom_voice", TEXT, "aiden", "English")
        assert (instruct == INSTRUCT) == kept
        longer = with_instruct[0].shape[1] - without[0].shape[1]
        assert longer == (len(port.tokenizer.instruct_ids(INSTRUCT).reshape(-1)) if kept else 0)


def test_dialect_speaker_takes_the_dialect_language_id(make):
    """Dylan asked for Chinese or Auto gets the Beijing-dialect language id
    in the think prefix; asked for English, English. A speaker without a
    dialect asked for Auto keeps the nothink prefix."""
    _, port = make("custom_voice")
    tc = port.config.talker
    pb = port.prompt_builder
    for lang in ("Chinese", "Auto"):
        block = pb._item_codec_block(0, lang, "dylan", None)
        np.testing.assert_array_equal(block[2], pb._codec_embed([tc.codec_language_id["beijing_dialect"]])[0])
        np.testing.assert_array_equal(block[0], pb._codec_embed([tc.codec_think_id])[0])
    english = pb._item_codec_block(0, "English", "dylan", None)
    np.testing.assert_array_equal(english[2], pb._codec_embed([tc.codec_language_id["english"]])[0])
    auto = pb._item_codec_block(0, "Auto", "aiden", None)  # no dialect: the nothink prefix
    assert auto.shape[0] == english.shape[0] - 1
    np.testing.assert_array_equal(auto[0], pb._codec_embed([tc.codec_nothink_id])[0])


def _stream(model, method, *args, **kw):
    frames = []
    relay = model._stream_decode

    def tap(stream, *a):
        def recorded():
            for item in stream:
                frames.append(np.asarray(item[0]))
                yield item

        return relay(recorded(), *a)

    model._stream_decode = tap
    try:
        chunks = list(getattr(model, method)(*args, **kw))
    finally:
        del model._stream_decode
    return np.concatenate(frames), chunks


STREAM_CASES = {
    "custom_voice_dialect": ("custom_voice", "generate_custom_voice_streaming", (TEXT, "dylan", "Chinese"),
                             {"instruct": INSTRUCT}),
    "custom_voice_step_fed": ("custom_voice", "generate_custom_voice_streaming",
                              (TEXT, "aiden", "English"), {"non_streaming_mode": False}),
    "voice_design": ("voice_design", "generate_voice_design_streaming", (TEXT, DESIGN, "English"), {}),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streaming_matches_jax(make, greedy_predictor, case):
    model_type, method, args, kw = STREAM_CASES[case]
    jax_model, port = make(model_type)
    frames, chunks = _stream(port, method, *args, **kw, **STREAM)
    jframes, jchunks = _stream(jax_model, method, *args, **kw, **STREAM)
    np.testing.assert_array_equal(frames, jframes)
    assert frames.shape[0] == STREAM["max_new_tokens"]  # no early EOS: every chunk is compared
    assert len(chunks) == len(jchunks)
    for (a, sr, t), (ja, jsr, jt) in zip(chunks, jchunks):
        assert sr == jsr == 24000
        assert a.dtype == np.float32 and a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
        assert set(t) == set(jt)
        for key in ("chunk_index", "chunk_steps", "total_steps_so_far", "is_final"):
            assert t[key] == jt[key], key
    # every chunk vocoded on the device: the samples of the frames, less the decoder's deficit
    from faster_qwen3_tts_tpu_torch.engine.fused_stream import codec_deficit

    cfg = port.config.codec
    assert sum(a.size for a, _, _ in chunks) == frames.shape[0] * cfg.total_upsample - codec_deficit(cfg)


@pytest.mark.parametrize("model_type, method, args", [
    ("custom_voice", "generate_custom_voice", (TEXT, "dylan", "Chinese")),
    ("voice_design", "generate_voice_design", (TEXT, DESIGN, "English")),
])
def test_non_streaming_matches_jax(make, greedy_predictor, model_type, method, args):
    jax_model, port = make(model_type)
    kw = dict(max_new_tokens=20, do_sample=False, seed=3)
    (a,), sr = getattr(port, method)(*args, **kw)
    (ja,), jsr = getattr(jax_model, method)(*args, **kw)
    assert sr == jsr == 24000 and a.dtype == np.float32 and a.shape == ja.shape
    np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)


def _call(model, method, *args, **kw):
    out = getattr(model, method)(*args, **kw)
    return next(out) if inspect.isgenerator(out) else out


@pytest.mark.parametrize("method", METHODS)
def test_wrong_model_type_raises(make, method):
    other = "voice_design" if "custom" in method else "custom_voice"
    for model in make(other) + make("base", "0b6"):
        args = (TEXT, "aiden", "English") if "custom" in method else (TEXT, DESIGN, "English")
        with pytest.raises(ValueError, match="does not support"):
            _call(model, method, *args, max_new_tokens=2)


@pytest.mark.parametrize("method", METHODS)
def test_unknown_speaker_or_language_raises(make, method):
    model_type = "custom_voice" if "custom" in method else "voice_design"
    for model in make(model_type):
        if "custom" in method:
            with pytest.raises(NotImplementedError, match="Speaker"):
                _call(model, method, TEXT, "nobody", "English", max_new_tokens=2)
            args = (TEXT, "aiden", "Klingon")
        else:
            args = (TEXT, DESIGN, "Klingon")
        with pytest.raises(NotImplementedError, match="Language"):
            _call(model, method, *args, max_new_tokens=2)


def test_speakers_and_model_properties_match_jax(make):
    for key in (("custom_voice", "1b7"), ("voice_design", "1b7"), ("custom_voice", "0b6")):
        jax_model, port = make(*key)
        assert port.get_supported_speakers() == jax_model.get_supported_speakers()
        assert (port.tts_model_type, port.tts_model_size) == (jax_model.tts_model_type,
                                                               jax_model.tts_model_size) == key
    assert make("custom_voice")[1].get_supported_speakers() == ["aiden", "dylan"]
    with pytest.raises(NotImplementedError, match="generate_custom_voice"):
        make("custom_voice")[1].generate(TEXT)


@pytest.mark.parametrize("method", METHODS)
def test_signature_matches_jax(method):
    names = list(inspect.signature(getattr(FasterQwen3TTS, method)).parameters)
    assert names == list(inspect.signature(getattr(JaxTTS, method)).parameters)
