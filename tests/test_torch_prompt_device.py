"""Device-side prompt assembly of the port (`PromptBuilder.build_device`)
against its host build and the JAX package's device build.

`build_device` re-implements the whole streaming layout of `build` with index
arithmetic, so in every streaming mode (x-vector, with and without an
instruct, CustomVoice, language Auto, ICL at 1, 7 and 40 reference frames and
with an instruct, a single-token text, VoiceDesign) it must equal `build`
plus the session's padding and cast bit for bit, in float32, in bf16 and in
bf16 Q8_0 (where the text projection takes the GEMV's plain route at <= 16
rows and the many-row product above). In float32 it agrees with the JAX
package's `build_device` within 1e-5 (two libraries, one layout), and a
batch of two returns None, as there. Also: the ICL-block and codec-block
caches hit and stay within their LRU bound of 16, and the prompt methods
keep the JAX parameter names.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import faster_qwen3_tts_tpu.config as jax_config
from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.prompt import PromptBuilder as JaxPromptBuilder
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.prompt import PromptBuilder

torch.set_num_threads(1)
MAX_SEQ = 512
TOK = PromptTokenizer(ByteTokenizer())
DTYPES = {"f32": (torch.float32, "none"), "bf16": (torch.bfloat16, "none"), "bf16_q8": (torch.bfloat16, "int8")}


@pytest.fixture(scope="module")
def setup(tiny_config):
    """(cfg, host tree, JAX builder, port builder per dtype)."""
    talker = dataclasses.replace(tiny_config.talker, spk_id=jax_config._freeze({"ryan": 5}),
                                 spk_is_dialect=jax_config._freeze({}))
    cfg = dataclasses.replace(tiny_config, talker=talker, tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    port = {name: PromptBuilder(weights.materialize(host, dt, quant, "cpu"), cfg)
            for name, (dt, quant) in DTYPES.items()}
    return cfg, host, JaxPromptBuilder(jax.device_put(host), cfg), port


def _xvec(seed=0):
    return dict(ref_code=[None], ref_spk_embedding=[np.random.default_rng(seed).standard_normal(2048)
                                                     .astype(np.float32)],
                x_vector_only_mode=[True], icl_mode=[False])


def _icl(n_frames, seed=0):
    rng = np.random.default_rng(seed)
    vcp = dict(ref_code=[rng.integers(0, 100, size=(n_frames, 16)).astype(np.int32)],
               ref_spk_embedding=[rng.standard_normal(2048).astype(np.float32)],
               x_vector_only_mode=[False], icl_mode=[True])
    return vcp, [TOK.ref_ids("reference transcript text")]


def _request(text, vcp=None, ref_ids=(None,), language="English", speaker=None, instruct=None):
    """build_device's arguments but max_seq_len, for one request."""
    return dict(input_ids=[TOK.assistant_ids(text)], ref_ids=list(ref_ids), voice_clone_prompt=vcp,
                languages=[language], speakers=[speaker],
                instruct_ids=[TOK.instruct_ids(instruct) if instruct else None])


MODES = {
    "xvec": lambda: _request("hello world this is a test", _xvec()),
    "xvec_instruct": lambda: _request("hello world", _xvec(), instruct="speak slowly and softly"),
    "custom_speaker": lambda: _request("custom voice speaker path", speaker="ryan"),
    "language_auto": lambda: _request("auto language nothink prefix", _xvec(), language="Auto"),
    "icl_1": lambda: _request("in context learning voice cloning sentence", *_icl(1)),
    "icl_7": lambda: _request("in context learning voice cloning sentence", *_icl(7)),
    "icl_40": lambda: _request("in context learning voice cloning sentence", *_icl(40)),
    "icl_instruct": lambda: _request("icl with an instruct turn", *_icl(8, seed=3), instruct="whisper"),
    "single_token": lambda: _request("a", _xvec()),
    "voice_design": lambda: _request("a voice described by its instruction",
                                     instruct="A bright young voice, quick and cheerful."),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
def test_build_device_equals_build_and_jax(setup, mode, dtype):
    cfg, _, jax_builder, port = setup
    builder = port[dtype]
    req = MODES[mode]()
    tie_h, mask_h, tth_h, tpe_h = builder.build(
        req["input_ids"], req["ref_ids"], req["voice_clone_prompt"], req["languages"], req["speakers"],
        non_streaming_mode=False, instruct_ids=req["instruct_ids"])
    tie, mask, tth, tpe = builder.build_device(**req, max_seq_len=MAX_SEQ)

    # the host build as a session takes it: padded to the buckets, cast once to the parameter dtype
    pb, tb = gen.prefill_bucket(tie_h.shape[1], MAX_SEQ), gen.tth_bucket(tth_h.shape[1])
    tie_hb, mask_hb = gen._pad_left(tie_h, mask_h, pb)
    tth_hb = gen._pad_trailing(tth_h, tpe_h, tb)
    dt = DTYPES[dtype][0]
    H = cfg.talker.hidden_size
    assert tie.shape == (1, pb, H) and tth.shape == (1, tb, H) and mask.shape == (1, pb)
    assert tie.dtype == tth.dtype == dt and mask.dtype == torch.int32
    assert torch.equal(mask, torch.as_tensor(mask_hb))
    assert torch.equal(tie, torch.as_tensor(tie_hb).to(dt)), "tie"
    assert torch.equal(tth, torch.as_tensor(tth_hb).to(dt)), "tth"
    np.testing.assert_array_equal(tpe, tpe_h)

    if dtype == "f32":  # the JAX package's device build, on the same weights
        jtie, jmask, jtth, jtpe = jax_builder.build_device(**req, max_seq_len=MAX_SEQ)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(tie.numpy(), np.asarray(jtie), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tth.numpy(), np.asarray(jtth), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tpe, np.asarray(jtpe), atol=1e-5, rtol=0)

    vcp = req["voice_clone_prompt"]
    pair = {k: (v if k == "voice_clone_prompt" else v * 2) for k, v in req.items()}
    pair["voice_clone_prompt"] = None if vcp is None else {k: v * 2 for k, v in vcp.items()}
    assert builder.build_device(**pair, max_seq_len=MAX_SEQ) is None


def test_device_caches_hit_and_stay_bounded(setup):
    """A second request for a voice reuses its device ICL block and codec
    block (the same tensors); 20 voices leave 16 of each."""
    cfg, host, _, _ = setup
    builder = PromptBuilder(weights.params_from_numpy(host, device="cpu"), cfg)
    vcp, rid = _icl(10, seed=7)
    builder.build_device(**_request("first request", vcp, rid), max_seq_len=MAX_SEQ)
    (block,) = builder._icl_block_cache.values()
    (codec,) = builder._codec_block_cache.values()
    builder.build_device(**_request("second request, same voice", vcp, rid), max_seq_len=MAX_SEQ)
    assert len(builder._icl_block_cache) == len(builder._codec_block_cache) == 1
    assert next(iter(builder._icl_block_cache.values()))[0] is block[0]
    assert next(iter(builder._codec_block_cache.values())) is codec
    for seed in range(20):
        vcp, rid = _icl(3 + seed % 4, seed=100 + seed)
        builder.build_device(**_request("another voice", vcp, rid), max_seq_len=MAX_SEQ)
    assert len(builder._icl_block_cache) == len(builder._codec_block_cache) == 16
    # the most recent voice is the newest entry; the first voice was evicted
    assert next(reversed(builder._icl_block_cache.values()))[1] == 3 + 19 % 4 + 1
    assert all(entry[0] is not block[0] for entry in builder._icl_block_cache.values())


def test_prompt_methods_keep_the_jax_parameters():
    for name in ("_prepare_generation", "_prepare_generation_custom", "_device_prompt_ok"):
        ours = inspect.signature(getattr(FasterQwen3TTS, name)).parameters
        theirs = inspect.signature(getattr(JaxTTS, name)).parameters
        assert list(ours) == list(theirs), name
        assert [p.default for p in ours.values()] == [p.default for p in theirs.values()], name
