"""The port's public API against the JAX model on the same weights.

Greedy (talker and code predictor), x-vector prompt, float32, tiny geometry.
Token frames must be exactly equal; audio chunks agree at atol 1e-4 with
equal lengths."""
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = dataclasses.replace(
        tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302
    )
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=128)
    return jax_model, port


@pytest.fixture(scope="module")
def xvec_prompt():
    return {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}


def _tap_frames(model, sink):
    """Record the token frames that reach the model's stream vocoder."""
    relay = model._stream_decode

    def wrapped(stream, *args):
        def tap():
            for item in stream:
                sink.append(np.asarray(item[0]))
                yield item

        return relay(tap(), *args)

    model._stream_decode = wrapped


def test_streaming_voice_clone_matches_jax(models, xvec_prompt):
    jax_model, port = models
    kw = dict(voice_clone_prompt=xvec_prompt, max_new_tokens=30, chunk_size=8, first_chunk_size=4, **GREEDY)
    text = "The quick brown fox jumps."
    jframes, pframes = [], []
    _tap_frames(jax_model, jframes)
    _tap_frames(port, pframes)
    ref = list(jax_model.generate_voice_clone_streaming(text, "English", **kw))
    out = list(port.generate_voice_clone_streaming(text, "English", **kw))

    # the vocoder context grew 0 -> 4 -> 12 -> 20 -> 24 frames
    assert [t["total_steps_so_far"] for _, _, t in out] == [4, 12, 20, 28, 30]
    np.testing.assert_array_equal(np.concatenate(pframes), np.concatenate(jframes))
    assert len(out) == len(ref)
    for (a, sr, t), (ja, jsr, jt) in zip(out, ref):
        assert sr == jsr == 24000
        assert a.dtype == np.float32 and a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
        assert set(t) == set(jt)
        for key in ("chunk_index", "chunk_steps", "total_steps_so_far", "is_final"):
            assert t[key] == jt[key], key


def test_non_streaming_generate_and_codec_decode_match_jax(models, xvec_prompt):
    """fast_generate (greedy predictor) on each model's own prompt, then the
    bucketed codec decode of generate_voice_clone."""
    from faster_qwen3_tts_tpu.engine import generate as jax_gen
    from faster_qwen3_tts_tpu_torch.engine import generate as gen

    jax_model, port = models
    kw = dict(max_seq_len=128, max_new_tokens=10, device_chunk=8, **GREEDY)
    jprompt = jax_model._prepare_generation(
        "Same text.", language="English", voice_clone_prompt=xvec_prompt, prefer_device=False
    )[:4]
    prompt = port._prepare_generation("Same text.", language="English", voice_clone_prompt=xvec_prompt)
    assert prompt[4] is None  # no reference codes in x-vector mode
    prompt = prompt[:4]
    for a, b in zip(prompt, jprompt):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    jcodes, jtiming = jax_gen.fast_generate(jax_model.params, jax_model.config, *jprompt, **kw)
    codes, timing = gen.fast_generate(port.params, port.config, *prompt, **kw)
    np.testing.assert_array_equal(codes, jcodes)
    assert set(timing) == set(jtiming) and timing["steps"] == jtiming["steps"] == 10
    (ja,), _ = jax_model.speech_tokenizer.decode({"audio_codes": jcodes[None]})
    (a,), sr = port.speech_tokenizer.decode({"audio_codes": codes[None]})
    assert sr == 24000 and a.shape == ja.shape
    np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
    (full,), _ = port.generate_voice_clone("Same text.", "English", voice_clone_prompt=xvec_prompt,
                                           max_new_tokens=10, seed=0)
    assert full.dtype == np.float32 and full.shape == a.shape and np.isfinite(full).all()


def test_unported_prompts_raise(models, xvec_prompt):
    """parity_mode and the native backend's cached-reference kwargs are
    rejected at call time, as the JAX package rejects the latter."""
    _, port = models
    kw = dict(voice_clone_prompt=xvec_prompt, max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="parity_mode"):
        next(port.generate_voice_clone_streaming("Hi.", "English", parity_mode=True, **kw))
    with pytest.raises(NotImplementedError, match="parity_mode"):
        port.generate_voice_clone("Hi.", "English", parity_mode=True, **kw)
    for name in ("ref_spk", "ref_rvq", "ref_spk_emb", "ref_codes"):
        with pytest.raises(NotImplementedError, match="native"):
            next(port.generate_voice_clone_streaming("Hi.", "English", **{name: np.zeros(4)}, **kw))
        with pytest.raises(NotImplementedError, match="native"):
            port.generate_voice_clone("Hi.", "English", **{name: np.zeros(4)}, **kw)


@pytest.mark.parametrize("method", ["generate_voice_clone", "generate_voice_clone_streaming"])
def test_voice_clone_signature_matches_jax(method):
    """Same parameter names in the same order, so positional calls written
    for the JAX package (text, language, ref_audio, ref_text, ...) mean the
    same on the port."""
    names = list(inspect.signature(getattr(FasterQwen3TTS, method)).parameters)
    assert names == list(inspect.signature(getattr(JaxTTS, method)).parameters)


def test_from_pretrained_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        FasterQwen3TTS.from_pretrained("Qwen/Qwen3-TTS-12Hz-0.6B-Base", device="cuda")


def test_port_never_imports_jax(tmp_path):
    """Tiny CPU generates through the port, x-vector and ICL from a
    reference wav, CustomVoice and VoiceDesign, built from the port's own
    config, tokenizer and audio modules, leave jax and the JAX package
    unimported."""
    script = tmp_path / "run.py"
    script.write_text(
        "import dataclasses, sys\n"
        "import numpy as np, torch\n"
        "from faster_qwen3_tts_tpu_torch.config import tiny_test_config\n"
        "from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer\n"
        "from faster_qwen3_tts_tpu_torch import weights\n"
        "from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS\n"
        "torch.set_num_threads(1)\n"
        "cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300,\n"
        "                          tts_eos_token_id=301, tts_pad_token_id=302)\n"
        "m = FasterQwen3TTS(weights.init_all(cfg, dtype=torch.float32, quant='int8', device='cpu'), cfg,\n"
        "                   PromptTokenizer(ByteTokenizer()), max_seq_len=64)\n"
        "prompt = {'ref_spk_embedding': [np.ones(2048, np.float32)]}\n"
        "n = sum(len(a) for a, _, _ in m.generate_voice_clone_streaming(\n"
        "    'Hi.', 'English', voice_clone_prompt=prompt, max_new_tokens=6, chunk_size=4, seed=0))\n"
        "assert n > 0\n"
        "from faster_qwen3_tts_tpu_torch.utils.audio import write_wav\n"
        "write_wav(sys.argv[1], (0.3 * np.sin(np.arange(12000) / 20)).astype(np.float32), 24000)\n"
        "n = sum(len(a) for a, _, _ in m.generate_voice_clone_streaming(\n"
        "    'Hi.', 'English', sys.argv[1], 'Ref.', max_new_tokens=6, chunk_size=4, seed=0))\n"
        "assert n > 0 and m._voice_prompt_cache\n"
        "from faster_qwen3_tts_tpu_torch.config import get_config\n"
        "cv = get_config('1.7b-custom').talker\n"
        "c = FasterQwen3TTS(m.params, dataclasses.replace(\n"
        "    cfg, model_type='custom_voice', model_size='1b7', talker=dataclasses.replace(\n"
        "        cfg.talker, spk_id=cv.spk_id, spk_is_dialect=cv.spk_is_dialect)),\n"
        "    m.tokenizer, max_seq_len=64)\n"
        "n = sum(len(a) for a, _, _ in c.generate_custom_voice_streaming(\n"
        "    'Hi.', 'dylan', 'Chinese', instruct='Calm.', max_new_tokens=6, chunk_size=4, seed=0))\n"
        "assert n > 0\n"
        "d = FasterQwen3TTS(m.params, dataclasses.replace(cfg, model_type='voice_design'), m.tokenizer,\n"
        "                   max_seq_len=64)\n"
        "(wav,), sr = d.generate_voice_design('Hi.', 'A calm voice.', 'English', max_new_tokens=6, seed=0)\n"
        "assert wav.size > 0 and sr == 24000\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert not any(k == 'faster_qwen3_tts_tpu' or k.startswith('faster_qwen3_tts_tpu.')\n"
        "               for k in sys.modules), sorted(k for k in sys.modules if 'tts_tpu' in k)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "ref.wav")], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
