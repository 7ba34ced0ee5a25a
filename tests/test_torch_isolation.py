"""The port stands alone: it imports neither jax nor the JAX package, and its
own copies of the JAX package's config, tokenizer and audio helpers give the
same results as the originals."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import faster_qwen3_tts_tpu.config as jax_config
from faster_qwen3_tts_tpu.utils import audio as jax_audio
from faster_qwen3_tts_tpu.utils import tokenizer as jax_tokenizer
from faster_qwen3_tts_tpu_torch import config
from faster_qwen3_tts_tpu_torch.utils import audio, tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every name `get_config` resolves: the served model ids and the short forms
MODEL_NAMES = ["Qwen/Qwen3-TTS-12Hz-0.6B-Base", "Qwen/Qwen3-TTS-12Hz-1.7B-Base",
               "Qwen/Qwen3-TTS-12Hz-0.6B-CustomVoice", "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
               "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign", "0.6b", "1.7b", "1.7b-custom", "1.7b-design"]


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    """In a fresh interpreter: import every module of the port, then run tiny
    CPU generations (x-vector, ICL from a wav, CustomVoice, VoiceDesign)
    built only from the port's config, tokenizer and audio helpers."""
    script = tmp_path / "run.py"
    script.write_text(
        "import dataclasses, importlib, pkgutil, sys\n"
        "import numpy as np, torch\n"
        "import faster_qwen3_tts_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from faster_qwen3_tts_tpu_torch import weights\n"
        "from faster_qwen3_tts_tpu_torch.config import get_config, tiny_test_config\n"
        "from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS\n"
        "from faster_qwen3_tts_tpu_torch.utils.audio import write_wav\n"
        "from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer\n"
        "torch.set_num_threads(1)\n"
        "cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300,\n"
        "                          tts_eos_token_id=301, tts_pad_token_id=302)\n"
        "m = FasterQwen3TTS(weights.init_all(cfg, dtype=torch.float32, quant='int8', device='cpu'),\n"
        "                   cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=64)\n"
        "prompt = {'ref_spk_embedding': [np.ones(2048, np.float32)]}\n"
        "n = sum(len(a) for a, _, _ in m.generate_voice_clone_streaming(\n"
        "    'Hi.', 'English', voice_clone_prompt=prompt, max_new_tokens=6, chunk_size=4, seed=0))\n"
        "assert n > 0\n"
        "write_wav(sys.argv[1], (0.3 * np.sin(np.arange(12000) / 20)).astype(np.float32), 24000)\n"
        "n = sum(len(a) for a, _, _ in m.generate_voice_clone_streaming(\n"
        "    'Hi.', 'English', sys.argv[1], 'Ref.', max_new_tokens=6, chunk_size=4, seed=0))\n"
        "assert n > 0 and m._voice_prompt_cache\n"
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
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'faster_qwen3_tts_tpu' or k.startswith('faster_qwen3_tts_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "ref.wav")], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_port_module_imports_the_jax_package():
    """No source line of the port or of chip_smoke.py imports the JAX package."""
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "faster_qwen3_tts_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                words = line.split()
                if len(words) >= 2 and words[0] in ("import", "from") and (
                        words[1] == "faster_qwen3_tts_tpu" or words[1].startswith("faster_qwen3_tts_tpu.")
                        or words[1] == "jax" or words[1].startswith("jax.")):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}: {line.strip()}")
    assert not offenders, offenders


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_get_config_matches_jax(name):
    ours, theirs = config.get_config(name), jax_config.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert ours.talker.q_dim == theirs.talker.q_dim and ours.predictor.max_seq == theirs.predictor.max_seq
    assert ours.codec.total_upsample == theirs.codec.total_upsample and ours.frame_rate == theirs.frame_rate


@pytest.mark.parametrize("model_type", ["base", "custom_voice", "voice_design"])
def test_tiny_test_config_matches_jax(model_type):
    ours, theirs = config.tiny_test_config(model_type), jax_config.tiny_test_config(model_type)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("name", ["1.7b-custom", "0.6b"])
def test_config_from_dict_converts_the_jax_config(name, tmp_path):
    """A JAX config converts field for field, and a config.json directory
    resolves the same in both packages; frozen maps stay hashable."""
    theirs = jax_config.get_config(name)
    ours = config.config_from_dict(dataclasses.asdict(theirs))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    hash(ours)
    with pytest.raises(TypeError):
        ours.talker.codec_language_id["english"] = 0
    (tmp_path / "config.json").write_text(
        '{"model_type": "custom_voice", "talker_config": {"hidden_size": 256, "spk_id": {"a": 1}}}')
    assert (dataclasses.asdict(config.get_config(str(tmp_path)))
            == dataclasses.asdict(jax_config.get_config(str(tmp_path))))


TEXTS = ["Hello there.", "Grüße aus Köln — ça va?", "你好，世界。", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizers_match_jax(text):
    ours, theirs = tokenizer.PromptTokenizer(tokenizer.ByteTokenizer()), \
        jax_tokenizer.PromptTokenizer(jax_tokenizer.ByteTokenizer())
    assert tokenizer.ByteTokenizer().encode(text) == jax_tokenizer.ByteTokenizer().encode(text)
    for method in ("assistant_ids", "ref_ids", "instruct_ids"):
        np.testing.assert_array_equal(getattr(ours, method)(text), getattr(theirs, method)(text))
    ids = tokenizer.ByteTokenizer().encode(text)
    assert tokenizer.ByteTokenizer().decode(ids) == jax_tokenizer.ByteTokenizer().decode(ids)
    assert type(tokenizer.load_tokenizer(None)).__name__ == type(jax_tokenizer.load_tokenizer(None)).__name__


@pytest.mark.parametrize("sr_in, sr_out", [(24000, 16000), (44100, 24000), (16000, 16000)])
def test_audio_helpers_match_jax(tmp_path, sr_in, sr_out):
    rng = np.random.default_rng(sr_in + sr_out)
    x = (0.5 * rng.standard_normal(4001)).astype(np.float32)
    np.testing.assert_array_equal(audio.resample(x, sr_in, sr_out), jax_audio.resample(x, sr_in, sr_out))
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    audio.write_wav(ours, x, sr_in)
    jax_audio.write_wav(theirs, x, sr_in)
    assert ours.read_bytes() == theirs.read_bytes()
    a, sa = audio.read_wav(theirs)
    b, sb = jax_audio.read_wav(ours)
    assert sa == sb == sr_in
    np.testing.assert_array_equal(a, b)
    a, _ = audio.load_ref_audio(ours, silence_secs=0.25)
    b, _ = jax_audio.load_ref_audio(ours, silence_secs=0.25)
    np.testing.assert_array_equal(a, b)
    assert audio.wav_header(sr_out) == jax_audio.wav_header(sr_out)
    assert audio.float_to_pcm16(x) == jax_audio.float_to_pcm16(x)
