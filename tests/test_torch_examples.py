"""The examples over the port (examples_torch/) on the CPU: each script's
`main` runs once from a tiny own-format checkpoint with `--device cpu`, and
no example imports jax or the JAX package."""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.utils import audio

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")


def _example(name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)  # streaming_playback imports its `audio` helper as a script does
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    weights.save_pretrained(str(d / "ckpt"), weights.init_numpy(cfg, seed=0), cfg)
    audio.write_wav(d / "ref.wav", (0.3 * np.sin(np.arange(24000) / 20)).astype(np.float32), 24000)
    return d


def _wav_ok(path, max_frames):
    wav, sr = audio.read_wav(path)
    assert sr == 24000 and 0 < wav.size <= max_frames * 1920 and np.isfinite(wav).all()


@pytest.mark.parametrize("fmt", ["npy", "spk"])
def test_extract_then_generate_with_embedding(work, fmt, capsys):
    """extract_speaker writes the x-vector (.npy, or the raw .spk the native
    backend reads); generate_with_embedding speaks with it."""
    spk = work / f"speaker.{fmt}"
    _example("extract_speaker").main([str(work / "ref.wav"), str(spk), "--model", str(work / "ckpt"),
                                      "--device", "cpu"] + (["--spk"] if fmt == "spk" else []))
    xvec = np.load(spk) if fmt == "npy" else np.fromfile(spk, np.float32)
    assert xvec.shape == (2048,) and xvec.dtype == np.float32 and np.isfinite(xvec).all()
    out = work / f"out_{fmt}.wav"
    _example("generate_with_embedding").main([str(spk), "Hello from an embedding.", "-o", str(out), "--model",
                                              str(work / "ckpt"), "--device", "cpu", "--max-new-tokens", "6"])
    assert "RTF" in capsys.readouterr().out
    _wav_ok(out, 6)


def test_streaming_playback_extracts_once(work, capsys):
    """Headless streaming playback writes the streamed wav; a second run
    reads the voice from the reference cache."""
    argv = ["Hello there.", "--ref-audio", str(work / "ref.wav"), "--ref-text", "A reference.", "--ref-cache-dir",
            str(work / "refs"), "--model", str(work / "ckpt"), "--device", "cpu", "--max-new-tokens", "6",
            "--out", str(work / "streamed.wav")]
    mod = _example("streaming_playback")
    mod.main(argv)
    first = capsys.readouterr().out
    mod.main(argv)
    second = capsys.readouterr().out
    assert "cache miss" in first and "cache hit" in second and "TTFA" in second
    assert sorted(p.suffix for p in (work / "refs").iterdir()) == [".json", ".rvq", ".spk"]
    if not mod.HAS_AUDIO:
        _wav_ok(work / "streamed.wav", 6)


def test_examples_import_only_the_port():
    offenders = []
    for name in sorted(os.listdir(EXAMPLES)):
        if name.endswith(".py"):
            for n, line in enumerate(open(os.path.join(EXAMPLES, name)), 1):
                words = line.split()
                if len(words) >= 2 and words[0] in ("import", "from") and (
                        words[1].split(".")[0] in ("faster_qwen3_tts_tpu", "jax")):
                    offenders.append(f"{name}:{n}: {line.strip()}")
    assert not offenders, offenders
