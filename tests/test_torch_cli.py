"""The port's command line (faster_qwen3_tts_tpu_torch/cli.py): the parse and
validation cases of tests/test_cli.py (less --aot-cache and --attn, which
are not ported), the flags it passes to from_pretrained (--backend,
--ref-cache-dir and --fuse-qkv among them), and `clone` runs end to end on
the CPU from a tiny own-format checkpoint, one through the native backend,
one from a deploy bundle that `bundle` wrote."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch import cli
from faster_qwen3_tts_tpu_torch.cli import build_parser

torch.set_num_threads(1)


def test_clone_flags_parse():
    args = build_parser().parse_args([
        "clone", "hello world", "--ref-audio", "ref.wav", "--ref-text", "hi", "--quant", "Q8_0",
        "--streaming", "--chunk-size", "4", "--xvec-only", "--language", "French"])
    assert args.command == "clone" and args.quant == "Q8_0"
    assert args.streaming and args.chunk_size == 4 and args.xvec_only
    assert args.language == "French"
    assert args.device == "cuda" and args.strict is None and args.append_silence


def test_custom_and_design_flags():
    ap = build_parser()
    assert ap.parse_args(["custom", "--list-speakers"]).list_speakers
    assert ap.parse_args(["design", "text", "--instruct", "warm narrator"]).instruct == "warm narrator"
    s = ap.parse_args(["serve", "--mode", "custom", "--speaker", "aiden"])
    assert s.mode == "custom" and s.speaker == "aiden"


@pytest.mark.parametrize("argv", [["clone", "hi", "--backend", "ggml"], ["clone", "hi", "--aot-cache", "d"],
                                  ["clone", "hi", "--attn", "xla"], ["bundle"]])
def test_unported_flags_are_refused(argv):
    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


def test_bundle_flags_parse():
    args = build_parser().parse_args(["bundle", "/tmp/out_bundle", "--model", "ckpt_dir", "--quant", "Q8_0"])
    assert args.command == "bundle" and args.func is cli.cmd_bundle
    assert args.out_dir == "/tmp/out_bundle" and args.quant == "Q8_0" and args.model == "ckpt_dir"
    assert not args.full_f32 and args.device == "cuda"
    assert build_parser().parse_args(["bundle", "out", "--full-f32"]).full_f32


def test_clone_requires_ref(capsys):
    ap = build_parser()
    assert cli.cmd_clone(ap.parse_args(["clone", "hello"])) == 2
    assert "ref-audio" in capsys.readouterr().err
    assert cli.cmd_clone(ap.parse_args(["clone", "hello", "--ref-audio", "x.wav"])) == 2  # ICL without ref text
    assert "ref-text" in capsys.readouterr().err


def test_design_requires_instruct():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["design", "text"])


@pytest.mark.parametrize("flag, strict", [([], None), (["--strict"], True), (["--no-strict"], False)])
def test_load_flags_reach_from_pretrained(monkeypatch, flag, strict):
    seen = {}

    def fake(model, **kw):
        seen.update(kw, model=model)
        raise RuntimeError("stop before the model is built")

    monkeypatch.setattr("faster_qwen3_tts_tpu_torch.model.FasterQwen3TTS.from_pretrained", fake)
    args = build_parser().parse_args(["clone", "hi", "--ref-audio", "r.wav", "--xvec-only", "--model", "ckpt",
                                      "--device", "cpu", "--dtype", "fp32", "--quant", "Q8_0", *flag])
    with pytest.raises(RuntimeError, match="stop before"):
        cli._load_model(args)
    assert seen == {"model": "ckpt", "device": "cpu", "dtype": "fp32", "quant": "Q8_0", "max_seq_len": 2048,
                    "strict": strict, "backend": "torch"}


@pytest.mark.parametrize("flags, expect", [
    ([], {"backend": "torch"}),
    (["--backend", "jax"], {"backend": "jax"}),  # the JAX package's default: from_pretrained takes it as torch
    (["--backend", "native"], {"backend": "native"}),
    (["--backend", "native", "--ref-cache-dir", "refs"], {"backend": "native", "voice_ref_cache_dir": "refs"}),
    (["--ref-cache-dir", "refs"], {"backend": "torch"}),  # read by the native backend only, as in the JAX CLI
    (["--fuse-qkv"], {"backend": "torch", "fuse_qkv": True}),
])
def test_backend_cache_and_fuse_flags_reach_from_pretrained(monkeypatch, flags, expect):
    seen = {}

    def fake(model, **kw):
        seen.update({k: kw[k] for k in ("backend", "voice_ref_cache_dir", "fuse_qkv") if k in kw})
        raise RuntimeError("stop before the model is built")

    monkeypatch.setattr("faster_qwen3_tts_tpu_torch.model.FasterQwen3TTS.from_pretrained", fake)
    args = build_parser().parse_args(["clone", "hi", "--ref-audio", "r.wav", "--xvec-only", *flags])
    with pytest.raises(RuntimeError, match="stop before"):
        cli._load_model(args)
    assert seen == expect


def test_int4_is_not_ported(monkeypatch):
    """The int4 names (once refused here) reach `from_pretrained` unchanged."""
    seen = []

    def fake(model, **kw):
        seen.append(kw["quant"])
        raise RuntimeError("stop before the model is built")

    monkeypatch.setattr("faster_qwen3_tts_tpu_torch.model.FasterQwen3TTS.from_pretrained", fake)
    for name in ("Q4_K_M", "Q8_4"):
        args = build_parser().parse_args(["clone", "hi", "--ref-audio", "r.wav", "--xvec-only", "--quant", name,
                                          "--device", "cpu"])
        with pytest.raises(RuntimeError, match="stop before"):
            cli._load_model(args)
    assert seen == ["Q4_K_M", "Q8_4"]


def test_clone_end_to_end_on_the_cpu(tmp_path, capsys):
    """`clone --xvec-only --streaming` from a tiny own-format checkpoint
    writes a 24 kHz wav of whole frames."""
    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config
    from faster_qwen3_tts_tpu_torch.utils import audio

    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    weights.save_pretrained(str(tmp_path / "ckpt"), weights.init_numpy(cfg, seed=0), cfg)
    ref = tmp_path / "ref.wav"
    audio.write_wav(ref, (0.3 * np.sin(np.arange(24000) / 20)).astype(np.float32), 24000)
    out = tmp_path / "out.wav"
    rc = cli.main(["clone", "Hello from the command line.", "--model", str(tmp_path / "ckpt"), "--xvec-only",
                   "--ref-audio", str(ref), "--streaming", "--max-new-tokens", "8", "--seed", "0",
                   "--device", "cpu", "--dtype", "fp32", "-o", str(out)])
    assert rc == 0 and "TTFA" in capsys.readouterr().out
    wav, sr = audio.read_wav(out)
    assert sr == 24000 and 0 < wav.size <= 8 * 1920 and np.isfinite(wav).all()


def test_clone_native_backend_end_to_end_on_the_cpu(tmp_path, capsys):
    """`clone --backend native --ref-cache-dir` extracts the voice into the
    cache directory (the .spk / .rvq / .json triplet), and a second run
    reads it back and writes the same wav."""
    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config
    from faster_qwen3_tts_tpu_torch.utils import audio

    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    weights.save_pretrained(str(tmp_path / "ckpt"), weights.init_numpy(cfg, seed=0), cfg)
    ref = tmp_path / "ref.wav"
    audio.write_wav(ref, (0.3 * np.sin(np.arange(24000) / 20)).astype(np.float32), 24000)
    wavs = []
    for i in range(2):
        out = tmp_path / f"out{i}.wav"
        rc = cli.main(["clone", "Hello from the native backend.", "--model", str(tmp_path / "ckpt"),
                       "--ref-audio", str(ref), "--ref-text", "A reference.", "--backend", "native",
                       "--ref-cache-dir", str(tmp_path / "refs"), "--max-new-tokens", "6", "--seed", "0",
                       "--device", "cpu", "--dtype", "fp32", "-o", str(out)])
        assert rc == 0 and "wrote" in capsys.readouterr().out
        wavs.append(audio.read_wav(out)[0])
    assert sorted(p.suffix for p in (tmp_path / "refs").iterdir()) == [".json", ".rvq", ".spk"]
    assert wavs[0].size > 0 and np.array_equal(wavs[0], wavs[1])


def test_bundle_then_clone_from_it_on_the_cpu(tmp_path, capsys):
    """`bundle OUT --quant Q8_0 --full-f32` from a tiny own-format checkpoint
    writes a quantized deploy bundle; `clone --model OUT` restarts from it
    and writes the wav that `clone --model <checkpoint> --quant Q8_0` writes
    (without --full-f32 the codec would be rounded to bf16)."""
    from faster_qwen3_tts_tpu_torch import weights
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config
    from faster_qwen3_tts_tpu_torch.utils import audio

    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    weights.save_pretrained(str(tmp_path / "ckpt"), weights.init_numpy(cfg, seed=0), cfg)
    out_dir = tmp_path / "bundle"
    assert cli.main(["bundle", str(out_dir), "--model", str(tmp_path / "ckpt"), "--quant", "Q8_0",
                     "--full-f32", "--device", "cpu"]) == 0
    assert "deploy bundle written" in capsys.readouterr().out
    assert weights.is_deploy_bundle(str(out_dir))
    assert json.loads((out_dir / "bundle.json").read_text())["quant"] == "int8"
    ref = tmp_path / "ref.wav"
    audio.write_wav(ref, (0.3 * np.sin(np.arange(24000) / 20)).astype(np.float32), 24000)
    wavs = []
    for model, quant in ((str(out_dir), "BF16"), (str(tmp_path / "ckpt"), "Q8_0")):
        out = tmp_path / f"out_{len(wavs)}.wav"
        assert cli.main(["clone", "Hello from a bundle.", "--model", model, "--quant", quant, "--xvec-only",
                         "--ref-audio", str(ref), "--max-new-tokens", "6", "--seed", "0", "--device", "cpu",
                         "-o", str(out)]) == 0
        wavs.append(audio.read_wav(out)[0])
    assert wavs[0].size > 0 and np.array_equal(wavs[0], wavs[1])
