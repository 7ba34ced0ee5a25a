"""The port keeps the JAX package's entry-point signatures and top-level names.

`warmup` and `from_pretrained` take the JAX parameters in the JAX order (a
positional call written for the JAX package lands in the same parameters),
the package exports the JAX package's names, and importing it loads no
torch."""
import dataclasses
import inspect
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import faster_qwen3_tts_tpu as jax_pkg
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
import faster_qwen3_tts_tpu_torch as pkg
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.native_backend import NativeQwen3TTS

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(fn):
    return [p for p in inspect.signature(fn).parameters.values() if p.name != "self"]


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    path = tmp_path_factory.mktemp("sig") / "ckpt"
    weights.save_pretrained(str(path), weights.init_numpy(cfg, seed=0), cfg)
    return str(path)


def test_warmup_keeps_the_jax_leading_parameters():
    jax_params = _params(JaxTTS.warmup)
    ours = _params(FasterQwen3TTS.warmup)
    assert [(p.name, p.default, p.kind) for p in ours[:len(jax_params)]] == \
        [(p.name, p.default, p.kind) for p in jax_params]
    assert [p.name for p in jax_params] == ["prefill_len", "chunk_sizes", "first_chunk_size"]
    assert "batch_sizes" in [p.name for p in ours[3:]] and "pool_slots" in [p.name for p in ours[3:]]


def test_from_pretrained_keeps_the_jax_parameters():
    """Same names, order and kinds; the same defaults but for the device
    ("cuda" for "tpu") and the backend ("torch", this engine, for "jax")."""
    jax_params = _params(JaxTTS.from_pretrained)
    ours = _params(FasterQwen3TTS.from_pretrained)
    assert [(p.name, p.kind) for p in ours] == [(p.name, p.kind) for p in jax_params]
    differ = {p.name: (q.default, p.default) for p, q in zip(ours, jax_params) if p.default != q.default}
    assert differ == {"device": ("tpu", "cuda"), "backend": ("jax", "torch")}
    assert [p.name for p in ours][:4] == ["model_name", "device", "dtype", "attn_implementation"]


@pytest.mark.parametrize("name", jax_pkg.__all__)
def test_top_level_names_match_jax(name):
    assert name in pkg.__all__
    ours, theirs = getattr(pkg, name), getattr(jax_pkg, name)
    if name == "__version__":
        assert ours == theirs
    elif name == "get_config":
        for model in ("0.6b", "1.7b-custom", "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign"):
            assert dataclasses.asdict(ours(model)) == dataclasses.asdict(theirs(model))
    elif name == "FasterQwen3TTS":
        assert ours is FasterQwen3TTS
    else:  # the config classes: same name and fields
        assert ours.__name__ == theirs.__name__
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert pkg.NativeQwen3TTS is NativeQwen3TTS


def test_import_loads_no_torch():
    code = ("import sys, faster_qwen3_tts_tpu_torch as p\n"
            "cfg = p.get_config('0.6b')\n"
            "assert isinstance(cfg, p.Qwen3TTSConfig) and p.__version__\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_warmup_prefill_len_adds_its_bucket(tiny_dir):
    """warmup(prefill_len=300) on a model of max_seq_len 512 notes bucket 512
    beside the served buckets (on the CPU nothing is captured, the buckets
    are still noted); the default prefill_len=100 adds nothing to them."""
    model = FasterQwen3TTS.from_pretrained(tiny_dir, device="cpu", dtype="float32", max_seq_len=512)
    phases = model.warmup(prefill_len=300, chunk_sizes=(4,))
    assert phases["prefill_buckets"] == [32, 64, 128, 256, 512]
    assert model.warmup(chunk_sizes=(4,))["prefill_buckets"] == [32, 64, 128, 256]


def test_positional_from_pretrained_call_of_the_jax_package(tiny_dir):
    """`from_pretrained(name, device, dtype, "pallas")` puts "pallas" into
    attn_implementation, as the JAX package does."""
    model = FasterQwen3TTS.from_pretrained(tiny_dir, "cpu", "float32", "pallas", 256)
    assert model.max_seq_len == 256 and model.params["talker"]["codec_embed"].dtype == torch.float32
    with pytest.raises(ValueError, match="attn_implementation"):
        FasterQwen3TTS.from_pretrained(tiny_dir, "cpu", "float32", "Q8_0")


def test_from_pretrained_arguments(tiny_dir, caplog):
    """The JAX arguments the port accepts, ignores (with a warning) or
    refuses."""
    kw = dict(device="cpu", dtype="float32")
    with caplog.at_level(logging.WARNING):
        m = FasterQwen3TTS.from_pretrained(tiny_dir, attn_implementation="xla", backend="jax", cache_dir="/nonexistent",
                                           local_files_only=True, dp=1, tp=None, unknown_knob=3, **kw)
    assert type(m) is FasterQwen3TTS
    text = caplog.text
    assert "attn_implementation='xla'" in text and "'unknown_knob'" in text
    for backend in ("tpu", "xla", "torch"):
        assert type(FasterQwen3TTS.from_pretrained(tiny_dir, backend=backend, **kw)) is FasterQwen3TTS
    with pytest.raises(ValueError, match="backend"):
        FasterQwen3TTS.from_pretrained(tiny_dir, backend="ggml", **kw)
    # dp / tp build a (dp, tp) mesh, of cpu entries on the CPU; tp must divide every kv head count
    m = FasterQwen3TTS.from_pretrained(tiny_dir, dp=2, **kw)
    assert m.mesh is not None and m.mesh.shape == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError, match="tp=4 must divide num_key_value_heads"):
        FasterQwen3TTS.from_pretrained(tiny_dir, tp=4, **kw)


def test_from_pretrained_native_backend(tiny_dir, tmp_path):
    m = FasterQwen3TTS.from_pretrained(tiny_dir, backend="native", voice_ref_cache_dir=str(tmp_path / "refs"),
                                       quant="Q8_0", **dict(device="cpu", dtype="float32"))
    assert isinstance(m, NativeQwen3TTS) and m.voice_ref_cache_dir == tmp_path / "refs"
    assert type(m.params["talker"]["layers"]["wq"]).__name__ == "QuantizedLinear"
    wav, sr = m.generate_voice_clone("Hi.", "English", ref_spk_emb=np.ones(2048, np.float32), xvec_only=True,
                                     max_new_tokens=4, seed=0)
    assert sr == 24000 and wav[0].size > 0
