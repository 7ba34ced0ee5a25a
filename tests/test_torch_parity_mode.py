"""The port's independent parity decode (`engine/parity.py`).

Against the JAX package's parity decode on the same weights (float32, tiny
geometry): greedy tokens exactly equal for unquantized, int8, int4 and mixed
weights. Against the port's own engine: greedy tokens equal, and sampled
tokens equal with one seed (the same generator drawn in the same order).
A fault injected into the engine's `models/layers.py` must make the two
disagree, and the parity path must reach neither that module, nor
`engine/core.py`, nor any kernel wrapper.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import parity as jax_parity
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.engine import parity
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.models import layers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = dict(do_sample=False, subtalker_dosample=False)


class _greedy_predictor:
    """The non-streaming method samples the code predictor: make it greedy."""

    def __enter__(self):
        self.saved = gen.predictor_sampling
        gen.predictor_sampling = lambda *a: self.saved(False)

    def __exit__(self, *exc):
        gen.predictor_sampling = self.saved


def _inputs(cfg):
    H = cfg.talker.hidden_size
    rng = np.random.default_rng(11)
    tie = (rng.standard_normal((1, 20, H)) * 0.05).astype(np.float32)
    mask = np.ones((1, 20), np.int32)
    tth = (rng.standard_normal((1, 6, H)) * 0.05).astype(np.float32)
    tpe = (rng.standard_normal((1, 1, H)) * 0.05).astype(np.float32)
    return tie, mask, tth, tpe


@pytest.fixture(scope="module")
def setup(tiny_config):
    """(config, host tree, prompt arrays), the JAX parity test's inputs."""
    return tiny_config, jax_weights.init_all(tiny_config, seed=5, dtype=jnp.float32, device_put=False), \
        _inputs(tiny_config)


@pytest.fixture(scope="module")
def sliding_setup(tiny_config):
    """Mixed full / sliding layers with small windows on both stacks."""
    talker = dataclasses.replace(tiny_config.talker, sliding_window=4,
                                 layer_types=("full_attention", "sliding_attention"))
    pred = dataclasses.replace(tiny_config.predictor, sliding_window=3,
                               layer_types=("sliding_attention", "full_attention"))
    cfg = dataclasses.replace(tiny_config, talker=talker, predictor=pred)
    return cfg, jax_weights.init_all(cfg, seed=5, dtype=jnp.float32, device_put=False), _inputs(cfg)


def _tree(host, mode):
    return host if mode == "none" else jax_quant.quantize_model_params(host, mode)


def _port_parity(setup, mode="none", seed=3, **kw):
    cfg, host, prompt = setup
    codes, _ = parity.parity_generate(weights.params_from_numpy(_tree(host, mode), device="cpu"), cfg, *prompt,
                                      max_seq_len=64, max_new_tokens=16, seed=seed, **kw)
    return codes


def _port_engine(setup, mode="none", **kw):
    cfg, host, prompt = setup
    codes, _ = gen.fast_generate(weights.params_from_numpy(_tree(host, mode), device="cpu"), cfg, *prompt,
                                 max_seq_len=64, max_new_tokens=16, seed=3, device_chunk=8, **kw)
    return codes


@pytest.mark.parametrize("mode", ["none", "int8", "int4", "mixed"])
def test_greedy_tokens_match_jax_parity(setup, mode):
    cfg, host, prompt = setup
    ref, _ = jax_parity.parity_generate(_tree(host, mode), cfg, *prompt, max_seq_len=64, max_new_tokens=16,
                                        seed=3, **GREEDY)
    out = _port_parity(setup, mode, **GREEDY)
    assert out is not None and out.shape == (16, 16) and out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["none", "int4"])
def test_greedy_tokens_match_the_engine(setup, mode):
    """int4 too: the engine's int4 products against the dequantized weights."""
    np.testing.assert_array_equal(_port_parity(setup, mode, **GREEDY), _port_engine(setup, mode, **GREEDY))


def test_sampled_tokens_match_the_engine(setup):
    """One seed, one generator on one device, the engine's draw order: the
    sampled streams are equal, not only the greedy ones."""
    eng, par = _port_engine(setup), _port_parity(setup)
    assert len(np.unique(eng[:, 1:])) > 8  # really sampled
    np.testing.assert_array_equal(par, eng)


def test_sampled_tokens_follow_the_seed(setup):
    assert not np.array_equal(_port_parity(setup, seed=3), _port_parity(setup, seed=4))


def test_streaming_chunks_match_protocol(setup):
    cfg, host, prompt = setup
    chunks = list(parity.parity_generate_streaming(
        weights.params_from_numpy(host, device="cpu"), cfg, *prompt, max_seq_len=64, max_new_tokens=10,
        seed=3, chunk_size=4, first_chunk_size=2, **GREEDY))
    ref = list(jax_parity.parity_generate_streaming(
        host, cfg, *prompt, max_seq_len=64, max_new_tokens=10, seed=3, chunk_size=4, first_chunk_size=2,
        **GREEDY))
    frames = np.concatenate([f for f, _ in chunks], axis=0)
    np.testing.assert_array_equal(frames, _port_engine(setup, **GREEDY)[:10])
    timings = [t for _, t in chunks]
    assert [t["chunk_steps"] for t in timings] == [2, 4, 4]
    assert [t["chunk_index"] for t in timings] == list(range(len(timings)))
    assert [t["total_steps_so_far"] for t in timings] == [2, 6, 10]
    assert [t["is_final"] for t in timings] == [False, False, True]
    assert timings[0]["prefill_ms"] > 0 and all(t["prefill_ms"] == 0.0 for t in timings[1:])
    for (f, t), (jf, jt) in zip(chunks, ref):
        np.testing.assert_array_equal(f, jf)
        assert set(t) == set(jt)


def test_sliding_layer_types_match_engine_and_jax(sliding_setup):
    cfg, host, prompt = sliding_setup
    par = _port_parity(sliding_setup, **GREEDY)
    np.testing.assert_array_equal(par, _port_engine(sliding_setup, **GREEDY))
    ref, _ = jax_parity.parity_generate(host, cfg, *prompt, max_seq_len=64, max_new_tokens=16, seed=3, **GREEDY)
    np.testing.assert_array_equal(par, ref)
    # the window bites: without it the same weights give another stream
    full = dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, sliding_window=None, layer_types=None),
        predictor=dataclasses.replace(cfg.predictor, sliding_window=None, layer_types=None))
    unslid, _ = parity.parity_generate(weights.params_from_numpy(host, device="cpu"), full, *prompt,
                                       max_seq_len=64, max_new_tokens=16, seed=3, **GREEDY)
    assert unslid.shape != par.shape or not np.array_equal(unslid, par)


def test_bug_injection_into_layers_is_detected(setup, monkeypatch):
    """Shift the rope position of the engine's decode steps by one in
    `models/layers.py` (a uniform shift would leave attention unchanged):
    the engine's tokens change, the parity path's do not, so the comparison
    fails. The two are independent computations."""
    par = _port_parity(setup, **GREEDY)
    assert np.array_equal(par, _port_engine(setup, **GREEDY))
    real = layers.stack_decode
    monkeypatch.setattr(layers, "stack_decode",
                        lambda stacked, x, pos, rope_pos, *a: real(stacked, x, pos, rope_pos + 1, *a))
    eng = _port_engine(setup, **GREEDY)
    assert eng.shape != par.shape or not np.array_equal(eng, par)
    np.testing.assert_array_equal(_port_parity(setup, **GREEDY), par)


def test_parity_reaches_no_engine_module_and_no_kernel(setup, monkeypatch):
    """Every function of `models/layers.py`, `engine/core.py` and every
    kernel wrapper raise when called: the parity decode still runs, and the
    module's own imports name none of them."""
    from faster_qwen3_tts_tpu_torch.engine import core
    from faster_qwen3_tts_tpu_torch.ops import attention, quant

    def boom(*a, **k):
        raise AssertionError("the parity path called the engine")

    for mod in (layers, core):
        for name, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                monkeypatch.setattr(mod, name, boom)
    for mod, name in ((quant, "dot"), (quant, "int8_gemv"), (quant, "int4_gemv"), (quant, "int8_gemv_plain"),
                      (quant, "int4_gemv_plain"), (attention, "decode_attention")):
        monkeypatch.setattr(mod, name, boom)
    for mode in ("int8", "int4"):
        assert _port_parity(setup, mode, **GREEDY).shape == (16, 16)
    script = ("import sys\n"
              "import faster_qwen3_tts_tpu_torch.engine.parity\n"
              "bad = [m for m in ('faster_qwen3_tts_tpu_torch.models.layers', 'faster_qwen3_tts_tpu_torch.engine.core',\n"
              "                   'faster_qwen3_tts_tpu_torch.ops.attention') if m in sys.modules]\n"
              "assert not bad, bad\n"
              "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
    with open(os.path.join(REPO, "faster_qwen3_tts_tpu_torch", "engine", "parity.py")) as f:
        imports = [ln.strip() for ln in f if ln.lstrip().startswith(("import ", "from "))]
    assert not [ln for ln in imports if "layers" in ln or "core" in ln or "kernels" in ln or "attention" in ln
                or "gemv" in ln], imports


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_quant.quantize_model_params(
        jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False), "mixed")
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=128)
    return jax_model, port


def _xvec():
    return {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}


def test_parity_mode_stream_matches_jax(models):
    """`generate_voice_clone_streaming(parity_mode=True)` on Q8_4 weights:
    the same chunks as the JAX package's parity stream, every one vocoded on
    the host, audio within 1e-4."""
    jax_model, port = models
    kw = dict(voice_clone_prompt=_xvec(), max_new_tokens=30, chunk_size=8, first_chunk_size=4, parity_mode=True,
              seed=0, **GREEDY)
    ref = list(jax_model.generate_voice_clone_streaming("Parity hello.", "English", **kw))
    out = list(port.generate_voice_clone_streaming("Parity hello.", "English", **kw))
    assert [t["chunk_steps"] for *_, t in out] == [t["chunk_steps"] for *_, t in ref]
    assert len(out) > 2
    for (a, sr, t), (ja, jsr, jt) in zip(out, ref):
        assert sr == jsr == 24000 and a.dtype == np.float32 and a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)


def test_parity_mode_non_streaming_matches_the_engine(models):
    """`generate_voice_clone(parity_mode=True)` decodes the same tokens as
    the engine, so the audio is the same."""
    _, port = models
    kw = dict(voice_clone_prompt=_xvec(), max_new_tokens=12, do_sample=False, seed=0)
    with _greedy_predictor():
        (par,), sr = port.generate_voice_clone("Parity hello.", "English", parity_mode=True, **kw)
        (eng,), _ = port.generate_voice_clone("Parity hello.", "English", **kw)
    assert sr == 24000 and par.size > 0 and par.shape == eng.shape
    np.testing.assert_allclose(par, eng, atol=1e-5, rtol=0)
