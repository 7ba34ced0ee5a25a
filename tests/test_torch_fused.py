"""The fused projection layout (`quant.fuse_layer_weights`, `from_pretrained(
fuse_qkv=True)`) against the JAX package's and against the unfused port.

Every case runs in each quant mode (float32 weights, int8, int4, mixed) at
the tiny float32 geometry, greedy. The fused leaves are bitwise the JAX
package's; fused decode gives the unfused tokens exactly and its logits
within 1e-5; the fused port gives the fused JAX engine's tokens exactly and
its logits within 1e-4 (f32 sums in another order)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import core as jax_core
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import tiny_test_config
from faster_qwen3_tts_tpu_torch.engine import core
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.ops import quant
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

torch.set_num_threads(1)
MODES = ["none", "int8", "int4", "mixed"]
QUANT_NAMES = {"none": "F32", "int8": "Q8_0", "int4": "Q4_K_M", "mixed": "Q8_4"}
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)


def _host(cfg, mode, seed=3):
    host = jax_weights.init_all(cfg, seed=seed, dtype=jnp.float32, device_put=False)
    return host if mode == "none" else jax_quant.quantize_model_params(host, mode)


def _leaves(node):
    return [np.asarray(x) for x in node] if isinstance(node, tuple) else [np.asarray(node)]


@pytest.mark.parametrize("mode", MODES)
def test_fuse_layer_weights_bitwise_equals_jax(tiny_config, mode):
    host = _host(tiny_config, mode)
    theirs = jax_quant.fuse_layer_weights(host)
    port = weights.params_from_numpy(host, device="cpu")
    ours = quant.fuse_layer_weights(port)
    assert "wq" in port["talker"]["layers"]  # the input tree is left as it was
    for sub in ("talker", "predictor"):
        assert sorted(ours[sub]["layers"]) == sorted(theirs[sub]["layers"])
        assert "wqkv" in ours[sub]["layers"] and "w_gate" not in ours[sub]["layers"]
        for key in ("wqkv", "w_gateup"):
            a, b = ours[sub]["layers"][key], theirs[sub]["layers"][key]
            assert isinstance(a, tuple) == isinstance(b, tuple)
            if isinstance(a, tuple):
                assert type(a).__name__ == type(b).__name__
            for x, y in zip(_leaves(a), _leaves(b)):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    assert quant.infer_quant_mode(ours) == jax_quant.infer_quant_mode(theirs) == quant.infer_quant_mode(port)


def _prompt(cfg, seed=0):
    rng = np.random.default_rng(seed)
    H = cfg.talker.hidden_size
    embeds = (rng.standard_normal((2, 12, H)) * 0.5).astype(np.float32)
    pad = np.ones((2, 12), np.int32)
    pad[1, :4] = 0  # a left-padded row
    embeds[1, :4] = 0.0
    tth = (rng.standard_normal((2, 5, H)) * 0.5).astype(np.float32)
    tpe = (rng.standard_normal((1, 1, H)) * 0.5).astype(np.float32)
    return embeds, pad, tth, tpe


def _port_decode(params, cfg, prompt, chunks=3, chunk=4):
    embeds, pad, tth, tpe = prompt
    ts, ps = SamplingParams(do_sample=False), SamplingParams(do_sample=False, repetition_penalty=1.0)
    state, logits = core.start_state(params["talker"], cfg.talker, torch.tensor(embeds), torch.tensor(pad), None,
                                     64, ts, 2)
    out = [state.token.numpy().copy()]
    for _ in range(chunks):
        state, packed = core.decode_chunk(params["talker"], params["predictor"], cfg.talker, cfg.predictor, state,
                                          torch.tensor(tth), torch.tensor(tpe), chunk, ts, ps, 2)
        out.append(packed.numpy().copy())
    return logits.numpy(), state.past_hidden.float().numpy(), out


@pytest.mark.parametrize("mode", MODES)
def test_fused_decode_equals_unfused(tiny_config, mode):
    port = weights.params_from_numpy(_host(tiny_config, mode), device="cpu")
    prompt = _prompt(tiny_config)
    logits, hidden, frames = _port_decode(port, tiny_config, prompt)
    flogits, fhidden, fframes = _port_decode(quant.fuse_layer_weights(port), tiny_config, prompt)
    np.testing.assert_allclose(flogits, logits, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fhidden, hidden, atol=1e-5, rtol=1e-5)
    for a, b in zip(fframes, frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_fused_port_equals_fused_jax(tiny_config, mode):
    host = _host(tiny_config, mode)
    jparams = jax.device_put(jax_quant.fuse_layer_weights(host))
    embeds, pad, tth, tpe = prompt = _prompt(tiny_config)
    js, jps = JaxSamplingParams(do_sample=False), JaxSamplingParams(do_sample=False, repetition_penalty=1.0)
    jstate, jlogits = jax_core.start_state(jparams["talker"], tiny_config.talker, jnp.asarray(embeds),
                                           jnp.asarray(pad), jax.random.PRNGKey(0), 64, js, 2)
    jframes = [np.asarray(jstate.token)]
    for _ in range(3):
        jstate, jpacked = jax_core.decode_chunk(jparams["talker"], jparams["predictor"], tiny_config.talker,
                                                tiny_config.predictor, jstate, jnp.asarray(tth), jnp.asarray(tpe),
                                                4, js, jps, 2)
        jframes.append(np.asarray(jpacked))
    logits, _, frames = _port_decode(quant.fuse_layer_weights(weights.params_from_numpy(host, device="cpu")),
                                     tiny_config, prompt)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    path = tmp_path_factory.mktemp("fused") / "ckpt"
    weights.save_pretrained(str(path), weights.init_numpy(cfg, seed=0), cfg)
    return str(path)


def _load(tiny_dir, mode, fuse):
    return FasterQwen3TTS.from_pretrained(tiny_dir, device="cpu", dtype="float32", quant=QUANT_NAMES[mode],
                                          max_seq_len=128, fuse_qkv=fuse)


def _frames(model, sink):
    relay = model._stream_decode
    model._stream_decode = lambda stream, *a: relay(((sink.append(np.asarray(i[0])), i)[1] for i in stream), *a)


@pytest.mark.parametrize("mode", MODES)
def test_from_pretrained_fuse_qkv_streams_like_unfused(tiny_dir, mode, monkeypatch):
    """`from_pretrained(dir, fuse_qkv=True)`: the fused layout after
    quantization (the unfused names gone), streaming and non-streaming
    requests with the unfused model's tokens and audio within 1e-5."""
    monkeypatch.setattr(gen, "predictor_sampling", lambda *a, _f=gen.predictor_sampling: _f(False))
    plain, fused = _load(tiny_dir, mode, False), _load(tiny_dir, mode, True)
    for sub in ("talker", "predictor"):
        layers = fused.params[sub]["layers"]
        assert "wqkv" in layers and "w_gateup" in layers and not {"wq", "wk", "wv", "w_gate", "w_up"} & set(layers)
        assert type(layers["wqkv"]) is type(plain.params[sub]["layers"]["wq"])
    assert "fuse" in fused.load_phases and "fuse" not in plain.load_phases
    prompt = {"ref_spk_embedding": [np.random.default_rng(1).standard_normal(2048).astype(np.float32)]}
    kw = dict(voice_clone_prompt=prompt, max_new_tokens=14, chunk_size=4, first_chunk_size=2, **GREEDY)
    sinks = [], []
    outs = []
    for model, sink in zip((plain, fused), sinks):
        _frames(model, sink)
        outs.append([a for a, _, _ in model.generate_voice_clone_streaming("Fused and not.", "English", **kw)])
    np.testing.assert_array_equal(np.concatenate(sinks[1]), np.concatenate(sinks[0]))
    assert [a.shape for a in outs[1]] == [a.shape for a in outs[0]]
    np.testing.assert_allclose(np.concatenate(outs[1]), np.concatenate(outs[0]), atol=1e-5, rtol=0)
    (a,), _ = plain.generate_voice_clone("Fused and not.", "English", voice_clone_prompt=prompt, max_new_tokens=10,
                                         do_sample=False, seed=0)
    (b,), _ = fused.generate_voice_clone("Fused and not.", "English", voice_clone_prompt=prompt, max_new_tokens=10,
                                         do_sample=False, seed=0)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_parity_mode_on_a_fused_model_raises(tiny_dir):
    fused = _load(tiny_dir, "int8", True)
    prompt = {"ref_spk_embedding": [np.ones(2048, np.float32)]}
    with pytest.raises(ValueError, match="fuse_qkv"):
        fused.generate_voice_clone("Hi.", "English", voice_clone_prompt=prompt, parity_mode=True)
    with pytest.raises(ValueError, match="fuse_qkv"):
        next(fused.generate_voice_clone_streaming("Hi.", "English", voice_clone_prompt=prompt, parity_mode=True))


def test_fused_checkpoint_loads_back_as_in_jax(tmp_path, monkeypatch):
    """A fused host tree saved with `save_pretrained` loads back fused in both
    packages (the JAX package keeps the saved layout): the same leaves, and
    greedy tokens equal to the JAX model's on that checkpoint;
    `fuse_qkv=True` on it changes nothing."""
    monkeypatch.setattr(gen, "predictor_sampling", lambda *a, _f=gen.predictor_sampling: _f(False))
    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    tree = quant.fuse_layer_weights(weights.init_numpy(cfg, seed=0))
    weights.save_pretrained(str(tmp_path / "fused"), tree, cfg)
    jax_tree, _ = jax_weights.load_pretrained(str(tmp_path / "fused"))
    assert "wqkv" in jax_tree["talker"]["layers"] and "wq" not in jax_tree["talker"]["layers"]
    ours = FasterQwen3TTS.from_pretrained(str(tmp_path / "fused"), device="cpu", dtype="float32", max_seq_len=128)
    again = FasterQwen3TTS.from_pretrained(str(tmp_path / "fused"), device="cpu", dtype="float32", max_seq_len=128,
                                           fuse_qkv=True)
    for sub in ("talker", "predictor"):
        for key in ("wqkv", "w_gateup"):
            np.testing.assert_array_equal(ours.params[sub]["layers"][key].numpy(), jax_tree[sub]["layers"][key])
            assert torch.equal(again.params[sub]["layers"][key], ours.params[sub]["layers"][key])
    theirs = JaxTTS.from_pretrained(str(tmp_path / "fused"), dtype="float32", max_seq_len=128)
    theirs._warmed_up = True
    prompt = {"ref_spk_embedding": [np.random.default_rng(2).standard_normal(2048).astype(np.float32)]}
    kw = dict(voice_clone_prompt=prompt, max_new_tokens=10, chunk_size=4, **GREEDY)
    sinks = [], []
    for model, sink in zip((theirs, ours), sinks):
        _frames(model, sink)
        list(model.generate_voice_clone_streaming("A saved fused tree.", "English", **kw))
    np.testing.assert_array_equal(np.concatenate(sinks[1]), np.concatenate(sinks[0]))
