"""Int4 and mixed quantization of the port against the JAX package.

The same seeded numpy weights go through both packages. Quantized leaves
(packed nibbles, scales, mins) and dequantized weights are bitwise equal;
the int4 product agrees with the JAX `_dot4` at 1e-5 in float32 (f32 sums in
another order); greedy tokens of whole generations at the tiny float32
geometry are exactly equal for int4 and mixed (Q8_4) weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import faster_qwen3_tts_tpu.config as jax_config
from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.models import layers
from faster_qwen3_tts_tpu_torch.models import talker as talker_lib
from faster_qwen3_tts_tpu_torch.ops import quant

torch.set_num_threads(1)
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)


class _greedy_predictors:
    """The methods without `subtalker_*` arguments sample the code predictor:
    make it greedy in both packages for the block."""

    def __enter__(self):
        self.saved = jax_gen.predictor_sampling, gen.predictor_sampling
        jax_gen.predictor_sampling = lambda *a, _f=self.saved[0]: _f(False)
        gen.predictor_sampling = lambda *a, _f=self.saved[1]: _f(False)

    def __exit__(self, *exc):
        jax_gen.predictor_sampling, gen.predictor_sampling = self.saved


def _w(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)


# (shape, group): a stacked [L, I, O] weight, an input width that is not a
# multiple of the group (one group: the tiny-layer fallback), and plain layers
@pytest.mark.parametrize("shape, group", [((128, 64), 32), ((3, 64, 32), 32), ((48, 16), 32),
                                          ((2, 40, 32), 32), ((256, 96), 64)])
def test_quantize_linear4_bitwise_equals_jax(shape, group):
    w = _w(shape)
    ours, theirs = quant.quantize_linear4(w, group=group), jax_quant.quantize_linear4(w, group=group)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, np.asarray(b))
    expect = group if shape[-2] % group == 0 else shape[-2]
    assert ours.packed.dtype == np.uint8 and ours.packed.shape[-2] == shape[-2] // 2
    assert quant.QuantizedLinear4(*ours).group == jax_quant.QuantizedLinear4(*theirs).group == expect


@pytest.mark.parametrize("kind", ["int4", "int4-stacked", "int8", "plain"])
def test_dequantize_bitwise_equals_jax(kind):
    w = _w((3, 64, 32) if kind == "int4-stacked" else (96, 48), seed=1)
    if kind.startswith("int4"):
        theirs = jax_quant.quantize_linear4(w)
    elif kind == "int8":
        theirs = jax_quant.quantize_linear(w)
    else:
        theirs = w
    node = weights.params_from_numpy({"w": theirs}, device="cpu")["w"]
    ours = quant.dequantize(node)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), jax_quant.dequantize(theirs))


# 1, 2 and 16 rows take K4's plain version (the wrapper on a CPU tensor), 40
# the many-row `_int4_matmul`
@pytest.mark.parametrize("rows", [1, 2, 16, 40])
@pytest.mark.parametrize("I, O", [(128, 64), (64, 48), (48, 32)])
def test_int4_product_matches_jax_dot4(rows, I, O):
    w = _w((I, O), seed=2)
    x = np.random.default_rng(3).standard_normal((rows, I)).astype(np.float32)
    theirs = jax_quant.quantize_linear4(w)
    ref = np.asarray(jax_quant._dot4(jnp.asarray(x), jax_quant.QuantizedLinear4(*map(jnp.asarray, theirs))))
    node = weights.params_from_numpy({"w": theirs}, device="cpu")["w"]
    out = quant.dot(torch.from_numpy(x), node)
    assert out.dtype == torch.float32 and out.shape == (rows, O)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    plain = quant.int4_gemv_plain(torch.from_numpy(x), node.packed, node.scale, node.wmin)
    np.testing.assert_array_equal(plain.numpy(), out.numpy())  # one formulation on every route
    launches = quant.int4_gemv.launches
    quant.int4_gemv(torch.from_numpy(x[:1]), node.packed, node.scale, node.wmin)
    assert quant.int4_gemv.launches == launches  # a CPU tensor launches nothing


def test_int4_product_of_stacked_weights_matches_jax():
    """[L, I, O] weights sliced per layer by `layers.unstack_layers` (as the
    decoder stacks do), each layer against the JAX product of its slice."""
    w = _w((3, 64, 32), seed=4)
    x = np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32)
    theirs = jax_quant.quantize_linear4(w)
    node = weights.params_from_numpy({"w": theirs}, device="cpu")["w"]
    per_layer = layers.unstack_layers({"wq": node})
    assert len(per_layer) == layers._num_layers({"wq": node}) == 3
    for i, lp in enumerate(per_layer):
        assert isinstance(lp["wq"], quant.QuantizedLinear4) and lp["wq"].group == 32
        ref = jax_quant._dot4(jnp.asarray(x), jax_quant.QuantizedLinear4(*(jnp.asarray(f[i]) for f in theirs)))
        np.testing.assert_allclose(quant.dot(torch.from_numpy(x), lp["wq"]).numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def host(tiny_config):
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    return cfg, jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)


@pytest.mark.parametrize("mode", ["none", "int8", "int4", "mixed"])
def test_infer_quant_mode_matches_jax(host, mode):
    _, tree = host
    theirs = tree if mode == "none" else jax_quant.quantize_model_params(tree, mode)
    ours = weights.params_from_numpy(theirs, device="cpu")
    assert quant.infer_quant_mode(ours) == jax_quant.infer_quant_mode(theirs) == mode


def test_infer_quant_mode_raises_on_a_layout_never_produced(host):
    _, tree = host
    q8, q4 = (jax_quant.quantize_model_params(tree, m) for m in ("int8", "int4"))
    odd = dict(q4, predictor=q8["predictor"])  # talker int4, predictor int8
    with pytest.raises(ValueError, match="talker=int4, predictor=int8"):
        jax_quant.infer_quant_mode(odd)
    with pytest.raises(ValueError, match="talker=int4, predictor=int8"):
        quant.infer_quant_mode(weights.params_from_numpy(odd, device="cpu"))


@pytest.mark.parametrize("name", ["BF16", "bf16", "F32", "fp32", "none", "float32", "bfloat16", None, "",
                                  "Q8_0", "int8", "q8", "Q4_K_M", "q4_k", "int4", "Q4", "q4_0", "Q8_4",
                                  "mixed"])
def test_resolve_quant_name_matches_jax(name):
    assert quant.resolve_quant_name(name) == jax_quant.resolve_quant_name(name)


def test_resolve_quant_name_raises_as_jax():
    with pytest.raises(ValueError) as ours:
        quant.resolve_quant_name("Q5_1")
    with pytest.raises(ValueError) as theirs:
        jax_quant.resolve_quant_name("Q5_1")
    assert str(ours.value) == str(theirs.value)


def test_mixed_mode_structure(host):
    """Q8_4: every talker projection int8, every predictor projection int4,
    leaf for leaf equal to the JAX package's tree."""
    _, tree = host
    ours, theirs = quant.quantize_model_params(tree, "mixed"), jax_quant.quantize_model_params(tree, "mixed")
    for sub, kind in (("talker", quant.QuantizedLinear), ("predictor", quant.QuantizedLinear4)):
        heads = ("codec_head",) if sub == "talker" else ("lm_heads",)
        projs = [ours[sub]["layers"][k] for k in quant._LAYER_WEIGHTS] + [ours[sub][h] for h in heads]
        projs.append(ours[sub]["text_proj" if sub == "talker" else "mtp_proj"]["w"])
        assert all(isinstance(p, kind) for p in projs), sub
    assert isinstance(ours["talker"]["codec_embed"], np.ndarray)
    assert isinstance(ours["predictor"]["codec_embeds"], np.ndarray)
    flat_ours = jax.tree_util.tree_leaves(ours)
    flat_theirs = jax.tree_util.tree_leaves(theirs)
    assert len(flat_ours) == len(flat_theirs)
    for a, b in zip(flat_ours, flat_theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_int4_logit_cosine_guardrail(host):
    """The JAX package's quality guardrail on the port: int4 talker prefill
    logits keep cosine > 0.95 with the float32 ones at the tiny geometry,
    and int8 is tighter (> 0.999)."""
    cfg, tree = host
    H = cfg.talker.hidden_size
    embeds = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16, H)).astype(np.float32) * 0.05)
    mask = torch.ones((1, 16), dtype=torch.int32)

    def logits(mode):
        p = weights.materialize(tree, torch.float32, mode, "cpu")
        return talker_lib.prefill(p["talker"], cfg.talker, embeds, mask)[1][0].numpy()

    a, b, c8 = logits("none"), logits("int4"), logits("int8")
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    cos8 = float(a @ c8 / (np.linalg.norm(a) * np.linalg.norm(c8)))
    assert cos > 0.95, cos
    assert cos8 > cos and cos8 > 0.999, (cos8, cos)


@pytest.fixture(scope="module")
def models(host):
    """mode -> (JAX model, port model) on one quantized host tree."""
    cfg, tree = host
    built = {}

    def build(mode, **over):
        key = (mode, tuple(sorted(over)))
        if key not in built:
            c = dataclasses.replace(cfg, **over)
            q = jax_quant.quantize_model_params(tree, mode)
            jax_model = JaxTTS(jax.device_put(q), c, PromptTokenizer(ByteTokenizer()), max_seq_len=160)
            jax_model._warmed_up = True
            port = FasterQwen3TTS(weights.params_from_numpy(q, device="cpu"), c,
                                  PromptTokenizer(ByteTokenizer()), max_seq_len=160)
            built[key] = (jax_model, port)
        return built[key]

    return build


def _xvec(seed):
    return {"ref_spk_embedding": [np.random.default_rng(seed).standard_normal(2048).astype(np.float32)]}


def _frames(model, call):
    """Token frames of one public call: each stream chunk's, or the whole
    sequence handed to the codec."""
    got = []
    stream_relay, whole_relay = model._stream_decode, model._decode_audio

    def stream_tap(stream, *a):
        def tap():
            for item in stream:
                got.append(np.asarray(item[0]))
                yield item
        return stream_relay(tap(), *a)

    model._stream_decode = stream_tap
    model._decode_audio = lambda ids, rc: (got.append(np.asarray(ids)), whole_relay(ids, rc))[1]
    try:
        out = call(model)
        if not isinstance(out, tuple):
            out = list(out)
    finally:
        del model._stream_decode, model._decode_audio
    return np.concatenate(got)


@pytest.mark.parametrize("mode", ["int4", "mixed"])
@pytest.mark.parametrize("method", ["generate_voice_clone", "generate_voice_clone_streaming"])
def test_voice_clone_tokens_match_jax(models, mode, method):
    jax_model, port = models(mode)
    kw = dict(voice_clone_prompt=_xvec(0), max_new_tokens=20, **GREEDY)
    if method.endswith("streaming"):
        kw.update(chunk_size=8, first_chunk_size=4)
    else:
        kw.pop("subtalker_dosample")  # the non-streaming methods sample the predictor: keep it greedy below
    call = lambda m: getattr(m, method)("Quantized hello there.", "English", **kw)
    if method.endswith("streaming"):
        ref, out = _frames(jax_model, call), _frames(port, call)
    else:
        with _greedy_predictors():
            ref, out = _frames(jax_model, call), _frames(port, call)
    assert out.shape[0] > 4
    np.testing.assert_array_equal(out, ref)



@pytest.mark.parametrize("mode", ["int4", "mixed"])
def test_custom_voice_tokens_match_jax(models, mode):
    speakers = dict(spk_id=jax_config._freeze({"aiden": 2180, "dylan": 2182}),
                    spk_is_dialect=jax_config._freeze({"aiden": False, "dylan": "beijing_dialect"}))
    _, tiny = models(mode)  # the base config's talker
    talker = dataclasses.replace(tiny.config.talker, **speakers)
    jax_model, port = models(mode, model_type="custom_voice", model_size="1b7", talker=talker)
    call = lambda m: m.generate_custom_voice_streaming(
        "Custom voice text.", "dylan", "Chinese", instruct="Speak slowly.", max_new_tokens=20,
        chunk_size=8, first_chunk_size=4, do_sample=False, seed=0)
    with _greedy_predictors():
        ref, out = _frames(jax_model, call), _frames(port, call)
    assert out.shape[0] > 4
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["int4", "mixed"])
def test_lockstep_batch_tokens_match_jax(models, mode, monkeypatch):
    """A lockstep batch of B = 2: every lane's valid frames equal."""
    jax_model, port = models(mode)
    requests = [{"text": "Hello world.", "voice_clone_prompt": _xvec(1), "xvec_only": True},
                {"text": "A longer second sentence here.", "voice_clone_prompt": _xvec(2), "xvec_only": True}]
    lanes = {}
    for name, mod in (("jax", jax_gen), ("port", gen)):
        real = mod.fast_generate_streaming_batch
        rec = lanes[name] = {}

        def recording(*a, _real=real, _rec=rec, **k):
            for item in _real(*a, **k):
                frames, valid = np.asarray(item[0]), np.asarray(item[1])
                for s in range(frames.shape[1]):
                    _rec.setdefault(s, []).append(frames[valid[:, s], s])
                yield item

        monkeypatch.setattr(mod, "fast_generate_streaming_batch", recording)
    for model in (jax_model, port):
        list(model.generate_voice_clone_streaming_batch(requests, chunk_size=8, max_new_tokens=20, **GREEDY))
    for s in range(2):
        ours, theirs = np.concatenate(lanes["port"][s]), np.concatenate(lanes["jax"][s])
        assert ours.shape[0] > 4
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name, mode", [("Q4_K_M", "int4"), ("int4", "int4"), ("Q8_4", "mixed"),
                                        ("mixed", "mixed")])
def test_from_pretrained_loads_every_int4_name(tmp_path_factory, host, name, mode):
    """`from_pretrained(dir, quant=...)` on the CPU: the tree the name asks
    for, leaf for leaf the JAX package's quantization of the checkpoint's
    weights, a timed quantize phase, and a stream of audio."""
    from faster_qwen3_tts_tpu_torch.config import tiny_test_config

    cfg = dataclasses.replace(tiny_test_config(), tts_bos_token_id=300, tts_eos_token_id=301,
                              tts_pad_token_id=302)
    path = tmp_path_factory.mktemp("ckpt") / "tiny"
    tree = weights.init_numpy(cfg, seed=0)
    weights.save_pretrained(str(path), tree, cfg)
    model = FasterQwen3TTS.from_pretrained(str(path), device="cpu", dtype="float32", quant=name)
    assert quant.infer_quant_mode(model.params) == mode
    assert "quantize" in model.load_phases
    want = jax_quant.quantize_model_params(tree, mode)["predictor"]["lm_heads"]
    for a, b in zip(model.params["predictor"]["lm_heads"], want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n = sum(a.size for a, _, _ in model.generate_voice_clone_streaming(
        "Hi.", "English", voice_clone_prompt=_xvec(0), max_new_tokens=6, chunk_size=4, **GREEDY))
    assert n > 0
