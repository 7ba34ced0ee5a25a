"""The serving restart in the port against the JAX package's, on the CPU:
deploy bundles, the packed transfer, random init on the device and the
quantizers that run on a tensor's device.

The JAX package's bundle, pack, device-init and quantizer tests of
tests/test_weights.py, one for one, over the port; then the cases between
the two packages: a bundle written by either loads in the other bit for bit
(int8, int4, mixed, compact, fused), both write the same bytes from one host
tree, and a bundle-loaded port model streams the JAX model's greedy tokens
(exact) and audio (atol 1e-4). Weights come from the JAX package
(`weights.init_all(cfg, device_put=False)`, quantized by its numpy code) and
reach the port through `params_from_numpy`.
"""
import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu import weights as jw
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.models import voice_extract as jax_voice_extract
from faster_qwen3_tts_tpu.ops import quant as jq
from faster_qwen3_tts_tpu_torch import weights as pw
from faster_qwen3_tts_tpu_torch.config import config_from_dict
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.ops import quant as pq
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

torch.set_num_threads(1)
MODES = ("none", "int8", "int4", "mixed")
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)


@pytest.fixture(scope="module")
def cfg(tiny_config):
    # the byte tokenizer's text ids stay below the tiny text vocabulary of 512
    return dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)


@pytest.fixture(scope="module")
def port_cfg(cfg):
    return config_from_dict(jw._config_to_dict(cfg))


@pytest.fixture(scope="module")
def bf16_tree(cfg):
    """The JAX package's host tree: talker and predictor bfloat16 (ml_dtypes), codec float32."""
    return jw.init_all(cfg, seed=0, dtype=jnp.bfloat16, device_put=False)


def _jax_quantized(tree, mode):
    return tree if mode == "none" else jq.quantize_model_params(tree, mode)


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf of either package (numpy, ml_dtypes, jax or torch)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def assert_trees_bitwise(a, b):
    """Two trees of either package: the same typed paths, dtypes, shapes and bytes."""
    fa, fb = pw._flatten_typed(a), pw._flatten_typed(b)
    assert list(fa) == list(fb), sorted(set(fa) ^ set(fb))
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.array_equal(_bits(fa[k]), _bits(fb[k])), k


def _port_tree(jax_tree):
    return pw.params_from_numpy(jax_tree, "cpu")


# -- random init on the device (tests/test_weights.py:74-122) ----------------------------------------


def test_init_all_device_matches_host_structure(cfg, port_cfg, bf16_tree):
    """Same tree, shapes and dtypes as the host init (the JAX package's,
    through params_from_numpy); random leaves drawn at the right scale;
    constant leaves exact."""
    host = _port_tree(bf16_tree)
    dev = pw.init_all_device(port_cfg, seed=0, device="cpu")
    fh, fd = pw._flatten_typed(host), pw._flatten_typed(dev)
    assert list(fh) == list(fd)
    n_random = 0
    for k in fh:
        h, d = fh[k], fd[k]
        assert h.shape == d.shape and h.dtype == d.dtype, k
        hf, df = h.float(), d.float()
        if h.numel() and bool((hf == hf.reshape(-1)[0]).all()):
            assert torch.equal(d, h), k  # norm ones, biases, layer scales
        elif h.numel() >= 256:
            n_random += 1
            hstd, dstd = float(hf.std()), float(df.std())
            assert dstd > 0, k
            assert 0.6 < dstd / max(hstd, 1e-30) < 1.6, (k, hstd, dstd)
    assert n_random > 5


def test_init_all_device_is_seeded(port_cfg):
    a = pw._flatten_typed(pw.init_all_device(port_cfg, seed=1, device="cpu"))
    b = pw._flatten_typed(pw.init_all_device(port_cfg, seed=1, device="cpu"))
    c = pw._flatten_typed(pw.init_all_device(port_cfg, seed=2, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["talker/codec_head"], c["talker/codec_head"])


@pytest.mark.parametrize("mode", ["int8", "int4", "mixed"])
def test_device_init_quantizes_on_device(cfg, port_cfg, bf16_tree, mode):
    """quantize_model_params on a device-init tree (torch quantizers) gives
    the structure, shapes and dtypes of the JAX host path."""
    dev = pq.quantize_model_params(pw.init_all_device(port_cfg, seed=0, device="cpu"), mode)
    host = _port_tree(jq.quantize_model_params(bf16_tree, mode))
    fd, fh = pw._flatten_typed(dev), pw._flatten_typed(host)
    assert list(fd) == list(fh)
    for k in fd:
        assert fd[k].shape == fh[k].shape and fd[k].dtype == fh[k].dtype, k


@pytest.mark.parametrize("mode", ["int8", "mixed"])
def test_quantize_on_device_equals_host_quantization(bf16_tree, mode):
    """The port's tree quantized by the torch quantizers equals the JAX
    package's numpy quantization of the same tree, bit for bit."""
    assert_trees_bitwise(pq.quantize_model_params(_port_tree(bf16_tree), mode),
                         _port_tree(jq.quantize_model_params(bf16_tree, mode)))


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 32), (40, 24), (2, 72, 16)])
def test_quantize_torch_matches_numpy(shape):
    """The torch quantizers equal the numpy ones (the port's and the JAX
    package's) bit for bit: q / packed exact, scale / wmin bitwise; 40 and
    72 are no multiple of 32, where int4 falls back to one group. Where the
    JAX device twins run (I % 32 == 0) they agree at their rtol of 1e-6."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape, dtype=np.float32) * np.float32(rng.uniform(0.01, 3.0))
    for np_fn, torch_fn, jax_np in ((pq.quantize_linear, pq.quantize_linear_torch, jq.quantize_linear),
                                    (pq.quantize_linear4, pq.quantize_linear4_torch, jq.quantize_linear4)):
        ours, theirs, got = np_fn(w), jax_np(w), torch_fn(torch.from_numpy(w))
        for a, b, c in zip(ours, theirs, got):
            assert a.dtype == b.dtype == c.numpy().dtype and a.shape == b.shape == tuple(c.shape)
            assert np.array_equal(_bits(a), _bits(b)) and np.array_equal(_bits(a), _bits(c))
        bf = torch.from_numpy(w).to(torch.bfloat16)  # a bf16 leaf, as a loaded tree holds them
        for a, c in zip(np_fn(bf.float().numpy()), torch_fn(bf)):
            assert np.array_equal(_bits(a), _bits(c))
    if shape[-2] % 32 == 0:
        q8, q4 = jq.quantize_linear_jnp(jnp.asarray(w)), jq.quantize_linear4_jnp(jnp.asarray(w))
        np.testing.assert_array_equal(np.asarray(q8.q), pq.quantize_linear(w).q)
        np.testing.assert_allclose(np.asarray(q8.scale), pq.quantize_linear(w).scale, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(q4.packed), pq.quantize_linear4(w).packed)
        np.testing.assert_allclose(np.asarray(q4.wmin), pq.quantize_linear4(w).wmin, rtol=1e-6)


def test_infer_quant_mode():
    def tree(t, p):
        return {"talker": {"layers": {"wq": t}}, "predictor": {"layers": {"wq": p}}}

    w = torch.zeros(4, 4)
    q8 = pq.quantize_linear_torch(w)
    q4 = pq.quantize_linear4_torch(torch.zeros(32, 32))
    assert pq.infer_quant_mode(tree(w, w)) == "none"
    assert pq.infer_quant_mode(tree(q8, q8)) == "int8"
    assert pq.infer_quant_mode(tree(q4, q4)) == "int4"
    assert pq.infer_quant_mode(tree(q8, q4)) == "mixed"
    with pytest.raises(ValueError, match="unrecognized"):
        pq.infer_quant_mode(tree(q4, q8))


# -- the packed transfer and the bundle (tests/test_weights.py:142-290) ------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_pack_transfer_bit_exact(bf16_tree, mode):
    """pack_transfer of a host tree (quantized nodes included) equals
    params_from_numpy of it, bit for bit, every leaf its own allocation."""
    tree = _jax_quantized(bf16_tree, mode)
    got = pw.pack_transfer(tree, device="cpu")
    assert_trees_bitwise(got, _port_tree(tree))
    flat = pw._flatten_typed(got)
    assert len({t.untyped_storage().data_ptr() for t in pw._leaves(got)}) == len(flat)
    if mode == "mixed":
        assert isinstance(got["talker"]["layers"]["wq"], pq.QuantizedLinear)
        assert isinstance(got["predictor"]["layers"]["wq"], pq.QuantizedLinear4)
    with pytest.raises(ValueError, match="sharding"):
        pw.pack_transfer(tree, sharding="replicated", device="cpu")


def test_deploy_bundle_compact_f32(cfg, port_cfg, tmp_path):
    """compact_f32 stores float32 leaves as bfloat16 and upcasts them at the
    unpack: dtypes come back float32, values the bf16 rounding of the
    source; the file shrinks."""
    tree = jw.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    pw.save_deploy_bundle(tmp_path / "full", tree, port_cfg)
    pw.save_deploy_bundle(tmp_path / "compact", tree, port_cfg, compact_f32=True)
    full = (tmp_path / "full" / "bundle.bin").stat().st_size
    compact = (tmp_path / "compact" / "bundle.bin").stat().st_size
    assert compact < full * 0.75
    got, cfg2, mode = pw.load_deploy_bundle(tmp_path / "compact", device="cpu")
    assert cfg2 == port_cfg and mode == "none"
    want = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32), tree)
    assert_trees_bitwise(got, _port_tree(want))


def test_deploy_bundle_roundtrip_and_from_pretrained(cfg, port_cfg, tmp_path, caplog):
    """save -> load is bit-exact; from_pretrained(dir) takes the bundle,
    keeps its quant mode and rejects a conflicting quant."""
    q = jq.quantize_model_params(jw.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False), "int8")
    pw.save_deploy_bundle(tmp_path, q, port_cfg, quant_mode="int8")
    assert pw.is_deploy_bundle(tmp_path)
    got, cfg2, mode = pw.load_deploy_bundle(tmp_path, device="cpu")
    assert mode == "int8" and cfg2 == port_cfg
    assert_trees_bitwise(got, _port_tree(q))
    with caplog.at_level(logging.WARNING):
        m = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", quant="Q8_0", max_seq_len=128,
                                           fuse_qkv=True)
    assert "BYTE tokenizer" in caplog.text and "keeps the layout" in caplog.text
    assert isinstance(m.params["talker"]["layers"]["wq"], pq.QuantizedLinear)  # fuse_qkv ignored
    assert {"pin", "weights_read", "device_transfer"} <= set(m.load_phases)
    assert m.load_phases["transfer_mb"] == round(os.path.getsize(tmp_path / "bundle.bin") / 1e6, 1)
    assert_trees_bitwise(m.params, _port_tree(q))
    with pytest.raises(ValueError, match="conflicts"):
        FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", quant="Q4_K_M", max_seq_len=128)


def test_bundle_version_is_checked(cfg, port_cfg, tmp_path):
    pw.save_deploy_bundle(tmp_path, jw.init_all(cfg, seed=0, device_put=False), port_cfg)
    meta = json.loads((tmp_path / "bundle.json").read_text())
    meta["version"] = 1
    (tmp_path / "bundle.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="unsupported bundle version 1"):
        pw.read_deploy_bundle(tmp_path)


def test_model_save_deploy_bundle_roundtrip(cfg, port_cfg, tmp_path):
    """model.save_deploy_bundle writes the current (quantized) parameters
    with the inferred mode; loading them back is bit-exact."""
    q = _port_tree(jq.quantize_model_params(jw.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False),
                                            "mixed"))
    m = FasterQwen3TTS(q, port_cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    m.save_deploy_bundle(str(tmp_path / "b"), compact_f32=False)
    got, cfg2, mode = pw.load_deploy_bundle(tmp_path / "b", device="cpu")
    assert mode == "mixed" and cfg2 == port_cfg
    assert_trees_bitwise(got, q)
    assert isinstance(got["predictor"]["layers"]["wq"], pq.QuantizedLinear4)


def test_unquantized_bundle_quantizes_on_load(cfg, port_cfg, bf16_tree, tmp_path):
    """quant=Q8_0 on an unquantized bundle quantizes after the unpack, with
    the bits of the host quantization."""
    pw.save_deploy_bundle(tmp_path, bf16_tree, port_cfg, quant_mode="none")
    m = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", quant="Q8_0", max_seq_len=128)
    assert isinstance(m.params["talker"]["layers"]["wq"], pq.QuantizedLinear)
    assert "quantize" in m.load_phases
    assert_trees_bitwise(m.params, _port_tree(jq.quantize_model_params(bf16_tree, "int8")))


def test_bundle_carries_tokenizer_assets(cfg, port_cfg, tmp_path, caplog):
    """save_deploy_bundle copies the tokenizer assets of the source
    checkpoint; with none to copy it warns."""
    src = tmp_path / "src"
    jw.save_pretrained(str(src), jw.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False), cfg)
    (src / "tokenizer.json").write_text("{}")
    (src / "tokenizer_config.json").write_text("{}")
    m = FasterQwen3TTS.from_pretrained(str(src), device="cpu", dtype="float32", max_seq_len=128)
    m.save_deploy_bundle(str(tmp_path / "bundle"), compact_f32=False)
    assert (tmp_path / "bundle" / "tokenizer.json").exists()
    assert (tmp_path / "bundle" / "tokenizer_config.json").exists()
    with caplog.at_level(logging.WARNING):
        FasterQwen3TTS(m.params, port_cfg, m.tokenizer).save_deploy_bundle(str(tmp_path / "bare"))
    assert "no tokenizer assets" in caplog.text


def test_device_init_from_pretrained(port_cfg, monkeypatch):
    """FQ3T_DEVICE_INIT=1 on a model id (here resolving to the tiny
    geometry): drawn on the device and quantized there; the tree of the
    host path."""
    monkeypatch.setattr("faster_qwen3_tts_tpu_torch.model.get_config", lambda name: port_cfg)
    host = FasterQwen3TTS.from_pretrained("0.6b", device="cpu", quant="Q8_0", max_seq_len=128)
    monkeypatch.setenv("FQ3T_DEVICE_INIT", "1")
    dev = FasterQwen3TTS.from_pretrained("0.6b", device="cpu", quant="Q8_0", max_seq_len=128)
    assert {"weights_read", "quantize"} <= set(dev.load_phases)
    fh, fd = pw._flatten_typed(host.params), pw._flatten_typed(dev.params)
    assert list(fh) == list(fd)
    assert all(fh[k].shape == fd[k].shape and fh[k].dtype == fd[k].dtype for k in fh)
    assert not torch.equal(fh["talker/codec_embed"], fd["talker/codec_embed"])


def test_the_card_is_required_without_a_fallback(cfg, port_cfg, tmp_path, monkeypatch):
    """device="cuda" without a card: the bundle load and the device init raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pw.save_deploy_bundle(tmp_path, jw.init_all(cfg, seed=0, device_put=False), port_cfg)
    for fn in (lambda: pw.load_deploy_bundle(tmp_path), lambda: pw.init_all_device(port_cfg),
               lambda: FasterQwen3TTS.from_pretrained(str(tmp_path))):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


# -- between the two packages ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compact", [False, True])
def test_jax_bundle_loads_in_the_port(cfg, bf16_tree, tmp_path, mode, compact):
    """(a) A bundle written by the JAX package loads in the port with every
    leaf bitwise params_from_numpy of the same tree (compact: of its bf16
    rounding)."""
    tree = _jax_quantized(bf16_tree, mode)
    jw.save_deploy_bundle(str(tmp_path), tree, cfg, quant_mode=mode, compact_f32=compact)
    got, pcfg, got_mode = pw.load_deploy_bundle(tmp_path, device="cpu")
    assert got_mode == mode and pw._config_to_dict(pcfg) == jw._config_to_dict(cfg)
    if compact:
        tree = jax.tree.map(lambda a: (np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32)
                                       if np.asarray(a).dtype == np.float32 else a), tree)
    assert_trees_bitwise(got, _port_tree(tree))


@pytest.mark.parametrize("mode", MODES)
def test_port_bundle_loads_in_jax(cfg, port_cfg, bf16_tree, tmp_path, mode):
    """(b) model.save_deploy_bundle of the port loads in the JAX
    load_deploy_bundle bitwise equal to the JAX tree it came from."""
    tree = _jax_quantized(bf16_tree, mode)
    m = FasterQwen3TTS(_port_tree(tree), port_cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    m.save_deploy_bundle(str(tmp_path), compact_f32=False)
    got, jcfg, got_mode = jw.load_deploy_bundle(str(tmp_path))
    assert got_mode == mode and jcfg == cfg
    fa, fb = jw._flatten_typed(tree), jw._flatten_typed(got)
    assert list(fa) == list(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        assert np.array_equal(_bits(fa[k]), _bits(fb[k])), k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("compact", [False, True])
def test_both_packages_write_the_same_bytes(cfg, port_cfg, bf16_tree, tmp_path, mode, compact):
    """(c) bundle.bin and bundle.json from one host tree are byte-identical,
    whether the port is given the JAX tree or its own `host_tree` of it."""
    tree = _jax_quantized(bf16_tree, mode)
    jw.save_deploy_bundle(str(tmp_path / "jax"), tree, cfg, quant_mode=mode, compact_f32=compact)
    pw.save_deploy_bundle(tmp_path / "port", tree, port_cfg, quant_mode=mode, compact_f32=compact)
    pw.save_deploy_bundle(tmp_path / "host", pw.host_tree(_port_tree(tree)), port_cfg, quant_mode=mode,
                          compact_f32=compact)
    for name in ("bundle.bin", "bundle.json"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
        assert (tmp_path / "host" / name).read_bytes() == want, name


def test_fused_bundle_loads_fused_in_both(cfg, port_cfg, bf16_tree, tmp_path):
    """(d) a fuse_qkv=True model's bundle holds wqkv / w_gateup and loads
    fused, bitwise, in the port and in the JAX package."""
    jw.save_pretrained(str(tmp_path / "src"), bf16_tree, cfg)
    m = FasterQwen3TTS.from_pretrained(str(tmp_path / "src"), device="cpu", quant="Q8_0", max_seq_len=128,
                                       fuse_qkv=True)
    m.save_deploy_bundle(str(tmp_path / "b"), compact_f32=False)
    got, _, mode = pw.load_deploy_bundle(tmp_path / "b", device="cpu")
    assert mode == "int8" and "wqkv" in got["talker"]["layers"] and "wq" not in got["predictor"]["layers"]
    assert_trees_bitwise(got, m.params)
    fused = jq.fuse_layer_weights(jq.quantize_model_params(bf16_tree, "int8"))
    jgot, _, jmode = jw.load_deploy_bundle(str(tmp_path / "b"))
    assert jmode == "int8" and isinstance(jgot["predictor"]["layers"]["w_gateup"], jq.QuantizedLinear)
    assert_trees_bitwise(jgot, fused)


def _stream(model, prompt, frames):
    relay, tokens = model._stream_decode, []

    def tap(stream, *a):
        def inner():
            for item in stream:
                tokens.append(np.asarray(item[0]))
                yield item
        return relay(inner(), *a)

    model._stream_decode = tap
    audio = [a for a, _, _ in model.generate_voice_clone_streaming(
        "Restarted from a bundle.", "English", voice_clone_prompt=prompt, max_new_tokens=frames,
        chunk_size=8, first_chunk_size=4, **GREEDY)]
    return np.concatenate(tokens), np.concatenate(audio)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bundle_loaded_model_streams_the_tokens_of_jax(cfg, port_cfg, tmp_path, writer):
    """(e) one bundle, written by either package, loaded by both
    from_pretrained: a tiny float32 greedy stream gives equal tokens and
    audio within 1e-4."""
    tree = jw.init_all(cfg, seed=5, dtype=jnp.float32, device_put=False)
    if writer == "jax":
        jw.save_deploy_bundle(str(tmp_path), tree, cfg)
    else:
        FasterQwen3TTS(_port_tree(tree), port_cfg, PromptTokenizer(ByteTokenizer()),
                       max_seq_len=128).save_deploy_bundle(str(tmp_path), compact_f32=False)
    pm = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", max_seq_len=128)
    jm = JaxTTS.from_pretrained(str(tmp_path), dtype="float32", max_seq_len=128)
    jm._warmed_up = True
    assert_trees_bitwise(pm.params, _port_tree(tree))
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    jt, ja = _stream(jm, prompt, 20)
    pt, pa = _stream(pm, prompt, 20)
    np.testing.assert_array_equal(pt, jt)
    assert pa.shape == ja.shape
    np.testing.assert_allclose(pa, ja, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_host_tree_round_trips_bit_for_bit(cfg, bf16_tree, mode):
    """(f) params_from_numpy(host_tree(p)) equals p bit for bit, with the two
    encoders and in the fused layout; host_tree(params_from_numpy(t))
    equals t (the JAX layouts, bf16 kept bf16)."""
    tree = dict(_jax_quantized(bf16_tree, mode))
    tree["speaker_encoder"] = jax_voice_extract.init_speaker_params(7, cfg.speaker_encoder)
    tree["codec_encoder"] = jax_voice_extract.init_encoder_params(8, cfg.codec)
    p = _port_tree(tree)
    host = pw.host_tree(p)
    assert_trees_bitwise(host, tree)
    assert host["talker"]["codec_embed"].dtype == torch.bfloat16
    assert_trees_bitwise(pw.params_from_numpy(host, "cpu"), p)
    fused = pq.fuse_layer_weights(p)
    assert_trees_bitwise(pw.params_from_numpy(pw.host_tree(fused), "cpu"), fused)
