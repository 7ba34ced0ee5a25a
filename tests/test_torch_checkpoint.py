"""Checkpoint loading in the port against the JAX package's, on the CPU.

Weights are made by the JAX package (`weights.init_all(cfg, device_put=False)`
plus its encoder inits) and written by its `save_pretrained` (own format) and
`export_hf_layout` (upstream HF layout) into tmp_path; both packages load
them. Trees are compared leaf for leaf, exactly; greedy stream tokens
exactly, audio at atol 1e-4. The HF cases mirror tests/test_hf_import.py.
The port's safetensors reader and writer are held against the `safetensors`
package itself.
"""
import dataclasses
import json
import logging
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as pt_save_file

from faster_qwen3_tts_tpu import weights as jw
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.models import voice_extract as jax_voice_extract
from faster_qwen3_tts_tpu_torch import weights as pw
from faster_qwen3_tts_tpu_torch.config import config_from_dict
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.utils import safetensors as st

torch.set_num_threads(1)
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)
SUBMODELS = ("talker", "predictor", "codec", "speaker_encoder", "codec_encoder")


@pytest.fixture(scope="module")
def cfg(tiny_config):
    # the byte tokenizer's text ids stay below the tiny text vocabulary of 512
    return dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)


@pytest.fixture(scope="module")
def port_cfg(cfg):
    return config_from_dict(jw._config_to_dict(cfg))


@pytest.fixture(scope="module")
def src(cfg):
    """Every submodel, float32, made by the JAX package."""
    p = jw.init_all(cfg, seed=123, dtype=jnp.float32, device_put=False)
    p["speaker_encoder"] = jax_voice_extract.init_speaker_params(124, cfg.speaker_encoder)
    p["codec_encoder"] = jax_voice_extract.init_encoder_params(125, cfg.codec)
    return p


def _diffs(jax_tree, port_tree):
    """Leaf paths (in the JAX leaf order) that differ in shape or value."""
    la = jax.tree_util.tree_leaves_with_path(jax_tree)
    lb = pw._leaves(port_tree)
    assert len(la) == len(lb)
    return [jax.tree_util.keystr(path) for (path, a), b in zip(la, lb)
            if np.shape(a) != np.shape(b)
            or not np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))]


def _export(src, cfg, path, drop=(), rename=None):
    """The JAX package's HF export, then tensors dropped or renamed."""
    jw.export_hf_layout(src, cfg, str(path))
    f = os.path.join(str(path), "model.safetensors")
    flat = np_load_file(f)
    for k in drop:
        flat.pop(k)
    if rename:
        flat = {rename(k): v for k, v in flat.items()}
    np_save_file(flat, f)
    return path


def _load_both(path, cfg, port_cfg, **kw):
    j = jw.load_hf_checkpoint(str(path), cfg, dtype=jnp.float32, device_put=False, **kw)
    p = pw.load_hf_checkpoint(str(path), port_cfg, dtype=torch.float32, **kw)
    return j, p


# -- the safetensors reader and writer ---------------------------------------------------------------


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16), "f32": torch.randn(4, 2, generator=g),
            "f16": torch.randn(7, generator=g).half(), "i8": torch.randint(-128, 127, (6,), dtype=torch.int8),
            "i32": torch.arange(5, dtype=torch.int32), "i64": torch.arange(3, dtype=torch.int64),
            "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3), "bool": torch.tensor([True, False, True]),
            "empty": torch.zeros(0, 4), "scalar": torch.tensor(2.5)}


@pytest.mark.parametrize("writer", ["safetensors.torch", "safetensors.numpy"])
def test_reader_reads_files_of_the_safetensors_package(tmp_path, writer):
    ts = _tensors()
    path = tmp_path / "t.safetensors"
    if writer == "safetensors.torch":
        pt_save_file(ts, str(path))
    else:
        ts.pop("bf16")  # numpy has no bfloat16
        np_save_file({k: v.numpy() for k, v in ts.items()}, str(path))
    f = st.SafetensorsFile(path)
    assert set(f.keys()) == set(ts)
    for k, t in ts.items():
        got = f.tensor(k)
        assert got.dtype == t.dtype and got.shape == t.shape and torch.equal(got, t), k
        assert np.array_equal(f.float32(k), t.float().numpy()), k
        if k != "bf16":
            assert np.array_equal(f.numpy(k), t.numpy()), k


def test_writer_is_read_by_the_safetensors_package(tmp_path):
    ts = _tensors()
    flat = dict(ts, transposed=np.arange(12, dtype=np.float32).reshape(3, 4).T,  # a view: stale strides
                flipped=np.arange(6, dtype=np.float32)[::-1])
    path = tmp_path / "w.safetensors"
    st.save_file(flat, path)
    with safe_open(str(path), framework="pt") as h:
        assert set(h.keys()) == set(flat)
        for k, v in flat.items():
            want = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            assert torch.equal(h.get_tensor(k), want), k
    assert np.array_equal(st.load_file(path)["transposed"], flat["transposed"])


def _write_raw(path, header, data=b""):
    text = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(text)) + text + data)


@pytest.mark.parametrize("case", ["overlap", "past_end", "size", "dtype", "header_length"])
def test_reader_rejects_a_header_the_file_cannot_hold(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    b = {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}
    if case == "overlap":
        b["data_offsets"] = [4, 12]
    elif case == "past_end":
        b["data_offsets"] = [8, 24]
        b["shape"] = [4]
    elif case == "size":
        b["shape"] = [3]
    elif case == "dtype":
        b["dtype"] = "F8"
    _write_raw(path, {"a": a, "b": b}, bytes(16))
    if case == "header_length":
        raw = bytearray(path.read_bytes())
        raw[:8] = struct.pack("<Q", 1 << 40)
        path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        st.SafetensorsFile(path)


# -- the own format --------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_own_format_round_trip_matches_jax(cfg, port_cfg, tmp_path, dtype):
    """The JAX package's save_pretrained -> both loads equal, leaf for leaf
    (bfloat16 leaves come back as float32 of the same value); the port's
    save_pretrained -> the JAX load equal to the source."""
    tree = jw.init_all(cfg, seed=3, dtype=dtype, device_put=False)
    jw.save_pretrained(str(tmp_path / "jax"), tree, cfg)
    assert pw.is_own_checkpoint(str(tmp_path / "jax"))
    j, jcfg = jw.load_pretrained(str(tmp_path / "jax"))
    p, pcfg = pw.load_pretrained(str(tmp_path / "jax"))
    assert not _diffs(j, p)
    assert jw._config_to_dict(jcfg) == pw._config_to_dict(pcfg)
    pw.save_pretrained(str(tmp_path / "port"), p, pcfg)
    back, _ = jw.load_pretrained(str(tmp_path / "port"))
    assert not _diffs(tree, back)


# -- upstream HF layout (tests/test_hf_import.py, case for case) -----------------------------------


def test_hf_strict_round_trip_zero_fallbacks(src, cfg, port_cfg, tmp_path):
    _export(src, cfg, tmp_path)
    coverage = {}
    p = pw.load_hf_checkpoint(str(tmp_path), port_cfg, dtype=torch.float32, strict=True, coverage=coverage)
    j = jw.load_hf_checkpoint(str(tmp_path), cfg, dtype=jnp.float32, strict=True, device_put=False)
    for sub in SUBMODELS:
        assert not _diffs(src[sub], p[sub]), sub
        assert not _diffs(j[sub], p[sub]), sub
    for sub in SUBMODELS:
        matched, wanted = (int(x) for x in coverage[sub].split("/"))
        assert matched == wanted > 0, (sub, coverage[sub])


@pytest.mark.parametrize("case", ["missing", "mismatch"])
def test_hf_strict_raises_with_per_submodel_coverage(src, cfg, port_cfg, tmp_path, case):
    _export(src, cfg, tmp_path, drop=["talker.codec_head.weight"])
    if case == "mismatch":
        f = os.path.join(str(tmp_path), "model.safetensors")
        np_save_file(dict(np_load_file(f), **{"talker.codec_head.weight": np.zeros((3, 3), np.float32)}), f)
    match = "codec_head" if case == "missing" else "mismatch"
    with pytest.raises(jw.StrictLoadError, match=match) as jerr:
        jw.load_hf_checkpoint(str(tmp_path), cfg, dtype=jnp.float32, strict=True, device_put=False)
    with pytest.raises(pw.StrictLoadError, match=match) as perr:
        pw.load_hf_checkpoint(str(tmp_path), port_cfg, dtype=torch.float32, strict=True)
    assert "Per-submodel coverage" in str(perr.value)
    assert perr.value.coverage == jerr.value.coverage
    if case == "missing":
        t_match, t_req = (int(x) for x in perr.value.coverage["talker"].split("/"))
        assert t_match == t_req - 1  # exactly the one dropped tensor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_hf_nonstrict_partial_load_regenerates_like_jax(src, cfg, port_cfg, tmp_path, dtype):
    """Missing tensors (the talker's codec head, a codec upsample stage) are
    drawn as the JAX package's host `_finalize` draws them: same values,
    the init scale read back in the load dtype."""
    drop = ["talker.codec_head.weight"] + [k for k in _export_keys(src, cfg, tmp_path)
                                           if k.startswith("speech_tokenizer.model.decoder.upsample.1.")]
    _export(src, cfg, tmp_path, drop=drop)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = jw.load_hf_checkpoint(str(tmp_path), cfg, dtype=jdt, strict=False, device_put=False)
    p = pw.load_hf_checkpoint(str(tmp_path), port_cfg, dtype=dtype, strict=False)
    if dtype != torch.float32:  # the JAX tree holds the talker and predictor in bfloat16
        for sub in ("talker", "predictor"):
            p[sub] = pw._round_to(p[sub], dtype)
    for sub in SUBMODELS:
        assert not _diffs(j[sub], p[sub]), sub
    assert p["talker"]["codec_head"].shape == np.shape(src["talker"]["codec_head"])
    a = np.abs(p["talker"]["codec_head"])
    assert a.min() > 1e-25 and 0.01 < a.std() < 1  # drawn at its init scale, no sentinel left


def _export_keys(src, cfg, tmp_path):
    path = tmp_path / "keys"
    jw.export_hf_layout(src, cfg, str(path))
    return list(np_load_file(os.path.join(str(path), "model.safetensors")))


def test_hf_missing_encoders_tolerated_in_strict(src, cfg, port_cfg, tmp_path):
    core = {k: src[k] for k in ("talker", "predictor", "codec")}
    _export(core, cfg, tmp_path)
    j, p = _load_both(tmp_path, cfg, port_cfg, strict=True)
    for sub in ("talker", "predictor", "codec"):
        assert not _diffs(src[sub], p[sub]), sub
    for sub in ("speaker_encoder", "codec_encoder"):  # drawn as the JAX package draws them
        assert not _diffs(j[sub], p[sub]), sub


def test_hf_prefix_detection(src, cfg, port_cfg, tmp_path):
    """Upstream packagings differ in their root: a 'model.' root still loads."""
    _export(src, cfg, tmp_path, rename=lambda k: f"model.{k}")
    p = pw.load_hf_checkpoint(str(tmp_path), port_cfg, dtype=torch.float32, strict=True)
    for sub in SUBMODELS:
        assert not _diffs(src[sub], p[sub]), sub


def test_port_export_equals_jax_export(src, cfg, port_cfg, tmp_path):
    """The port's export_hf_layout writes the JAX package's file, tensor for tensor."""
    jw.export_hf_layout(src, cfg, str(tmp_path / "jax"))
    host = jax.tree.map(np.asarray, src)
    pw.export_hf_layout(host, port_cfg, str(tmp_path / "port"))
    a = np_load_file(str(tmp_path / "jax" / "model.safetensors"))
    b = np_load_file(str(tmp_path / "port" / "model.safetensors"))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_materialize_of_a_loaded_tree_equals_init_all(port_cfg, tmp_path):
    """A seeded tree through the port's HF export and strict load, then
    `materialize`, equals `init_all` of the same seed: the tconv flip and
    every transpose round-trip, in bfloat16 and int8 alike."""
    tree = pw.init_numpy(port_cfg, seed=9)
    pw.export_hf_layout(tree, port_cfg, str(tmp_path))
    loaded = pw.load_hf_checkpoint(str(tmp_path), port_cfg, strict=True)
    for quant in ("none", "int8"):
        got = pw.materialize(loaded, torch.bfloat16, quant, "cpu")
        want = pw.init_all(port_cfg, seed=9, dtype=torch.bfloat16, device="cpu", quant=quant)
        for sub in want:
            a, b = pw._leaves(got[sub]), pw._leaves(want[sub])
            assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b)), sub


# -- from_pretrained -------------------------------------------------------------------------------


def test_config_only_directory_raises_in_both_packages(cfg, tmp_path, caplog):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(jw._config_to_dict(cfg), f)
    with pytest.raises(jw.StrictLoadError, match="no safetensors"):
        JaxTTS.from_pretrained(str(tmp_path), dtype="float32")
    with pytest.raises(pw.StrictLoadError, match="no safetensors"):
        FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", dtype="float32")
    with caplog.at_level(logging.WARNING):
        model = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", dtype="float32", strict=False)
    assert "random init" in caplog.text and "BYTE tokenizer" in caplog.text
    assert model.config.talker.hidden_size == cfg.talker.hidden_size


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
        "Loaded from a checkpoint.", "English", voice_clone_prompt=prompt, max_new_tokens=frames,
        chunk_size=8, first_chunk_size=4, **GREEDY)]
    return np.concatenate(tokens), np.concatenate(audio)


@pytest.mark.parametrize("fmt", ["own", "hf"])
def test_from_pretrained_streams_the_tokens_of_jax(src, cfg, tmp_path, fmt):
    """from_pretrained(dir) in both packages, float32, greedy: equal tokens,
    audio within 1e-4; and the port's tree equals the JAX package's."""
    if fmt == "own":
        jw.save_pretrained(str(tmp_path), {k: src[k] for k in ("talker", "predictor", "codec")}, cfg)
    else:
        _export(src, cfg, tmp_path)
        with open(tmp_path / "config.json", "w") as f:
            json.dump(jw._config_to_dict(cfg), f)
    jm = JaxTTS.from_pretrained(str(tmp_path), dtype="float32", max_seq_len=128)
    jm._warmed_up = True
    pm = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cpu", dtype="float32", max_seq_len=128)
    assert set(pm.load_phases) == {"weights_read", "quantize", "device_transfer"}
    assert bool(pm.load_coverage) == (fmt == "hf")
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    jt, ja = _stream(jm, prompt, 20)
    pt, pa = _stream(pm, prompt, 20)
    np.testing.assert_array_equal(pt, jt)
    assert pa.shape == ja.shape
    np.testing.assert_allclose(pa, ja, atol=1e-4, rtol=0)
    want = pw.params_from_numpy(jax.tree.map(np.asarray, jax.device_get(jm.params)), device="cpu")
    for sub in ("talker", "predictor", "codec"):
        a, b = pw._leaves(pm.params[sub]), pw._leaves(want[sub])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), sub
