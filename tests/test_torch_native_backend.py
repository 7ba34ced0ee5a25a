"""The port's NativeQwen3TTS against the JAX package's, case for case as
tests/test_native_backend.py: extract once then read from memory or disk,
one disk cache shared across instances and across the two packages (the
same keys and files), the cached-reference keywords' checks, and generation
from an `.spk` file with the JAX package's greedy tokens. Tiny geometry,
float32, the same seeded weights in both packages."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.native_backend import NativeQwen3TTS as JaxNative
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from faster_qwen3_tts_tpu.utils.tokenizer import PromptTokenizer as JaxPromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.native_backend import NativeQwen3TTS
from faster_qwen3_tts_tpu_torch.utils.audio import write_wav
from faster_qwen3_tts_tpu_torch.utils.tokenizer import ByteTokenizer, PromptTokenizer

torch.set_num_threads(1)
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)


@pytest.fixture(scope="module")
def cfg(tiny_config):
    return dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)


@pytest.fixture(scope="module")
def host(cfg):
    return jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)


def _port(cfg, host, cache_dir):
    return NativeQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=128, voice_ref_cache_dir=cache_dir)


def _jax(cfg, host, cache_dir):
    m = JaxNative(jax.device_put(host), cfg, JaxPromptTokenizer(JaxByteTokenizer()), max_seq_len=128,
                  voice_ref_cache_dir=cache_dir)
    m._warmed_up = True
    return m


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("audio") / "ref.wav"
    t = np.arange(16000) / 16000
    write_wav(p, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    return p


def test_extract_once_then_cached(cfg, host, tmp_path, ref_wav):
    model = _port(cfg, host, tmp_path / "refs")
    xv1, codes1, prof1 = model.extract_voice_ref(ref_wav)
    assert prof1["cache"] == "miss"
    assert xv1.shape == (2048,) and codes1 is not None
    xv2, codes2, prof2 = model.extract_voice_ref(ref_wav)
    assert prof2["cache"] == "hit"
    np.testing.assert_array_equal(codes1, codes2)
    assert sorted(p.suffix for p in (tmp_path / "refs").iterdir()) == [".json", ".rvq", ".spk"]
    # the JAX package's extraction of the same recording: x-vector 1e-4, codes equal
    jxv, jcodes, jprof = _jax(cfg, host, tmp_path / "jax_refs").extract_voice_ref(ref_wav)
    assert jprof["cache"] == "miss"
    np.testing.assert_allclose(xv1, jxv, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(codes1, jcodes)
    assert sorted(p.name for p in (tmp_path / "refs").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax_refs").iterdir())


def test_cross_instance_disk_reuse(cfg, host, tmp_path, ref_wav):
    """A fresh instance reads what another wrote, also across the packages:
    a directory written by the JAX package is a hit for the port, and the
    reverse, with the entry's values."""
    m1 = _port(cfg, host, tmp_path / "a")
    xv, _, p1 = m1.extract_voice_ref(ref_wav, xvec_only=True)
    assert p1["cache"] == "miss"
    _, _, p2 = _port(cfg, host, tmp_path / "a").extract_voice_ref(ref_wav, xvec_only=True)
    assert p2["cache"] == "hit"
    jxv, jcodes, jp = _jax(cfg, host, tmp_path / "a").extract_voice_ref(ref_wav, xvec_only=True)
    assert jp["cache"] == "hit" and jcodes is None
    np.testing.assert_array_equal(jxv, xv)
    jxv, jcodes, jp = _jax(cfg, host, tmp_path / "b").extract_voice_ref(ref_wav)
    assert jp["cache"] == "miss"
    xv, codes, p = _port(cfg, host, tmp_path / "b").extract_voice_ref(ref_wav)
    assert p["cache"] == "hit"
    np.testing.assert_array_equal(xv, jxv)
    np.testing.assert_array_equal(codes, jcodes)


def test_xvec_only_key_differs(cfg, host, tmp_path, ref_wav):
    model, theirs = _port(cfg, host, tmp_path / "refs"), _jax(cfg, host, tmp_path / "refs")
    _, codes_icl, _ = model.extract_voice_ref(ref_wav, xvec_only=False)
    _, codes_xv, _ = model.extract_voice_ref(ref_wav, xvec_only=True)
    assert codes_icl is not None and codes_xv is None
    audio = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    keys = set()
    for xvec_only in (False, True):
        for silence in (False, True):
            key = model._ref_cache_key(audio, 16000, xvec_only, silence)
            assert key == theirs._ref_cache_key(audio, 16000, xvec_only, silence)
            keys.add(key)
    assert len(keys) == 4


def test_cached_ref_kwargs_validation(cfg, host, tmp_path, ref_wav):
    model, theirs = _port(cfg, host, tmp_path / "refs"), _jax(cfg, host, tmp_path / "refs")
    xv = np.zeros(2048, np.float32)
    cases = [
        ((str(ref_wav), None, None, xv, None), "only one of"),
        ((None, None, "x.rvq", None, np.zeros((3, 16))), "only one of"),
    ]
    for args, match in cases:
        for m in (model, theirs):
            with pytest.raises(ValueError, match=match):
                m._validate_cached_ref_args(*args)
    for m in (model, theirs):  # an ICL cached reference without ref_text
        with pytest.raises(ValueError, match="ref_text"):
            m._resolve_cached_reference(None, "", False, True, ref_spk_emb=xv,
                                        ref_codes=np.zeros((3, 16), np.int32))
        with pytest.raises(ValueError, match="speaker embedding"):
            m._resolve_cached_reference(None, "", False, True, ref_codes=np.zeros((3, 16), np.int32))


def _tap(model, sink):
    relay = model._stream_decode
    model._stream_decode = lambda stream, *a: relay(((sink.append(np.asarray(i[0])), i)[1] for i in stream), *a)


def test_generate_with_spk_file(cfg, host, tmp_path):
    """An `.spk` file drives generation without the speaker encoder: the
    port's greedy tokens equal the JAX package's, non-streaming and
    streaming, and the streaming request from the file equals one from a
    `voice_clone_prompt` of the same x-vector bit for bit."""
    spk_path = tmp_path / "v.spk"
    xvec = np.random.default_rng(0).standard_normal(2048).astype(np.float32)
    xvec.tofile(spk_path)
    model, theirs = _port(cfg, host, tmp_path / "refs"), _jax(cfg, host, tmp_path / "refs")
    audio, sr = model.generate_voice_clone("cached speaker", "English", ref_spk=spk_path, xvec_only=True,
                                           max_new_tokens=8, do_sample=False, seed=0)
    assert sr == 24000 and audio[0].size > 500
    kw = dict(max_new_tokens=12, chunk_size=4, **GREEDY)
    sinks = [], [], []
    outs = []
    for m, sink, voice in ((theirs, sinks[0], dict(ref_spk=spk_path, xvec_only=True)),
                           (model, sinks[1], dict(ref_spk=spk_path, xvec_only=True)),
                           (model, sinks[2], dict(voice_clone_prompt={"ref_spk_embedding": [xvec]}))):
        _tap(m, sink)
        outs.append([a for a, _, _ in m.generate_voice_clone_streaming("cached speaker", "English", **voice, **kw)])
        del m._stream_decode
    np.testing.assert_array_equal(np.concatenate(sinks[1]), np.concatenate(sinks[0]))
    np.testing.assert_array_equal(np.concatenate(sinks[2]), np.concatenate(sinks[1]))
    assert len(outs[1]) == len(outs[2]) and all(np.array_equal(a, b) for a, b in zip(outs[1], outs[2]))
    np.testing.assert_allclose(np.concatenate(outs[1]), np.concatenate(outs[0]), atol=1e-4, rtol=0)


def test_icl_cached_reference_streams_like_ref_audio(cfg, host, tmp_path, ref_wav):
    """An ICL stream from `ref_audio` through the cache (miss, then hit) and
    one from the cached `.spk` / `.rvq` files give the same tokens."""
    model = _port(cfg, host, tmp_path / "refs")
    kw = dict(ref_text="A reference.", max_new_tokens=10, chunk_size=4, **GREEDY)
    runs = []
    for voice in (dict(ref_audio=str(ref_wav)), dict(ref_audio=str(ref_wav)), None):
        if voice is None:
            stem = next((tmp_path / "refs").glob("*.json")).stem
            voice = dict(ref_spk=tmp_path / "refs" / f"{stem}.spk", ref_rvq=tmp_path / "refs" / f"{stem}.rvq")
        sink = []
        _tap(model, sink)
        list(model.generate_voice_clone_streaming("An ICL voice.", "English", **voice, **kw))
        del model._stream_decode
        runs.append(np.concatenate(sink))
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])
