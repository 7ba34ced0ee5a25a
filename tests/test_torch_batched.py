"""Lockstep batching on the port against the JAX package, same weights.

Tiny geometry, float32, greedy talker and predictor, on the CPU. The engine
(start_state + decode_chunk on a left-padded B=3 batch, lane insert and
release), the per-stream host vocoder and the public
`generate_voice_clone_streaming_batch`: tokens, flags and cache lanes must be
exactly equal, audio within 1e-4 (f32 sums in another order). Each lane must
also equal its own solo run on the port."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import core as jax_core
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.model import _StreamVocoder as JaxStreamVocoder
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import core
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS, _StreamVocoder
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

torch.set_num_threads(1)
GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=0)
MAXNEW, CHUNK = 10, 4
FIELDS = ("pos", "num_pads", "token", "past_hidden", "gen_step", "seen", "done", "n_frames")


# -- engine: start_state + decode_chunk on a left-padded batch ------------------------------------


@pytest.fixture(scope="module")
def engine_params(tiny_config):
    host = jax_weights.init_all(tiny_config, seed=9, dtype=jnp.float32, device_put=False)
    return jax.device_put(host), weights.params_from_numpy(host, device="cpu")


def _prompts(cfg, lengths, bucket, seed=3):
    """Left-padded batch of random prompts with the given real lengths."""
    H = cfg.talker.hidden_size
    rng = np.random.default_rng(seed)
    tie = np.zeros((len(lengths), bucket, H), np.float32)
    mask = np.zeros((len(lengths), bucket), np.int32)
    for i, L in enumerate(lengths):
        tie[i, bucket - L:] = rng.standard_normal((L, H)) * 0.05
        mask[i, bucket - L:] = 1
    return tie, mask


def _jax_start(jp, cfg, tie, mask, max_seq=64, min_new=2):
    return jax_core.start_state(jp["talker"], cfg.talker, jnp.asarray(tie), jnp.asarray(mask),
                                jax.random.PRNGKey(0), max_seq, JaxSamplingParams(do_sample=False), min_new)[0]


def _port_start(pp, cfg, tie, mask, max_seq=64, min_new=2):
    return core.start_state(pp["talker"], cfg.talker, torch.tensor(tie), torch.tensor(mask), None, max_seq,
                            SamplingParams(do_sample=False), min_new)[0]


def _jax_chunk(jp, cfg, state, B, chunk=4, min_new=2):
    H = cfg.talker.hidden_size
    g = JaxSamplingParams(do_sample=False)
    return jax_core.decode_chunk(jp["talker"], jp["predictor"], cfg.talker, cfg.predictor, state,
                                 jnp.zeros((B, 4, H)), jnp.zeros((B, 1, H)), chunk, g, g, min_new)


def _port_chunk(pp, cfg, state, B, chunk=4, min_new=2):
    H = cfg.talker.hidden_size
    g = SamplingParams(do_sample=False)
    return core.decode_chunk(pp["talker"], pp["predictor"], cfg.talker, cfg.predictor, state,
                             torch.zeros((B, 4, H)), torch.zeros((B, 1, H)), chunk, g, g, min_new)


def _port_decode(pp, cfg, tie, mask, n_chunks=3):
    state = _port_start(pp, cfg, tie, mask)
    outs = []
    for _ in range(n_chunks):
        state, packed = _port_chunk(pp, cfg, state, tie.shape[0])
        outs.append(packed)
    return core.read_packed_batch(torch.cat(outs))


def test_batched_decode_matches_jax_and_solo(tiny_config, engine_params):
    jp, pp = engine_params
    tie, mask = _prompts(tiny_config, [10, 17, 5], 24)
    jstate = _jax_start(jp, tiny_config, tie, mask)
    jouts = []
    for _ in range(3):
        jstate, jpacked = _jax_chunk(jp, tiny_config, jstate, 3)
        jouts.append(jpacked)
    jf, jv, jd = jax_gen.GenerationSession.materialize_batch(jnp.concatenate(jouts))
    f, v, d = _port_decode(pp, tiny_config, tie, mask)
    assert f.shape == (12, 3, 16) and v.dtype == bool and d.shape == (3,)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(d, jd)
    for i in range(3):
        sf, sv, _ = _port_decode(pp, tiny_config, tie[i:i + 1], mask[i:i + 1])
        np.testing.assert_array_equal(f[:, i], sf[:, 0])
        np.testing.assert_array_equal(v[:, i], sv[:, 0])


def test_eos_in_one_lane_does_not_perturb_the_others(tiny_config, engine_params):
    jp, pp = engine_params
    tie, mask = _prompts(tiny_config, [12, 12, 7], 16)
    eos = tiny_config.talker.codec_eos_token_id
    state = _port_start(pp, tiny_config, tie, mask, min_new=0)
    live = state.token.clone()
    state.token[0] = eos
    jstate = _jax_start(jp, tiny_config, tie, mask, min_new=0)
    jstate = jstate._replace(token=jnp.asarray(state.token.numpy()))
    state, packed = _port_chunk(pp, tiny_config, state, 3, min_new=0)
    _, jpacked = _jax_chunk(jp, tiny_config, jstate, 3, min_new=0)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    frames, valid, done = core.read_packed_batch(packed)
    assert not valid[:, 0].any() and done[0]
    assert valid[:, 1:].all() and not done[1:].any()
    np.testing.assert_array_equal(frames[0, 1:, 0], live[1:].numpy())
    # the live lanes continue exactly as without the EOS lane
    _, ref = _port_chunk(pp, tiny_config, _port_start(pp, tiny_config, tie[1:], mask[1:], min_new=0), 2,
                         min_new=0)
    np.testing.assert_array_equal(packed[:, 1:].numpy(), ref.numpy())


def test_read_packed_batch_matches_stream0_view(tiny_config, engine_params):
    _, pp = engine_params
    tie, mask = _prompts(tiny_config, [8, 11], 16)
    _, packed = _port_chunk(pp, tiny_config, _port_start(pp, tiny_config, tie, mask), 2)
    frames, valid, done = core.read_packed_batch(packed)
    solo_frames, solo_done = core.read_packed(packed)
    np.testing.assert_array_equal(solo_frames, frames[valid[:, 0], 0])
    assert solo_done == bool(done[0])


# -- lane surgery ---------------------------------------------------------------------------------


def _assert_state_equal(state, jstate):
    """Integer and flag fields exact; the float ones (cache, hidden) within
    1e-5, as computed by two libraries."""
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(state.cache, name).numpy(), np.asarray(getattr(jstate.cache, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    for name in FIELDS:
        ours, theirs = getattr(state, name).numpy(), np.asarray(getattr(jstate, name))
        if ours.dtype.kind == "f":
            np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(ours, theirs, err_msg=name)


def test_insert_and_release_slot_match_jax(tiny_config, engine_params):
    """A B=1 stream written into lane 1 of a running B=3 batch, then lane 2
    released: every field equal to the JAX state, the cache lanes exact, in
    place (no second cache); the next chunk is equal too."""
    jp, pp = engine_params
    tie, mask = _prompts(tiny_config, [10, 17, 5], 24)
    jstate, state = _jax_start(jp, tiny_config, tie, mask), _port_start(pp, tiny_config, tie, mask)
    jstate, _ = _jax_chunk(jp, tiny_config, jstate, 3)
    state, _ = _port_chunk(pp, tiny_config, state, 3)
    one_tie, one_mask = _prompts(tiny_config, [14], 24, seed=5)
    jslot = _jax_start(jp, tiny_config, one_tie, one_mask)
    slot = _port_start(pp, tiny_config, one_tie, one_mask)
    cache_k = state.cache.k
    jstate = jax_core.insert_slot(jstate, jslot, jnp.asarray(1, jnp.int32))
    assert core.insert_slot(state, slot, 1) is state and state.cache.k is cache_k
    _assert_state_equal(state, jstate)
    for name in ("k", "v"):  # the lane is the B=1 stream's cache, bit for bit
        assert torch.equal(getattr(state.cache, name)[:, 1], getattr(slot.cache, name)[:, 0])
    for name in FIELDS:
        assert torch.equal(getattr(state, name)[1], getattr(slot, name)[0]), name
    jstate = jax_core.release_slot(jstate, jnp.asarray(2, jnp.int32))
    core.release_slot(state, 2)
    _assert_state_equal(state, jstate)
    assert state.done.tolist() == [False, False, True]
    jstate, jpacked = _jax_chunk(jp, tiny_config, jstate, 3)
    state, packed = _port_chunk(pp, tiny_config, state, 3)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    _assert_state_equal(state, jstate)
    # the inserted lane goes on as its own solo stream
    _, solo = _port_chunk(pp, tiny_config, slot, 1)
    np.testing.assert_array_equal(packed[:, 1].numpy(), solo[:, 0].numpy())
    assert not packed[:, 2, -2].any()  # the released lane's frames are invalid


def test_insert_slot_refuses_another_cache_length(tiny_config, engine_params):
    _, pp = engine_params
    tie, mask = _prompts(tiny_config, [10, 17], 24)
    pool = _port_start(pp, tiny_config, tie, mask)
    slot = _port_start(pp, tiny_config, tie[:1], mask[:1], max_seq=96)
    with pytest.raises(ValueError, match="max_seq"):
        core.insert_slot(pool, slot, 0)


def test_zeros_state_is_an_empty_pool(tiny_config, engine_params):
    """Every lane of a fresh pool is done, so a chunk emits nothing."""
    _, pp = engine_params
    pool = core.zeros_state(tiny_config.talker, 3, 64, torch.float32, torch.device("cpu"), None)
    assert pool.done.all() and pool.cache.k.shape == (2, 3, 64, 2, 16)
    _, packed = _port_chunk(pp, tiny_config, pool, 3)
    assert not packed[:, :, -2].any() and packed[:, :, -1].all()


# -- the public API -------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=128)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=128)
    return jax_model, port


def _xvec(seed):
    rng = np.random.default_rng(seed)
    return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [True], "icl_mode": [False], "ref_code": [None]}


def _icl(seed, frames):
    rng = np.random.default_rng(seed)
    return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [False], "icl_mode": [True],
            "ref_code": [rng.integers(0, 2048, size=(frames, 16)).astype(np.int32)]}


BATCHES = {
    "xvec": [{"text": "Hello world.", "voice_clone_prompt": _xvec(0), "xvec_only": True},
             {"text": "A much longer second sentence here.", "voice_clone_prompt": _xvec(1), "xvec_only": True}],
    "long_icl": [{"text": "Hello world.", "voice_clone_prompt": _icl(3, 30), "ref_text": "Ref one."},
                 {"text": "A different second text.", "voice_clone_prompt": _icl(4, 30), "ref_text": "Ref two."}],
    "mixed": [{"text": "Hello world.", "voice_clone_prompt": _xvec(0), "xvec_only": True},
              {"text": "A much longer second sentence here.", "voice_clone_prompt": _icl(1, 6),
               "ref_text": "Reference words."}],
    # x-vector, a short and a long reference: host vocoders for all three
    "mixed3": [{"text": "Hello world.", "voice_clone_prompt": _xvec(0), "xvec_only": True},
               {"text": "Third one.", "voice_clone_prompt": _icl(2, 30), "ref_text": "Ref three."},
               {"text": "A much longer second sentence here.", "voice_clone_prompt": _icl(1, 6),
                "ref_text": "Reference words."}],
}


def _run_batch(model, requests, **kw):
    return list(model.generate_voice_clone_streaming_batch(
        requests, chunk_size=CHUNK, max_new_tokens=MAXNEW, **GREEDY, **kw))


def _per_slot(out, n):
    return {s: np.concatenate([a for slot, a, _, _ in out if slot == s] or [np.zeros(0, np.float32)])
            for s in range(n)}


def _solo(model, req):
    return np.concatenate([a for a, _, _ in model.generate_voice_clone_streaming(
        req["text"], "English", voice_clone_prompt=req["voice_clone_prompt"], ref_text=req.get("ref_text", ""),
        xvec_only=bool(req.get("xvec_only", False)), chunk_size=CHUNK, max_new_tokens=MAXNEW, **GREEDY)])


@pytest.mark.parametrize("kind, fused", [("xvec", True), ("long_icl", True), ("mixed", False), ("mixed3", False)])
def test_streaming_batch_matches_jax(models, kind, fused):
    """Same (slot, chunk) order, timing keys and values, audio within 1e-4;
    a uniform batch is vocoded on the device, a mixed one on the host."""
    jax_model, port = models
    requests = BATCHES[kind]
    ref, out = _run_batch(jax_model, requests), _run_batch(port, requests)
    assert [(s, t["chunk_index"]) for s, _, _, t in out] == [(s, t["chunk_index"]) for s, _, _, t in ref]
    for (s, a, sr, t), (_, ja, jsr, jt) in zip(out, ref):
        assert sr == jsr == 24000 and a.dtype == np.float32 and a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
        assert set(t) == set(jt)
        for key in ("slot", "chunk_steps", "total_steps_so_far", "is_final", "fused", "first_window"):
            assert t[key] == jt[key], key
        assert type(t["total_steps_so_far"]) is int
    assert all(t["fused"] == fused for _, _, _, t in out)
    if kind == "long_icl":
        assert not any(t["first_window"] for _, _, _, t in out)  # ctx 24 from chunk 0


@pytest.mark.parametrize("kind", ["xvec", "long_icl", "mixed"])
def test_streaming_batch_lanes_match_solo_streams(models, kind):
    """Each lane's audio equals its solo stream on the port. Fused lanes and
    fused solo streams share the window schedule (1e-5); a mixed batch's
    host vocoders differ from a solo x-vector stream's device windows only
    in early-window context (the JAX package's 5e-3)."""
    _, port = models
    requests = BATCHES[kind]
    got = _per_slot(_run_batch(port, requests), len(requests))
    for s, req in enumerate(requests):
        solo = _solo(port, req)
        assert got[s].size > 0 and got[s].shape == solo.shape
        atol = 5e-3 if kind == "mixed" and "xvec_only" in req else 1e-5
        np.testing.assert_allclose(got[s], solo, atol=atol, rtol=0)


def test_streaming_batch_first_chunk_size_matches_jax(models):
    jax_model, port = models
    requests = BATCHES["xvec"]
    ref = _run_batch(jax_model, requests, first_chunk_size=2)
    out = _run_batch(port, requests, first_chunk_size=2)
    assert [t["chunk_steps"] for *_, t in out] == [t["chunk_steps"] for *_, t in ref]
    assert out[0][3]["chunk_steps"] == 2 and out[0][3]["first_window"]
    for (_, a, _, _), (_, ja, _, _) in zip(out, ref):
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)


def test_empty_batch_yields_nothing(models):
    assert list(models[1].generate_voice_clone_streaming_batch([])) == []


# -- the host vocoder -----------------------------------------------------------------------------


@pytest.mark.parametrize("ref_frames", [None, 6, 30], ids=["xvec", "short_icl", "long_icl"])
def test_stream_vocoder_matches_jax(models, ref_frames):
    """The same frames, chunk by chunk (4 + 8 + 8 + 8 + 8: the accumulated
    regime, then the fixed 24-frame window), give the same samples."""
    jax_model, port = models
    rng = np.random.default_rng(7)
    rc = None if ref_frames is None else rng.integers(0, 2048, size=(ref_frames, 16)).astype(np.int32)
    cfg = port.config.codec
    jvoc = JaxStreamVocoder(jax_model.speech_tokenizer, cfg, rc)
    voc = port._make_stream_vocoder(rc)
    assert isinstance(voc, _StreamVocoder)
    total = 0
    for n in (4, 8, 8, 8, 8):
        frames = rng.integers(0, 2048, size=(n, 16)).astype(np.int32)
        a, ja = voc.vocode_new(frames), np.asarray(jvoc.vocode_new(frames))
        assert a.dtype == np.float32 and a.shape == ja.shape and a.size > 0
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
        total += a.size
    if ref_frames is None:  # exact sample accounting without a reference cut
        assert total == 36 * cfg.total_upsample - gen.fused_stream.codec_deficit(cfg)


def test_stream_vocoder_continues_after_device_chunks(models):
    """Samples vocoded elsewhere (`add_vocoded`) move the host regime on as
    if it had vocoded them itself."""
    _, port = models
    rng = np.random.default_rng(8)
    chunks = [rng.integers(0, 2048, size=(n, 16)).astype(np.int32) for n in (4, 8, 8)]
    a, b = port._make_stream_vocoder(None), port._make_stream_vocoder(None)
    first = a.vocode_new(chunks[0])
    b.add_vocoded(chunks[0], len(first))
    for c in chunks[1:]:
        np.testing.assert_array_equal(b.vocode_new(c), a.vocode_new(c))


@pytest.mark.parametrize("name", ["fast_generate_streaming_batch", "generate_voice_clone_streaming_batch",
                                  "continuous_batcher"])
def test_batch_signatures_match_jax(name):
    """The JAX parameter names in the JAX order, the engine's `mesh` included."""
    if name == "fast_generate_streaming_batch":
        ours, theirs = gen.fast_generate_streaming_batch, jax_gen.fast_generate_streaming_batch
    else:
        ours, theirs = getattr(FasterQwen3TTS, name), getattr(JaxTTS, name)
    want = list(inspect.signature(theirs).parameters)
    assert list(inspect.signature(ours).parameters) == want
