"""The request front of the port on the CPU: a graph set's prefill over its
prompt-bucket buffers, sessions fed device prompts, and streams from the
device prompt against the host prompt and the JAX package.

On the CPU a set runs the body it captures on the card once per prompt
bucket (`core.start_state` of the bucket's static tie / mask buffers into
its static state), so these tests hold that body to a fresh
`core.start_state` bit for bit and to the JAX `start_state` (tokens exact
with the JAX key's Gumbel noise fed to both, KV cache within 1e-4), at two
buckets; a session passes device prompts through untouched; greedy streams
from `build_device` prompts equal streams from `build` prompts and the JAX
package's, tokens exact, for x-vector, ICL, CustomVoice and VoiceDesign; a
continuous admission built on the device equals its solo stream; and
`warmup` notes the prefill buckets of every warmed set.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import faster_qwen3_tts_tpu.config as jax_config
from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import core as jax_core
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu.utils.tokenizer import ByteTokenizer, PromptTokenizer
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import core, graphs
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

torch.set_num_threads(1)
MAX_SEQ, MIN_NEW = 160, 2
MODES = {  # (talker, predictor) sampling
    "greedy": (dict(do_sample=False), dict(do_sample=False, repetition_penalty=1.0)),
    "sampled": (dict(), dict(temperature=0.9, top_k=50, top_p=1.0, do_sample=True, repetition_penalty=1.0)),
}
STREAM = dict(max_new_tokens=20, chunk_size=8, first_chunk_size=4, do_sample=False, subtalker_dosample=False,
              seed=3)


@pytest.fixture(scope="module")
def models(tiny_config):
    """model type -> (JAX model, port model) on one host tree."""
    cfg0 = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_weights.init_all(cfg0, seed=0, dtype=jnp.float32, device_put=False)
    jp, pp = jax.device_put(host), weights.params_from_numpy(host, device="cpu")
    out = {}
    for model_type in ("base", "custom_voice", "voice_design"):
        cfg = dataclasses.replace(cfg0, model_type=model_type)
        if model_type == "custom_voice":
            cfg = dataclasses.replace(cfg, talker=dataclasses.replace(
                cfg.talker, spk_id=jax_config._freeze({"aiden": 2180}),
                spk_is_dialect=jax_config._freeze({"aiden": False})))
        jax_model = JaxTTS(jp, cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=MAX_SEQ)
        jax_model._warmed_up = True
        out[model_type] = (jax_model, FasterQwen3TTS(pp, cfg, PromptTokenizer(ByteTokenizer()),
                                                     max_seq_len=MAX_SEQ))
    return out


def _bucket_prompt(cfg, bucket, lengths, seed):
    """Left-padded prompts [B, bucket, H] of the given real lengths."""
    rng = np.random.default_rng(seed)
    H = cfg.talker.hidden_size
    tie = np.zeros((len(lengths), bucket, H), np.float32)
    mask = np.zeros((len(lengths), bucket), np.int32)
    for i, n in enumerate(lengths):
        tie[i, bucket - n:] = rng.standard_normal((n, H)) * 0.5
        mask[i, bucket - n:] = 1
    return tie, mask


@pytest.mark.parametrize("bucket", [32, 64])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_set_prefill_equals_start_state_and_jax(models, bucket, mode):
    jax_model, port = models["base"]
    cfg, pp, jp = port.config, port.params, jax_model.params
    tie, mask = _bucket_prompt(cfg, bucket, [bucket - 3, bucket // 2], seed=bucket)
    t, p = MODES[mode]
    ts = SamplingParams(**t)
    key = graphs.make_key(pp, 2, MAX_SEQ, 256, ts, SamplingParams(**p), MIN_NEW)
    reg = graphs.registry_for(pp)
    gset = reg.lease(pp, cfg, key)
    try:
        # the port's eager start_state, the same seed
        gset.prefill(pp, torch.tensor(tie), torch.tensor(mask), 5)
        assert bucket in gset.prompts and gset.prefills[bucket] is None  # noted, nothing captured on the CPU
        ref, logits = core.start_state(pp["talker"], cfg.talker, torch.tensor(tie), torch.tensor(mask),
                                       torch.Generator().manual_seed(5), MAX_SEQ, ts, MIN_NEW)
        st = gset.state
        for name in ("token", "past_hidden", "pos", "num_pads", "gen_step", "seen", "done", "n_frames"):
            assert torch.equal(getattr(st, name), getattr(ref, name).to(getattr(st, name).dtype)), name
        assert torch.equal(st.cache.k, ref.cache.k) and torch.equal(st.cache.v, ref.cache.v)
        assert torch.equal(gset.logits, logits)
        # the JAX start_state: its key's first draw fed to the set's body
        jkey = jax.random.PRNGKey(9)
        noise = None
        if mode == "sampled":
            noise = torch.tensor(np.asarray(jax.random.gumbel(jax.random.split(jkey)[1], (2, cfg.talker.vocab_size))))
        gset.prefill(pp, torch.tensor(tie), torch.tensor(mask), 0, noise=noise)
        jstate, _ = jax_core.start_state(jp["talker"], cfg.talker, jnp.asarray(tie), jnp.asarray(mask), jkey,
                                         MAX_SEQ, JaxSamplingParams(**t), MIN_NEW)
        for name in ("token", "pos", "num_pads"):
            np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jstate, name)), name)
        for ours, theirs in ((st.cache.k, jstate.cache.k), (st.cache.v, jstate.cache.v),
                             (st.past_hidden, jstate.past_hidden)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)
    finally:
        reg.release(gset)


def test_session_passes_device_prompts_through(models):
    _, port = models["base"]
    tie, mask, tth, tpe, _ = port._prepare_generation("Hello there.", voice_clone_prompt={
        "ref_spk_embedding": [np.ones(2048, np.float32)]})
    assert isinstance(tie, torch.Tensor) and tie.shape[1] == gen.prefill_bucket(tie.shape[1], MAX_SEQ)
    args = (port.params, port.config)
    rest = (MAX_SEQ, SamplingParams(), gen.predictor_sampling(), MIN_NEW)
    sess = gen.GenerationSession(*args, tie, mask, tth, tpe, *rest, seed=0)
    assert sess.tie is tie and sess.mask is mask and sess.tth is tth
    with pytest.raises(ValueError):  # a device prompt off its bucket
        gen.GenerationSession(*args, tie[:, 1:], mask[:, 1:], tth, tpe, *rest)
    with pytest.raises(ValueError):  # or in another dtype than the parameters'
        gen.GenerationSession(*args, tie.to(torch.float64), mask, tth, tpe, *rest)


def _xvec():
    return {"ref_spk_embedding": [np.random.default_rng(4).standard_normal(2048).astype(np.float32)]}


def _icl(frames=30):
    rng = np.random.default_rng(5)
    return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [False], "icl_mode": [True],
            "ref_code": [rng.integers(0, 2048, size=(frames, 16)).astype(np.int32)]}


TEXT = "The device prompt streams."
STREAMS = {  # model type -> (prepare method, its arguments)
    "xvec": ("base", "_prepare_generation", (TEXT,), dict(voice_clone_prompt=_xvec())),
    "icl": ("base", "_prepare_generation", (TEXT,), dict(voice_clone_prompt=_icl(), ref_text="the reference")),
    "custom_voice": ("custom_voice", "_prepare_generation_custom", (TEXT, "English", "aiden"),
                     dict(non_streaming_mode=False)),
    "voice_design": ("voice_design", "_prepare_generation_custom", (TEXT, "English", None),
                     dict(instruct="A calm low voice.", non_streaming_mode=False)),
}


def _frames(stream):
    return np.concatenate([frames for frames, _, _ in stream])


@pytest.mark.parametrize("case", list(STREAMS))
def test_device_prompt_streams_equal_host_and_jax(models, case):
    model_type, method, args, kw = STREAMS[case]
    jax_model, port = models[model_type]
    prompts = {}
    for where, prefer in (("device", True), ("host", False)):
        out = getattr(port, method)(*args, **kw, prefer_device=prefer)
        prompts[where] = out
    assert isinstance(prompts["device"][0], torch.Tensor) and isinstance(prompts["host"][0], np.ndarray)
    jprompt = getattr(jax_model, method)(*args, **kw)  # the JAX package's device assembly
    ref_codes = prompts["host"][4] if len(prompts["host"]) == 5 else None
    drive = dict(STREAM, max_seq_len=MAX_SEQ, fuse_first_chunk=ref_codes is None, ref_codes=ref_codes)
    frames = {where: _frames(gen.fast_generate_streaming_fused(port.params, port.config, *p[:4], **drive))
              for where, p in prompts.items()}
    jframes = _frames(jax_gen.fast_generate_streaming_fused(jax_model.params, jax_model.config, *jprompt[:4],
                                                            **drive))
    assert frames["device"].shape[0] == STREAM["max_new_tokens"]  # no early EOS: every chunk is compared
    np.testing.assert_array_equal(frames["device"], frames["host"])
    np.testing.assert_array_equal(frames["device"], jframes)


def test_continuous_admission_on_the_device_equals_solo(models, monkeypatch):
    """Two requests (x-vector, ICL) admitted into a 2-lane pool: each prompt
    is assembled on the device, and each stream's audio equals its solo
    stream's (the ICL reference is short of 24 frames, so the solo stream
    vocodes on the host too, as a pool's ICL lane does)."""
    _, port = models["base"]
    built = []
    build_device = port.prompt_builder.build_device
    monkeypatch.setattr(port.prompt_builder, "build_device",
                        lambda *a, **k: built.append(1) or build_device(*a, **k))
    reqs = [{"text": "First pool request.", "voice_clone_prompt": _xvec()},
            {"text": "Second pool request.", "voice_clone_prompt": _icl(12), "ref_text": "the reference"}]
    greedy = dict(do_sample=False, subtalker_dosample=False, seed=0)
    cb = port.continuous_batcher(max_slots=2, chunk_size=4, max_new_tokens=12, **greedy)
    for r in reqs:
        cb.submit(r)
    got = {}
    for sid, audio, _, _ in cb.run():
        got.setdefault(sid, []).append(audio)
    assert len(built) == 2
    for sid, r in enumerate(reqs):
        solo = np.concatenate([a for a, _, _ in port.generate_voice_clone_streaming(
            r["text"], "English", voice_clone_prompt=r["voice_clone_prompt"], ref_text=r.get("ref_text", ""),
            chunk_size=4, max_new_tokens=12, **greedy)])
        ours = np.concatenate(got[sid])
        assert ours.shape == solo.shape
        np.testing.assert_allclose(ours, solo, atol=1e-4, rtol=0)


def test_warmup_notes_the_prefill_buckets(models):
    _, port = models["base"]
    phases = port.warmup(chunk_sizes=(8,), first_chunk_size=4, batch_sizes=(1, 2), pool_slots=3)
    buckets = [b for b in gen.SERVED_PREFILL_BUCKETS if b <= MAX_SEQ]
    assert phases["prefill_buckets"] == buckets == [32, 64, 128]
    assert phases["captures"] == phases["prefill_captures"] == 0  # nothing is captured on the CPU
    reg = graphs.registry_for(port.params)
    key = graphs.make_key(port.params, 1, MAX_SEQ, gen.tth_bucket(1), SamplingParams(), gen.predictor_sampling(),
                          MIN_NEW)
    for B in (1, 2):  # the lockstep sizes, and B = 1 for the solo path and admissions
        (gset,) = [s for s in reg.sets if s.key == key._replace(batch=B)]
        assert sorted(gset.prompts) == buckets and all(g is None for g in gset.prefills.values())
        assert all(t.shape == (B, b) for b, (_, t) in gset.prompts.items())
    (pool,) = [s for s in reg.sets if s.key == key._replace(batch=3)]
    assert not pool.prompts  # the pool is filled by lane copies, never prefilled
