"""The graph sets of the port (engine/graphs.py) on the CPU, against the eager
engine of the port and the JAX engine on the same weights.

On the CPU a set runs the body it would capture on the card (one frame on
its static state, the window vocode on its static buffers) eagerly, so these
tests hold that body to `core.decode_chunk` and to the JAX `decode_chunk`:
tiny geometry, float32, greedy, and sampled with the JAX key's Gumbel noise
fed to both (tokens, valid and done flags and pos exact; KV lanes exact
against the port's eager engine, within 1e-5 against JAX, as two
libraries sum in another order). Then leases (two interleaved streams of one
key get two sets; an abandoned stream returns its set), the drivers'
dispatch-ahead (the order of dispatches and yields equal to the JAX
drivers', frames exact and audio within 1e-4), and warmup's windows against
the windows the JAX warmup compiles."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
MAX_SEQ, MIN_NEW, CHUNKS = 48, 2, (4, 8, 8)
MODES = {  # (talker, predictor) sampling
    "greedy": (dict(do_sample=False), dict(do_sample=False, repetition_penalty=1.0)),
    "sampled": (dict(), dict(temperature=0.9, top_k=50, top_p=1.0, do_sample=True, repetition_penalty=1.0)),
}


# -- the static-buffer body against both engines --------------------------------------------------


@pytest.fixture(scope="module")
def engine(tiny_config):
    host = jax_weights.init_all(tiny_config, seed=11, dtype=jnp.float32, device_put=False)
    return jax.device_put(host), weights.params_from_numpy(host, device="cpu")


def _prompt(cfg, lengths, P=12, T=6, seed=0):
    """Left-padded prompts of the given real lengths, their trailing text
    and pad embedding."""
    rng = np.random.default_rng(seed)
    H = cfg.talker.hidden_size
    tie = np.zeros((len(lengths), P, H), np.float32)
    mask = np.zeros((len(lengths), P), np.int32)
    for i, n in enumerate(lengths):
        tie[i, P - n:] = rng.standard_normal((n, H)) * 0.5
        mask[i, P - n:] = 1
    tth = (rng.standard_normal((len(lengths), T, H)) * 0.5).astype(np.float32)
    tpe = (rng.standard_normal((1, 1, H)) * 0.5).astype(np.float32)
    return tie, mask, tth, tpe


def _jax_noise(key, B, cfg):
    """The Gumbel noise of one JAX frame (its key schedule: split in three,
    the predictor's draws fold in the codebook step) -> (next key, (predictor
    noise [15, B, Vp], talker noise [B, V]))."""
    key, k_pred, k_tok = jax.random.split(key, 3)
    pred = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(k_pred, s), (B, cfg.predictor.vocab_size)))
                     for s in range(cfg.predictor.num_codebooks)])
    tok = np.asarray(jax.random.gumbel(k_tok, (B, cfg.talker.vocab_size)))
    return key, (torch.tensor(pred), torch.tensor(tok))


def _lease(pp, cfg, B, mode, T):
    ps, pps = (SamplingParams(**m) for m in MODES[mode])
    key = graphs.make_key(pp, B, MAX_SEQ, T, ps, pps, MIN_NEW)
    return graphs.registry_for(pp).lease(pp, cfg, key)


def _assert_kv(state, ref, exact):
    for name in ("k", "v"):
        ours, theirs = getattr(state.cache, name), getattr(ref.cache, name)
        if exact:
            assert torch.equal(ours, theirs), name
        else:
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_static_body_equals_eager_and_jax(tiny_config, engine, B, mode):
    """Three chunks (4, 8, 8 frames) of the set's body from one prompt equal
    the port's `core.decode_chunk` (same seed) and the JAX `decode_chunk`
    (the JAX key's noise fed to the body)."""
    jp, pp = engine
    cfg = tiny_config
    tie, mask, tth, tpe = _prompt(cfg, [12, 7, 10][:B])
    t, p = MODES[mode]
    ts, pss = SamplingParams(**t), SamplingParams(**p)
    jts, jpss = JaxSamplingParams(**t), JaxSamplingParams(**p)
    # the port's eager engine, seed 5
    gen_ = torch.Generator().manual_seed(5)
    state, _ = core.start_state(pp["talker"], cfg.talker, torch.tensor(tie), torch.tensor(mask), gen_, MAX_SEQ,
                                ts, MIN_NEW)
    eager = []
    for chunk in CHUNKS:
        state, packed = core.decode_chunk(pp["talker"], pp["predictor"], cfg.talker, cfg.predictor, state,
                                          torch.tensor(tth), torch.tensor(tpe), chunk, ts, pss, MIN_NEW)
        eager.append(packed.numpy())
    # the JAX engine
    key = jax.random.PRNGKey(3)
    jstate, _ = jax_core.start_state(jp["talker"], cfg.talker, jnp.asarray(tie), jnp.asarray(mask), key, MAX_SEQ,
                                     jts, MIN_NEW)
    ref = []
    for chunk in CHUNKS:
        jstate, jpacked = jax_core.decode_chunk(jp["talker"], jp["predictor"], cfg.talker, cfg.predictor, jstate,
                                                jnp.asarray(tth), jnp.asarray(tpe), chunk, jts, jpss, MIN_NEW)
        ref.append(np.asarray(jpacked))

    gset = _lease(pp, cfg, B, mode, tth.shape[1])
    try:
        gset.load_text(torch.tensor(tth), torch.tensor(tpe))
        # with the generator: the port's eager engine
        gset.prefill(pp, torch.tensor(tie), torch.tensor(mask), 5)
        body = [gset.run_chunk(pp, chunk).numpy().copy() for chunk in CHUNKS]
        for i, (ours, theirs) in enumerate(zip(body, eager)):
            np.testing.assert_array_equal(ours, theirs, err_msg=f"chunk {i} against the port's eager engine")
        assert torch.equal(gset.state.pos, state.pos) and torch.equal(gset.state.n_frames, state.n_frames)
        _assert_kv(gset.state, state, exact=True)
        # with the JAX key's noise (greedy draws none): the JAX engine
        noise0 = None
        key, sub = jax.random.split(jax.random.PRNGKey(3))
        if mode == "sampled":
            noise0 = torch.tensor(np.asarray(jax.random.gumbel(sub, (B, cfg.talker.vocab_size))))
        gset.prefill(pp, torch.tensor(tie), torch.tensor(mask), 0, noise=noise0)
        for i, chunk in enumerate(CHUNKS):
            noise = None
            if mode == "sampled":
                noise = []
                for _ in range(chunk):
                    key, n = _jax_noise(key, B, cfg)
                    noise.append(n)
            ours = gset.run_chunk(pp, chunk, noise=noise).numpy()
            np.testing.assert_array_equal(ours, ref[i], err_msg=f"chunk {i} against the JAX engine")
        np.testing.assert_array_equal(gset.state.pos.numpy(), np.asarray(jstate.pos))
        np.testing.assert_array_equal(gset.state.done.numpy(), np.asarray(jstate.done))
        _assert_kv(gset.state, jstate, exact=False)
    finally:
        graphs.registry_for(pp).release(gset)


def test_pool_with_an_insert_mid_run(tiny_config, engine):
    """A 2-lane pool (every lane done), stream A inserted into lane 0, one
    chunk, stream B into lane 1, two chunks: the set's body equals the
    port's eager engine and the JAX engine doing the same."""
    jp, pp = engine
    cfg = tiny_config
    greedy = MODES["greedy"]
    ts, pss = SamplingParams(**greedy[0]), SamplingParams(**greedy[1])
    jts, jpss = JaxSamplingParams(**greedy[0]), JaxSamplingParams(**greedy[1])
    tie, mask, tth, tpe = _prompt(cfg, [9, 12], seed=1)  # the pool's first prompt: both lanes, then done
    a = _prompt(cfg, [11], seed=2)
    b = _prompt(cfg, [6], seed=3)
    tth_pool = np.concatenate([a[2], b[2]])
    T = tth.shape[1]

    def port_start(p, into=None):
        return core.start_state(pp["talker"], cfg.talker, torch.tensor(p[0]), torch.tensor(p[1]), None, MAX_SEQ,
                                ts, MIN_NEW, into=into)[0]

    def jax_start(p):
        return jax_core.start_state(jp["talker"], cfg.talker, jnp.asarray(p[0]), jnp.asarray(p[1]),
                                    jax.random.PRNGKey(0), MAX_SEQ, jts, MIN_NEW)[0]

    pool = port_start((tie, mask))
    pool.done.fill_(True)
    jpool = jax_start((tie, mask))
    jpool = jpool._replace(done=jnp.ones_like(jpool.done))
    gset = _lease(pp, cfg, 2, "greedy", T)
    slot = _lease(pp, cfg, 1, "greedy", T)
    try:
        gset.load_text(torch.tensor(tth_pool), torch.tensor(tpe))
        port_start((tie, mask), into=gset.state)
        gset.state.done.fill_(True)
        for lane, p, chunks in ((0, a, (4,)), (1, b, (8, 8))):
            core.insert_slot(pool, port_start(p), lane)
            jpool = jax_core.insert_slot(jpool, jax_start(p), jnp.asarray(lane, jnp.int32))
            core.insert_slot(gset.state, port_start(p, into=slot.state), lane)
            for chunk in chunks:
                pool, packed = core.decode_chunk(pp["talker"], pp["predictor"], cfg.talker, cfg.predictor, pool,
                                                 torch.tensor(tth_pool), torch.tensor(tpe), chunk, ts, pss, MIN_NEW)
                jpool, jpacked = jax_core.decode_chunk(
                    jp["talker"], jp["predictor"], cfg.talker, cfg.predictor, jpool, jnp.asarray(tth_pool),
                    jnp.asarray(tpe), chunk, jts, jpss, MIN_NEW)
                ours = gset.run_chunk(pp, chunk).numpy()
                np.testing.assert_array_equal(ours, packed.numpy())
                np.testing.assert_array_equal(ours, np.asarray(jpacked))
        assert ours[:, :, -2].all()  # both lanes live in the last chunk
        assert torch.equal(gset.state.pos, pool.pos)
        np.testing.assert_array_equal(gset.state.pos.numpy(), np.asarray(jpool.pos))
        _assert_kv(gset.state, pool, exact=True)
        _assert_kv(gset.state, jpool, exact=False)
    finally:
        graphs.registry_for(pp).release(gset)
        graphs.registry_for(pp).release(slot)


# -- leases ---------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tiny_config):
    cfg = dataclasses.replace(tiny_config, tts_bos_token_id=300, tts_eos_token_id=301, tts_pad_token_id=302)
    host = jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False)
    jax_model = JaxTTS(jax.device_put(host), cfg, PromptTokenizer(ByteTokenizer()), max_seq_len=160)
    jax_model._warmed_up = True
    port = FasterQwen3TTS(weights.params_from_numpy(host, device="cpu"), cfg, PromptTokenizer(ByteTokenizer()),
                          max_seq_len=160)
    return jax_model, port


def _xvec(seed):
    return {"ref_spk_embedding": [np.random.default_rng(seed).standard_normal(2048).astype(np.float32)]}


def _icl(seed, frames):
    rng = np.random.default_rng(seed)
    return {"ref_spk_embedding": [rng.standard_normal(2048).astype(np.float32)], "x_vector_only_mode": [False],
            "icl_mode": [True], "ref_code": [rng.integers(0, 2048, (frames, 16)).astype(np.int32)]}


def test_interleaved_streams_lease_two_sets(models, monkeypatch):
    """Two streams of one key, stepped alternately in one thread, run on two
    sets and each equals its solo run; closing a stream early returns its set."""
    _, port = models
    leased = []
    real = graphs.GraphRegistry.lease
    monkeypatch.setattr(graphs.GraphRegistry, "lease", lambda self, *a: leased.append(real(self, *a)) or leased[-1])
    kw = dict(max_new_tokens=20, min_new_tokens=20, chunk_size=4, first_chunk_size=4)

    def stream(text, seed):
        return port.generate_voice_clone_streaming(text, "English", voice_clone_prompt=_xvec(seed), seed=seed, **kw)

    streams = [stream("The first stream.", 1), stream("A second, longer stream of text.", 2)]
    got = [[], []]
    while streams[0] is not None or streams[1] is not None:
        for i, s in enumerate(streams):
            if s is not None:
                item = next(s, None)
                if item is None:
                    streams[i] = None
                else:
                    got[i].append(item[0])
    assert len(leased) == 2 and leased[0] is not leased[1] and leased[0].key == leased[1].key
    for i, (text, seed) in enumerate((("The first stream.", 1), ("A second, longer stream of text.", 2))):
        solo = np.concatenate([a for a, _, _ in stream(text, seed)])
        np.testing.assert_array_equal(np.concatenate(got[i]), solo)
    reg = graphs.registry_for(port.params)
    free = reg.free_count(leased[0].key)
    early = stream("Closed early.", 3)
    next(early)
    assert reg.free_count(leased[0].key) == free - 1
    early.close()
    assert reg.free_count(leased[0].key) == free


# -- dispatch-ahead -------------------------------------------------------------------------------

GREEDY = dict(do_sample=False, subtalker_dosample=False, seed=3)
SOLO = {"xvec": dict(voice_clone_prompt=_xvec(0)),
        "short_icl": dict(voice_clone_prompt=_icl(1, 12), ref_text="Reference words."),
        "long_icl": dict(voice_clone_prompt=_icl(2, 30), ref_text="Reference words.")}
LOCKSTEP = {"xvec": [{"text": "Hello world.", "voice_clone_prompt": _xvec(0), "xvec_only": True},
                     {"text": "A much longer second sentence here.", "voice_clone_prompt": _xvec(1),
                      "xvec_only": True}],
            "short_icl": [{"text": "Hello world.", "voice_clone_prompt": _xvec(0), "xvec_only": True},
                          {"text": "A second text.", "voice_clone_prompt": _icl(1, 6), "ref_text": "Ref words."}],
            "long_icl": [{"text": "Hello world.", "voice_clone_prompt": _icl(3, 30), "ref_text": "Ref one."},
                         {"text": "A different second text.", "voice_clone_prompt": _icl(4, 30),
                          "ref_text": "Ref two."}]}


def _spy(monkeypatch, mod, driver, events):
    """Record each chunk dispatch ("D") of `mod`'s session and each yield of
    its `driver` (("Y", chunk index, is_final))."""
    for name in ("decode_chunk_async", "decode_chunk_fused_async"):
        real = getattr(mod.GenerationSession, name)

        def dispatch(self, *a, _real=real, **k):
            events.append("D")
            return _real(self, *a, **k)

        monkeypatch.setattr(mod.GenerationSession, name, dispatch)
    real_driver = getattr(mod, driver)

    def recording(*a, **k):
        for item in real_driver(*a, **k):
            events.append(("Y", item[-1]["chunk_index"], bool(item[-1]["is_final"])))
            yield item

    monkeypatch.setattr(mod, driver, recording)


def _assert_ahead(events, first_ahead):
    """Chunk k+1 was dispatched before chunk k was yielded, from chunk
    `first_ahead` on, and nothing was dispatched after the final chunk."""
    yields = [(i, e) for i, e in enumerate(events) if e != "D"]
    assert yields and yields[-1][1][2] and "D" not in events[yields[-1][0]:]
    for i, (_, k, final) in yields:
        dispatched = events[:i].count("D")
        assert dispatched == (k + 2 if k >= first_ahead and not final else k + 1), (k, events)


@pytest.mark.parametrize("case", list(SOLO))
def test_solo_stream_dispatches_ahead_like_jax(models, monkeypatch, case):
    jax_model, port = models
    events = {"jax": [], "port": []}
    _spy(monkeypatch, jax_gen, "fast_generate_streaming_fused", events["jax"])
    _spy(monkeypatch, gen, "fast_generate_streaming_fused", events["port"])
    kw = dict(max_new_tokens=40, chunk_size=8, first_chunk_size=4, **GREEDY, **SOLO[case])
    ref = list(jax_model.generate_voice_clone_streaming("Hello streaming world.", "English", **kw))
    out = list(port.generate_voice_clone_streaming("Hello streaming world.", "English", **kw))
    assert events["port"] == events["jax"]
    _assert_ahead(events["port"], first_ahead=1)
    assert len(out) == len(ref) and len(out) >= 3
    for (a, sr, t), (ja, jsr, jt) in zip(out, ref):
        assert sr == jsr and a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)
        for key in ("chunk_index", "chunk_steps", "total_steps_so_far", "is_final"):
            assert t[key] == jt[key], key


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_batch_dispatches_ahead_like_jax(models, monkeypatch, case):
    jax_model, port = models
    events = {"jax": [], "port": []}
    frames = {"jax": [], "port": []}
    for name, mod in (("jax", jax_gen), ("port", gen)):
        _spy(monkeypatch, mod, "fast_generate_streaming_batch", events[name])
        tapped = getattr(mod, "fast_generate_streaming_batch")
        monkeypatch.setattr(mod, "fast_generate_streaming_batch",
                            lambda *a, _t=tapped, _f=frames[name], **k: (_f.append(it[:3]) or it for it in _t(*a, **k)))
    kw = dict(chunk_size=8, first_chunk_size=4, max_new_tokens=36, **GREEDY)
    ref = list(jax_model.generate_voice_clone_streaming_batch(LOCKSTEP[case], **kw))
    out = list(port.generate_voice_clone_streaming_batch(LOCKSTEP[case], **kw))
    assert events["port"] == events["jax"]
    _assert_ahead(events["port"], first_ahead=0)
    for (f, v, d), (jf, jv, jd) in zip(frames["port"], frames["jax"]):
        np.testing.assert_array_equal(f[v], np.asarray(jf)[jv])
        np.testing.assert_array_equal(d, jd)
    assert [(s, t["chunk_index"], t["is_final"]) for s, _, _, t in out] == \
        [(s, t["chunk_index"], t["is_final"]) for s, _, _, t in ref]
    for (_, a, _, _), (_, ja, _, _) in zip(out, ref):
        assert a.shape == ja.shape
        np.testing.assert_allclose(a, ja, atol=1e-4, rtol=0)


# -- warmup ---------------------------------------------------------------------------------------


def test_warmup_windows_are_the_jax_warmup_set(models, monkeypatch):
    """`warmup(chunk_sizes=(8, 12), first_chunk_size=4)` notes on its B=1 set
    the (chunk, ctx) windows the JAX warmup compiles for the same sizes (its
    dispatches recorded, nothing run)."""
    jax_model, port = models
    compiled = []
    S = jax_gen.GenerationSession
    monkeypatch.setattr(S, "prefill", lambda self, block=True: setattr(
        self, "state", types.SimpleNamespace(token=jnp.zeros(1))))
    monkeypatch.setattr(S, "decode_chunk_async", lambda self, chunk: jnp.zeros(1))
    monkeypatch.setattr(S, "set_codec_history", lambda self, frames, ctx: None)
    monkeypatch.setattr(S, "decode_chunk_fused_async",
                        lambda self, chunk, ctx: compiled.append((chunk, ctx)) or jnp.zeros(1))
    monkeypatch.setattr(jax_model, "_prepare_generation", lambda *a, **k: None)
    monkeypatch.setattr(jax_model.prompt_builder, "specials", lambda: None)
    monkeypatch.setattr(jax_model.prompt_builder, "speaker_embed_from_xvector", lambda x: None)
    monkeypatch.setattr(jax_model, "_warmed_up", False)
    jax_model.warmup(first_chunk_size=4)
    phases = port.warmup(chunk_sizes=(8, 12), first_chunk_size=4)
    assert phases["captures"] == 0  # nothing is captured on the CPU
    key = graphs.make_key(port.params, 1, port.max_seq_len, gen.tth_bucket(1), SamplingParams(),
                          gen.predictor_sampling(), 2)
    (warm,) = [s for s in graphs.registry_for(port.params).sets if s.key == key]
    assert set(warm.windows) == set(compiled) and len(set(compiled)) == 9
