"""The captured decode (engine/graphs.py) on the card against the eager engine.

These need an NVIDIA GPU and skip without one. The file imports no jax, so
it runs on a machine without it:

    python -m pytest tests/test_torch_graph_capture.py --noconftest -q

From one start state, chunks of replays of the captured frame equal eager
`core.decode_chunk` token for token (packed rows, pos and the KV cache
exactly): at a tiny float32 geometry and at the 0.6B widths with two layers
a stack in bf16 Q8_0, greedy and sampled with one seed (the set's generator
is registered with its graph, so a replay draws what the eager frame
draws); the window graph equals eager `_vocode_window` at 1e-5 (f32) or
exactly (bf16: the same kernels in the same order); a released set is
leased again and a second live lease gets another set; a new seed after a
set was used gives the eager tokens of that seed; and after `warmup` a
served request runs no eager frame on the card. The prefill: a set's
replayed prefill graph equals eager `core.start_state` bit for bit (tokens,
logits, past hidden, positions, pads, the KV cache over the prompt) at
prompt buckets 32-256, greedy and sampled; replays of prefill, frame and
window graphs in mixed order on one set keep every chunk equal to eager; and
after `warmup` a served request runs no eager prefill. The fused projection
layout (bf16 Q8_0 and Q4_K_M at the 0.6B widths, tiny f32) replays equal to
its eager decode bit for bit, in graph sets of its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.config import config_from_dict, get_config
from faster_qwen3_tts_tpu_torch.engine import core, fused_stream, graphs
from faster_qwen3_tts_tpu_torch.ops import quant
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams

TINY = {
    "model_type": "base", "tts_bos_token_id": 300, "tts_eos_token_id": 301, "tts_pad_token_id": 302,
    "talker_config": {"num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 4,
                      "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 256,
                      "text_hidden_size": 64, "text_vocab_size": 512},
    "predictor_config": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 2,
                         "num_key_value_heads": 1, "head_dim": 32, "intermediate_size": 128},
    "codec_config": {"hidden_size": 64, "num_hidden_layers": 1, "intermediate_size": 128,
                     "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 32, "decoder_dim": 64},
}
GREEDY = (SamplingParams(do_sample=False), SamplingParams(do_sample=False, repetition_penalty=1.0))
SAMPLED = (SamplingParams(), SamplingParams(0.9, 50, 1.0, True, 1.0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


_MODELS = {}


def _model(name, device):
    """(params, cfg) of the tiny f32 geometry or of the 0.6B widths with two
    layers a stack in bf16 Q8_0 (and "-q4": Q4_K_M), made once; a name
    ending in "-fused" is that tree in the fused projection layout."""
    if name not in _MODELS:
        if name.endswith("-fused"):
            plain, cfg = _model(name[:-len("-fused")], device)
            params = quant.fuse_layer_weights(plain)
        elif name == "tiny":
            cfg = config_from_dict(TINY)
            params = weights.materialize(weights.init_numpy(cfg, seed=0), torch.float32, "none", device)
        else:
            full = get_config("Qwen/Qwen3-TTS-12Hz-0.6B-Base")
            cfg = dataclasses.replace(
                full, talker=dataclasses.replace(full.talker, num_hidden_layers=2),
                predictor=dataclasses.replace(full.predictor, num_hidden_layers=2))
            params = weights.materialize(weights.init_numpy(cfg, seed=0), torch.bfloat16,
                                         "int4" if name.endswith("-q4") else "int8", device)
        _MODELS[name] = (params, cfg)
    return _MODELS[name]


def _prompt(cfg, params, B=1, P=24, T=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    H, dtype, device = cfg.talker.hidden_size, params["talker"]["codec_embed"].dtype, "cuda"
    tie = (torch.randn(B, P, H, generator=g) * 0.5).to(device, dtype)
    mask = torch.ones(B, P, dtype=torch.int32)
    if B > 1:
        mask[1, :5] = 0  # a left-padded lane
    tth = (torch.randn(B, T, H, generator=g) * 0.5).to(device, dtype)
    tpe = (torch.randn(1, 1, H, generator=g) * 0.5).to(device, dtype)
    return tie, mask.to(device), tth, tpe


def _eager(params, cfg, prompt, sampling, seed, chunks, max_seq=256, min_new=2):
    tie, mask, tth, tpe = prompt
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, _ = core.start_state(params["talker"], cfg.talker, tie, mask, gen, max_seq, sampling[0], min_new)
    out = []
    for chunk in chunks:
        state, packed = core.decode_chunk(params["talker"], params["predictor"], cfg.talker, cfg.predictor, state,
                                          tth, tpe, chunk, sampling[0], sampling[1], min_new)
        out.append(packed.clone())
    return state, out


def _replayed(gset, params, prompt, seed, chunks):
    tie, mask, tth, tpe = prompt
    gset.load_text(tth, tpe)
    gset.prefill(params, tie, mask, seed)
    return [gset.run_chunk(params, chunk).clone() for chunk in chunks]


def _key(params, prompt, sampling, max_seq=256, min_new=2):
    tie, _, tth, _ = prompt
    return graphs.make_key(params, tie.shape[0], max_seq, tth.shape[1], sampling[0], sampling[1], min_new)


def _assert_same(gset, state, eager, replayed):
    for i, (e, r) in enumerate(zip(eager, replayed)):
        assert torch.equal(e, r), f"chunk {i}: replayed rows differ from eager"
    assert torch.equal(gset.state.pos, state.pos) and torch.equal(gset.state.done, state.done)
    assert torch.equal(gset.state.cache.k, state.cache.k) and torch.equal(gset.state.cache.v, state.cache.v)


@pytest.mark.cuda
@pytest.mark.parametrize("name, B", [("tiny", 1), ("tiny", 3), ("0.6b-2-layers", 1)])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_replay_equals_eager(cuda_device, name, B, mode):
    params, cfg = _model(name, cuda_device)
    sampling = GREEDY if mode == "greedy" else SAMPLED
    prompt = _prompt(cfg, params, B=B)
    chunks = (4, 8, 8, 12)
    state, eager = _eager(params, cfg, prompt, sampling, 7, chunks)
    reg = graphs.registry_for(params)
    gset = reg.lease(params, cfg, _key(params, prompt, sampling))
    try:
        assert gset.frame_graph is not None and sum(gset.frame_launches.values()) > 0
        _assert_same(gset, state, eager, _replayed(gset, params, prompt, 7, chunks))
    finally:
        reg.release(gset)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-fused", "0.6b-2-layers-fused", "0.6b-2-layers-q4-fused"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_fused_replay_equals_eager(cuda_device, name, mode):
    """The fused layout: replays equal eager bit for bit, in graph sets of
    their own (the fused tree shares every other leaf with the unfused one),
    whose frame makes 4 projection launches a layer instead of 7."""
    params, cfg = _model(name, cuda_device)
    plain, _ = _model(name[:-len("-fused")], cuda_device)
    sampling = GREEDY if mode == "greedy" else SAMPLED
    prompt = _prompt(cfg, params)
    chunks = (4, 8, 8)
    state, eager = _eager(params, cfg, prompt, sampling, 7, chunks)
    reg = graphs.registry_for(params)
    assert reg is not graphs.registry_for(plain)
    gset = reg.lease(params, cfg, _key(params, prompt, sampling))
    pset = graphs.registry_for(plain).lease(plain, cfg, _key(plain, prompt, sampling))
    try:
        _assert_same(gset, state, eager, _replayed(gset, params, prompt, 7, chunks))
        layer_passes = cfg.talker.num_hidden_layers + 15 * cfg.predictor.num_hidden_layers
        kernel = "K1" if name.startswith("tiny") else ("K4" if "-q4" in name else "K2")
        if kernel != "K1":
            assert pset.frame_launches[kernel] - gset.frame_launches[kernel] == 3 * layer_passes
    finally:
        reg.release(gset)
        graphs.registry_for(plain).release(pset)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny", "0.6b-2-layers"])
@pytest.mark.parametrize("ctx", [0, 4, 24])
def test_window_replay_equals_eager(cuda_device, name, ctx):
    params, cfg = _model(name, cuda_device)
    prompt = _prompt(cfg, params)
    reg = graphs.registry_for(params)
    gset = reg.lease(params, cfg, _key(params, prompt, GREEDY))
    try:
        _replayed(gset, params, prompt, 0, (8,))
        if ctx:
            gset.set_history(np.random.default_rng(ctx).integers(0, 2048, (1, 30, 16)), ctx)
        audio = gset.vocode(params, 8, ctx).clone()
        want = fused_stream._vocode_window(params["codec"], cfg.talker, cfg.codec,
                                           gset.hist(ctx) if ctx else None, gset.packed[:8], 8, ctx)
        assert audio.shape == want.shape and torch.isfinite(audio).all()
        torch.testing.assert_close(audio, want, atol=1e-5, rtol=0)
    finally:
        reg.release(gset)


@pytest.mark.cuda
def test_leases_are_reused_and_never_shared(cuda_device):
    params, cfg = _model("tiny", cuda_device)
    prompt = _prompt(cfg, params)
    reg = graphs.registry_for(params)
    key = _key(params, prompt, GREEDY, min_new=3)  # a key no other test captures
    a = reg.lease(params, cfg, key)
    b = reg.lease(params, cfg, key)  # a second live session: another set
    assert a is not b and a.frame_graph is not b.frame_graph
    captures = reg.stats["captures"]
    reg.release(a)
    c = reg.lease(params, cfg, key)
    assert c is a and reg.stats["captures"] == captures  # reused, nothing captured
    reg.release(b)
    reg.release(c)
    assert reg.free_count(key) == 2


@pytest.mark.cuda
def test_new_seed_after_manual_seed(cuda_device):
    """A set used with one seed, then prefilled with another, gives the eager
    tokens of the second seed: the replays read the generator's current
    seed and offset."""
    params, cfg = _model("tiny", cuda_device)
    prompt = _prompt(cfg, params)
    reg = graphs.registry_for(params)
    gset = reg.lease(params, cfg, _key(params, prompt, SAMPLED))
    try:
        first = _replayed(gset, params, prompt, 11, (8, 8))
        state, eager = _eager(params, cfg, prompt, SAMPLED, 12, (8, 8))
        second = _replayed(gset, params, prompt, 12, (8, 8))
        _assert_same(gset, state, eager, second)
        assert any(not torch.equal(x, y) for x, y in zip(first, second))
    finally:
        reg.release(gset)


@pytest.mark.cuda
def test_no_eager_frame_after_warmup(cuda_device, tmp_path):
    """After `warmup` a streaming request with the warmed sampling runs every
    frame as a replay: the eager-frame counter does not move."""
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    cfg = config_from_dict(TINY)
    weights.save_pretrained(str(tmp_path), weights.init_numpy(cfg, seed=0), cfg)
    model = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cuda", dtype="float32", quant="Q8_0",
                                           max_seq_len=256)
    # no EOS before 20 frames (a tiny random model may end at once); the request uses the same key
    phases = model.warmup(chunk_sizes=(8,), first_chunk_size=4, min_new_tokens=20)
    assert phases["captures"] >= 1
    before = core._decode_frame.eager_cuda
    graphs.reset_replayed()
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    chunks = list(model.generate_voice_clone_streaming("Hello there.", "English", voice_clone_prompt=prompt,
                                                       max_new_tokens=20, min_new_tokens=20, chunk_size=8,
                                                       first_chunk_size=4, seed=1))
    assert chunks and core._decode_frame.eager_cuda == before
    assert graphs.replayed["frames"] == 20 and graphs.replayed["K1"] > 0 and graphs.replayed["K2"] > 0


def _bucket_prompt(cfg, params, bucket, real, seed):
    """A prompt [1, bucket, H] left-padded to `real` rows."""
    g = torch.Generator().manual_seed(seed)
    H, dtype = cfg.talker.hidden_size, params["talker"]["codec_embed"].dtype
    tie = torch.zeros(1, bucket, H)
    tie[:, bucket - real:] = torch.randn(1, real, H, generator=g) * 0.5
    mask = torch.zeros(1, bucket, dtype=torch.int32)
    mask[:, bucket - real:] = 1
    tth = (torch.randn(1, 40, H, generator=g) * 0.5).to("cuda", dtype)
    tpe = (torch.randn(1, 1, H, generator=g) * 0.5).to("cuda", dtype)
    return tie.to("cuda", dtype), mask.to("cuda"), tth, tpe


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny", "0.6b-2-layers"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_prefill_replay_equals_eager(cuda_device, name, mode):
    params, cfg = _model(name, cuda_device)
    sampling = GREEDY if mode == "greedy" else SAMPLED
    reg = graphs.registry_for(params)
    gset = reg.lease(params, cfg, _key(params, _prompt(cfg, params), sampling))
    try:
        for bucket in (32, 64, 128, 256):
            tie, mask, _, _ = _bucket_prompt(cfg, params, bucket, bucket - 5, seed=bucket)
            gset.prepare_prefill(params, bucket)
            assert gset.prefills[bucket] is not None
            before = core.start_state.eager_cuda
            gset.prefill(params, tie, mask, 21)
            assert core.start_state.eager_cuda == before  # a replay, not an eager prefill
            gen = torch.Generator(device="cuda").manual_seed(21)
            state, logits = core.start_state(params["talker"], cfg.talker, tie, mask, gen, 256, sampling[0], 2)
            st = gset.state
            for field in ("token", "past_hidden", "pos", "num_pads"):
                assert torch.equal(getattr(st, field), getattr(state, field)), (bucket, field)
            assert torch.equal(gset.logits, logits), bucket
            assert torch.equal(st.cache.k[:, :, :bucket], state.cache.k[:, :, :bucket]), bucket
            assert torch.equal(st.cache.v[:, :, :bucket], state.cache.v[:, :, :bucket]), bucket
            assert not st.cache.k[:, :, bucket:].any()  # the rows past the prompt are zeroed
    finally:
        reg.release(gset)


@pytest.mark.cuda
def test_mixed_replays_keep_equality(cuda_device):
    """Two prompts at two buckets prefilled in turn on one set, each followed
    by chunks and windows, in the order A, B, A, B: every chunk equals eager,
    each window equals eager `_vocode_window`."""
    params, cfg = _model("0.6b-2-layers", cuda_device)
    a = _bucket_prompt(cfg, params, 64, 40, seed=1)
    b = _bucket_prompt(cfg, params, 32, 20, seed=2)
    runs = {"a": (a, 3, (4, 8)), "b": (b, 4, (8,))}
    eager = {k: _eager(params, cfg, p, SAMPLED, seed, chunks)[1] for k, (p, seed, chunks) in runs.items()}
    reg = graphs.registry_for(params)
    gset = reg.lease(params, cfg, _key(params, a, SAMPLED))
    try:
        for k in ("a", "b", "a", "b"):
            (tie, mask, tth, tpe), seed, chunks = runs[k]
            gset.load_text(tth, tpe)
            gset.prefill(params, tie, mask, seed)
            for i, chunk in enumerate(chunks):
                assert torch.equal(gset.run_chunk(params, chunk), eager[k][i]), (k, i)
                audio = gset.vocode(params, chunk, 0).clone()
                want = fused_stream._vocode_window(params["codec"], cfg.talker, cfg.codec, None, gset.packed[:chunk],
                                                   chunk, 0)
                torch.testing.assert_close(audio, want, atol=1e-5, rtol=0)
    finally:
        reg.release(gset)


@pytest.mark.cuda
def test_no_eager_prefill_after_warmup(cuda_device, tmp_path):
    """After `warmup` a streaming request (its prompt assembled on the card)
    replays its prefill: the eager-prefill counter does not move."""
    from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS

    cfg = config_from_dict(TINY)
    weights.save_pretrained(str(tmp_path), weights.init_numpy(cfg, seed=0), cfg)
    model = FasterQwen3TTS.from_pretrained(str(tmp_path), device="cuda", dtype="float32", quant="Q8_0",
                                           max_seq_len=256)
    phases = model.warmup(chunk_sizes=(8,), first_chunk_size=4, min_new_tokens=20)
    assert phases["prefill_captures"] == 4 and phases["prefill_buckets"] == [32, 64, 128, 256]
    before = core.start_state.eager_cuda, core._decode_frame.eager_cuda
    graphs.reset_replayed()
    prompt = {"ref_spk_embedding": [np.random.default_rng(0).standard_normal(2048).astype(np.float32)]}
    chunks = list(model.generate_voice_clone_streaming("Hello there.", "English", voice_clone_prompt=prompt,
                                                       max_new_tokens=20, min_new_tokens=20, chunk_size=8,
                                                       first_chunk_size=4, seed=1))
    assert chunks and (core.start_state.eager_cuda, core._decode_frame.eager_cuda) == before
    assert graphs.replayed["prefills"] == 1 and graphs.replayed["frames"] == 20
