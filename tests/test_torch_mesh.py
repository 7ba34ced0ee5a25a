"""The port's (dp, tp) device mesh (parallel/mesh.py) against the JAX package's.

The port's mesh is a grid of torch devices that may repeat a device, as the
JAX tests' eight virtual CPU devices do (tests/conftest.py): here a mesh of
`cpu` entries. At the `tiny_tp_config` geometry of tests/test_sharding.py
(talker 4/2 heads, predictor 2/2, so tp = 2 divides both) in float32:
`make_mesh`'s inference, every leaf's spec and shard shapes against the JAX
package's NamedShardings, the prefill and one greedy chunk on each mesh
(packed frames exact against the port unsharded and the JAX package's
sharded run, prefill logits within 1e-5: the tp partial sums run in another
order), `from_pretrained(dp=2, tp=2)` lockstep batches against dp = tp = 1
and the JAX package's (codes exact), the errors, and a sampled 2 x 2 stream
fed one noise draw for the whole batch.
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import faster_qwen3_tts_tpu.config as jax_config
from faster_qwen3_tts_tpu import weights as jax_weights
from faster_qwen3_tts_tpu.engine import core as jax_core
from faster_qwen3_tts_tpu.engine import generate as jax_gen
from faster_qwen3_tts_tpu.model import FasterQwen3TTS as JaxTTS
from faster_qwen3_tts_tpu.ops import quant as jax_quant
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu.parallel import mesh as jax_mesh
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.ops import quant
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams
from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)
MESHES = [(4, 2), (8, 1), (2, 2), (1, 2)]
QUANTS = {"F32": "none", "Q8_0": "int8", "Q8_4": "mixed"}
GREEDY = SamplingParams(do_sample=False)
PFX, TEXT, MAX_SEQ, CHUNK = 32, 32, 64, 4  # prompt and trailing text at their buckets: no padding


def _tiny_tp(tiny_config):
    """tests/test_sharding.py's tiny_tp_config (kv heads divisible by tp = 2
    in both submodels) with the conftest codec, and special ids the byte
    tokenizer reaches."""
    talker = dataclasses.replace(tiny_config.talker, num_key_value_heads=2)
    pred = jax_config.PredictorConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                      num_key_value_heads=2, head_dim=16, intermediate_size=64)
    return dataclasses.replace(tiny_config, talker=talker, predictor=pred, tts_bos_token_id=300,
                               tts_eos_token_id=301, tts_pad_token_id=302)


@pytest.fixture(scope="module")
def tp_cfg(tiny_config):
    return _tiny_tp(tiny_config)


@pytest.fixture(scope="module")
def host(tp_cfg):
    """quant name -> the host tree, quantized by the JAX package's numpy code."""
    tree = jax_weights.init_all(tp_cfg, seed=0, dtype=jnp.float32, device_put=False)
    return {name: tree if mode == "none" else jax_quant.quantize_model_params(tree, mode)
            for name, mode in QUANTS.items()}


def _cpu_mesh(dp, tp):
    return mesh_lib.make_mesh(dp * tp, dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _leaves(tree, path=""):
    """(path, leaf) of a params tree: dicts, lists and the quantized tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        for k, v in zip(names, tree):
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


# -- (1) make_mesh ---------------------------------------------------------------------------------


@pytest.mark.parametrize("args", [dict(), dict(dp=2), dict(tp=2), dict(dp=4, tp=2), dict(dp=1), dict(tp=8)])
def test_make_mesh_infers_dp_and_tp_as_jax(args):
    ours = mesh_lib.make_mesh(8, devices=["cpu"] * 8, **args)
    theirs = jax_mesh.make_mesh(8, **args)
    assert ours.shape == dict(theirs.shape) and ours.devices.shape == theirs.devices.shape
    assert all(d == torch.device("cpu") for d in ours.devices.flat)


def test_make_mesh_asserts_dp_times_tp():
    with pytest.raises(AssertionError, match=r"dp\(3\) \* tp\(2\) != 8"):
        mesh_lib.make_mesh(8, dp=3, tp=2, devices=["cpu"] * 8)
    with pytest.raises(AssertionError):
        jax_mesh.make_mesh(8, dp=3, tp=2)


# -- (2) specs, (3) shard shapes --------------------------------------------------------------------


def test_param_and_cache_specs_equal_jax():
    def tuples(tree):
        return {k: tuples(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree)

    assert tuples(mesh_lib.talker_param_specs()) == tuples(jax_mesh.talker_param_specs())
    assert tuples(mesh_lib.predictor_param_specs()) == tuples(jax_mesh.predictor_param_specs())
    assert tuple(mesh_lib.kv_cache_spec()) == tuple(jax_mesh.kv_cache_spec()) == (None, "dp", None, "tp", None)
    ours, theirs = mesh_lib.state_specs(), jax_mesh.state_specs()
    for name in ("pos", "num_pads", "token", "past_hidden", "gen_step", "seen", "done", "n_frames"):
        assert tuple(getattr(ours, name)) == tuple(getattr(theirs, name)), name
    assert tuple(ours.cache.k) == tuple(theirs.cache.k) and tuple(ours.generator) == tuple(theirs.key) == ()


@pytest.mark.parametrize("tp", [1, 2])
def test_group_cache_is_the_kv_cache_spec_shard(tp_cfg, host, tp):
    """A dp group's static KV cache is one cache a tp rank, each the shard
    `kv_cache_spec` gives (kv heads / tp); one rank's is a plain KVCache."""
    from faster_qwen3_tts_tpu_torch.engine.core import KVCache

    mesh = _cpu_mesh(2, tp)
    sharded = mesh_lib.shard_params(weights.params_from_numpy(host["F32"], device="cpu"), mesh)
    tie, mask, tth, tpe = _inputs(tp_cfg, 2)
    sess = gen.GenerationSession(sharded, tp_cfg, tie, mask, tth, tpe, MAX_SEQ, GREEDY, GREEDY, 2, seed=0,
                                 mesh=mesh)
    try:
        t = tp_cfg.talker
        whole = (t.num_hidden_layers, 1, MAX_SEQ, t.num_key_value_heads, t.head_dim)
        want = mesh_lib.shard_shape(whole, mesh_lib.kv_cache_spec(), {"tp": tp})
        assert want[3] == t.num_key_value_heads // tp
        sess.prefill()  # leases each group's graph set
        for part in sess.parts:
            cache = part.graphs.state.cache
            assert isinstance(cache, mesh_lib.Ranks if tp > 1 else KVCache)
            caches = mesh_lib.as_ranks(cache)
            assert len(caches) == tp and all(c.k.shape == c.v.shape == want for c in caches)
    finally:
        sess.close()


@pytest.mark.parametrize("qname", list(QUANTS))
def test_leaf_specs_and_shard_shapes_equal_jax(host, qname):
    """Every talker and predictor leaf on a (4, 2) mesh: its spec (padded
    to its rank) and the shapes of its eight shards equal the JAX leaf's
    NamedSharding spec and `addressable_shards`; int8 q shards like its
    weight and its scale only on O; int4 leaves are replicated. Each shard
    is its own allocation on its group's device. The codec (whose conv
    layouts are the port's own) is replicated, one copy a dp group."""
    tree = host[qname]
    mesh = _cpu_mesh(4, 2)
    ours = mesh_lib.shard_params(weights.params_from_numpy(tree, device="cpu"), mesh)
    theirs = jax_mesh.shard_params(jax.device_put(tree), jax_mesh.make_mesh(8, dp=4, tp=2))
    mine = dict(_leaves(ours))
    for path, got in mine.items():
        if path.startswith("/codec/"):
            assert set(got.spec) == {None} and all(t.shape == got.shape for t in got.addressable_shards), path
            assert len({t.data_ptr() for t in got.addressable_shards}) == 4  # a copy a dp group
    for path, leaf in _leaves({k: theirs[k] for k in ("talker", "predictor")}):
        got = mine[path]
        assert isinstance(got, mesh_lib.ShardedTensor), path
        spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(tuple(leaf.sharding.spec)))
        assert tuple(got.spec) == spec, path
        assert sorted(tuple(t.shape) for t in got.addressable_shards) == \
            sorted(tuple(s.data.shape) for s in leaf.addressable_shards), path
        assert tuple(got.shape) == tuple(leaf.shape) and len(got.addressable_shards) == 8
        for g in range(4):
            if "tp" in spec:  # each rank's slice in an allocation of its own
                a, b = got.shards[g]
                assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
                assert a.is_contiguous() and a.data_ptr() % 16 == 0
    kinds = {"F32": (torch.Tensor, torch.Tensor), "Q8_0": (quant.QuantizedLinear, quant.QuantizedLinear),
             "Q8_4": (quant.QuantizedLinear, quant.QuantizedLinear4)}[qname]
    for sub, kind in zip(("talker", "predictor"), kinds):
        w = ours[sub]["layers"]["wq"]
        assert isinstance(w, mesh_lib.ShardedTensor if kind is torch.Tensor else kind)
    wq = ours["talker"]["layers"]["wq"]
    if qname != "F32":
        assert tuple(wq.scale.spec) == (None, None, "tp") and tuple(ours["talker"]["layers"]["wo"].scale.spec) == \
            (None, None, None)
    if qname == "Q8_4":
        assert isinstance(ours["predictor"]["layers"]["wq"], quant.QuantizedLinear4)
        assert all(s is None for s in ours["predictor"]["layers"]["wq"].packed.spec)


def test_gather_params_is_the_unsharded_tree(host):
    src = weights.params_from_numpy(host["Q8_0"], device="cpu")
    back = mesh_lib.gather_params(mesh_lib.shard_params(src, _cpu_mesh(2, 2)))
    pairs = list(zip(_leaves(src), _leaves(back)))
    assert len(pairs) == len(list(_leaves(src)))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb and torch.equal(a, b), pa


# -- (4) prefill and one greedy chunk on each mesh ------------------------------------------------


def _inputs(cfg, B):
    H = cfg.talker.hidden_size
    tie = (np.random.default_rng(0).standard_normal((B, PFX, H)) * 0.02).astype(np.float32)
    return tie, np.ones((B, PFX), np.int32), np.zeros((B, TEXT, H), np.float32), np.zeros((1, 1, H), np.float32)


def _port_chunk(params, cfg, B, mesh=None, sampling=GREEDY, noise=None):
    """Prefill and one chunk through the port's session -> (prefill logits
    [B, V], packed rows [chunk, B, 18])."""
    tie, mask, tth, tpe = _inputs(cfg, B)
    sess = gen.GenerationSession(params, cfg, tie, mask, tth, tpe, MAX_SEQ, sampling, sampling, 2, seed=0,
                                 mesh=mesh)
    try:
        sess.prefill(noise=None if noise is None else noise[0])
        logits = torch.cat([p.graphs.logits for p in sess.parts]).clone()
        packed = sess.decode_chunk_async(CHUNK, None if noise is None else noise[1]).clone()
    finally:
        sess.close()
    return logits.numpy(), packed.numpy()


def _jax_chunk(cfg, params, B, mesh):
    """tests/test_sharding.py's `_run_chunk` (prefill + one greedy chunk on
    the JAX mesh), also returning the prefill logits."""
    tie, mask, tth, _ = _inputs(cfg, B)
    tpe = np.zeros((B, 1, cfg.talker.hidden_size), np.float32)
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    s = JaxSamplingParams(do_sample=False)
    with mesh:
        state, logits = jax_core.start_state(
            params["talker"], cfg.talker, put(tie, JP("dp", None, None)), put(mask, JP("dp", None)),
            jax.random.PRNGKey(0), MAX_SEQ, s, 2)
        state, packed = jax_core.decode_chunk(
            params["talker"], params["predictor"], cfg.talker, cfg.predictor, state,
            put(tth, JP("dp", None, None)), put(tpe, JP("dp", None, None)), CHUNK, s, s, 2)
    return np.asarray(logits), np.asarray(packed)


@pytest.mark.parametrize("qname", list(QUANTS))
@pytest.mark.parametrize("dp, tp", MESHES)
def test_sharded_chunk_matches_unsharded_and_jax(tp_cfg, host, dp, tp, qname):
    """B = dp lanes, split over dp (one lane a group): packed frames exactly
    the port unsharded's and the JAX package's sharded run; prefill logits
    within 1e-5 of both."""
    tree = host[qname]
    plain = weights.params_from_numpy(tree, device="cpu")
    mesh = _cpu_mesh(dp, tp)
    ref_logits, ref = _port_chunk(plain, tp_cfg, dp)
    logits, got = _port_chunk(mesh_lib.shard_params(plain, mesh), tp_cfg, dp, mesh)
    jmesh = jax_mesh.make_mesh(dp * tp, dp=dp, tp=tp)
    jparams = jax_mesh.shard_params({"talker": tree["talker"], "predictor": tree["predictor"]}, jmesh)
    jlogits, jgot = _jax_chunk(tp_cfg, jparams, dp, jmesh)
    assert got.shape == (CHUNK, dp, 18) and got[:, :, -2].all()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits, jlogits, atol=1e-5, rtol=0)


def test_batch_not_divisible_by_dp_runs_on_group_zero(tp_cfg, host):
    """B = 3 on dp = 2: dp group 0 runs every lane (the JAX package
    replicates such a batch over dp): the unsharded frames."""
    plain = weights.params_from_numpy(host["F32"], device="cpu")
    mesh = _cpu_mesh(2, 2)
    sharded = mesh_lib.shard_params(plain, mesh)
    groups = gen.lane_groups(sharded, 3, mesh)
    assert len(groups) == 1 and groups[0][0].index == 0 and groups[0][1] == slice(0, 3)
    assert [g.index for g, _ in gen.lane_groups(sharded, 4, mesh)] == [0, 1]
    assert len(gen.lane_groups(sharded, 4)) == 1  # no mesh= (a solo or non-streaming driver): group 0
    np.testing.assert_array_equal(_port_chunk(sharded, tp_cfg, 3, mesh)[1], _port_chunk(plain, tp_cfg, 3)[1])


# -- (7) a sampled stream fed one noise draw for the whole batch ----------------------------------


def test_sampled_2x2_with_shared_noise_equals_unsharded(tp_cfg, host):
    """The JAX package draws one replicated key for the whole batch; the
    port's dp groups each have a generator, so the batch's noise is drawn
    once here and each group takes its lanes' rows: the sampled frames
    equal the unsharded run's."""
    cfg, B = tp_cfg, 4
    rng = np.random.default_rng(5)
    g = lambda *shape: torch.from_numpy(rng.gumbel(size=shape).astype(np.float32))
    Vp = cfg.predictor.vocab_size
    noise = (g(B, cfg.talker.vocab_size), [(g(15, B, Vp), g(B, cfg.talker.vocab_size)) for _ in range(CHUNK)])
    sampling = SamplingParams(temperature=0.9, top_k=50, top_p=1.0, do_sample=True, repetition_penalty=1.05)
    plain = weights.params_from_numpy(host["F32"], device="cpu")
    mesh = _cpu_mesh(2, 2)
    _, ref = _port_chunk(plain, cfg, B, sampling=sampling, noise=noise)
    _, got = _port_chunk(mesh_lib.shard_params(plain, mesh), cfg, B, mesh, sampling=sampling, noise=noise)
    assert got[:, :, -2].all()
    np.testing.assert_array_equal(got, ref)


# -- (5) from_pretrained(dp=2, tp=2) and the lockstep batch ---------------------------------------


@pytest.fixture(scope="module")
def tp_dir(tp_cfg, host, tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "ckpt"
    weights.save_pretrained(str(path), host["F32"], tp_cfg)
    return str(path)


def _xvec(seed):
    return {"ref_spk_embedding": [np.random.default_rng(seed).standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [True], "icl_mode": [False], "ref_code": [None]}


TEXTS = ["Hello world.", "A much longer second sentence here.", "Third one.", "Four."]


def _batch_codes(model, gen_module, n):
    """Each lane's codes of a greedy lockstep batch of n x-vector requests,
    tapped at the driver."""
    lanes = {s: [] for s in range(n)}
    driver = gen_module.fast_generate_streaming_batch

    def tap(*a, **kw):
        for frames, valid, done, audio, timing in driver(*a, **kw):
            for s in range(n):
                lanes[s].append(np.asarray(frames)[np.asarray(valid)[:, s], s])
            yield frames, valid, done, audio, timing

    gen_module.fast_generate_streaming_batch = tap
    try:
        reqs = [{"text": TEXTS[i], "voice_clone_prompt": _xvec(i), "xvec_only": True} for i in range(n)]
        audio = list(model.generate_voice_clone_streaming_batch(reqs, chunk_size=4, max_new_tokens=12,
                                                                do_sample=False, subtalker_dosample=False, seed=0))
    finally:
        gen_module.fast_generate_streaming_batch = driver
    assert audio and all(np.isfinite(a).all() for _, a, _, _ in audio)
    return [np.concatenate(lanes[s]) for s in range(n)]


@pytest.fixture(scope="module")
def mesh_models(tp_dir):
    kw = dict(device="cpu", dtype="float32", max_seq_len=128)
    return (FasterQwen3TTS.from_pretrained(tp_dir, **kw), FasterQwen3TTS.from_pretrained(tp_dir, dp=2, tp=2, **kw))


@pytest.mark.parametrize("B", [4, 3])
def test_from_pretrained_dp2_tp2_batch_codes_equal_jax(tp_dir, mesh_models, B):
    """A greedy x-vector lockstep batch on `from_pretrained(dir, "cpu",
    dp=2, tp=2)`: B = 4 splits two lanes a dp group, B = 3 takes the
    replicated-batch rule (dp group 0); every lane's codes equal dp = tp = 1
    and the JAX package's `from_pretrained(dir, dp=2, tp=2)`."""
    plain, meshed = mesh_models
    assert meshed.mesh.shape == {"dp": 2, "tp": 2} and plain.mesh is None
    assert not meshed._device_prompt_ok(True, False) and plain._device_prompt_ok(True, False)
    jax_model = JaxTTS.from_pretrained(tp_dir, dtype="float32", max_seq_len=128, dp=2, tp=2)
    jax_model._warmed_up = True
    ref = _batch_codes(plain, gen, B)
    got = _batch_codes(meshed, gen, B)
    theirs = _batch_codes(jax_model, jax_gen, B)
    for s in range(B):
        assert got[s].shape[0] > 0
        np.testing.assert_array_equal(got[s], ref[s])
        np.testing.assert_array_equal(got[s], theirs[s])


def test_mesh_model_solo_stream_parity_and_warmup(mesh_models):
    """A solo greedy stream on the 2 x 2 model (tp over dp group 0) equals
    the unsharded model's, so does `parity_mode` (it reads the gathered
    tree), and warmup notes a set for each dp group of a 2-lane batch."""
    plain, meshed = mesh_models
    kw = dict(voice_clone_prompt=_xvec(7), xvec_only=True, chunk_size=4, max_new_tokens=8, do_sample=False,
              subtalker_dosample=False, seed=0)
    want = np.concatenate([a for a, _, _ in plain.generate_voice_clone_streaming("Hi there.", "English", **kw)])
    got = np.concatenate([a for a, _, _ in meshed.generate_voice_clone_streaming("Hi there.", "English", **kw)])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    par = np.concatenate([a for a, _, _ in meshed.generate_voice_clone_streaming("Hi there.", "English",
                                                                                 parity_mode=True, **kw)])
    np.testing.assert_allclose(par, want, atol=1e-4, rtol=0)
    phases = meshed.warmup(chunk_sizes=(4,), first_chunk_size=4, batch_sizes=(2,), do_sample=False,
                           subtalker_dosample=False)
    assert phases["captures"] == 0  # nothing is captured on the CPU
    from faster_qwen3_tts_tpu_torch.engine import graphs

    regs = graphs.registries(meshed.params)
    assert len(regs) == 2 and regs[0] is not regs[1]
    assert all(any(k.batch == 1 and k.mesh == (2, 2) for k in r._free) for r in regs)


# -- (6) errors ------------------------------------------------------------------------------------


def test_tp_that_does_not_divide_the_kv_heads_raises_as_jax(tp_dir):
    with pytest.raises(ValueError, match="tp=4 must divide num_key_value_heads"):
        FasterQwen3TTS.from_pretrained(tp_dir, device="cpu", dtype="float32", tp=4)
    with pytest.raises(ValueError, match="tp=4 must divide num_key_value_heads"):
        JaxTTS.from_pretrained(tp_dir, dtype="float32", tp=4)


def test_from_pretrained_on_one_card_raises_the_device_count_error(tp_dir, monkeypatch):
    """dp = tp = 2 on a machine with one card: the JAX device-count
    ValueError, before anything is placed (no card is touched here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"dp=2 x tp=2 needs 4 devices; only 1 visible"):
        FasterQwen3TTS.from_pretrained(tp_dir, device="cuda", dtype="float32", dp=2, tp=2)


def test_continuous_batcher_is_refused_under_a_mesh(mesh_models):
    with pytest.raises(ValueError, match="continuous batching is single-chip for now"):
        mesh_models[1].continuous_batcher(max_slots=2)


def test_tp_group_over_distinct_cards_raises(monkeypatch):
    """Built from torch.device objects only: no card is touched and nothing
    is spawned. A grid of distinct cards (two visible) builds the process
    form, a tp group or dp groups alike; a tp group over one card repeated
    in that form raises ValueError (NCCL takes one rank a card), and so
    does a grid over a card that is not visible; a mesh of one repeated
    card is the one-process form."""
    import multiprocessing

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda:0"), torch.device("cuda:1")]
    children = len(multiprocessing.active_children())
    for dp, tp in ((1, 2), (2, 1)):
        m = mesh_lib.make_mesh(2, dp=dp, tp=tp, devices=cards)
        assert m.processes and m.workers is None and m.tp_group is None and m.own == (0, 0)
        assert [m.device_of(*divmod(i, tp)) for i in range(2)] == cards
    with pytest.raises(ValueError, match="NCCL takes one rank of a communicator a card"):
        mesh_lib.make_mesh(2, dp=1, tp=2, devices=cards[:1] * 2, processes=True)
    assert mesh_lib.make_mesh(2, dp=2, tp=1, devices=cards[:1] * 2, processes=True).processes  # dp may share
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices; only 1 visible"):
        mesh_lib.make_mesh(2, dp=1, tp=2, devices=cards)
    assert len(multiprocessing.active_children()) == children
    m = mesh_lib.make_mesh(4, dp=2, tp=2, devices=cards[:1] * 4)
    assert not m.processes and [m.group_device(g) for g in range(2)] == cards[:1] * 2


def test_fuse_qkv_under_a_mesh_warns_and_stays_unfused(tp_dir, caplog):
    with caplog.at_level(logging.WARNING):
        m = FasterQwen3TTS.from_pretrained(tp_dir, device="cpu", dtype="float32", dp=2, fuse_qkv=True)
    assert "fuse_qkv=True is a one-device layout" in caplog.text
    assert "wq" in m.params["talker"]["layers"] and "wqkv" not in m.params["talker"]["layers"]
    with pytest.raises(ValueError, match="fused projection layout"):
        mesh_lib.shard_params(quant.fuse_layer_weights(mesh_lib.gather_params(m.params)), m.mesh)


@pytest.mark.parametrize("flags, expect", [([], (None, None)), (["--dp", "2", "--batch", "4"], (2, None)),
                                           (["--dp", "2", "--tp", "2"], (2, 2))])
def test_server_dp_tp_flags_reach_from_pretrained(monkeypatch, flags, expect):
    """`server.py --dp / --tp`, as servers/openai_server.py has them, reach
    `from_pretrained`."""
    from faster_qwen3_tts_tpu_torch import server

    seen = {}

    def fake(model, **kw):
        seen.update(kw)
        raise RuntimeError("stop before the model is built")

    monkeypatch.setattr("faster_qwen3_tts_tpu_torch.model.FasterQwen3TTS.from_pretrained", fake)
    with pytest.raises(RuntimeError, match="stop before"):
        server.main(["--model", "ckpt", "--device", "cpu", *flags])
    assert (seen["dp"], seen["tp"]) == expect


@pytest.mark.parametrize("size", ["0.6b", "1.7b"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_every_sharded_launch_has_a_kernel_plan(size, tp):
    """K1 at kv_heads / tp heads (GQA ratio 2, rows of 256 B in bf16) and K2
    at every column (O / tp) and row (I / tp) shard of the published
    geometry, in bf16 and float32 rows (the row-parallel partials), at the
    rows a dp group's lanes give: each has a launch plan (no ValueError)."""
    from faster_qwen3_tts_tpu_torch.config import get_config
    from faster_qwen3_tts_tpu_torch.ops.attention import _decode_plan
    from faster_qwen3_tts_tpu_torch.ops.quant import _gemv_plan

    cfg = get_config(size)
    for sub in (cfg.talker, cfg.predictor):
        H, hd, I = sub.hidden_size, sub.head_dim, sub.intermediate_size
        q, kv = sub.num_attention_heads * hd, sub.num_key_value_heads * hd
        cols = [(H, q // tp), (H, kv // tp), (H, I // tp)]
        rows = [(q // tp, H), (I // tp, H)]
        heads = [(cfg.talker.hidden_size, cfg.talker.vocab_size // tp)] if sub is cfg.talker else \
            [(H, sub.vocab_size // tp)]
        for M in (1, 2, 4, 8):
            for (i, o), elt in [(c, 2) for c in cols + heads] + [(r, e) for r in rows for e in (2, 4)]:
                assert _gemv_plan(M, i, o, elt).smem > 0
            for S in (sub.max_seq if sub is cfg.predictor else 2048,):
                _decode_plan(M, S, sub.num_attention_heads // tp, sub.num_key_value_heads // tp, hd, 2)


def test_lane_groups_refuse_a_mesh_the_tree_is_not_on(host):
    plain = weights.params_from_numpy(host["F32"], device="cpu")
    sharded = mesh_lib.shard_params(plain, _cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="placed on that mesh"):
        gen.lane_groups(plain, 4, _cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="not on"):
        gen.lane_groups(sharded, 4, _cpu_mesh(4, 1))
    with pytest.raises(ValueError, match="placed on it"):
        FasterQwen3TTS(plain, None, None, mesh=_cpu_mesh(2, 2))
