"""The process form of the port's (dp, tp) mesh (parallel/procs.py) on the CPU.

One process a (dp group, tp rank): this test process is rank 0 and the
model spawns the others (spawn start method, the worker entry in the
package), joined by gloo for the control plane and for the tp collectives,
as NCCL joins them on cards. At the tiny geometry of tests/test_torch_mesh.py
in float32 (kv heads divisible by tp = 2; a second config with 4 kv heads
for tp = 4), greedy: the 2 x 2 process mesh's lockstep codes against the
JAX package's 2 x 2 mesh over the conftest's virtual CPU devices (computed
in this process) and against the one-process mesh, its talker prefill
logits bitwise the one-process mesh's (tp = 2 reduces with one float32 add)
and within 1e-5 of the largest logit from JAX; dp = 4 x tp = 1 and dp = 1 x
tp = 4 against the one-process mesh (tp = 4 logits within 1e-6 of the
largest: gloo sums four partials in its own order), Q8_0, Q8_4 and Q4_K_M
(int4 leaves replicated, run whole in each process), a batch dp does
not divide, a sampled stream with shared noise, a solo tp stream, the
control-plane gather of the parameters; then failures: a worker's error and
a killed worker each make rank 0 raise within 60 s and leave no worker
alive. A process runs one process mesh at a time, so the module's meshes
come from one manager: the 2 x 2 mesh is spawned once for the tests that
use it, and every mesh is closed by the module's end.
"""
import dataclasses
import multiprocessing
import os
import signal
import time

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
from faster_qwen3_tts_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from faster_qwen3_tts_tpu.parallel import mesh as jax_mesh
from faster_qwen3_tts_tpu_torch import weights
from faster_qwen3_tts_tpu_torch.engine import generate as gen
from faster_qwen3_tts_tpu_torch.model import FasterQwen3TTS
from faster_qwen3_tts_tpu_torch.ops.sampling import SamplingParams
from faster_qwen3_tts_tpu_torch.parallel import mesh as mesh_lib
from faster_qwen3_tts_tpu_torch.parallel import procs

torch.set_num_threads(1)
GREEDY = SamplingParams(do_sample=False)
PFX, TEXT, MAX_SEQ, CHUNK = 32, 32, 64, 4  # prompt and trailing text at their buckets: no padding
TEXTS = ["Hello world.", "A much longer second sentence here.", "Third one.", "Four."]
FRAMES = 8  # greedy frames a lane
KW = dict(device="cpu", dtype="float32", max_seq_len=128)


def _tiny_tp(tiny_config, kv: int):
    """The tiny config with `kv` kv heads (and as many query heads where
    fewer) in the talker and the predictor, and special ids the byte
    tokenizer reaches (tests/test_torch_mesh.py's `_tiny_tp` at kv = 2)."""
    talker = dataclasses.replace(tiny_config.talker, num_attention_heads=max(4, kv), num_key_value_heads=kv)
    pred = jax_config.PredictorConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=kv,
                                      num_key_value_heads=kv, head_dim=16, intermediate_size=64)
    return dataclasses.replace(tiny_config, talker=talker, predictor=pred, tts_bos_token_id=300,
                               tts_eos_token_id=301, tts_pad_token_id=302)


@pytest.fixture(scope="module")
def cfgs(tiny_config):
    return {2: _tiny_tp(tiny_config, 2), 4: _tiny_tp(tiny_config, 4)}


@pytest.fixture(scope="module")
def trees(cfgs):
    return {kv: jax_weights.init_all(cfg, seed=0, dtype=jnp.float32, device_put=False) for kv, cfg in cfgs.items()}


@pytest.fixture(scope="module")
def dirs(cfgs, trees, tmp_path_factory):
    """kv heads -> an own-format checkpoint of that config (what every
    process of a mesh loads)."""
    out = {}
    for kv, cfg in cfgs.items():
        path = tmp_path_factory.mktemp(f"procs{kv}") / "ckpt"
        weights.save_pretrained(str(path), trees[kv], cfg)
        out[kv] = str(path)
    return out


class _Meshes:
    """The module's process meshes, one alive at a time (one process runs
    one process mesh): `get` returns the live model of (kv, dp, tp, quant),
    closing another first; every start is kept, to check that all ended."""

    def __init__(self, dirs):
        self.dirs = dirs
        self.key = self.model = None
        self.started = []

    def get(self, kv, dp, tp, quant="F32"):
        if self.key != (kv, dp, tp, quant):
            self.close()
            mesh = mesh_lib.make_mesh(dp * tp, dp=dp, tp=tp, devices=["cpu"] * (dp * tp), processes=True)
            self.model = FasterQwen3TTS.from_pretrained(self.dirs[kv], quant=quant, mesh=mesh, **KW)
            self.key = (kv, dp, tp, quant)
            self.started.append(mesh.workers)
        return self.model

    def close(self):
        if self.model is not None:
            self.model.mesh.close()
        self.key = self.model = None


@pytest.fixture(scope="module")
def meshes(dirs):
    m = _Meshes(dirs)
    yield m
    m.close()


@pytest.fixture(scope="module")
def one_process(dirs):
    """(kv, dp, tp, quant) -> the one-process mesh of cpu entries (or
    the unsharded model at dp = tp = 1), loaded once."""
    cache = {}

    def get(kv, dp, tp, quant="F32"):
        key = (kv, dp, tp, quant)
        if key not in cache:
            extra = {} if dp * tp == 1 else dict(dp=dp, tp=tp)
            cache[key] = FasterQwen3TTS.from_pretrained(dirs[kv], quant=quant, **KW, **extra)
        return cache[key]

    return get


def _xvec(seed):
    return {"ref_spk_embedding": [np.random.default_rng(seed).standard_normal(2048).astype(np.float32)],
            "x_vector_only_mode": [True], "icl_mode": [False], "ref_code": [None]}


def _batch(model, gen_module, n):
    """Each lane's codes and audio of a greedy lockstep batch of n x-vector
    requests (codes tapped at the driver, on rank 0 for a process mesh)."""
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
        out = list(model.generate_voice_clone_streaming_batch(reqs, chunk_size=CHUNK, max_new_tokens=FRAMES,
                                                              do_sample=False, subtalker_dosample=False, seed=0))
    finally:
        gen_module.fast_generate_streaming_batch = driver
    audio = [np.concatenate([a for s_, a, _, _ in out if s_ == s]) for s in range(n)]
    codes = [np.concatenate(lanes[s]) for s in range(n)]
    assert all(0 < c.shape[0] <= FRAMES and c.shape[1] == 16 for c in codes), [c.shape for c in codes]
    assert all(np.isfinite(a).all() for a in audio)
    return codes, audio


def _inputs(cfg, B):
    H = cfg.talker.hidden_size
    tie = (np.random.default_rng(0).standard_normal((B, PFX, H)) * 0.02).astype(np.float32)
    return tie, np.ones((B, PFX), np.int32), np.zeros((B, TEXT, H), np.float32), np.zeros((1, 1, H), np.float32)


def _session(params, cfg, B, mesh=None, sampling=GREEDY, noise=None):
    """Prefill and one chunk through the port's session -> (prefill logits
    [B, V], packed rows [chunk, B, 18]), every lane (`collect`)."""
    tie, mask, tth, tpe = _inputs(cfg, B)
    sess = gen.GenerationSession(params, cfg, tie, mask, tth, tpe, MAX_SEQ, sampling, sampling, 2, seed=0,
                                 mesh=mesh)
    try:
        sess.prefill(noise=None if noise is None else noise[0])
        logits = sess.prefill_logits().clone()
        packed = sess.collect(sess.decode_chunk_async(CHUNK, None if noise is None else noise[1])).clone()
    finally:
        sess.close()
    return logits.numpy(), packed.numpy()


def _jax_session(cfg, tree, B, dp, tp):
    """tests/test_torch_mesh.py's `_jax_chunk`: the JAX package's prefill
    and one greedy chunk on its dp x tp mesh of virtual CPU devices."""
    jmesh = jax_mesh.make_mesh(dp * tp, dp=dp, tp=tp)
    params = jax_mesh.shard_params({"talker": tree["talker"], "predictor": tree["predictor"]}, jmesh)
    tie, mask, tth, _ = _inputs(cfg, B)
    tpe = np.zeros((B, 1, cfg.talker.hidden_size), np.float32)
    put = lambda a, spec: jax.device_put(a, NamedSharding(jmesh, spec))
    s = JaxSamplingParams(do_sample=False)
    with jmesh:
        state, logits = jax_core.start_state(
            params["talker"], cfg.talker, put(tie, JP("dp", None, None)), put(mask, JP("dp", None)),
            jax.random.PRNGKey(0), MAX_SEQ, s, 2)
        state, packed = jax_core.decode_chunk(
            params["talker"], params["predictor"], cfg.talker, cfg.predictor, state,
            put(tth, JP("dp", None, None)), put(tpe, JP("dp", None, None)), CHUNK, s, s, 2)
    return np.asarray(logits), np.asarray(packed)


# -- the 2 x 2 process mesh (spawned once) --------------------------------------------------------


def test_workers_start_clean_and_join_their_groups(meshes):
    """Three workers, each on cpu, each having checked at start (and after
    loading) that no jax or JAX-package module is loaded; this process is
    rank 0 of dp group 0, its tp group a 2-rank gloo group; warmup runs in
    every process."""
    import torch.distributed as dist

    model = meshes.get(2, 2, 2)
    mesh = model.mesh
    assert mesh.processes and mesh.own == (0, 0) and mesh.workers.alive() == [True] * 3
    assert [r["rank"] for r in mesh.workers.reports] == [1, 2, 3]
    assert all(r["modules_checked"] and r["forbidden"] == [] and r["device"] == "cpu" for r in mesh.workers.reports)
    assert dist.get_backend(mesh.tp_group) == "gloo" and dist.get_world_size(mesh.tp_group) == 2
    assert dist.get_world_size() == 4 and model.load_phases["workers_start"] > 0
    assert not procs.forbidden_modules() or "jax" in procs.forbidden_modules()  # this process is the test's
    phases = model.warmup(chunk_sizes=(CHUNK,), first_chunk_size=CHUNK, batch_sizes=(4,), do_sample=False,
                          subtalker_dosample=False)
    assert len(phases["workers"]) == 3 and phases["captures"] == 0  # nothing is captured on the CPU


def test_dp2_tp2_batch_codes_equal_jax_and_one_process(meshes, one_process, dirs):
    """A greedy lockstep batch of 4 lanes x 8 frames on the 2 x 2 process
    mesh (two lanes a dp group, each group's tp ranks in two processes):
    every lane's codes equal the JAX package's `from_pretrained(dp=2,
    tp=2)` and the one-process 2 x 2 mesh; its audio the one-process
    mesh's."""
    got, audio = _batch(meshes.get(2, 2, 2), gen, 4)
    ref, ref_audio = _batch(one_process(2, 2, 2), gen, 4)
    jax_model = JaxTTS.from_pretrained(dirs[2], dtype="float32", max_seq_len=128, dp=2, tp=2)
    jax_model._warmed_up = True
    theirs, _ = _batch(jax_model, jax_gen, 4)
    for s in range(4):
        np.testing.assert_array_equal(got[s], ref[s])
        np.testing.assert_array_equal(got[s], theirs[s])
        np.testing.assert_allclose(audio[s], ref_audio[s], atol=1e-6, rtol=0)


def test_dp2_tp2_prefill_logits_bitwise_one_process_and_near_jax(meshes, one_process, cfgs, trees):
    """The talker prefill logits of 2 lanes (one a dp group) on the process
    mesh are bit for bit the one-process mesh's (tp = 2: one float32 add,
    in either order the same) and within 1e-5 of the largest logit from the
    JAX package's 2 x 2 mesh; the first chunk's packed rows equal both."""
    cfg = cfgs[2]
    model, ref_model = meshes.get(2, 2, 2), one_process(2, 2, 2)
    logits, packed = _session(model.params, cfg, 2, model.mesh)
    ref_logits, ref_packed = _session(ref_model.params, cfg, 2, ref_model.mesh)
    jlogits, jpacked = _jax_session(cfg, trees[2], 2, 2, 2)
    np.testing.assert_array_equal(logits, ref_logits)
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(packed, jpacked)
    assert np.abs(logits - jlogits).max() <= 1e-5 * np.abs(jlogits).max()


def test_batch_not_divisible_by_dp_runs_on_group_zero(meshes, one_process):
    """B = 3 on dp = 2: dp group 0 (this process and its tp worker) runs
    every lane, group 1's processes none: the one-process mesh's codes."""
    model = meshes.get(2, 2, 2)
    assert [(g.index, lanes) for g, lanes in gen.lane_groups(model.params, 3, model.mesh)] == [(0, slice(0, 3))]
    assert [(g.index, lanes) for g, lanes in gen.lane_groups(model.params, 4, model.mesh)] == [(0, slice(0, 2))]
    got, _ = _batch(model, gen, 3)
    ref, _ = _batch(one_process(2, 2, 2), gen, 3)
    for s in range(3):
        np.testing.assert_array_equal(got[s], ref[s])


def test_sampled_2x2_with_shared_noise_equals_unsharded(meshes, one_process, cfgs):
    """One noise draw for the whole batch, each process's group taking its
    lanes' rows (the port's dp groups have a generator each): the sampled
    frames of the process mesh equal the unsharded run's."""
    cfg, B = cfgs[2], 4
    rng = np.random.default_rng(5)
    g = lambda *shape: torch.from_numpy(rng.gumbel(size=shape).astype(np.float32))
    Vp = cfg.predictor.vocab_size
    noise = (g(B, cfg.talker.vocab_size), [(g(15, B, Vp), g(B, cfg.talker.vocab_size)) for _ in range(CHUNK)])
    sampling = SamplingParams(temperature=0.9, top_k=50, top_p=1.0, do_sample=True, repetition_penalty=1.05)
    model = meshes.get(2, 2, 2)
    _, ref = _session(one_process(2, 1, 1).params, cfg, B, sampling=sampling, noise=noise)
    _, got = _session(model.params, cfg, B, model.mesh, sampling=sampling, noise=noise)
    assert got[:, :, -2].all()
    np.testing.assert_array_equal(got, ref)


def test_solo_tp2_stream_and_parity_mode_equal_unsharded(meshes, one_process):
    """A solo greedy stream on the 2 x 2 process mesh (dp group 0: this
    process and its tp worker) equals the unsharded model's, and so does
    `parity_mode`, which reads the tree gathered over the control plane."""
    model, plain = meshes.get(2, 2, 2), one_process(2, 1, 1)
    kw = dict(voice_clone_prompt=_xvec(7), xvec_only=True, chunk_size=CHUNK, max_new_tokens=FRAMES,
              do_sample=False, subtalker_dosample=False, seed=0)
    want = np.concatenate([a for a, _, _ in plain.generate_voice_clone_streaming("Hi there.", "English", **kw)])
    got = np.concatenate([a for a, _, _ in model.generate_voice_clone_streaming("Hi there.", "English", **kw)])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    par = np.concatenate([a for a, _, _ in model.generate_voice_clone_streaming("Hi there.", "English",
                                                                                parity_mode=True, **kw)])
    np.testing.assert_allclose(par, want, atol=1e-4, rtol=0)


def test_non_streaming_request_equals_unsharded(meshes, one_process):
    """A non-streaming request (`generate_voice_clone`, whose chunks
    `GenerationSession.decode_chunk` collects; greedy talker, the code
    predictor sampled from the seed) on the 2 x 2 process mesh: the
    one-process mesh's waveform (the same bits into the same draws)."""
    model, ref = meshes.get(2, 2, 2), one_process(2, 2, 2)
    kw = dict(voice_clone_prompt=_xvec(9), xvec_only=True, max_new_tokens=FRAMES, do_sample=False, seed=3)
    (want,), sr = ref.generate_voice_clone("Non streaming.", "English", **kw)
    (got,), sr2 = model.generate_voice_clone("Non streaming.", "English", **kw)
    assert sr == sr2 and got.size > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_gather_params_over_the_control_plane(meshes, one_process):
    """`gather_params` on rank 0 of the 2 x 2 process mesh: rank 0 holds
    only its own shards, its tp worker sends the others; the gathered tree
    is the unsharded tree leaf for leaf."""
    model, plain = meshes.get(2, 2, 2), one_process(2, 1, 1)
    wq = model.params["talker"]["layers"]["wq"]
    assert wq.shards[0][1] is None and wq.shards[1][0] is None and wq.shards[0][0].shape[-1] * 2 == wq.shape[-1]
    a, b = weights.host_tree(mesh_lib.gather_params(model.params)), weights.host_tree(plain.params)

    def walk(x, y, path=""):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{i}")
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=path)

    walk(a, b)


# -- the other meshes --------------------------------------------------------------------------------


@pytest.mark.parametrize("dp, tp", [(4, 1), (1, 4)])
def test_other_meshes_codes_equal_one_process(meshes, one_process, cfgs, dp, tp):
    """dp = 4 x tp = 1 (a lane a process) and dp = 1 x tp = 4 (the four
    processes the tp ranks of one group), at the config with 4 kv heads: a
    greedy lockstep batch's codes equal the one-process mesh's; at tp = 4
    the prefill logits agree within 1e-6 of the largest (gloo sums the four
    partials in its own order)."""
    model, ref_model = meshes.get(4, dp, tp), one_process(4, dp, tp)
    got, _ = _batch(model, gen, 4)
    ref, _ = _batch(ref_model, gen, 4)
    for s in range(4):
        np.testing.assert_array_equal(got[s], ref[s])
    logits, packed = _session(model.params, cfgs[4], 4, model.mesh)
    ref_logits, ref_packed = _session(ref_model.params, cfgs[4], 4, ref_model.mesh)
    np.testing.assert_array_equal(packed, ref_packed)
    assert np.abs(logits - ref_logits).max() <= 1e-6 * np.abs(ref_logits).max()


@pytest.mark.parametrize("quant", ["Q8_0", "Q8_4", "Q4_K_M"])
def test_quantized_2x2_codes_equal_one_process(meshes, one_process, quant):
    """Quantized weights (quantized on load in every process, bitwise
    alike) on the 2 x 2 process mesh: the one-process mesh's lockstep
    codes. Q8_4 and Q4_K_M run replicated int4 leaves whole in each
    process, each rank taking its columns of a column projection and
    gathering its group's input slices over gloo for a row projection."""
    got, _ = _batch(meshes.get(2, 2, 2, quant), gen, 4)
    ref, _ = _batch(one_process(2, 2, 2, quant), gen, 4)
    for s in range(4):
        np.testing.assert_array_equal(got[s], ref[s])


def test_mesh_arguments_are_checked(meshes, dirs, one_process):
    """`mesh=` and dp / tp must agree; a process mesh's tree whose workers
    were never started is refused by the model (before any work)."""
    mesh = mesh_lib.make_mesh(2, dp=2, tp=1, devices=["cpu"] * 2, processes=True)
    with pytest.raises(ValueError, match="disagree with mesh="):
        FasterQwen3TTS.from_pretrained(dirs[2], mesh=mesh, dp=1, **KW)
    plain = one_process(2, 1, 1)
    with pytest.raises(ValueError, match="has not started its workers"):
        FasterQwen3TTS(mesh_lib.shard_params(plain.params, mesh), plain.config, plain.tokenizer, mesh=mesh)
    assert mesh.workers is None


# -- failures and clean-up ---------------------------------------------------------------------------


def test_a_worker_error_raises_on_rank_0_within_60_s(meshes):
    """A worker that raises (here a call of `mesh.group_params` for a group
    it does not run) makes rank 0 raise `WorkerError` with the worker's own
    message and traceback, within 60 s; the mesh is then closed: no worker
    is alive and a request raises."""
    model = meshes.get(2, 2, 1)
    t0 = time.monotonic()
    with pytest.raises(procs.WorkerError, match="(?s)worker rank 1 .*Traceback.*dp group 5 runs in another process"):
        model.mesh.workers.call("faster_qwen3_tts_tpu_torch.parallel.mesh:group_params", 5)
    assert time.monotonic() - t0 < 60
    assert model.mesh.workers.alive() == [False]
    with pytest.raises(RuntimeError, match="is closed"):
        list(model.generate_voice_clone_streaming_batch([{"text": "Hi.", "voice_clone_prompt": _xvec(0)}] * 2,
                                                        max_new_tokens=4, chunk_size=CHUNK))
    meshes.close()


def test_a_killed_worker_raises_on_rank_0_within_60_s(meshes):
    """A worker killed mid-service (SIGKILL, no report): the next tp stream
    on rank 0 raises `WorkerError` naming the dead rank within 60 s instead
    of waiting in a collective, and no worker is left."""
    model = meshes.get(2, 1, 2)
    victim = model.mesh.workers.procs[0]
    os.kill(victim.pid, signal.SIGKILL)
    victim.join(30)
    t0 = time.monotonic()
    with pytest.raises(procs.WorkerError, match="worker rank 1 .* exited with code -9"):
        list(model.generate_voice_clone_streaming("Hi there.", "English", voice_clone_prompt=_xvec(1),
                                                  xvec_only=True, chunk_size=CHUNK, max_new_tokens=FRAMES))
    assert time.monotonic() - t0 < 60
    assert not any(model.mesh.workers.alive())
    meshes.close()


def test_close_stops_every_worker(meshes):
    """`close()` stops the workers (joined, none alive), leaves the world
    group, removes the rendezvous directory and is idempotent."""
    import torch.distributed as dist

    model = meshes.get(2, 2, 1)
    workers = model.mesh.workers
    assert os.path.isdir(workers.dir) and dist.is_initialized()
    meshes.close()
    assert workers.alive() == [False] and [p.exitcode for p in workers.procs] == [0]
    assert not os.path.exists(workers.dir) and not dist.is_initialized() and model.mesh.tp_group is None
    model.mesh.close()


def test_no_worker_outlives_the_module(meshes):
    """Every worker any test of this module started has ended, and this
    process has no child left."""
    meshes.close()
    assert meshes.started and not any(alive for w in meshes.started for alive in w.alive())
    assert not [p for p in multiprocessing.active_children() if p.name.startswith("fq3t-mesh")]
