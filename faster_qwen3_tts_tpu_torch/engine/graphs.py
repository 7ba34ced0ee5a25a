"""Captured prefill and decode: CUDA graphs of the prefill, of one frame and
of a window vocode, over static buffers that a session leases.

Counterpart of the JAX package's `jax.jit` caches of `core.start_state`,
`core.decode_chunk` and `fused_stream.decode_chunk_fused`, and of the
in-process role of `engine/aot.py`: JAX compiles one program a prompt bucket
and one a chunk, this port captures the prefill and first-token draw
(`core.start_state` into the set's state) once per prompt bucket, one frame
(`core._decode_frame`) and one window vocode (`fused_stream._vocode_window`)
as CUDA graphs; a request is a prefill replay, then chunks of `chunk`
replays of the frame graph, each followed by the window's replay. A graph
cannot outlive its process, so nothing is written to disk.

A `GraphSet` owns everything one key of static shapes and static arguments
needs (`GraphKey`: lanes, max_seq, the trailing-text bucket, dtype and
quant mode of the parameters, both samplings, min_new_tokens, and the
(dp, tp) shape of the mesh for a dp group's parameters): the static
`DecodeState` (KV cache, positions, tokens, flags), the trailing-text,
pad-embedding and suppress-mask buffers, a prompt buffer pair (tie, mask)
per prompt bucket and the last prefill's logits, the packed chunk rows
[rows, B, 18], one vocoder history per window width and one audio buffer
per window, its own `torch.Generator` (registered with every graph that
draws, so each replay draws the next stretch of the generator's stream, as
eager calls do; a prefill reseeds it first), the prefill graphs, the frame
graph and the window graphs. The prefill writes the set's state in place;
at the end of the captured frame the new state is copied back into the same
tensors, which is what JAX's donation does: each replay continues from the
last one. A second live session of one key gets a set of its own, which
captures its prefill graphs at their first use.

Under a mesh the engine runs one set per dp group, leased from that
group's registry (`mesh.group_params`, whose tree is told apart by its
first shard); its frame graph captures every tp rank of the group, the
partial sums and the logit gathers included, and its KV cache is one
cache per rank. In a process mesh each process has the registry of its own
group and rank (the registries are per process, as graphs are): its graphs
capture its own rank, the tp collectives included (NCCL on cards, whose
communicators exist before the first capture: `procs` runs one eager
collective on every tp group at start), and its KV cache is its rank's.

A `GraphRegistry` per parameter tree (`registry_for`) leases sets: a live
session holds its set until it is closed (or collected); a second live
session with the same key gets a set of its own, captured if none is free,
and never waits; released sets are reused. Every graph of one registry
shares one memory pool. Static buffers live outside the pool, so the pool
holds nothing between replays and graphs may replay in any order.

On the card a chunk is always a replay: a capture or a replay that fails
raises, and nothing turns the graphs off. On the CPU (the tests) a set runs
the same static-buffer body eagerly and makes no `torch.cuda` call.

`replayed` counts the kernel launches that replays made (each graph's
launches at capture times its replays) and the frames and prefills
replayed, beside the wrappers' own counters, which move where a kernel is
launched eagerly or recorded into a graph. The registry's `stats` count
captures and their seconds.
"""
from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import attention as attention_ops
from ..ops import glue as glue_ops
from ..ops import quant as quant_ops
from ..ops.sampling import SamplingParams, make_suppress_mask
from ..parallel import mesh as mesh_lib
from ..utils import trace
from . import core, fused_stream

ROWS = 32  # packed chunk rows a set starts with (the non-streaming chunk); grown on demand

# kernel launches made by graph replays since the last reset, and replays
replayed = {"K1": 0, "K2": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0, "frames": 0, "prefills": 0}


def reset_replayed() -> None:
    for k in replayed:
        replayed[k] = 0


def _launch_counts() -> Dict[str, int]:
    return {"K1": attention_ops.decode_attention.launches, "K2": quant_ops.int8_gemv.launches,
            "K4": quant_ops.int4_gemv.launches, "K5": glue_ops.add_rms_norm.launches,
            "K6": glue_ops.qk_norm_rope_kv.launches, "K7": glue_ops.silu_mul.launches}


class GraphKey(NamedTuple):
    """Everything that fixes a captured frame's shapes or is baked into it."""

    batch: int
    max_seq: int
    text_rows: int  # the trailing-text bucket
    dtype: torch.dtype
    quant: str
    sampling: SamplingParams
    pred_sampling: SamplingParams
    min_new_tokens: int
    mesh: Optional[Tuple[int, int]] = None  # (dp, tp) of a dp group's parameters; None unsharded

    @property
    def tp(self) -> int:
        return self.mesh[1] if self.mesh else 1


def _replica_tree(params):
    """A tree's replicated view: rank 0's talker and predictor of a dp group."""
    return {k: mesh_lib.replica(v) for k, v in params.items()}


def make_key(params, batch: int, max_seq: int, text_rows: int, sampling: SamplingParams,
             pred_sampling: SamplingParams, min_new_tokens: int) -> GraphKey:
    mesh = getattr(params, "mesh", None)
    shape = (mesh.shape["dp"], mesh.shape["tp"]) if mesh is not None else None
    tree = _replica_tree(params)
    return GraphKey(batch, max_seq, text_rows, tree["talker"]["codec_embed"].dtype,
                    quant_ops.infer_quant_mode(tree), sampling, pred_sampling, min_new_tokens, shape)


def warmup_windows(chunk_sizes: Sequence[int], first_chunk_size: Optional[int],
                   context_frames: int) -> List[Tuple[int, int]]:
    """The (chunk, ctx) windows the JAX warmup compiles: for each chunk size
    the first window (first, 0), the growing contexts min(first + k * chunk,
    context_frames) of an x-vector stream, and the ICL first window (first,
    context_frames)."""
    keys = []
    for chunk in chunk_sizes:
        first = first_chunk_size or chunk
        keys.append((first, 0))
        k = 0
        while True:
            ctx = min(first + k * chunk, context_frames)
            keys.append((chunk, ctx))
            if ctx >= context_frames:
                break
            k += 1
        if first != chunk:
            keys.append((first, context_frames))
    return list(dict.fromkeys(keys))


_CAPTURE_LOCK = threading.Lock()  # one capture at a time per process


class GraphSet:
    """The static buffers and graphs of one key (see the module docstring)."""

    def __init__(self, key: GraphKey, cfg, device: torch.device, registry: "GraphRegistry", ranks: int = 1):
        self.key = key
        self.cfg = cfg
        self.device = device
        self.registry = registry
        self.cuda = device.type == "cuda"
        tcfg = cfg.talker
        B, ncg = key.batch, tcfg.num_code_groups
        self.generator = torch.Generator(device=device)
        self.state = core.zeros_state(tcfg, B, key.max_seq, key.dtype, device, self.generator, key.tp, ranks)
        self.tth = torch.zeros((B, key.text_rows, tcfg.hidden_size), dtype=key.dtype, device=device)
        self.tpe = torch.zeros((B, 1, tcfg.hidden_size), dtype=key.dtype, device=device)
        self.suppress = make_suppress_mask(tcfg.vocab_size, tcfg.codec_eos_token_id, device)
        self.out = torch.zeros((B, ncg + 2), dtype=torch.int32, device=device)
        self.logits = torch.zeros((B, tcfg.vocab_size), dtype=torch.float32, device=device)  # the last prefill's
        self.prompts: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}  # bucket -> (tie, mask) buffers
        self.prefills: Dict[int, object] = {}  # bucket -> its prefill graph (None on the CPU)
        self.prefill_launches: Dict[int, Dict[str, int]] = {}  # bucket -> a prefill replay's launches
        self.packed = torch.zeros((ROWS, B, ncg + 2), dtype=torch.int32, device=device)
        self.hists: Dict[int, torch.Tensor] = {}
        self.audio: Dict[Tuple[int, int], torch.Tensor] = {}
        self.frame_graph = None
        self.frame_launches = {k: 0 for k in _launch_counts()}  # a replay's launches
        self.windows: Dict[Tuple[int, int], object] = {}  # (chunk, ctx) -> its graph (None on the CPU)

    # -- the bodies (captured on the card, run eagerly on the CPU) -------------------------------

    def _prefill(self, params, bucket: int, noise=None) -> None:
        """`core.start_state` of the bucket's prompt buffers into the static
        state (cache rows past the prompt zeroed), its logits into `logits`."""
        k = self.key
        tie, mask = self.prompts[bucket]
        _, logits = core.start_state(params["talker"], self.cfg.talker, tie, mask, self.generator, k.max_seq,
                                     k.sampling, k.min_new_tokens, noise=noise, into=self.state)
        self.logits.copy_(logits)

    def _frame(self, params, noise=None) -> None:
        """One frame on the static state: `core._decode_frame`, then its new
        state copied back into the same tensors and (frame, valid, done) into
        `out`."""
        k, cfg, st = self.key, self.cfg, self.state
        new, frame, valid = core._decode_frame(
            params["talker"], params["predictor"], cfg.talker, cfg.predictor, st, self.tth, self.tpe,
            k.sampling, k.pred_sampling, k.min_new_tokens, self.suppress, noise,
        )
        for name in core._LANE_FIELDS:
            dst, src = getattr(st, name), getattr(new, name)
            if src is not dst:
                dst.copy_(src)
        ncg = cfg.talker.num_code_groups
        self.out[:, :ncg].copy_(frame)
        self.out[:, ncg].copy_(valid)
        self.out[:, ncg + 1].copy_(new.done)

    def _window(self, params, chunk: int, ctx: int) -> torch.Tensor:
        return fused_stream._vocode_window(
            params["codec"], self.cfg.talker, self.cfg.codec, self.hist(ctx) if ctx > 0 else None,
            self.packed[:chunk], chunk, ctx,
        )

    # -- capture -----------------------------------------------------------------------------

    def _capture(self, body) -> "torch.cuda.CUDAGraph":
        """One eager run of `body` on a side stream (builds the kernel
        library, K2's tensor maps, K4's plans and the cuBLAS / cuDNN handles),
        then its capture into the registry's pool."""
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                body()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # each replay then reads the generator's seed and offset and advances it by the graph's draws
            graph.register_generator_state(self.generator)
            # no garbage collection inside the capture: a dead registry's graphs (a registry and its sets
            # form a cycle) destroyed there would invalidate it, since no graph may be destroyed while
            # this thread captures
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.registry.pool(), capture_error_mode="thread_local"):
                    body()
            finally:
                if gc_on:
                    gc.enable()
        self.registry.stats["captures"] += 1
        self.registry.stats["capture_s"] += time.perf_counter() - t0
        return graph

    def prepare_frame(self, params) -> None:
        """Capture the frame graph (on the card; nothing to do on the CPU).
        Its warm-up frame runs on the static state, so this comes before a
        prefill writes it."""
        if not self.cuda or self.frame_graph is not None:
            return
        before = _launch_counts()
        self.frame_graph = self._capture(lambda: self._frame(params))
        # the wrappers counted the warm-up frame and the recorded one
        self.frame_launches = {k: (n - before[k]) // 2 for k, n in _launch_counts().items()}

    def prepare_prefill(self, params, bucket: int) -> None:
        """The prompt buffers of `bucket` (outside the pool) and, on the card,
        the capture of its prefill graph. Its warm-up prefill writes the
        static state, so this comes before a prefill that is to be read."""
        if bucket in self.prefills:
            return
        B, H = self.key.batch, self.cfg.talker.hidden_size
        self.prompts[bucket] = (torch.zeros((B, bucket, H), dtype=self.key.dtype, device=self.device),
                                torch.ones((B, bucket), dtype=torch.int32, device=self.device))
        if not self.cuda:
            self.prefills[bucket] = None
            return
        before = _launch_counts()
        self.prefills[bucket] = self._capture(lambda: self._prefill(params, bucket))
        self.registry.stats["prefill_captures"] += 1
        self.prefill_launches[bucket] = {k: (n - before[k]) // 2 for k, n in _launch_counts().items()}

    def prepare_window(self, params, chunk: int, ctx: int) -> None:
        """Capture the window vocode of (chunk, ctx) (on the CPU: note it)."""
        key = (chunk, ctx)
        if key in self.windows:
            return
        self._rows(chunk)
        if not self.cuda:
            self.windows[key] = None
            return
        shape = self._window(params, chunk, ctx)  # outside the pool: the static audio buffer
        self.audio[key] = torch.empty_like(shape)
        del shape
        self.windows[key] = self._capture(lambda: self.audio[key].copy_(self._window(params, chunk, ctx)))

    def _rows(self, chunk: int) -> None:
        """Grow the packed rows to `chunk` (the window graphs read the old
        buffer: they are dropped and captured again at their next use)."""
        if chunk > self.packed.shape[0]:
            self.packed = torch.zeros((chunk,) + tuple(self.packed.shape[1:]), dtype=torch.int32,
                                      device=self.device)
            self.windows.clear()
            self.audio.clear()

    def static_bytes(self) -> int:
        """Bytes of the set's static buffers (outside the graph pool)."""
        st = self.state
        caches = [t for c in mesh_lib.as_ranks(st.cache) for t in (c.k, c.v)]
        tensors = [*caches, st.pos, st.num_pads, st.token, st.past_hidden, st.gen_step, st.seen,
                   st.done, st.n_frames, self.tth, self.tpe, self.suppress, self.out, self.logits, self.packed,
                   *(t for pair in self.prompts.values() for t in pair), *self.hists.values(),
                   *self.audio.values()]
        return sum(t.numel() * t.element_size() for t in tensors)

    # -- what a session calls ------------------------------------------------------------------

    def hist(self, ctx: int) -> torch.Tensor:
        """The static vocoder history [B, ctx, 16] of windows of width ctx."""
        if ctx not in self.hists:
            self.hists[ctx] = torch.zeros((self.key.batch, ctx, self.cfg.talker.num_code_groups),
                                          dtype=torch.int32, device=self.device)
        return self.hists[ctx]

    def set_history(self, frames_b: np.ndarray, ctx: int) -> None:
        """Copy the last `ctx` frames of each lane's frames_b [B, >= ctx, 16]
        into the static history."""
        src = torch.as_tensor(np.ascontiguousarray(np.asarray(frames_b)[:, -ctx:], np.int32))
        self.hist(ctx).copy_(src)

    def load_text(self, tth: torch.Tensor, tpe: torch.Tensor) -> None:
        self.tth.copy_(tth)
        self.tpe.copy_(tpe.expand_as(self.tpe))

    def prefill(self, params, tie: torch.Tensor, mask: torch.Tensor, seed: int,
                noise: Optional[torch.Tensor] = None) -> None:
        """The prefill and first-token draw of tie [B, bucket, H] / mask
        [B, bucket] into the static state: the prompt is copied into the
        bucket's buffers, the set's generator reseeded, and on the card the
        bucket's graph replayed (captured first if it is new), so a seeded
        sampled first token equals the eager one. `noise` [B, V] replaces the
        first draw (CPU tests: the CPU runs the same body eagerly)."""
        bucket = tie.shape[1]
        self.prepare_prefill(params, bucket)
        buf_tie, buf_mask = self.prompts[bucket]
        buf_tie.copy_(tie)
        buf_mask.copy_(mask)
        self.generator.manual_seed(seed)
        if not self.cuda:
            self._prefill(params, bucket, noise)
            return
        if noise is not None:
            raise ValueError("prefill noise replaces the draw on the CPU only")
        self.prefills[bucket].replay()
        for k, n in self.prefill_launches[bucket].items():
            replayed[k] += n
        replayed["prefills"] += 1

    def reset_empty(self, seed: int) -> None:
        """An empty pool (`core.zeros_state`): every lane done, all zeros."""
        self.generator.manual_seed(seed)
        st = self.state
        caches = [t for c in mesh_lib.as_ranks(st.cache) for t in (c.k, c.v)]
        for t in (*caches, st.pos, st.num_pads, st.token, st.past_hidden, st.gen_step,
                  st.seen, st.n_frames, self.tth):
            t.zero_()
        st.done.fill_(True)
        for h in self.hists.values():
            h.zero_()

    def run_chunk(self, params, chunk: int, noise=None) -> torch.Tensor:
        """`chunk` frames -> the packed rows [chunk, B, 18] (a view of the
        static buffer, valid until the next chunk): the frame tokens, the
        valid flag and the done flag after the chunk, as `core.decode_chunk`
        packs them, each frame a `graph.frame` span (the host's time to queue
        it on the card). `noise`: per frame, the (predictor, talker) noise
        that replaces the generator's draws (CPU tests)."""
        self._rows(chunk)
        packed = self.packed
        for i in range(chunk):
            with trace.span("graph.frame", value=self.key.batch):
                if self.cuda:
                    self.frame_graph.replay()
                else:
                    self._frame(params, None if noise is None else noise[i])
                packed[i].copy_(self.out)
        packed[:chunk, :, -1].copy_(self.out[:, -1].expand(chunk, -1))
        if self.cuda:
            for k, n in self.frame_launches.items():
                replayed[k] += n * chunk
            replayed["frames"] += chunk
        return packed[:chunk]

    def vocode(self, params, chunk: int, ctx: int) -> torch.Tensor:
        """The window vocode of the last chunk -> audio [B, chunk * up] (on
        the card a static buffer, valid until the window's next replay)."""
        self.prepare_window(params, chunk, ctx)
        if not self.cuda:
            return self._window(params, chunk, ctx)
        self.windows[(chunk, ctx)].replay()
        return self.audio[(chunk, ctx)]


class GraphRegistry:
    """The graph sets of one parameter tree, leased by key."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pool = None
        self._free: Dict[GraphKey, List[GraphSet]] = {}
        self._lock = threading.Lock()
        self.sets: List[GraphSet] = []
        self.stats = {"captures": 0, "capture_s": 0.0, "prefill_captures": 0}

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def lease(self, params, cfg, key: GraphKey) -> GraphSet:
        """A free set of `key`, or a new one (its frame captured before it is
        handed out). Never waits for another session's set."""
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
        # the KV caches of the tp ranks this process runs
        gset = GraphSet(key, cfg, self.device, self, len(mesh_lib.as_ranks(params["talker"])))
        gset.prepare_frame(params)
        with self._lock:
            self.sets.append(gset)
        return gset

    def release(self, gset: GraphSet) -> None:
        with self._lock:
            self._free.setdefault(gset.key, []).append(gset)

    def memory(self) -> Dict[str, Optional[int]]:
        """Bytes of the sets' static buffers, and on the card of the segments
        the allocator holds for the graphs' pool (None where its snapshot
        does not name a segment's pool)."""
        with self._lock:
            static = sum(g.static_bytes() for g in self.sets)
        pool = None
        if self.device.type == "cuda" and self._pool is not None:
            segments = torch.cuda.memory._snapshot().get("segments", [])
            if segments and all("segment_pool_id" in seg for seg in segments):
                pool = sum(seg["total_size"] for seg in segments
                           if tuple(seg["segment_pool_id"]) == tuple(self._pool))
        return {"static_bytes": static, "pool_bytes": pool}

    def leased(self) -> int:
        """Sets out on lease now (held by a live session or batcher)."""
        with self._lock:
            return len(self.sets) - sum(len(free) for free in self._free.values())

    def free_count(self, key: GraphKey) -> int:
        with self._lock:
            return len(self._free.get(key, ()))

    def warm(self, params, cfg, key: GraphKey, windows: Sequence[Tuple[int, int]] = (),
             prefill_buckets: Sequence[int] = ()) -> GraphSet:
        """Capture the frame, `windows` and the prefill graphs of
        `prefill_buckets` of `key` in one set (a free one if there is one)
        and return it to the free sets."""
        gset = self.lease(params, cfg, key)
        try:
            for bucket in prefill_buckets:
                gset.prepare_prefill(params, bucket)
            for chunk, ctx in windows:
                gset.prepare_window(params, chunk, ctx)
        finally:
            self.release(gset)
        return gset


class Lease:
    """A session's hold on a set: `release()` (or the holder's collection)
    returns it to the registry, once."""

    def __init__(self, holder, registry: GraphRegistry, gset: GraphSet):
        self.gset = gset
        self._finalizer = weakref.finalize(holder, registry.release, gset)

    def release(self) -> None:
        self._finalizer()


_REGISTRIES: Dict[Tuple[int, int], GraphRegistry] = {}


def _anchors(params):
    """Two tensors that identify a tree's graphs: its codec embedding and its
    talker's first attention projection. The second tells a fused tree
    (`quant.fuse_layer_weights`, which shares every other leaf) from the tree
    it was fused from, so each gets its own graphs. A dp group's tree is told
    apart by its first shard (rank 0's leaves, its group's own copies)."""
    talker = mesh_lib.replica(params["talker"])
    stack = talker["layers"]
    w = stack["wqkv"] if "wqkv" in stack else stack["wq"]
    return talker["codec_embed"], (w[0] if isinstance(w, tuple) else w)


def registry_for(params) -> GraphRegistry:
    """The registry of a parameter tree; it lives as long as the tree's codec
    embedding and attention projection (the tree is not referenced: callers
    pass it in)."""
    if mesh_lib.is_sharded(params):
        raise TypeError("registry_for takes a plain tree or one dp group's (mesh.group_params); "
                        "registries(params) gives every group's registry of a sharded tree")
    anchors = _anchors(params)
    key = tuple(id(a) for a in anchors)
    reg = _REGISTRIES.get(key)
    if reg is None:
        reg = _REGISTRIES[key] = GraphRegistry(anchors[0].device)
        for a in anchors:
            weakref.finalize(a, _REGISTRIES.pop, key, None)
    return reg


def registries(params) -> List[GraphRegistry]:
    """The registry of a plain tree, or of every dp group of a sharded tree
    (`mesh.shard_params`) that this process runs, in group order (a process
    mesh's process: its own group's)."""
    mesh = mesh_lib.mesh_of(params)
    if mesh is None:
        return [registry_for(params)]
    return [registry_for(mesh_lib.group_params(params, g)) for g in mesh_lib.own_groups(mesh)]
