"""Host-side generation drivers over the device engine.

Port of faster_qwen3_tts_tpu/engine/generate.py without its parity
engine (`engine/parity.py` holds the port's): prompt padding buckets,
`GenerationSession`, `fast_generate` (non-streaming),
`fast_generate_streaming_fused` (streaming; chunks vocoded on the device
after their decode, or left to the caller's host vocode while an ICL stream
with a short reference warms in) and `fast_generate_streaming_batch` (B
streams in lockstep on one batch, split over the dp groups of a mesh). The
host reads the device once per chunk.
Each session leases a graph set (`engine/graphs.py`) from its prefill until
the driver ends or is closed; on the card its chunks are graph replays. The
streaming drivers dispatch ahead where the JAX drivers do: chunk k+1 is
queued after chunk k was read and before chunk k is yielded (the solo stream
from its second chunk on, the lockstep batch from its first), never past the
final chunk.

Timing dicts keep the JAX package's keys:
  non-streaming: {prefill_ms, decode_s, steps, ms_per_step, steps_per_s}
  streaming:     {chunk_index, chunk_steps, prefill_ms, decode_ms,
                  total_steps_so_far, is_final}
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from faster_qwen3_tts_tpu_torch.config import Qwen3TTSConfig

from ..ops.sampling import SamplingParams
from ..parallel import mesh as mesh_lib
from ..parallel import procs
from ..utils import trace
from . import core, fused_stream, graphs

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
SERVED_PREFILL_BUCKETS = (32, 64, 128, 256)  # the prompt buckets `warmup` captures (up to max_seq_len)

# Steady-state vocoder left context (frames), as in the JAX package.
CONTEXT_FRAMES = 24


def predictor_sampling(
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
) -> SamplingParams:
    """Code-predictor sampling: samples by default (top-k 50, temperature
    0.9), independently of the talker's sampling arguments."""
    return SamplingParams(
        0.9 if subtalker_temperature is None else subtalker_temperature,
        50 if subtalker_top_k is None else subtalker_top_k,
        1.0 if subtalker_top_p is None else subtalker_top_p,
        True if subtalker_dosample is None else subtalker_dosample,
        1.0,
    )


def prefill_bucket(n: int, max_seq: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b <= max_seq:
            return b
    if n <= max_seq:
        return max_seq
    raise ValueError(f"prefill length {n} exceeds max_seq_len {max_seq}")


def tth_bucket(n: int) -> int:
    """Trailing-text bucket: one size (FQ3T_TTH_BUCKET, default 256) for every
    text up to it, powers of two above. Positions past the text resolve to
    the pad embedding, so the bucket does not change the result; the JAX
    package reads the same variable, so both run the same shapes."""
    cap = int(os.environ.get("FQ3T_TTH_BUCKET", "256"))
    b = cap
    while b < n:
        b *= 2
    return b


def _pad_left(tie: np.ndarray, mask: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    B, P, H = tie.shape
    if P == bucket:
        return tie, mask
    out = np.zeros((B, bucket, H), tie.dtype)
    m = np.zeros((B, bucket), mask.dtype)
    out[:, bucket - P :] = tie
    m[:, bucket - P :] = mask
    return out, m


def _pad_trailing(tth: np.ndarray, tpe: np.ndarray, bucket: int) -> np.ndarray:
    B, T, H = tth.shape
    if T == bucket:
        return tth
    out = np.tile(np.asarray(tpe).reshape(1, 1, H), (B, bucket, 1)).astype(tth.dtype)
    out[:, :T] = tth
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lane_groups(params, batch: int, mesh=None) -> List[Tuple[Dict[str, Any], slice]]:
    """Where a batch of `batch` lanes runs in this process -> [(parameters,
    lanes)]. A plain tree runs every lane. A sharded tree
    (`mesh.shard_params`) splits the lanes over its dp groups when `mesh`
    is passed, dp > 1 and dp divides the batch (the JAX package's rule);
    otherwise dp group 0 runs every lane (the JAX package replicates such a
    batch over dp: the same codes). In a process mesh a process runs only
    its own group's share (none if its group has no lanes)."""
    placed = mesh_lib.mesh_of(params)
    if placed is None:
        if mesh is not None:
            raise ValueError("mesh= needs parameters placed on that mesh (mesh.shard_params)")
        return [(params, slice(0, batch))]
    if mesh is not None and (mesh.shape != placed.shape or list(mesh.devices.flat) != list(placed.devices.flat)):
        raise ValueError(f"the parameters are placed on {placed}, not on {mesh}")
    dp = placed.shape["dp"]
    if mesh is not None and dp > 1 and batch % dp == 0:
        n = batch // dp
        shares = [(g, slice(g * n, (g + 1) * n)) for g in range(dp)]
    else:
        shares = [(0, slice(0, batch))]
    own = mesh_lib.own_groups(placed)
    return [(mesh_lib.group_params(params, g), lanes) for g, lanes in shares if g in own]


def warm_sets(params, cfg: Qwen3TTSConfig, batch: int, split: bool, max_seq_len: int, text_rows: int,
              sampling: SamplingParams, pred_sampling: SamplingParams, min_new_tokens: int,
              windows: Sequence[Tuple[int, int]], buckets: Sequence[int]) -> Dict[str, float]:
    """Capture, in this process, the graph sets a batch of `batch` lanes
    leases (one a dp group it runs here, `lane_groups`; split over dp when
    `split`): the frame, `windows` and the prefill graphs of `buckets`
    (`GraphRegistry.warm`) -> the captures it made, with their seconds.
    Each process of a process mesh runs it for its own group."""
    regs = graphs.registries(params)
    before = [dict(r.stats) for r in regs]
    for gparams, lanes in lane_groups(params, batch, mesh_lib.mesh_of(params) if split else None):
        key = graphs.make_key(gparams, lanes.stop - lanes.start, max_seq_len, text_rows, sampling, pred_sampling,
                              min_new_tokens)
        graphs.registry_for(gparams).warm(gparams, cfg, key, windows, prefill_buckets=buckets)
    return {k: sum(r.stats[k] - b[k] for r, b in zip(regs, before))
            for k in ("captures", "prefill_captures", "capture_s")}


class _Part:
    """One dp group's share of a session: its parameters, its lanes, its
    prompt on its device, its graph key, seed and leased set."""

    def __init__(self, params, lanes: slice, tie, mask, tth, tpe, key: graphs.GraphKey, seed: int):
        self.params, self.lanes = params, lanes
        self.tie, self.mask, self.tth, self.tpe = tie, mask, tth, tpe
        self.key, self.seed = key, seed
        self.graphs: Optional[graphs.GraphSet] = None


class GenerationSession:
    """One request's chunk pump over leased graph sets.

    The prompt is host numpy at its own length (padded to the prefill and
    trailing-text buckets, cast and uploaded here) or device tensors at
    exactly those buckets in the parameter dtype (`build_device`), which pass
    through untouched. `prefill` leases a `graphs.GraphSet` of the request's
    key and writes the prompt's state into it (on the card: a replay of the
    set's prefill graph of the bucket); every chunk then runs on the set's
    static buffers (on the card: replays of its captured frame and window
    graphs).
    The `*_async` methods queue a chunk and return its device tensors
    without reading them; they stay valid until the next chunk is queued.
    `close()` (or the session's collection) returns the set.

    Spans (`utils.trace`): a chunk's `sess.chunk` runs from its dispatch to
    `chunk_read()`, which its driver calls once the host has read it, and is
    the parent of its `graph.frame`s; `sess.prefill` is written at the first
    `chunk_read()` (or at `close()`). On the card each carries the device ms
    of a CUDA-event pair around its replays, read only after that host read.
    Every span of the session carries `rid`: the request id of the span
    open around its construction, else a new one.

    Sharded parameters (`mesh.shard_params`): the lanes run on the dp
    groups `lane_groups` gives (split over dp with `mesh`, else all on group
    0), each group with its own set (its tp ranks in one frame graph) and
    seed (seed + group index); the chunks' rows and audio are concatenated
    in lane order. The JAX package draws one replicated key for the whole
    batch, so sampled lanes split over dp part from an unsharded run; the
    `noise` arguments (CPU) slice one draw for the whole batch per group."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: Qwen3TTSConfig,
        tie: np.ndarray,
        attention_mask: np.ndarray,
        trailing_text: np.ndarray,
        tts_pad_embed: np.ndarray,
        max_seq_len: int,
        sampling: SamplingParams,
        pred_sampling: SamplingParams,
        min_new_tokens: int,
        seed: Optional[int] = None,
        mesh=None,
    ):
        self.params = params
        self.cfg = cfg
        self.sampling = sampling
        self.pred_sampling = pred_sampling
        self.min_new_tokens = min_new_tokens
        bucket = prefill_bucket(tie.shape[1], max_seq_len)
        t_bucket = tth_bucket(trailing_text.shape[1])
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        self.seed = seed
        self.max_seq_len = max_seq_len
        device_prompt = isinstance(tie, torch.Tensor)
        if not device_prompt:
            tie_b, mask_b = _pad_left(tie, attention_mask, bucket)
            tth_b = _pad_trailing(trailing_text, tts_pad_embed, t_bucket)
        self.parts: List[_Part] = []
        for g, (gparams, lanes) in enumerate(lane_groups(params, tie.shape[0], mesh)):
            embed = mesh_lib.replica(gparams["talker"])["codec_embed"]
            device, dtype = embed.device, embed.dtype
            put = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device, dt)
            if device_prompt:
                # a device prompt (`PromptBuilder.build_device`) at its exact buckets passes through untouched
                if (tie.shape[1], trailing_text.shape[1]) != (bucket, t_bucket) or tie.dtype != dtype \
                        or trailing_text.dtype != dtype or tie.device != device:
                    raise ValueError(f"a device prompt must be at its buckets ({bucket}, {t_bucket}) in {dtype} on "
                                     f"{device}: tie {tuple(tie.shape)} {tie.dtype} on {tie.device}, "
                                     f"tth {tuple(trailing_text.shape)} {trailing_text.dtype}")
                whole = lanes == slice(0, tie.shape[0])
                ptie, pmask, ptth = ((tie, attention_mask, trailing_text) if whole
                                     else (tie[lanes], attention_mask[lanes], trailing_text[lanes]))
            else:
                ptie, pmask, ptth = put(tie_b[lanes], dtype), put(mask_b[lanes], torch.int32), put(tth_b[lanes], dtype)
            key = graphs.make_key(gparams, lanes.stop - lanes.start, max_seq_len, t_bucket, sampling,
                                  pred_sampling, min_new_tokens)
            self.parts.append(_Part(gparams, lanes, ptie, pmask, ptth, put(tts_pad_embed, dtype), key,
                                    seed + gparams.index if isinstance(gparams, mesh_lib.GroupParams) else seed))
        first = self.parts[0]
        # the first (or only) part's, as a session of one device has them
        self.device, self.key = first.tie.device, first.key
        self.tie, self.mask, self.tth, self.tpe = first.tie, first.mask, first.tth, first.tpe
        self.graphs: Optional[graphs.GraphSet] = None
        self._leases: List[graphs.Lease] = []
        self.state: Optional[core.DecodeState] = None
        self.prefill_ms = 0.0
        rid = trace.current_rid()
        self.rid = trace.new_rid() if rid is None else rid
        self._prefill_span = None  # (t0_ns, t1_ns, timer) until the first chunk is read
        self._chunk_span = None  # (span, timer) of the last chunk queued, until it is read
        # a process mesh's workers, from rank 0: this session's mirror in each
        self._workers = mesh_lib.workers_of(params)
        self._sid = None
        if self._workers is not None:
            placed = mesh_lib.mesh_of(params)
            split = mesh is not None and placed.shape["dp"] > 1 and tie.shape[0] % placed.shape["dp"] == 0
            self._groups = list(range(placed.shape["dp"])) if split else [0]
            self._sid = self._workers.open_session(
                procs.host_prompt(tie), procs.host_prompt(attention_mask), procs.host_prompt(trailing_text),
                procs.host_prompt(tts_pad_embed), max_seq_len, sampling, pred_sampling, min_new_tokens, seed, split)

    def _send(self, *cmd) -> None:
        """A call's mirror to every worker (a process mesh)."""
        if self._workers is not None:
            self._workers.send(cmd[0], self._sid, *cmd[1:])

    def _guard(self):
        """This process's share of a mesh call: fatal to the mesh if it fails."""
        return contextlib.nullcontext() if self._workers is None else self._workers.guard()

    def close(self) -> None:
        """Return the graph sets (idempotent)."""
        self._write_prefill_span()
        self._chunk_span = None  # queued, never read: no span
        for lease in self._leases:
            lease.release()
        if self._sid is not None and not self._workers.closed:
            self._workers.send("close", self._sid)
        self._sid = None

    def prefill(self, block: bool = True, noise: Optional[torch.Tensor] = None) -> None:
        """Lease the sets and run the prefill into their static states (on
        the card a replay of the bucket's graph); with block=False its time
        folds into the first chunk's (prefill_ms stays 0). `noise` [B, V]
        replaces the first draw (CPU)."""
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        self._send("prefill", noise)
        timer = self._timer()
        with self._guard():
            for part in self.parts:
                if part.graphs is None:  # a set of this part's key, captured if none is free
                    reg = graphs.registry_for(part.params)
                    part.graphs = reg.lease(part.params, self.cfg, part.key)
                    self._leases.append(graphs.Lease(self, reg, part.graphs))
                part.graphs.load_text(part.tth, part.tpe)
                part.graphs.prefill(part.params, part.tie, part.mask, part.seed,
                                    None if noise is None else noise[part.lanes])
        if timer is not None:
            timer[1].record(timer[2])
        self._prefill_span = (t0_ns, time.perf_counter_ns(), timer) if trace.enabled() else None
        self.graphs = self.parts[0].graphs
        self.state = self.graphs.state
        if block:
            for part in self.parts:
                _sync(part.tie.device)
            self.prefill_ms = (time.perf_counter() - t0) * 1000.0

    # -- spans ---------------------------------------------------------------------------------

    def _timer(self):
        """A CUDA-event pair on this session's stream, its start recorded ->
        (start, end, stream); None on the CPU or with the recorder off."""
        if self.device.type != "cuda" or not trace.enabled():
            return None
        stream = torch.cuda.current_stream(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return start, end, stream

    @staticmethod
    def _device_ms(timer) -> Optional[float]:
        """A timer's milliseconds once its end has passed on the device
        (never waits), else None."""
        if timer is None or not timer[1].query():
            return None
        return timer[0].elapsed_time(timer[1])

    @contextlib.contextmanager
    def _queue_chunk(self):
        """The `sess.chunk` span and timer of the chunk queued in the block."""
        sp = trace.begin("sess.chunk", self.rid)
        timer = self._timer()
        with sp:
            yield
        if timer is not None:
            timer[1].record(timer[2])
        self._chunk_span = (sp, timer)

    def _write_prefill_span(self) -> None:
        if self._prefill_span is not None:
            t0, t1, timer = self._prefill_span
            self._prefill_span = None
            trace.add("sess.prefill", t0, t1, rid=self.rid, value=self._device_ms(timer))

    def chunk_read(self) -> None:
        """The host has read the last chunk queued: its `sess.chunk` span
        ends (and, at the first, the prefill's is written)."""
        self._write_prefill_span()
        if self._chunk_span is not None:
            sp, timer = self._chunk_span
            self._chunk_span = None
            sp.end(self._device_ms(timer))

    def _lanes(self, tensors: List[torch.Tensor], dim: int) -> torch.Tensor:
        """The parts' outputs in lane order (on the first part's device)."""
        if len(tensors) == 1:
            return tensors[0]
        return torch.cat([t.to(self.device) for t in tensors], dim=dim)

    def _chunk(self, part: _Part, chunk_size: int, noise) -> torch.Tensor:
        if noise is not None:
            noise = [(p[:, part.lanes], t[part.lanes]) for p, t in noise]
        return part.graphs.run_chunk(part.params, chunk_size, noise)

    def decode_chunk_async(self, chunk_size: int, noise=None) -> torch.Tensor:
        """Queue one chunk -> its packed rows [chunk, B, 18], not read
        (in a process mesh this process's lanes: `collect` gives them all).
        `noise`: per frame (predictor [15, B, Vp], talker [B, V]) draws (CPU)."""
        self._send("chunk", chunk_size, noise)
        with self._queue_chunk(), self._guard():
            return self._lanes([self._chunk(part, chunk_size, noise) for part in self.parts], dim=1)

    def decode_chunk(self, chunk_size: int) -> Tuple[np.ndarray, bool]:
        """One chunk, read once -> (valid frames [n, 16] int32, done)."""
        out = core.read_packed(self.collect(self.decode_chunk_async(chunk_size)))
        self.chunk_read()
        return out

    def collect(self, out):
        """A queued chunk (`decode_chunk_async`'s packed rows, or
        `decode_chunk_fused_async`'s (audio, packed)) with every lane: as it
        is, or on rank 0 of a process mesh with the workers' lanes gathered
        and merged in lane order (on this process's device); raises if a
        group's tp ranks sent different rows."""
        if self._workers is None:
            return out
        tp = self._workers.mesh.shape["tp"]
        # this process's rows on the host only where its tp ranks are held to them
        replies = [procs.host_chunk(out) if tp > 1 else None] + self._workers.request("collect", self._sid)
        fused = isinstance(out, tuple)
        for g in self._groups:
            ref = replies[g * tp]
            for r in range(1, tp):
                got = replies[g * tp + r]
                if ref is None or got is None or not np.array_equal(got[-1], ref[-1]):
                    raise RuntimeError(f"the tp ranks of dp group {g} disagree: rank {r}'s chunk differs from "
                                       "rank 0's")
        merged = []
        for i, local in enumerate(out if fused else (out,)):
            merged.append(self._lanes([local] + [torch.from_numpy(replies[g * tp][i]) for g in self._groups[1:]],
                                      dim=1 if local.dim() == 3 else 0))
        return tuple(merged) if fused else merged[0]

    def prefill_logits(self) -> torch.Tensor:
        """The last prefill's talker logits [B, V] of every lane, in lane
        order (a process mesh's workers' gathered)."""
        local = self._lanes([p.graphs.logits for p in self.parts], dim=0)
        if self._workers is None:
            return local
        replies = self._workers.request("logits", self._sid)
        tp = self._workers.mesh.shape["tp"]
        return self._lanes([local] + [torch.from_numpy(replies[g * tp - 1]) for g in self._groups[1:]], dim=0)

    # -- a chunk plus its window vocode ------------------------------------------------------

    def set_codec_history(self, frames: np.ndarray, ctx: int) -> None:
        """The vocoder's left context of a single stream: the last `ctx` of
        frames [n >= ctx, 16] (an ICL stream's reference codes first)."""
        self.set_codec_history_batch(np.asarray(frames)[None], ctx)

    def set_codec_history_batch(self, frames_b: np.ndarray, ctx: int) -> None:
        """Every lane's vocoder left context: the last `ctx` frames of
        frames_b [B, >= ctx, 16] (each lane's own history, or its ICL
        reference tail), each part's lanes into its set (the JAX
        `_put_hist`)."""
        frames_b = np.asarray(frames_b)
        self._send("history", frames_b, ctx)
        with self._guard():
            for part in self.parts:
                part.graphs.set_history(frames_b[part.lanes], ctx)

    def decode_chunk_fused_async(self, chunk_size: int, ctx: int):
        """Queue one chunk and the window vocode of every lane over the
        history set for width `ctx` (none for ctx 0) -> (audio [B, chunk *
        up], packed), not read (in a process mesh this process's lanes:
        `collect` gives them all). Each part vocodes its lanes on its group's
        replicated codec."""
        self._send("fused", chunk_size, ctx)
        packed, audio = [], []
        with self._queue_chunk(), self._guard():
            for part in self.parts:
                packed.append(part.graphs.run_chunk(part.params, chunk_size))
                audio.append(part.graphs.vocode(part.params, chunk_size, ctx))
        return self._lanes(audio, dim=0), self._lanes(packed, dim=1)


def fast_generate(
    params,
    cfg: Qwen3TTSConfig,
    tie,
    attention_mask,
    trailing_text,
    tts_pad_embed,
    max_seq_len: int = 2048,
    max_new_tokens: int = 2048,
    min_new_tokens: int = 2,
    temperature: float = 0.9,
    top_k: int = 50,
    top_p: float = 1.0,
    do_sample: bool = True,
    repetition_penalty: float = 1.05,
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
    seed: Optional[int] = None,
    device_chunk: int = 32,
) -> Tuple[Optional[np.ndarray], Dict[str, Any]]:
    """Non-streaming generation -> ([T, 16] codes or None, timing)."""
    sess = GenerationSession(
        params, cfg, tie, attention_mask, trailing_text, tts_pad_embed, max_seq_len,
        SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty),
        predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                           subtalker_temperature),
        min_new_tokens, seed,
    )
    try:
        sess.prefill()
        t0 = time.perf_counter()
        chunks, steps = [], 0
        while steps < max_new_tokens:
            frames, done = sess.decode_chunk(device_chunk)
            frames = frames[: max_new_tokens - steps]
            if frames.shape[0]:
                chunks.append(frames)
                steps += frames.shape[0]
            if done:
                break
        decode_s = time.perf_counter() - t0
    finally:
        sess.close()
    timing = {
        "prefill_ms": sess.prefill_ms,
        "decode_s": decode_s,
        "steps": steps,
        "ms_per_step": (decode_s / steps * 1000.0) if steps else 0.0,
        "steps_per_s": (steps / decode_s) if decode_s > 0 else 0.0,
    }
    return (np.concatenate(chunks, axis=0) if chunks else None), timing


def fast_generate_streaming_batch(
    params,
    cfg: Qwen3TTSConfig,
    tie,
    attention_mask,
    trailing_text,
    tts_pad_embed,
    max_seq_len: int = 2048,
    max_new_tokens: int = 2048,
    min_new_tokens: int = 2,
    temperature: float = 0.9,
    top_k: int = 50,
    top_p: float = 1.0,
    do_sample: bool = True,
    repetition_penalty: float = 1.05,
    chunk_size: int = 12,
    seed: Optional[int] = None,
    mesh=None,
    context_frames: int = CONTEXT_FRAMES,
    first_chunk_size: Optional[int] = None,
    ref_codes_list: Optional[List[Optional[np.ndarray]]] = None,
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
) -> Generator[Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray], Dict[str, Any]], None, None]:
    """B independent streams in lockstep on one engine batch.

    tie / attention_mask / trailing_text: [B, ...] stacked left-padded
    prompts. Yields (frames [chunk, B, 16] int32, valid [chunk, B] bool,
    done [B] bool, audio [B, chunk * up] f32 or None, timing) once per chunk,
    each chunk read once. A stream that hit EOS keeps its lane (masked
    invalid) until every stream has finished; valid is clipped to each
    stream's token budget.

    The window vocode runs on the device for every lane when every lane is
    x-vector (ref_codes_list all None: chunk 0 is `fused0`, then the context
    grows min(decoded, context_frames)) or every lane carries at least
    context_frames ICL reference frames (ctx = context_frames from chunk 0,
    over each lane's reference tail). Otherwise chunks are `plain` (audio
    None) and the caller vocodes each lane on the host. `mesh`: the mesh
    sharded parameters are placed on; the lanes split over its dp groups
    when dp divides B (`lane_groups`), each group's lanes vocoded on its
    own replicated codec."""
    sess = GenerationSession(
        params, cfg, tie, attention_mask, trailing_text, tts_pad_embed, max_seq_len,
        SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty),
        predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                           subtalker_temperature),
        min_new_tokens, seed, mesh=mesh,
    )
    B = tie.shape[0]
    refs = list(ref_codes_list) if ref_codes_list is not None else [None] * B
    icl_fused = all(r is not None and r.shape[0] >= context_frames for r in refs)
    use_fused = icl_fused or all(r is None for r in refs)
    first_cs = first_chunk_size or chunk_size
    ncg = cfg.talker.num_code_groups
    # each lane's newest frames (after its reference tail), the next window's context
    if icl_fused:
        tail = np.stack([np.asarray(r, np.int32)[-context_frames:] for r in refs], axis=0)
    else:
        tail = np.zeros((B, 0, ncg), np.int32)
    totals = np.zeros(B, np.int64)
    chunk_index = n_decoded = 0

    def dispatch():
        cs = first_cs if n_decoded == 0 else chunk_size
        if not use_fused:
            return "plain", sess.decode_chunk_async(cs), cs
        if icl_fused:
            ctx = context_frames
        elif n_decoded == 0:
            return "fused0", sess.decode_chunk_fused_async(cs, 0), cs
        else:
            ctx = min(n_decoded, context_frames)
        sess.set_codec_history_batch(tail, ctx)
        return "fused", sess.decode_chunk_fused_async(cs, ctx), cs

    try:
        t0 = time.perf_counter()
        sess.prefill(block=False)  # its time folds into chunk 0's decode_ms
        pending = dispatch()
        while True:
            kind, dev, cs = pending
            dev = sess.collect(dev)
            if kind == "plain":
                frames, valid, done = core.read_packed_batch(dev)
                audio = None
            else:
                audio, frames, valid, done = fused_stream.split_fused_output_batch(*dev)
                tail = np.concatenate([tail, frames.transpose(1, 0, 2)], axis=1)[:, -context_frames:]
            sess.chunk_read()
            n_decoded += cs
            # clip each stream to its token budget
            valid = valid & (valid.cumsum(axis=0) + totals[None, :] <= max_new_tokens)
            totals += valid.sum(axis=0)
            decode_ms = (time.perf_counter() - t0) * 1000.0
            stream_done = bool(np.all(done | (totals >= max_new_tokens)))
            if not stream_done:  # chunk k+1 runs on the device while the caller takes chunk k
                pending = dispatch()
            yield frames, valid, done, audio, {
                "chunk_index": chunk_index,
                "prefill_ms": sess.prefill_ms if chunk_index == 0 else 0.0,
                "decode_ms": decode_ms,
                "total_steps_so_far": totals.copy(),
                "is_final": stream_done,
                "fused": kind != "plain",
                "first_window": kind == "fused0",
            }
            chunk_index += 1
            if stream_done:
                break
            t0 = time.perf_counter()
    finally:
        sess.close()


def fast_generate_streaming_fused(
    params,
    cfg: Qwen3TTSConfig,
    tie,
    attention_mask,
    trailing_text,
    tts_pad_embed,
    max_seq_len: int = 2048,
    max_new_tokens: int = 2048,
    min_new_tokens: int = 2,
    temperature: float = 0.9,
    top_k: int = 50,
    top_p: float = 1.0,
    do_sample: bool = True,
    repetition_penalty: float = 1.05,
    chunk_size: int = 12,
    seed: Optional[int] = None,
    context_frames: int = CONTEXT_FRAMES,
    fuse_first_chunk: bool = False,
    first_chunk_size: Optional[int] = None,
    ref_codes: Optional[np.ndarray] = None,
    subtalker_dosample: Optional[bool] = None,
    subtalker_top_k: Optional[int] = None,
    subtalker_top_p: Optional[float] = None,
    subtalker_temperature: Optional[float] = None,
) -> Generator[Tuple[np.ndarray, Optional[np.ndarray], Dict[str, Any]], None, None]:
    """Streaming generation; yields (frames [n, 16], audio [m] f32 or None,
    timing). Each chunk is one of three kinds:

    - fused0 (chunk 0 with fuse_first_chunk): decode, then vocode the chunk
      alone; emits its first n * up - D samples;
    - fused: decode, then vocode a window whose left context is the last
      `ctx` frames of the history; emits the window-local samples
      [ctx*up - D, (ctx+n)*up - D), so fused chunks are sample-contiguous;
    - plain: decode only (audio None); the caller vocodes on the host.

    Without reference codes the context grows min(total, context_frames):
    0, first, first + chunk, ... With ICL reference codes ref_codes [R, 16]
    and R >= context_frames, every chunk, chunk 0 included, is fused with
    ctx = context_frames over the last frames of ref_codes + history, so the
    reference audio is never emitted. With R < context_frames (and
    fuse_first_chunk False) chunks stay plain until context_frames frames
    were generated, for the caller's reference-prepending host decode; then
    fused with ctx = min(total, context_frames) over generated frames only."""
    sess = GenerationSession(
        params, cfg, tie, attention_mask, trailing_text, tts_pad_embed, max_seq_len,
        SamplingParams(temperature, top_k, top_p, do_sample, repetition_penalty),
        predictor_sampling(subtalker_dosample, subtalker_top_k, subtalker_top_p,
                           subtalker_temperature),
        min_new_tokens, seed,
    )
    up = cfg.codec.total_upsample
    D = fused_stream.codec_deficit(cfg.codec)
    first_cs = first_chunk_size or chunk_size
    icl_fused = ref_codes is not None and ref_codes.shape[0] >= context_frames
    history: List[np.ndarray] = []
    total = chunk_index = 0

    def dispatch():
        cs = first_cs if total == 0 else chunk_size
        if icl_fused:
            ctx = context_frames
            sess.set_codec_history(np.concatenate([np.asarray(ref_codes)] + history, axis=0), ctx)
            return "fused", sess.decode_chunk_fused_async(cs, ctx)
        if total == 0:
            if fuse_first_chunk:
                return "fused0", sess.decode_chunk_fused_async(cs, 0)
            return "plain", sess.decode_chunk_async(cs)
        if not fuse_first_chunk and total < context_frames:
            return "plain", sess.decode_chunk_async(cs)  # ICL warm-in: the caller prepends the reference
        ctx = min(total, context_frames)
        sess.set_codec_history(np.concatenate(history, axis=0), ctx)
        return "fused", sess.decode_chunk_fused_async(cs, ctx)

    try:
        t0 = time.perf_counter()
        sess.prefill(block=False)  # its time folds into chunk 0's decode_ms
        pending = dispatch()
        while total < max_new_tokens:
            kind, dev = pending
            dev = sess.collect(dev)
            pending = None
            if kind == "plain":
                frames, done = core.read_packed(dev)
                audio = None
                frames = frames[: max_new_tokens - total]
            else:
                audio_full, frames, done = fused_stream.split_fused_output(*dev)
                # clip to the token budget before slicing audio, so audio stops at the last frame
                frames = frames[: max_new_tokens - total]
                v = frames.shape[0]
                audio = audio_full[0, : (max(v * up - D, 0) if kind == "fused0" else v * up)]
            sess.chunk_read()
            decode_ms = (time.perf_counter() - t0) * 1000.0
            v = frames.shape[0]
            stream_done = done or total + v >= max_new_tokens
            if v:
                history.append(frames)
                total += v
            elif not done:
                raise RuntimeError(
                    f"decode chunk {chunk_index} returned 0 valid frames without EOS "
                    f"(kind={kind}, total={total}): the engine state is not advancing"
                )
            # dispatch-ahead from the second chunk on: chunk 0's audio must not
            # queue behind chunk 1 (that is the TTFA path)
            if not stream_done and chunk_index >= 1:
                pending = dispatch()
            if v:
                yield frames, audio, {
                    "chunk_index": chunk_index,
                    "chunk_steps": int(v),
                    "prefill_ms": sess.prefill_ms if chunk_index == 0 else 0.0,
                    "decode_ms": decode_ms,
                    "total_steps_so_far": total,
                    "is_final": bool(stream_done),
                }
                chunk_index += 1
            if stream_done:
                break
            t0 = time.perf_counter()
            if pending is None:
                pending = dispatch()
    finally:
        sess.close()
