"""The process form of a (dp, tp) mesh: one process a (dp group, tp rank).

`parallel.mesh` describes the mesh; this module runs it. The caller's
process is rank 0 (dp group 0, tp rank 0 on devices[0, 0]) and keeps the
single-controller API: `FasterQwen3TTS.from_pretrained(..., dp=, tp=)`
loads its own shards and calls `start`, which spawns one worker for every
other (g, r) (rank g * tp + r, on devices[g, r]) with the spawn start
method. Each worker loads the same source with the same arguments and keeps
only its own shards, then serves rank 0's commands until `close`.

Two paths carry the traffic:
- the tp collectives (`mesh.all_reduce` / `all_gather`, called by
  `models.layers`) go through `torch.distributed` on one process group a dp
  group: NCCL on cards, where each rank captures them inside its own frame
  and prefill graphs; gloo on the CPU. One eager all-reduce on every tp
  group at start creates NCCL's communicators before any capture;
- the control plane runs on the gloo world group over CPU tensors: rank 0
  sends each command to every worker with one `broadcast_object_list`
  (request fan-out: a session's host prompt, its sampling and seed, then
  prefill / chunk / history / close) and takes replies with one
  `gather_object` (the workers' chunks, prefill logits, warmup statistics,
  kernel counters, parameter shards). `engine.generate.GenerationSession`
  mirrors every session of rank 0 onto the workers this way, and rank 0
  merges the dp groups' lanes in lane order, holding every tp rank's codes
  equal to its group's.

Nothing falls back: a worker that does not start, a failed NCCL init or
capture, or any error in a worker or in rank 0 during a mesh operation
stops every worker and raises (a worker's own error as `WorkerError`, with
its traceback). A worker that fails reports its traceback on a queue and
exits, which closes its sockets, so a peer waiting on it in a collective
fails at once; every other wait has a timeout (`TIMEOUT_S`). `close()`
(also run at exit) stops the workers, joins them and kills any that do not
end. A process runs one process mesh at a time (the world group is
`torch.distributed`'s default group), and one thread drives it at a time
(the commands of two threads would interleave), as the servers' engine
lock ensures. The spawn start method re-imports the caller's main module
in each worker: a script that starts a process mesh guards its entry with
`if __name__ == "__main__":`.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import importlib
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

TIMEOUT_S = 300.0  # seconds any collective, the start or a join may take
_GATHERED = ("collect", "logits", "warm", "call")  # commands whose reply rank 0 gathers


class WorkerError(RuntimeError):
    """A worker process of a process mesh failed (its rank, device and
    traceback); the mesh is closed."""


def forbidden_modules() -> List[str]:
    """Modules of jax or of the JAX package loaded in this process (a
    worker must have none)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "faster_qwen3_tts_tpu"))


def _timeout(timeout_s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=timeout_s)


def _join(mesh, path: str, timeout_s: float) -> None:
    """Join the world (gloo, file rendezvous at `path`) as `mesh.rank`,
    make every dp group's tp process group (each process makes all of
    them, in order) and run one eager all-reduce on this process's own."""
    import torch.distributed as dist

    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=mesh.rank, world_size=dp * tp,
                            timeout=_timeout(timeout_s))
    device = mesh.device_of(*mesh.own)
    backend = "nccl" if device.type == "cuda" else "gloo"
    for g in range(dp):
        pg = dist.new_group([g * tp + r for r in range(tp)], timeout=_timeout(timeout_s), backend=backend)
        if g == mesh.own[0]:
            mesh.tp_group = pg
    one = torch.ones(1, device=device)
    dist.all_reduce(one, group=mesh.tp_group)
    if float(one.item()) != tp:
        raise RuntimeError(f"rank {mesh.rank}: the tp group's first all-reduce gave {one.item()}, not {tp}")


class Workers:
    """Rank 0's handle on the workers of a started process mesh
    (`mesh.workers`): `send` a command, `gather` the replies, `call` a
    function in every worker, `close`."""

    def __init__(self, mesh, timeout_s: float):
        self.mesh = mesh
        self.size = mesh.shape["dp"] * mesh.shape["tp"]
        self.timeout_s = timeout_s
        self.procs: List[Any] = []
        self.errors = None
        self.dir: Optional[str] = None
        self.closed = False
        self.reports: List[Dict[str, Any]] = []  # each worker's start report, rank order
        self.start_s = 0.0
        self._sid = 0

    # -- start and stop --------------------------------------------------------------------------

    def _start(self, spec: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="fq3t_mesh_")
        path = os.path.join(self.dir, "rendezvous")
        self.errors, joining = ctx.SimpleQueue(), ctx.SimpleQueue()
        devices = [str(d) for d in self.mesh.devices.flat]
        shape = (self.mesh.shape["dp"], self.mesh.shape["tp"])
        for rank in range(1, self.size):
            p = ctx.Process(target=_worker_main, name=f"fq3t-mesh-rank{rank}", daemon=True,
                            args=(rank, devices, shape, path, spec, self.timeout_s, self.errors, joining))
            p.start()
            self.procs.append(p)
        atexit.register(self.close)
        # every worker reaches the rendezvous (or fails) before rank 0 waits in it
        seen, deadline = 0, time.monotonic() + self.timeout_s
        while seen < self.size - 1:
            if not joining.empty():
                joining.get()
                seen += 1
                continue
            err = self._worker_error(0.0)
            if err is not None:
                raise err
            if time.monotonic() > deadline:
                raise WorkerError(f"{self.size - 1 - seen} worker(s) of {self.mesh} did not start within "
                                  f"{self.timeout_s:.0f} s")
            time.sleep(0.01)
        device = self.mesh.device_of(0, 0)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        _join(self.mesh, path, self.timeout_s)
        self.reports = self.gather()
        bad = [r for r in self.reports if r["forbidden"]]
        if bad:
            raise WorkerError(f"workers loaded jax or the JAX package: {bad}")
        self.start_s = time.perf_counter() - t0

    def close(self) -> None:
        """Stop the workers: a stop command, then join each (kill one that
        does not end), leave the world group and drop the rendezvous
        directory. Idempotent; run at exit too."""
        if not self.closed:
            self._stop(graceful=True)

    def _stop(self, graceful: bool) -> None:
        """Close the mesh: ask the workers to stop (graceful) or kill them,
        join them, leave the world group, drop the rendezvous directory."""
        import torch.distributed as dist

        self.closed = True
        atexit.unregister(self.close)
        if graceful and dist.is_initialized():
            with contextlib.suppress(Exception):
                dist.broadcast_object_list([("stop",)], src=0)
        elif not graceful:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
        self._reap(join_s=min(30.0, self.timeout_s))
        if dist.is_initialized():
            with contextlib.suppress(Exception):
                dist.destroy_process_group()
        self.mesh.tp_group = None
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)

    def _reap(self, join_s: float) -> None:
        deadline = time.monotonic() + join_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)

    def alive(self) -> List[bool]:
        """Whether each worker process (rank order) is running."""
        return [p.is_alive() for p in self.procs]

    def _worker_error(self, wait_s: float) -> Optional[WorkerError]:
        """A worker's reported error, else one for a worker that died
        without reporting, after waiting up to `wait_s` for a report."""
        deadline = time.monotonic() + wait_s
        while True:
            if self.errors is not None and not self.errors.empty():
                rank, tb = self.errors.get()
                return WorkerError(f"worker rank {rank} of {self.mesh} on "
                                   f"{self.mesh.devices.flat[rank]} failed:\n{tb}")
            dead = [(i + 1, p.exitcode) for i, p in enumerate(self.procs) if p.exitcode is not None]
            if time.monotonic() >= deadline:
                if dead:
                    return WorkerError(f"worker rank {dead[0][0]} of {self.mesh} exited with code {dead[0][1]}")
                return None
            time.sleep(0.05)

    @contextlib.contextmanager
    def guard(self):
        """Any failure inside a mesh operation is fatal to the mesh: the
        workers are stopped and a worker's own error, where one failed,
        is raised as `WorkerError` (rank 0's own error otherwise)."""
        if self.closed:
            raise RuntimeError(f"the process mesh {self.mesh} is closed")
        try:
            yield
        except BaseException as e:
            if self.closed:
                raise
            err = self._worker_error(5.0)
            self._stop(graceful=False)
            if err is not None:
                raise err from e
            raise

    # -- the control plane -------------------------------------------------------------------------

    def send(self, *cmd) -> None:
        """Send one command to every worker."""
        import torch.distributed as dist

        with self.guard():
            dist.broadcast_object_list([cmd], src=0)

    def gather(self) -> List[Any]:
        """Every worker's reply to the last gathered command, rank order."""
        import torch.distributed as dist

        with self.guard():
            out: List[Any] = [None] * self.size
            dist.gather_object(None, out, dst=0)
        return out[1:]

    def request(self, *cmd) -> List[Any]:
        self.send(*cmd)
        return self.gather()

    def call(self, target: str, *args) -> List[Any]:
        """Run `module:function`(the worker's parameter tree, *args) in every
        worker -> their results, rank order."""
        return self.request("call", target, args)

    def open_session(self, *args) -> int:
        """Open a session's mirror in every worker (`_Worker.open`) -> its id."""
        self._sid += 1
        self.send("open", self._sid, args)
        return self._sid


def start(mesh, spec: Dict[str, Any], timeout_s: float = TIMEOUT_S) -> Workers:
    """Spawn and start the workers of the process mesh `mesh` from rank 0:
    each loads `spec` (`model.load_params` arguments) on its device, and
    `mesh.workers` / `mesh.tp_group` are set here. Raises (after stopping
    every worker) if a worker does not start, load or join."""
    import torch.distributed as dist

    if not mesh.processes:
        raise ValueError(f"{mesh} is a one-process mesh: there is nothing to spawn")
    if dist.is_initialized():
        raise RuntimeError("this process already runs a process mesh (torch.distributed is initialized); "
                           "close it first")
    workers = Workers(mesh, timeout_s)
    with workers.guard():
        workers._start(spec)
    mesh.workers = workers
    return workers


def counters(params=None, reset: bool = False) -> Dict[str, int]:
    """This process's kernel launches (the wrappers' counts plus what graph
    replays launched), replayed frames and prefills, and frames and
    prefills run eagerly on the card; with `reset` the launch and replay
    counts are zeroed after the read (`Workers.call` passes the worker's
    tree as `params`, unused)."""
    from ..engine import core, graphs
    from ..ops import attention, glue
    from ..ops import quant

    wrappers = {"K1": attention.decode_attention, "K2": quant.int8_gemv, "K4": quant.int4_gemv,
                "K5": glue.add_rms_norm, "K6": glue.qk_norm_rope_kv, "K7": glue.silu_mul}
    out = {k: fn.launches + graphs.replayed[k] for k, fn in wrappers.items()}
    out.update(frames=graphs.replayed["frames"], prefills=graphs.replayed["prefills"],
               eager_frames=core._decode_frame.eager_cuda, eager_prefills=core.start_state.eager_cuda)
    if reset:
        for fn in wrappers.values():
            fn.launches = 0
        graphs.reset_replayed()
    return out


def host_chunk(out) -> Optional[tuple]:
    """A queued chunk on the host: (packed,) or (audio, packed) as numpy
    (what a worker sends `GenerationSession.collect`)."""
    if out is None:
        return None
    return tuple(t.cpu().numpy() for t in (out if isinstance(out, tuple) else (out,)))


class _Worker:
    """A worker's state: its mesh, its own shards and the mirrors of rank
    0's sessions."""

    def __init__(self, mesh, spec: Dict[str, Any]):
        from ..model import load_params
        from . import mesh as mesh_lib

        self.mesh = mesh
        phases: Dict[str, float] = {}
        params, self.cfg, _, _ = load_params(spec["model_name"], mesh.device_of(*mesh.own), spec["dtype"],
                                             spec["quant"], spec["seed"], spec["strict"], phases)
        self.params = mesh_lib.shard_params(params, mesh)
        del params
        self.load_phases = phases
        self.sessions: Dict[int, Any] = {}
        self.pending: Dict[int, Any] = {}

    def handle(self, cmd) -> Any:
        op, *args = cmd
        if op == "call":
            module, name = args[0].split(":")
            return getattr(importlib.import_module(module), name)(self.params, *args[1])
        if op == "warm":
            from ..engine import generate

            return generate.warm_sets(self.params, self.cfg, *args)
        sid, rest = args[0], args[1:]
        if op == "open":
            return self.open(sid, *rest[0])
        sess = self.sessions.get(sid)
        if op == "collect":
            return host_chunk(self.pending.pop(sid, None))
        if op == "logits":
            return None if sess is None else sess.prefill_logits().cpu().numpy()
        if op == "close":
            self.sessions.pop(sid, None)
            self.pending.pop(sid, None)
            if sess is not None:
                sess.close()
            return None
        if sess is None:  # this process runs none of the session's lanes
            return None
        if op == "prefill":
            sess.prefill(block=False, noise=rest[0])
        elif op == "chunk":
            self.pending[sid] = sess.decode_chunk_async(*rest)
        elif op == "fused":
            self.pending[sid] = sess.decode_chunk_fused_async(*rest)
        elif op == "history":
            sess.set_codec_history_batch(*rest)
        else:
            raise ValueError(f"unknown mesh command {op!r}")
        return None

    def open(self, sid: int, tie, mask, tth, tpe, max_seq_len, sampling, pred_sampling, min_new_tokens, seed,
             split: bool) -> None:
        """The mirror of rank 0's session `sid` over this process's lanes
        (none: no session)."""
        from ..engine import generate

        mesh = self.mesh if split else None
        if generate.lane_groups(self.params, tie.shape[0], mesh):
            self.sessions[sid] = generate.GenerationSession(
                self.params, self.cfg, tie, mask, tth, tpe, max_seq_len, sampling, pred_sampling, min_new_tokens,
                seed=seed, mesh=mesh)


def _worker_main(rank: int, devices: List[str], shape, path: str, spec: Dict[str, Any], timeout_s: float,
                 errors, joining) -> None:
    """A worker's process: check that no jax module came with it, join the
    mesh, load, report, then serve rank 0's commands until "stop". Any
    error is reported on `errors` and ends the process at once."""
    try:
        loaded = forbidden_modules()
        if loaded:
            raise RuntimeError(f"the worker started with jax or the JAX package loaded: {loaded[:8]}")
        torch.set_num_threads(1)
        import torch.distributed as dist

        from . import mesh as mesh_lib

        mesh = mesh_lib.make_mesh(devices=devices, dp=shape[0], tp=shape[1], processes=True)
        mesh.rank = rank
        device = mesh.device_of(*mesh.own)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        joining.put(rank)
        t0 = time.perf_counter()
        _join(mesh, path, timeout_s)
        join_s = time.perf_counter() - t0
        worker = _Worker(mesh, spec)
        report = {"rank": rank, "device": str(device), "modules_checked": True, "forbidden": forbidden_modules(),
                  "join_s": join_s, "load_s": time.perf_counter() - t0 - join_s, "load_phases": worker.load_phases}
        dist.gather_object(report, None, dst=0)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            cmd = box[0]
            if cmd[0] == "stop":
                break
            reply = worker.handle(cmd)
            if cmd[0] in _GATHERED:
                dist.gather_object(reply, None, dst=0)
        with contextlib.suppress(Exception):
            dist.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        os._exit(1)


def host_prompt(x) -> np.ndarray:
    """A prompt array as the control plane sends it (host numpy)."""
    if isinstance(x, torch.Tensor):
        raise ValueError("a process mesh takes host prompts (numpy); this one is a device tensor")
    return np.asarray(x)
