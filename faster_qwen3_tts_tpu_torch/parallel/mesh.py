"""The (dp, tp) device mesh: data parallel lanes and Megatron tensor parallel
weights over a grid of torch devices.

Port of faster_qwen3_tts_tpu/parallel/mesh.py. The JAX package annotates
its weights with NamedShardings and lets GSPMD partition every jitted
function; the port has no partitioner, so the placement is explicit and the
engine runs it:

- axis "dp": a batch's lanes split over the dp groups (each group decodes
  its own lanes with its own copy of the weights; no traffic between groups
  on the hot path);
- axis "tp": the talker's and the predictor's attention heads and MLP
  columns split over a group's tp ranks. Each rank runs its heads on its
  slices (`models.layers`); the row-parallel partials (wo, w_down) are
  summed (`all_reduce`) and the column-sharded heads' logits concatenated
  in rank order (`all_gather`), in the engine's own frame, so the
  collectives are part of the captured CUDA graphs.

A mesh takes one of two forms:

- one process: one process drives every device, as one JAX
  controller does, and a device may appear more than once, as the JAX
  tests' virtual CPU devices do: a mesh of `cpu` entries on the CPU, of
  `cuda:0` entries on one card. A tp group's ranks run in turn inside one
  frame graph and reduce in rank order on their one device.
- one process a (dp group, tp rank) (`processes`; `parallel/procs.py`):
  rank g * tp + r owns devices[g, r]. The caller's process is rank 0 and
  the model spawns the others, so the API stays single-controller. A grid
  that holds distinct devices takes this form; so does any grid built with
  `processes=True` (the CPU tests' gloo rehearsal, and dp groups sharing
  one card). A tp group's collectives go through `torch.distributed` on the
  group's process group (NCCL on cards, captured inside each rank's graphs;
  gloo on the CPU); NCCL takes one rank a card, so a process mesh whose tp
  group repeats a card is refused. Each process holds only its own (g, r)
  shards and runs only its own group's lanes.

`shard_params` places a parameter tree: every leaf becomes a
`ShardedTensor` (its global shape, dtype and spec, and `shards[g][r]`, the
tensor tp rank r of dp group g holds; each shard its own contiguous
allocation on its group's device, so K2's tensor-map cache, keyed on the
pointer, never shares a map). `group_params` is one dp group's view, the
engine's input: "talker" and "predictor" as `Ranks` of each rank's subtree,
every other submodel the group's replicated copy. `tp` must divide
num_key_value_heads (8 for all Qwen3-TTS sizes).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quant import QuantizedLinear, QuantizedLinear4

AXES = ("dp", "tp")


class P(tuple):
    """A partition spec: per dimension the mesh axis it is split over, or
    None (the port's `jax.sharding.PartitionSpec`; a tuple, so specs of
    both packages compare as tuples)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A [dp, tp] grid of torch devices (`devices`), with `shape` {"dp": ..,
    "tp": ..} as `jax.sharding.Mesh.shape`.

    `processes` None takes the process form when the grid holds distinct
    devices, else the one-process form; True asks for the process form on
    any grid. A one-process mesh sits on one device (it may repeat). A
    process mesh of cards refuses a tp group that repeats a card (NCCL
    takes one rank a card) and a card that is not visible, before anything
    is spawned. `rank` is this process's place in a process mesh (0 in the
    caller's), `tp_group` its tp group's process group and `workers` the
    caller's handle on the other processes (`procs.start`), all set when
    the mesh starts."""

    def __init__(self, devices: np.ndarray, processes: Optional[bool] = None):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        flat = [torch.device(d) for d in devices.flat]
        distinct = len(set(flat)) > 1
        self.processes = distinct if processes is None else bool(processes)
        self.rank = 0
        self.tp_group = None
        self.workers = None
        if not self.processes:
            if distinct:
                raise ValueError(f"a one-process mesh sits on one device, not on {sorted({str(d) for d in flat})}")
            return
        if len({d.type for d in flat}) > 1:
            raise ValueError(f"a process mesh sits on one kind of device: {[str(d) for d in flat]}")
        if flat[0].type == "cuda":
            for g, row in enumerate(devices):
                if len({torch.device(d) for d in row}) < len(row):
                    raise ValueError(
                        f"tp group {g} repeats a card ({[str(d) for d in row]}): NCCL takes one rank of a "
                        "communicator a card, so a process mesh's tp group needs distinct cards; tp on one "
                        "card is the one-process mesh (make_mesh(devices=['cuda:0'] * n))")
            need = max(d.index or 0 for d in flat) + 1
            visible = torch.cuda.device_count()
            if need > visible:
                raise ValueError(f"a mesh over {sorted({str(d) for d in flat})} needs {need} devices; only "
                                 f"{visible} visible")

    @property
    def own(self) -> Tuple[int, int]:
        """(dp group, tp rank) of this process (a process mesh; (0, 0) in
        the caller's)."""
        return divmod(self.rank, self.shape["tp"])

    def holds(self, g: int, r: int) -> bool:
        """Whether this process holds the shard of (g, r)."""
        return not self.processes or (g, r) == self.own

    def device_of(self, g: int, r: int = 0) -> torch.device:
        return torch.device(self.devices[g, r])

    def group_device(self, g: int) -> torch.device:
        """The device of dp group g (all of its tp ranks in a one-process
        mesh; tp rank 0's in a process mesh)."""
        return self.device_of(g, 0)

    def close(self) -> None:
        """Stop a process mesh's workers (`procs.Workers.close`); nothing
        to do for a one-process mesh or in a worker."""
        if self.workers is not None:
            self.workers.close()

    def __repr__(self) -> str:
        form = ", processes" if self.processes else ""
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, devices="
                f"{[str(d) for d in self.devices.flat]}{form})")


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence] = None, processes: Optional[bool] = None) -> Mesh:
    """A (dp, tp) mesh over the first n_devices of `devices` (default
    cuda:0 .. cuda:n-1, n the visible cards). dp and tp are inferred as in
    the JAX package; `devices` may repeat a device (`[cuda:0] * 4` runs a
    2 x 2 mesh on one card in one process). Distinct devices, or
    `processes=True`, give the process form (`Mesh`)."""
    if devices is None:
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if tp is None:
        tp = 1 if dp is None else n_devices // dp
    if dp is None:
        dp = n_devices // tp
    assert dp * tp == n_devices, f"dp({dp}) * tp({tp}) != {n_devices}"
    if len(devices) != n_devices:
        raise ValueError(f"a mesh of {n_devices} devices from a list of {len(devices)}")
    arr = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices):
        arr[i // tp, i % tp] = d
    return Mesh(arr, processes)


def _layer_specs() -> Dict[str, P]:
    """Specs of one stacked decoder-layer param dict (leading axis = layer).
    Megatron style: column-parallel q/k/v/gate/up, row-parallel o/down."""
    return {
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
        "w_gate": P(None, None, "tp"),
        "w_up": P(None, None, "tp"),
        "w_down": P(None, "tp", None),
        "q_norm": P(None, None),
        "k_norm": P(None, None),
        "ln1": P(None, None),
        "ln2": P(None, None),
    }


def talker_param_specs() -> Dict[str, Any]:
    return {
        "text_embed": P(None, None),
        "text_proj": {"w": P(None, None), "b": P(None)},
        "codec_embed": P(None, None),
        "codec_head": P(None, "tp"),
        "spk_proj": {"w": P(None, None), "b": P(None)},
        "layers": _layer_specs(),
        "final_norm": P(None),
    }


def predictor_param_specs() -> Dict[str, Any]:
    return {
        "mtp_proj": {"w": P(None, None), "b": P(None)},
        "codec_embeds": P(None, None, None),
        "lm_heads": P(None, None, "tp"),
        "layers": _layer_specs(),
        "final_norm": P(None),
    }


def kv_cache_spec() -> P:
    """KVCache [L, B, S, kv_heads, hd]: batch over dp, kv heads over tp (a
    KV cache per (dp group, tp rank))."""
    return P(None, "dp", None, "tp", None)


def state_specs(vocab_spec: P = P("dp", None)):
    """Specs of `engine.core.DecodeState`'s fields (batch over dp). The
    port's state holds a generator where the JAX state holds a key: one per
    dp group (the JAX key is replicated, `P()`)."""
    from ..engine.core import DecodeState
    from ..models.layers import KVCache

    return DecodeState(
        cache=KVCache(k=kv_cache_spec(), v=kv_cache_spec()),
        pos=P("dp"),
        num_pads=P("dp"),
        token=P("dp"),
        past_hidden=P("dp", None, None),
        gen_step=P("dp"),
        seen=vocab_spec,
        generator=P(),
        done=P("dp"),
        n_frames=P("dp"),
    )


class ShardedTensor:
    """One leaf placed on a mesh (the port's sharded `jax.Array`): its global
    `shape` and `dtype`, its `spec`, and `shards[g][r]`, the tensor that tp
    rank r of dp group g holds. The tp ranks of one group share a
    replicated leaf's tensor. In a process mesh only this process's own
    (g, r) entry is a tensor; the others are None."""

    __slots__ = ("shards", "spec", "shape", "dtype", "mesh")

    def __init__(self, shards: List[List[Optional[torch.Tensor]]], spec: P, shape: torch.Size,
                 dtype: torch.dtype, mesh: Mesh):
        self.shards, self.spec, self.shape, self.dtype, self.mesh = shards, spec, shape, dtype, mesh

    @property
    def device(self) -> torch.device:
        return self.addressable_shards[0].device

    @property
    def addressable_shards(self) -> List[torch.Tensor]:
        """Every (group, rank) shard this process holds, in mesh order."""
        return [t for row in self.shards for t in row if t is not None]

    def __repr__(self) -> str:
        return f"ShardedTensor({tuple(self.shape)}, {self.dtype}, {self.spec})"


class Ranks(tuple):
    """The values of a tp group's ranks that this process holds, in rank
    order: the rank subtrees of a group's talker or predictor, and a
    sharded model's per-rank KV caches. `size` is the group's rank count,
    `rank` the place of the first value held and `group` the process group
    a process mesh reduces through (None: every rank is here and the
    reductions are sums in rank order). A one-process group holds all of
    its ranks; a process of a process mesh holds one. A group of one rank
    holds its value plain (`group`)."""

    def __new__(cls, values=(), group=None, rank: int = 0, size: Optional[int] = None):
        self = super().__new__(cls, values)
        self.group, self.rank = group, rank
        self.size = len(self) if size is None else size
        return self


def like(ranks: Ranks, values) -> Ranks:
    """`values` as ranks of the same group as `ranks`."""
    return Ranks(values, ranks.group, ranks.rank, ranks.size)


def group(values) -> Any:
    """Per-rank values as the engine holds them: one rank's value plain,
    several a `Ranks` (the inverse of `as_ranks`)."""
    values = tuple(values)
    return values[0] if len(values) == 1 else Ranks(values)


def as_ranks(x) -> Ranks:
    """A `Ranks`, or one value as a group of one rank."""
    return x if isinstance(x, Ranks) else Ranks((x,))


def replica(params):
    """The replicated leaves of a model's params: the first subtree of a
    `Ranks`, or the plain subtree itself."""
    return params[0] if isinstance(params, Ranks) else params


def per_rank(params, key: str):
    """params[key] of a plain subtree, or of every rank of a `Ranks`."""
    if isinstance(params, Ranks):
        return like(params, (p[key] for p in params))
    return params[key]


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Every rank's x concatenated along dim 0 into out (newer torch names
    it `all_gather_single`)."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


def all_reduce(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The sum of a tp group's partials in float32, the same bits on every
    rank: the partials held here summed in rank order, then, in a process
    mesh, all-reduced over the tp process group `group` (at tp = 2 one
    float32 add either way, so both forms agree bit for bit; at tp = 4
    gloo and NCCL sum in their own order)."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(acc, group=group)
    return acc


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1, group=None) -> torch.Tensor:
    """A tp group's column slices (vocab slices of a head) concatenated in
    rank order; in a process mesh gathered over `group` first (along dim
    0, as NCCL's all-gather lays them out, then concatenated along `dim`)."""
    if group is None:
        return torch.cat(list(parts), dim=dim)
    import torch.distributed as dist

    x = parts[0].contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group)
    return torch.cat(out.chunk(n, dim=0), dim=dim)


def _norm_spec(spec: P, rank: int) -> tuple:
    t = tuple(spec) + (None,) * (rank - len(tuple(spec)))
    return t[:rank]


def shard_shape(shape: Sequence[int], spec: P, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one shard of a `shape` leaf placed by `spec`: each axis
    whose mesh axis `sizes` names split that many ways (`{"tp": 2}`: a tp
    rank's shard of a group's leaf)."""
    out = []
    for ax, (n, name) in enumerate(zip(shape, _norm_spec(spec, len(shape)))):
        ways = sizes.get(name, 1) if name else 1
        if n % ways:
            raise ValueError(f"{name}={ways} does not divide dimension {ax} of a {tuple(shape)} leaf")
        out.append(n // ways)
    return tuple(out)


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of t in an allocation of its own on `device` (the
    caching allocator's blocks are 512-byte aligned on the card)."""
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _put(t: torch.Tensor, spec: P, mesh: Mesh) -> ShardedTensor:
    spec = P(*_norm_spec(spec, t.dim()))
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    split = "tp" in spec and tp > 1
    if split:
        ax = spec.index("tp")
        n = shard_shape(t.shape, spec, {"tp": tp})[ax]
    shards: List[List[Optional[torch.Tensor]]] = [[None] * tp for _ in range(dp)]
    for g in range(dp):
        one = None  # a replicated leaf: one copy a device a group
        for r in range(tp):
            if not mesh.holds(g, r):
                continue
            dev = mesh.device_of(g, r)
            if split:
                shards[g][r] = _own(t.narrow(ax, r * n, n), dev)
            else:
                if one is None or one.device != dev:
                    one = _own(t, dev)
                shards[g][r] = one
    return ShardedTensor(shards, spec, t.shape, t.dtype, mesh)


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Place talker / predictor params on the mesh with tp shardings (the
    codec, the encoders and any other submodel replicated, one copy per dp
    group).

    Quantized weights: an int8 QuantizedLinear shards like its plain
    counterpart, q taking the weight's spec and the per-output-channel scale
    [.., 1, out] only the out axis (a row-parallel axis on its size-1 dim is
    dropped). K2 applies the scale in its epilogue, so a row-parallel int8
    projection sums scaled partials (the JAX package reduces the int8
    partial dot before the scale, bit for bit the unsharded product; here
    the sum is reassociated: logits agree to a tolerance). A grouped-int4
    QuantizedLinear4 is replicated (its interleaved nibbles do not shard
    cleanly): `models.layers` runs it whole, once a group. The fused layout
    (wqkv, w_gateup) does not shard: its q/k/v columns are not head-major
    across ranks. On a process mesh each process keeps only its own (g, r)
    shards (`Mesh.holds`)."""
    for sub in ("talker", "predictor"):
        if sub in params and ("wqkv" in params[sub]["layers"] or "w_gateup" in params[sub]["layers"]):
            raise ValueError("shard_params: the fused projection layout (fuse_qkv) does not shard; load the "
                             "unfused layout under a mesh")
    specs = {"talker": talker_param_specs(), "predictor": predictor_param_specs()}

    def place(tree, spec):
        if isinstance(tree, QuantizedLinear):
            qs = _norm_spec(spec if isinstance(spec, P) else P(), tree.q.dim())
            ss = qs[:-2] + (None, qs[-1])
            return QuantizedLinear(q=_put(tree.q, P(*qs), mesh), scale=_put(tree.scale, P(*ss), mesh))
        if isinstance(tree, QuantizedLinear4):
            return QuantizedLinear4(*(_put(f, P(), mesh) for f in tree))
        if isinstance(tree, dict):
            return {k: place(v, spec[k] if isinstance(spec, dict) else spec) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(place(v, spec) for v in tree)
        if isinstance(tree, torch.Tensor):
            return _put(tree, spec if isinstance(spec, P) else P(), mesh)
        return tree

    return {key: place(sub, specs.get(key, P())) for key, sub in params.items()}


def _map(tree, fn):
    if isinstance(tree, (QuantizedLinear, QuantizedLinear4)):
        return type(tree)(*(fn(f) for f in tree))
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Ranks):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, ShardedTensor):
        return fn(tree)
    return tree


def local_tree(params: Dict[str, Any], g: Optional[int] = None, r: Optional[int] = None) -> Dict[str, Any]:
    """The plain tree that tp rank r of dp group g holds (a sharded leaf is
    that rank's shard); by default this process's own (g, r), which is
    (0, 0) in the caller's. Rank (0, 0)'s replicated leaves feed the prompt
    builder, the codec facade and the voice extractor."""
    mesh = mesh_of(params)
    own = mesh.own if mesh is not None else (0, 0)
    g, r = own[0] if g is None else g, own[1] if r is None else r
    return _map(params, lambda t: t.shards[g][r])


class GroupParams(dict):
    """dp group `index`'s parameters on `mesh` (`group_params`)."""

    def __init__(self, items, mesh: Mesh, index: int):
        super().__init__(items)
        self.mesh = mesh
        self.index = index


def group_params(params: Dict[str, Any], g: int) -> GroupParams:
    """dp group g's parameters, the engine's input: "talker" and
    "predictor" are each tp rank's subtree (`group`: a `Ranks` over tp > 1
    ranks), every other key the group's replicated subtree. In a process
    mesh only the process's own group has parameters here, and its talker
    and predictor are a `Ranks` of its own rank that reduces through the
    tp process group."""
    mesh = mesh_of(params)
    tp = mesh.shape["tp"]
    if mesh.processes:
        own_g, own_r = mesh.own
        if g != own_g:
            raise ValueError(f"dp group {g} runs in another process of {mesh}")
        if tp > 1 and mesh.tp_group is None:
            raise RuntimeError(f"{mesh} has not started: its tp process groups do not exist")
    out = {}
    for key, sub in params.items():
        if key not in ("talker", "predictor"):
            out[key] = _map(sub, lambda t: next(x for x in t.shards[g] if x is not None))
        elif mesh.processes and tp > 1:
            out[key] = Ranks((_map(sub, lambda t: t.shards[g][own_r]),), mesh.tp_group, own_r, tp)
        else:
            out[key] = group(_map(sub, lambda t, r=r: t.shards[g][r]) for r in range(tp) if mesh.holds(g, r))
    return GroupParams(out, mesh, g)


def own_groups(mesh: Mesh) -> List[int]:
    """The dp groups whose lanes this process runs: all of a one-process
    mesh's, a process mesh's own."""
    return [mesh.own[0]] if mesh.processes else list(range(mesh.shape["dp"]))


def _tp_leaves(params) -> List[ShardedTensor]:
    out: List[ShardedTensor] = []
    _map(params, lambda t: out.append(t) if "tp" in t.spec and len(t.shards[0]) > 1 else None)
    return out


def rank_shards(params: Dict[str, Any]) -> List[torch.Tensor]:
    """This process's shards of every tp-sharded leaf, on the host, in tree
    order: what a process mesh's tp rank of dp group 0 sends `gather_params`
    (nothing from another group)."""
    g, r = mesh_of(params).own
    return [t.shards[g][r].cpu() for t in _tp_leaves(params)] if g == 0 else []


def gather_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The unsharded tree of dp group 0, on its device: every tp-sharded
    leaf concatenated in rank order, a replicated leaf as it is (no copy).
    In a process mesh (from rank 0) the other tp ranks of group 0 send
    their shards over the control plane (`rank_shards`)."""
    mesh = mesh_of(params)
    tp = mesh.shape["tp"]
    remote: Dict[int, List[torch.Tensor]] = {}
    if mesh.processes and tp > 1:
        if mesh.workers is None:
            raise RuntimeError(f"gather_params runs from rank 0 of a started process mesh, not on {mesh}")
        sent = mesh.workers.call("faster_qwen3_tts_tpu_torch.parallel.mesh:rank_shards")
        leaves = _tp_leaves(params)
        remote = {id(t): [t.shards[0][0]] + [sent[r - 1][i].to(t.shards[0][0].device) for r in range(1, tp)]
                  for i, t in enumerate(leaves)}

    def gather(t: ShardedTensor) -> torch.Tensor:
        if "tp" not in t.spec or len(t.shards[0]) == 1:
            return t.shards[0][0]
        return torch.cat(remote.get(id(t)) or t.shards[0], dim=t.spec.index("tp"))

    return _map(params, gather)


def mesh_of(params) -> Optional[Mesh]:
    """The mesh a `shard_params` tree is placed on; None for a plain tree."""
    sub = params.get("talker") if isinstance(params, dict) else None
    leaf = sub.get("codec_embed") if isinstance(sub, dict) else None
    return leaf.mesh if isinstance(leaf, ShardedTensor) else None


def is_sharded(params) -> bool:
    return mesh_of(params) is not None


def workers_of(params):
    """The worker processes of the process mesh a tree (or a dp group's
    tree) is placed on, seen from rank 0 (`procs.Workers`); None for a
    plain tree, a one-process mesh, or in a worker."""
    mesh = params.mesh if isinstance(params, GroupParams) else mesh_of(params)
    return None if mesh is None else mesh.workers
