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
  summed in rank order (`all_reduce`) and the column-sharded heads' logits
  concatenated in rank order (`all_gather`), in the engine's own frame, so
  a group's tp ranks are captured in one CUDA graph.

One process drives every device, as one JAX controller does, and a device
may appear more than once in a mesh, as the JAX tests' virtual CPU devices
do: a mesh of `cpu` entries on the CPU, of `cuda:0` entries on one card.
A mesh over distinct cards raises NotImplementedError (ROADMAP A.8): a tp
group there needs collectives between cards, which are not written, and dp
groups on distinct cards, which need none, have never run on a machine
with more than one card (the graph capture of a group on a card other than
the current one is untried).

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
    "tp": ..} as `jax.sharding.Mesh.shape`. A device may repeat; the whole
    mesh must sit on one device."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        for g, row in enumerate(devices):
            if len({torch.device(d) for d in row}) > 1:
                raise NotImplementedError(
                    f"tp group {g} spans {[str(d) for d in row]}: tensor parallelism across distinct cards "
                    "needs collectives between cards, which are not ported (ROADMAP A.8); put the mesh on "
                    "one device")
        if len({torch.device(d) for d in devices.flat}) > 1:
            raise NotImplementedError(
                f"dp groups on {[str(d) for d in devices[:, 0]]}: a mesh over distinct cards has not run on a "
                "machine with more than one card (ROADMAP A.8); put the mesh on one device")

    def group_device(self, g: int) -> torch.device:
        """The device of dp group g (all of its tp ranks)."""
        return torch.device(self.devices[g, 0])

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp) mesh over the first n_devices of `devices` (default
    cuda:0 .. cuda:n-1, n the visible cards). dp and tp are inferred as in
    the JAX package; `devices` may repeat a device (`[cuda:0] * 4` runs a
    2 x 2 mesh on one card)."""
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
    return Mesh(arr)


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
    replicated leaf's tensor."""

    __slots__ = ("shards", "spec", "shape", "dtype", "mesh")

    def __init__(self, shards: List[List[torch.Tensor]], spec: P, shape: torch.Size, dtype: torch.dtype,
                 mesh: Mesh):
        self.shards, self.spec, self.shape, self.dtype, self.mesh = shards, spec, shape, dtype, mesh

    @property
    def device(self) -> torch.device:
        return self.shards[0][0].device

    @property
    def addressable_shards(self) -> List[torch.Tensor]:
        """Every (group, rank) shard, in mesh order."""
        return [t for row in self.shards for t in row]

    def __repr__(self) -> str:
        return f"ShardedTensor({tuple(self.shape)}, {self.dtype}, {self.spec})"


class Ranks(tuple):
    """One value per tp rank of a group, in rank order: the rank subtrees of
    a group's talker or predictor, and a sharded model's per-rank KV caches.
    A group of one rank holds its value plain (`group`)."""


def group(values) -> Any:
    """Per-rank values as the engine holds them: one rank's value plain,
    several a `Ranks` (the inverse of `as_ranks`)."""
    values = tuple(values)
    return values[0] if len(values) == 1 else Ranks(values)


def as_ranks(x) -> tuple:
    """A `Ranks`, or one value as a group of one rank."""
    return x if isinstance(x, Ranks) else (x,)


def replica(params):
    """The replicated leaves of a model's params: rank 0's subtree of a
    `Ranks`, or the plain subtree itself."""
    return params[0] if isinstance(params, Ranks) else params


def per_rank(params, key: str):
    """params[key] of a plain subtree, or of every rank of a `Ranks`."""
    if isinstance(params, Ranks):
        return Ranks(p[key] for p in params)
    return params[key]


def all_reduce(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of a tp group's partials, in float32 and in rank order, so
    that every rank gets the same bits (the ranks of a group share a
    device, so the sum is local)."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """A tp group's column slices (vocab slices of a head) concatenated in
    rank order."""
    return torch.cat(list(parts), dim=dim)


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
    tp = mesh.shape["tp"]
    shards = []
    for g in range(mesh.shape["dp"]):
        dev = mesh.group_device(g)
        if "tp" in spec and tp > 1:
            ax = spec.index("tp")
            n = shard_shape(t.shape, spec, {"tp": tp})[ax]
            shards.append([_own(t.narrow(ax, r * n, n), dev) for r in range(tp)])
        else:
            one = _own(t, dev)
            shards.append([one] * tp)
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
    across ranks."""
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


def local_tree(params: Dict[str, Any], g: int = 0, r: int = 0) -> Dict[str, Any]:
    """The plain tree that tp rank r of dp group g holds (a sharded leaf is
    that rank's shard). Rank (0, 0)'s replicated leaves feed the prompt
    builder, the codec facade and the voice extractor."""
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
    ranks), every other key the group's replicated subtree."""
    mesh = mesh_of(params)
    out = {}
    for key, sub in params.items():
        if key in ("talker", "predictor"):
            out[key] = group(_map(sub, lambda t, r=r: t.shards[g][r]) for r in range(mesh.shape["tp"]))
        else:
            out[key] = _map(sub, lambda t: t.shards[g][0])
    return GroupParams(out, mesh, g)


def gather_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The unsharded tree of dp group 0, on its device: every tp-sharded
    leaf concatenated in rank order, a replicated leaf as it is (no copy)."""

    def gather(t: ShardedTensor) -> torch.Tensor:
        if "tp" not in t.spec or len(t.shards[0]) == 1:
            return t.shards[0][0]
        return torch.cat(t.shards[0], dim=t.spec.index("tp"))

    return _map(params, gather)


def mesh_of(params) -> Optional[Mesh]:
    """The mesh a `shard_params` tree is placed on; None for a plain tree."""
    sub = params.get("talker") if isinstance(params, dict) else None
    leaf = sub.get("codec_embed") if isinstance(sub, dict) else None
    return leaf.mesh if isinstance(leaf, ShardedTensor) else None


def is_sharded(params) -> bool:
    return mesh_of(params) is not None
