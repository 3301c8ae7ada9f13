"""Sharding rules: parameters, optimizer state, batches and caches, on the
JAX package's `parallel/sharding.py`.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod.
  * batch (DP):       ("pod", "data")
  * FSDP (ZeRO-3):    parameters/optimizer state shard their d_model-ish
                      dim over "data"; DTensor all-gathers them where a
                      product needs them whole.
  * TP (megatron):    heads / d_ff / vocab / experts shard over "model".
  * EP:               MoE expert stacks shard experts over "model".
  * caches:           batch over DP axes; kv-heads over "model" when
                      divisible, else the sequence dim.

The spec functions (`param_spec`, `batch_spec`, `cache_spec`) are the
reference's rules on geometry alone: a mesh is any object with
`.axis_names` and a `.shape` dict (`geometry(device_mesh)` gives one for
a torch `DeviceMesh`), and a spec is a tuple with one entry per tensor
dim: a mesh-axis name, a tuple of them, or None, as the reference's
`P(...)` reads. `placements(spec, mesh)` turns a spec into DTensor
placements; `param_shardings`, `batch_shardings` and `cache_shardings`
give them over the port's trees, and `distribute_module` /
`distribute_tree` put tensors on them.

The port's parameters are looked up under the reference's leaf names
(`models/convert.py::reference_leaf`). The reference stacks a pattern
slot's layers on a leading group axis and the port holds each layer as
its own tensor, so a port spec is the reference's less that axis. Where
no other dim of a stacked leaf divides an axis, the reference's
`_fix_divisibility` puts it on the group axis; the port's layer has no
such dim and keeps the leaf replicated over that axis
(`tests/test_torch_sharding.py` names every such leaf).

`activation_policy` and `constrain` pin activations as the reference's
`with_sharding_constraint` does: `constrain` redistributes a DTensor to
the resolved placements, and is a no-op without a policy, on a plain
tensor, or on a dim its axis does not divide.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


class Geometry:
    """Axis names and sizes of a mesh, without devices."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def geometry(mesh):
    """A torch `DeviceMesh` as a `Geometry`; anything with `.axis_names`
    and a `.shape` dict as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return Geometry(dict(zip(names, mesh.shape)))
    return mesh


def batch_axes(mesh, cfg=None) -> Tuple[str, ...]:
    names = geometry(mesh).axis_names
    if cfg is not None and getattr(cfg, "shard_strategy", "tp") == "ep_dp":
        return tuple(a for a in ("pod", "data", "model") if a in names)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return geometry(mesh).shape["model"]


# parameter rules keyed by leaf name -> spec WITHOUT the reference's
# scan-stack axis. "F" marks the FSDP axis ("data"), "M" the tensor axis
# ("model").
_PARAM_RULES = {
    # attention
    "wq": ("F", "M", None), "wk": ("F", "M", None), "wv": ("F", "M", None),
    "bq": ("M", None), "bk": ("M", None), "bv": ("M", None),
    "wo": ("M", "F"),
    # MLA
    "w_q": ("F", "M", None),
    "w_dq": ("F", None), "w_uq": (None, "M", None),
    "w_dkv": ("F", None), "w_uk": (None, "M", None),
    "w_uv": (None, "M", None), "w_kr": ("F", None),
    "q_norm": (None,), "kv_norm": (None,),
    # dense MLP
    "w_gate": ("F", "M"), "w_up": ("F", "M"), "w_down": ("M", "F"),
    "b_up": ("M",), "b_down": (None,),
    # router
    "router": ("F", None),
    # rglru
    "w_x": ("F", "M"), "w_r": ("M", None), "w_i": ("M", None),
    "b_r": (None,), "b_i": (None,), "lam": ("M",), "w_out": ("M", "F"),
    # ssd
    "w_in": ("F", "M"), "A_log": ("M",), "D": ("M",), "dt_bias": ("M",),
    "norm": ("M",),
    # conv
    "w": (None, "M"), "b": ("M",),
    # norms / embeddings
    "ln1": (None,), "ln2": (None,), "final_norm": (None,),
    "embed": ("M", "F"), "head": ("F", "M"),
}

# expert-stacked leaves ([E, ...]) get "M" on the expert axis instead
_EXPERT_RULES = {
    "w_gate": ("M", "F", None), "w_up": ("M", "F", None),
    "w_down": ("M", None, "F"),
}


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    shape = geometry(mesh).shape
    if isinstance(ax, tuple):
        return int(math.prod(shape[a] for a in ax))
    return int(shape[ax])


def _fix_divisibility(spec, shape, mesh) -> Spec:
    """Argument shardings require exact divisibility. For every axis that
    does not divide its dim, move it to the largest *free* divisible dim
    (preferring trailing dims, e.g. heads -> head_dim), else drop it."""
    spec = list(spec)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        if shape[i] % _axis_size(mesh, ax) == 0:
            continue
        spec[i] = None
        for j in range(len(spec) - 1, -1, -1):
            if (spec[j] is None and j != i
                    and shape[j] % _axis_size(mesh, ax) == 0
                    and shape[j] >= _axis_size(mesh, ax)):
                spec[j] = ax
                break
    return tuple(spec)


def param_spec(name: str, leaf, cfg, mesh) -> Spec:
    """The spec of the port parameter `name` (`named_parameters()`'s
    dotted name) of shape `leaf.shape`."""
    from repro_torch.models.convert import reference_leaf
    keys = reference_leaf(name).split(".")
    leaf_name = keys[-1]
    ndim = len(leaf.shape)
    in_moe = ("mlp" in keys and "shared" not in keys
              and cfg.mlp_type == "moe")
    if leaf_name == "embed" and cfg.n_codebooks > 1:
        rule: Tuple = (None, "M", "F")
    elif leaf_name == "head" and cfg.n_codebooks > 1:
        rule = (None, "F", "M")
    elif in_moe and leaf_name in _EXPERT_RULES and ndim == 3:
        rule = _EXPERT_RULES[leaf_name]
    elif leaf_name in _PARAM_RULES:
        rule = _PARAM_RULES[leaf_name]
    else:
        rule = (None,) * ndim
    if len(rule) != ndim:
        rule = (None,) * ndim
    ax = {"F": "data", "M": "model", None: None}
    if getattr(cfg, "shard_strategy", "tp") == "ep_dp":
        # only expert stacks use the model axis; everything else
        # replicates over it (pure-DP attention/MLP + EP)
        if not (in_moe and leaf_name in _EXPERT_RULES):
            ax = {"F": "data", "M": None, None: None}
    return _fix_divisibility(tuple(ax[r] for r in rule), leaf.shape, mesh)


def batch_spec(mesh, ndim: int, shape=None, cfg=None) -> Spec:
    ax = batch_axes(mesh, cfg)
    if shape is not None and (len(shape) == 0
                              or shape[0] % _axis_size(mesh, ax) != 0):
        # retry without the model axis (ep_dp with a small batch)
        ax = batch_axes(mesh)
        if len(shape) == 0 or shape[0] % _axis_size(mesh, ax) != 0:
            return (None,) * ndim
    return (ax,) + (None,) * (ndim - 1)


def cache_spec(path: str, leaf, cfg, mesh) -> Spec:
    """The spec of one cache tensor; `path` ends in its field name (`k`,
    `v`, `pos`, `c_kv`, `k_rope`, `h`, `conv`, `conv_x`, ...)."""
    name = path.split(".")[-1]
    b = batch_axes(mesh)
    msz = model_axis_size(mesh)
    nd = len(leaf.shape)
    if name in ("k", "v"):                      # [B, S, K, Dh]
        if cfg.n_kv_heads % msz == 0:
            rule: Tuple = (b, None, "model", None)
        else:
            rule = (b, "model", None, None)
    elif name in ("c_kv", "k_rope"):            # [B, S, R/Dr]
        rule = (b, "model", None)
    elif name == "pos":                         # [W]
        rule = (None,)
    elif name == "h" and nd == 2:               # rglru state [B, R]
        rule = (b, "model")
    elif name == "h" and nd == 4:               # ssd state [B, H, N, P]
        rule = (b, "model", None, None)
    elif nd == 3:                               # conv windows [B, W-1, C]
        rule = (b, None, "model")
    else:
        rule = (b,) + (None,) * (nd - 1)
    return _fix_divisibility(tuple(rule), leaf.shape, mesh)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of `spec` on a `DeviceMesh`, one per mesh dim: a
    mesh axis on tensor dim i is `Shard(i)`, an absent axis `Replicate()`;
    a tuple of axes shards one tensor dim over each of them. An axis of
    size 1 is `Replicate()` (a shard over one rank is the whole tensor,
    and DTensor reshapes fewer layouts of a sharded dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [i for i, ax in enumerate(spec)
                if ax == axis or (isinstance(ax, tuple) and axis in ax)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def replicated(mesh) -> Tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def param_shardings(params, cfg, mesh) -> Dict[str, Tuple]:
    """{name: placements} of a module's parameters or a {name: tensor}
    tree shaped like them (gradients, AdamW's moments and masters)."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else params)
    return {k: placements(param_spec(k, t, cfg, geometry(mesh)), mesh)
            for k, t in named.items()}


def batch_shardings(batch, mesh, cfg=None) -> Dict[str, Tuple]:
    return {k: placements(batch_spec(geometry(mesh), x.ndim, tuple(x.shape),
                                     cfg), mesh)
            for k, x in batch.items()}


def map_tree(fn, tree, path=""):
    """`fn(path, tensor)` over a tree of dicts, lists, NamedTuples and
    tensors (None kept), in the tree's own structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}.{k}") for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, f"{path}.{k}")
                            for k, v in zip(tree._fields, tree)))
    return [map_tree(fn, v, f"{path}.{i}") for i, v in enumerate(tree)]


def cache_shardings(caches, cfg, mesh):
    """The cache tree with each tensor replaced by its placements."""
    geo = geometry(mesh)
    return map_tree(lambda p, t: placements(cache_spec(p, t, cfg, geo),
                                             mesh), caches)


def distribute_tree(tree, shardings, mesh):
    """Each tensor of `tree` as a DTensor on the placements at the same
    place of `shardings` (a tree of the same structure, as
    `cache_shardings` or `param_shardings` give), each rank keeping its
    shard of the whole tensor it holds."""
    from torch.distributed.tensor import distribute_tensor
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, shardings, src_data_rank=None)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k], mesh)
                for k, v in tree.items()}
    parts = [distribute_tree(v, s, mesh) for v, s in zip(tree, shardings)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else parts


def distribute_module(module, cfg, mesh):
    """Replace every parameter of `module` in place by a DTensor on its
    `param_spec` placements (a parameter already a DTensor is moved to
    them); gradients stay as they were. Every rank holds the same whole
    parameters (drawn from one seed, or read from one checkpoint) and
    keeps its own shard of them: no collective. Returns the module."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    shard = param_shardings(module, cfg, mesh)
    for name, p in list(module.named_parameters()):
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        if isinstance(p.data, DTensor):
            d = p.data.redistribute(mesh, shard[name])
        else:
            d = distribute_tensor(p.detach(), mesh, shard[name],
                                  src_data_rank=None)
        owner._parameters[leaf] = torch.nn.Parameter(
            d, requires_grad=p.requires_grad)
    return module


def full_tensor(t):
    """A DTensor gathered whole (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# ---------------------------------------------------------------------------
# activation sharding policy (set around a step; consulted by model code
# via `constrain`). It pins: batch -> DP axes, and optionally seq ->
# "model" (megatron sequence parallelism) on the residual stream.
# ---------------------------------------------------------------------------
_ACT_POLICY: dict = {}


class activation_policy:
    """Context manager: set the logical->mesh mapping for activations."""

    def __init__(self, mesh, sequence_parallel: bool = False, cfg=None):
        ep_dp = (cfg is not None
                 and getattr(cfg, "shard_strategy", "tp") == "ep_dp")
        self.new = {
            "mesh": mesh,
            "batch": batch_axes(mesh, cfg),
            "seq": "model" if (sequence_parallel and not ep_dp) else None,
        }

    def __enter__(self):
        self._old = dict(_ACT_POLICY)
        _ACT_POLICY.clear()
        _ACT_POLICY.update(self.new)
        return self

    def __exit__(self, *exc):
        _ACT_POLICY.clear()
        _ACT_POLICY.update(self._old)
        return False


def active_mesh():
    """The mesh of the active policy, or None."""
    return _ACT_POLICY.get("mesh")


def resolve_spec(shape, logical: Tuple[Any, ...]) -> Spec:
    """The spec that logical axis names ("batch", "seq", None, or a mesh
    axis name like "model") give a tensor of `shape` under the active
    policy; an axis that does not divide its dim is dropped."""
    mesh = geometry(_ACT_POLICY["mesh"])

    def resolve(l):
        if isinstance(l, str):
            if l in _ACT_POLICY:
                return _ACT_POLICY.get(l)
            if l in mesh.axis_names:
                return l
            return None
        if isinstance(l, tuple):
            parts = []
            for e in l:
                r = resolve(e)
                if r is None:
                    continue
                parts.extend(r if isinstance(r, tuple) else (r,))
            return tuple(parts) or None
        return None

    spec = []
    for i, l in enumerate(logical):
        ax = resolve(l)
        if ax is not None and shape[i] % _axis_size(mesh, ax) != 0:
            ax = None
        spec.append(ax)
    return tuple(spec)


def constrain(x, logical: Tuple[Any, ...]):
    """Redistribute the DTensor `x` to the placements that `logical`
    resolves to under the active policy (other mesh axes replicate), as
    the reference's `with_sharding_constraint`, its gradient too. No-op
    when no policy is set (single-device steps) and on a plain tensor; a
    dim its axis does not divide is not split (e.g. decode's seq == 1
    under sequence parallelism)."""
    if not _ACT_POLICY or not is_dtensor(x):
        return x
    mesh = _ACT_POLICY["mesh"]
    # redistributed even where the placements already match: as the
    # reference's constraint, it pins the gradient too (the backward
    # brings it to these placements)
    return x.redistribute(mesh, placements(resolve_spec(x.shape, logical),
                                           mesh))


def axis_for(logical, size: int):
    """The mesh axes `logical` ("batch", "seq" or a mesh axis name)
    resolves to under the active policy if they divide `size`, else None
    (also without a policy)."""
    if not _ACT_POLICY:
        return None
    return resolve_spec((size,), (logical,))[0]


def head_axis(batch_axes_, *sizes):
    """"model" when the active policy has it, every size divides by it,
    and the batch does not already use it (ep_dp); else None: the dims
    that split a product's heads or channels over the model axis."""
    used = (batch_axes_ if isinstance(batch_axes_, tuple)
            else (batch_axes_,))
    if "model" in used or not all(axis_for("model", n) for n in sizes):
        return None
    return "model"


def spec_of(t) -> Spec:
    """The spec of a DTensor's placements (all None for a plain tensor):
    the inverse of `placements`."""
    spec: list = [None] * t.ndim
    if not is_dtensor(t):
        return tuple(spec)
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            e = spec[p.dim]
            spec[p.dim] = name if e is None else (
                (e if isinstance(e, tuple) else (e,)) + (name,))
    return tuple(spec)


def _axes(spec) -> set:
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


def local_linear(x, w, fn):
    """`fn(x, w)`, x [..., D] times a DTensor weight w [D, *out], on each
    rank's shards: w gathered over its first (FSDP) dim and x whole along
    D, x's leading dims and w's output dims split as they are (an output
    axis x's leading dims use already is gathered). DTensor cannot
    flatten w's output dims when an axis splits a later one of them (the
    head dim, where the heads do not divide the axis), so a weight of
    more than two dims takes this route; its gradient comes back as a
    partial sum over the gathered axis, reduced onto w's placements by
    the step."""
    xs = spec_of(x)[:-1] + (None,)
    used = _axes(xs)
    ws = (None,) + tuple(
        None if e is not None and _axes((e,)) & used else e
        for e in spec_of(w)[1:])
    return local_call(fn, (x, w), (xs, ws), (xs[:-1] + ws[1:],))


def merge_heads(x, n_heads: int):
    """x [B, S, H, D] -> [B, S, H * D], its merged dim pinned to the
    heads' split under a sharding policy (over "model" where the heads
    divide it, else whole): a gradient that comes back split along the
    merged dim can then be viewed as heads again (DTensor cannot unflatten
    a dim whose split falls inside a head). A plain reshape otherwise."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if not _ACT_POLICY or not is_dtensor(y):
        return y
    bat = axis_for("batch", x.shape[0])
    return constrain(y, ("batch",) + (None,) * (y.ndim - 2)
                     + (head_axis(bat, n_heads),))


def split_heads(x, n_heads: int):
    """x [..., H * D] -> [..., H, D], the inverse of `merge_heads`: under
    a sharding policy the last dim is first pinned to the heads' split
    (over "model" where the heads divide it, else whole), since DTensor
    cannot unflatten a dim whose split falls inside a head."""
    if _ACT_POLICY and is_dtensor(x):
        bat = axis_for("batch", x.shape[0])
        x = constrain(x, ("batch",) + (None,) * (x.ndim - 2)
                      + (head_axis(bat, n_heads),))
    return x.reshape(*x.shape[:-1], n_heads, x.shape[-1] // n_heads)


def is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and hasattr(x, "placements")


def local_call(fn, args, in_specs, out_specs):
    """`fn(*args)` on each rank's shards, for the ops DTensor has no
    sharding rule for (the kernel wrappers, which take plain tensors, and
    the MoE dispatch's sorts, gathers and scatters): each tensor argument
    is redistributed to its spec in `in_specs` (a plain tensor is taken
    as replicated), `fn` runs on the local shards through `local_map`,
    and each output becomes a DTensor on its spec in `out_specs` (None
    for a non-tensor). A replicated input's gradient is a partial sum over
    the mesh axes the outputs are split on. Without a policy or a DTensor
    argument, `fn(*args)` as it is."""
    mesh = active_mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    split = {ax for s in out_specs if s is not None for e in s
             for ax in (e if isinstance(e, tuple) else (e,))}
    args = [DTensor.from_local(a, mesh, replicated(mesh), run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    in_pl, grad_pl = [], []
    for a, s in zip(args, in_specs):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = placements(s, mesh)
        in_pl.append(pl)
        grad_pl.append(tuple(
            Partial() if isinstance(p, Replicate) and name in split else p
            for p, name in zip(pl, mesh.mesh_dim_names)))
    out_pl = tuple(None if s is None else placements(s, mesh)
                   for s in out_specs)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _runs(rows: Sequence[int]):
    """(position, index into rows, length) of each maximal run of
    consecutive positions in `rows`."""
    out = []
    for i, r in enumerate(rows):
        if out and r == out[-1][0] + out[-1][2]:
            out[-1][2] += 1
        else:
            out.append([r, i, 1])
    return out


def write_rows(buf, dim: int, rows: Sequence[int], val):
    """Rows `rows` (positions along `dim`, host ints) of buf take val's
    rows in order, in place, run by run of consecutive positions (a
    cache write is one run; a ring buffer's at most two). On a DTensor buf
    (a cache, whose sequence dim may be sharded) each rank writes the rows
    that fall in its own shard, found from its mesh coordinates; val is
    read whole along `dim`. Returns buf."""
    def write(b, v, off=0):
        n = b.shape[dim]
        for r, i, k in _runs(rows):
            lo, hi = max(r, off), min(r + k, off + n)
            if lo < hi:
                b.narrow(dim, lo - off, hi - lo).copy_(
                    v.narrow(dim, i + lo - r, hi - lo))
        return b

    if not is_dtensor(buf):
        return write(buf, val)
    mesh = buf.device_mesh
    spec = spec_of(buf)
    split = [d for d, p in enumerate(buf.placements)   # the mesh dims
             if p.is_shard() and p.dim == dim]         # sharding `dim`
    val_spec = tuple(None if i == dim else e for i, e in enumerate(spec))

    def write_shard(b, v):
        chunk = 0
        for d in split:
            chunk = chunk * mesh.size(d) + mesh.get_local_rank(d)
        return write(b, v, chunk * b.shape[dim])

    with activation_policy(mesh):
        return local_call(write_shard, (buf, val), (spec, val_spec),
                          (spec,))
