"""Carry model parameters, and trees shaped like them, between the JAX
package and the port.

The reference's tree (`lm.lm_init`, as numpy arrays: `jax.tree.map(
np.asarray, params)`) stacks each pattern slot's layers along a leading
group axis; the port holds each group's slice as its own layer module,
`stack["groups"][slot][g]`, and names every tensor by its path of dict
keys and list indices (`stack.groups.0.3.attn.wq`), as
`named_parameters()` gives it. Nested trees (a MoE layer's `shared`
experts) and leaves of any rank ([E, d, f] expert stacks, [K, V, D]
codebook embeddings) are copied as they are.

  * `lm_params_from_numpy(tree, cfg, device)`: the reference's params ->
    the port's `LM`; `lm_params_to_numpy(lm, cfg)`: back, groups stacked.
  * `named_from_tree(tree, cfg)` / `tree_from_named(named, cfg)`: the
    same mapping for any tree shaped like the params (gradients, AdamW's
    `m`, `v` and `master`), between the reference's nesting and the
    port's {name: leaf}.
  * `reference_leaf(name)`: the reference leaf a port tensor lies in.
  * `opt_state_to_numpy(state, cfg)` / `opt_state_from_numpy(tree, cfg,
    device)`: AdamW's state, each of `m`, `v` and `master` through the
    mapping above.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.models import transformer
from repro_torch.models.lm import LM


def _tensors(node, dev, index=None):
    """Copy a nested dict of arrays to tensors, taking `[index]` of every
    leaf when an index is given."""
    if isinstance(node, dict):
        return {k: _tensors(v, dev, index) for k, v in node.items()}
    arr = np.asarray(node) if index is None else np.asarray(node)[index]
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def lm_params_from_numpy(tree, cfg, device="cuda") -> LM:
    dev = resolve(device)
    _, period, n_groups = transformer.stack_layout(cfg)
    stack = tree["stack"]
    p = {
        "embed": _tensors(tree["embed"], dev),
        "stack": {
            "prologue": [_tensors(layer, dev) for layer in stack["prologue"]],
            "groups": [[_tensors(stack["groups"][slot], dev, g)
                        for g in range(n_groups)]
                       for slot in range(len(period))],
        },
        "final_norm": _tensors(tree["final_norm"], dev),
    }
    if "head" in tree:
        p["head"] = _tensors(tree["head"], dev)
    return LM(p)


def _flat(node, prefix: str, out: dict, index=None) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            _flat(v, f"{prefix}.{k}", out, index)
    else:
        out[prefix] = np.asarray(node) if index is None \
            else np.asarray(node)[index]


def named_from_tree(tree, cfg) -> Dict[str, np.ndarray]:
    """{port name: array} of a tree shaped like the reference's params
    (the groups' leaves sliced group by group)."""
    _, period, n_groups = transformer.stack_layout(cfg)
    out: Dict[str, np.ndarray] = {}
    for key in ("embed", "final_norm", "head"):
        if key in tree:
            _flat(tree[key], key, out)
    for i, layer in enumerate(tree["stack"]["prologue"]):
        _flat(layer, f"stack.prologue.{i}", out)
    for slot in range(len(period)):
        for g in range(n_groups):
            _flat(tree["stack"]["groups"][slot], f"stack.groups.{slot}.{g}",
                  out, g)
    return out


def reference_leaf(name: str) -> str:
    """The reference leaf a port tensor lies in: a group's layer
    `stack.groups.<slot>.<g>.<path>` is slice g of the slot's stacked
    leaf, named here `stack.groups.<slot>.<path>`; any other name is its
    own leaf."""
    keys = name.split(".")
    if keys[:2] == ["stack", "groups"] and len(keys) > 4:
        return ".".join(keys[:3] + keys[4:])
    return name


def _put(tree: dict, keys, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def tree_from_named(named, cfg) -> dict:
    """The reference's nesting of {port name: array or tensor}, each
    slot's leaves stacked over its groups on a new leading axis (tensors
    are copied to the CPU as numpy arrays)."""
    prologue, period, n_groups = transformer.stack_layout(cfg)
    tree: dict = {"stack": {"prologue": [{} for _ in prologue],
                            "groups": [{} if n_groups else None
                                       for _ in period]}}
    grouped: dict = {}
    for name, leaf in named.items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        keys = name.split(".")
        if keys[0] != "stack":
            _put(tree, keys, leaf)
        elif keys[1] == "prologue":
            _put(tree["stack"]["prologue"][int(keys[2])], keys[3:], leaf)
        else:
            slot, g = int(keys[2]), int(keys[3])
            grouped.setdefault((slot, tuple(keys[4:])), {})[g] = leaf
    for (slot, keys), by_group in grouped.items():
        if sorted(by_group) != list(range(n_groups)):
            raise ValueError(f"slot {slot} {'.'.join(keys)}: groups "
                             f"{sorted(by_group)} of {n_groups}")
        _put(tree["stack"]["groups"][slot], list(keys),
             np.stack([by_group[g] for g in range(n_groups)]))
    return tree


def lm_params_to_numpy(lm: LM, cfg) -> dict:
    """The inverse of `lm_params_from_numpy`: the reference's tree of
    numpy arrays, groups stacked."""
    return tree_from_named(dict(lm.named_parameters()), cfg)


def opt_state_to_numpy(state, cfg) -> dict:
    """AdamW's state as the reference's fields: {"step": int32, "m", "v",
    "master": the reference's trees (None without masters)}."""
    return {"step": np.int32(state.step),
            "m": tree_from_named(state.m, cfg),
            "v": tree_from_named(state.v, cfg),
            "master": (None if state.master is None
                       else tree_from_named(state.master, cfg))}


def opt_state_from_numpy(tree, cfg, device="cuda"):
    """The reference's AdamW state (`step`, `m`, `v`, `master`, as numpy:
    its `AdamWState` or a dict with those keys) as the port's."""
    from repro_torch.train.optimizer import AdamWState
    dev = resolve(device)
    get = (tree.get if isinstance(tree, dict)
           else lambda k: getattr(tree, k))

    def named(t):
        return None if t is None else {
            k: torch.from_numpy(np.array(a, copy=True)).to(dev)
            for k, a in named_from_tree(t, cfg).items()}

    return AdamWState(step=int(get("step")), m=named(get("m")),
                      v=named(get("v")), master=named(get("master")))
