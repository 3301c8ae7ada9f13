"""Carry the JAX package's model parameters over to the port.

`lm_params_from_numpy` takes the pytree of the reference's `lm.lm_init`
with every leaf turned into a numpy array (`jax.tree.map(np.asarray,
params)`) and returns the port's `LM` on `device`. The reference stacks
each pattern slot's layers along a leading group axis; here each group's
slice becomes its own layer module, `stack["groups"][slot][g]`. Nested
trees (a MoE layer's `shared` experts) and leaves of any rank ([E, d, f]
expert stacks, [K, V, D] codebook embeddings) are copied as they are.
"""
from __future__ import annotations

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
