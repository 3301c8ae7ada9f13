"""Gradient compression, on the JAX package's `parallel/compression.py`.

`fake_requantize(grads)`: per-tensor int8 symmetric quantize and
dequantize of every gradient, which models the accuracy effect of an
int8 all-reduce on one device. `quantize_tree` gives the (int8 values,
fp32 scale) pairs. Trees are {name: tensor} dicts, or a module's
parameters.

"Per tensor" is per leaf of the reference's tree, which stacks each
pattern slot's layers on a group axis: the port's layers of one slot
(`stack.groups.<slot>.<g>.<path>`, every g) share one scale, the largest
|value| over all of them, as the stacked leaf's would be
(`convert.reference_leaf`). The max is exact in any order, so the values
are the reference's bit for bit.

`compressed_psum(x, group)` is the explicit int8 all-reduce over a
process group: quantise locally, take the largest scale of the group,
renormalise each rank's quanta to it, sum them as int32 and rescale (the
wire format is int32, as in the reference's `psum`).
"""
from __future__ import annotations

import torch

from repro_torch.models.convert import reference_leaf
from repro_torch.train.optimizer import named


def _q8(x, amax=None):
    """(int8 values, fp32 scale) of x; `amax` is the max |value| of the
    reference leaf x lies in (default: x's own)."""
    amax = torch.max(torch.abs(x)) if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _amax(grads) -> dict:
    """The max |value| of each reference leaf over its tensors."""
    out: dict = {}
    for k, g in grads.items():
        m = torch.max(torch.abs(g.float()))
        key = reference_leaf(k)
        out[key] = m if key not in out else torch.maximum(out[key], m)
    return out


def quantize_tree(grads):
    g = named(grads)
    amax = _amax(g)
    return {k: _q8(x.float(), amax[reference_leaf(k)]) for k, x in g.items()}


def fake_requantize(grads):
    g = named(grads)
    amax = _amax(g)

    def f(k, x):
        q, s = _q8(x.float(), amax[reference_leaf(k)])
        return (q.float() * s).to(x.dtype)
    return {k: f(k, x) for k, x in g.items()}


def compressed_psum(x, group=None):
    """int8-compressed sum of x over the ranks of `group` (default: the
    whole world), the reference's `compressed_psum` with a process group
    in place of a shard_map axis. Returns fp32."""
    import torch.distributed as dist
    q, s = _q8(x.float())
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    # renormalize local quanta to the common scale before summing
    total = torch.round(q.float() * (s / s_max)).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * s_max
