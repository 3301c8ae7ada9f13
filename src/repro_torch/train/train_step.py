"""The train and serve steps, on the JAX package's `train/train_step.py`.

`make_train_step(cfg, opt_cfg, ...)` returns
    step(params, opt_state, batch) -> (params, opt_state, metrics)
with the reference's knobs: microbatch gradient accumulation in fp32 in
microbatch order, int8 gradient compression (`fake_requantize`) and
`cast_params="bfloat16"` (the loss differentiated with respect to bf16
copies of the fp32 parameters, whose bf16 gradients the update upcasts,
as in the reference). `params` is the model (`lm.LM`) with gradients on
(`requires_grad_(True)`); the update is in place. The model takes its
plain, differentiable forms while autograd records (no kernel has a
backward), as the reference trains under `use_pallas=False`.
`make_serve_step` is a thin wrapper of `lm.prefill` and `lm.decode_step`.

`make_sharded_train_step(cfg, opt_cfg, mesh, ...)` and
`make_sharded_serve_step(cfg, mesh, kind)` are the same steps over a
`DeviceMesh`, the reference's `jit_step` contract: each returns
(step, place). `place` puts the parameters (in place), AdamW's `m`, `v`
and `master` on `param_spec`'s placements and caches on `cache_spec`'s,
as DTensors; `step` puts each batch or token array on `batch_spec`'s,
runs under `activation_policy` with plain tensors taken as replicated,
and returns metrics and logits replicated, as plain tensors. Compute
follows the layout: DTensor propagates the placements through the model
as GSPMD does, `constrain` pins the residual stream, and the ops DTensor
has no rule for run on local shards (`sharding.local_call`). Donation is
the in-place update. On a 1 x 1 mesh the steps give the single-device
steps' numbers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models import modules as nn
from repro_torch.parallel import compression
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on `device`: integer arrays
    (tokens, labels) as int64, the index dtype of torch, floats as they
    are."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def loss_and_grad(cfg, params, batch):
    """((loss, metrics), grads) of `lm.loss_fn` at `params`, as the
    reference's `jax.value_and_grad(..., has_aux=True)`: grads is {name:
    gradient} over the parameters, each in its parameter's dtype."""
    names, leaves = zip(*params.named_parameters())
    if not all(t.requires_grad for t in leaves):
        raise ValueError("loss_and_grad: the parameters need gradients "
                         "(params.requires_grad_(True))")
    loss, metrics = lm.loss_fn(params, cfg, batch)
    grads = [_as_param(g, t) for g, t in
             zip(torch.autograd.grad(loss, leaves), leaves)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(names, grads))


def _as_param(g, param):
    """A DTensor gradient on its parameter's placements (a partial sum is
    reduced, a replicated one sliced), as the reference's out_shardings
    put the gradients where the parameters are; a plain one as it is."""
    if sharding.is_dtensor(g) and g.placements != param.placements:
        return g.redistribute(param.device_mesh, param.placements)
    return g


def make_train_step(cfg, opt_cfg: opt.AdamWConfig, microbatch: int = 0,
                    grad_compression: Optional[str] = None,
                    cast_params: Optional[str] = None):
    """microbatch > 1 splits each batch into that many accumulation
    chunks along its first axis. grad_compression: None | "int8".
    cast_params="bfloat16" differentiates bf16 copies of the fp32
    parameters; the optimizer still updates the fp32 parameters."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}")

    def step(params, opt_state, batch):
        master = params
        if cast_params:
            dt = getattr(torch, cast_params)
            params = nn.map_params(master, lambda p: (
                p.detach().to(dt) if p.dtype == torch.float32
                else p.detach())).requires_grad_(True)
        if microbatch and microbatch > 1:
            gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.named_parameters()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(gsum.values())).device)
            for i in range(microbatch):
                # a microbatch is a slice of the global batch, sharded as
                # the batch is (no-op on one device)
                mbatch = {k: sharding.constrain(
                    x[i * (x.shape[0] // microbatch):
                      (i + 1) * (x.shape[0] // microbatch)],
                    ("batch",) + (None,) * (x.ndim - 1))
                    for k, x in batch.items()}
                (loss, _), g = loss_and_grad(cfg, params, mbatch)
                for k, gk in g.items():
                    gsum[k].add_(gk)
                lsum = lsum + loss
                del g
            grads = {k: g / microbatch for k, g in gsum.items()}
            metrics = {"loss": lsum / microbatch}
        else:
            (_, metrics), grads = loss_and_grad(cfg, params, batch)
        if grad_compression == "int8":
            grads = compression.fake_requantize(grads)
        params2, opt2, om = opt.adamw_update(opt_cfg, grads, opt_state,
                                             master)
        metrics = dict(metrics)
        metrics.update(om)
        return params2, opt2, metrics

    return step


def make_serve_step(cfg, kind: str = "decode"):
    """kind: "decode" -> step(params, token, pos, caches, kv_valid) ->
    (logits, caches); "prefill" -> step(params, tokens, caches,
    prefix_embeds=None) -> (last_logits, caches). Both run without
    autograd, so the kernels serve."""
    if kind == "decode":
        def step(params, token, pos, caches, kv_valid=None):
            with torch.no_grad():
                return lm.decode_step(params, cfg, token, pos, caches,
                                      kv_valid=kv_valid)
    elif kind == "prefill":
        def step(params, tokens, caches, prefix_embeds=None):
            with torch.no_grad():
                return lm.prefill(params, cfg, tokens, caches,
                                  prefix_embeds=prefix_embeds)
    else:
        raise ValueError(f"kind {kind!r}")
    return step


# ---------------------------------------------------------------------------
# the steps over a device mesh
# ---------------------------------------------------------------------------
def place_state(params, opt_state, cfg, mesh):
    """The parameters (in place) and AdamW's state on `param_spec`'s
    placements: the reference's in_shardings of params and opt_state
    (`step` stays a replicated int)."""
    sharding.distribute_module(params, cfg, mesh)
    if opt_state is None:
        return params, None
    shard = sharding.param_shardings(params, cfg, mesh)

    def put(tree):
        return None if tree is None else {
            k: (t.redistribute(mesh, shard[k]) if sharding.is_dtensor(t)
                else sharding.distribute_tree(t, shard[k], mesh))
            for k, t in tree.items()}
    return params, opt_state._replace(m=put(opt_state.m), v=put(opt_state.v),
                                      master=put(opt_state.master))


def place_batch(batch, mesh, cfg=None):
    """Each array of the batch on `batch_spec`'s placements, from a whole
    copy that every rank holds (each keeps its shard: no collective)."""
    from torch.distributed.tensor import distribute_tensor
    shard = sharding.batch_shardings(batch, mesh, cfg)
    return {k: x if sharding.is_dtensor(x) else distribute_tensor(
        x, mesh, shard[k], src_data_rank=None) for k, x in batch.items()}


def _replicated(tree):
    return {k: sharding.full_tensor(v) if isinstance(v, torch.Tensor)
            else v for k, v in tree.items()}


def _policy(mesh, cfg, sequence_parallel=False):
    from contextlib import ExitStack

    from torch.distributed.tensor.experimental import implicit_replication
    stack = ExitStack()
    stack.enter_context(sharding.activation_policy(
        mesh, sequence_parallel=sequence_parallel, cfg=cfg))
    stack.enter_context(implicit_replication())
    return stack


def make_sharded_train_step(cfg, opt_cfg: opt.AdamWConfig, mesh,
                            microbatch: int = 0,
                            grad_compression: Optional[str] = None,
                            sequence_parallel: bool = False,
                            cast_params: Optional[str] = None):
    """`make_train_step` over `mesh`. Returns (step, place):
    place(params, opt_state) -> both on their placements;
    step(params, opt_state, batch) -> (params, opt_state, metrics), the
    batch placed by `place_batch`, the gradients reduced onto the
    parameters' placements, the metrics replicated."""
    inner = make_train_step(cfg, opt_cfg, microbatch=microbatch,
                            grad_compression=grad_compression,
                            cast_params=cast_params)

    def step(params, opt_state, batch):
        batch = place_batch(batch, mesh, cfg)
        with _policy(mesh, cfg, sequence_parallel):
            params, opt_state, metrics = inner(params, opt_state, batch)
        return params, opt_state, _replicated(metrics)

    def place(params, opt_state):
        return place_state(params, opt_state, cfg, mesh)

    return step, place


def make_sharded_serve_step(cfg, mesh, kind: str = "decode"):
    """`make_serve_step` over `mesh`. Returns (step, place):
    place(params, caches) -> the parameters on `param_spec`'s placements
    (in place) and the caches on `cache_spec`'s; step takes the same
    arguments as `make_serve_step`'s, puts tokens (and kv_valid, the
    prefix) on `batch_spec`'s placements and returns (logits replicated,
    caches on their placements)."""
    inner = make_serve_step(cfg, kind)

    def batch(x):
        if not isinstance(x, torch.Tensor):
            return x
        return place_batch({"x": x}, mesh)["x"]

    if kind == "decode":
        def step(params, token, pos, caches, kv_valid=None):
            with _policy(mesh, cfg):
                logits, caches = inner(params, batch(token), pos, caches,
                                       batch(kv_valid))
            return sharding.full_tensor(logits), caches
    else:
        def step(params, tokens, caches, prefix_embeds=None):
            with _policy(mesh, cfg):
                logits, caches = inner(params, batch(tokens), caches,
                                       batch(prefix_embeds))
            return sharding.full_tensor(logits), caches

    def place(params, caches):
        sharding.distribute_module(params, cfg, mesh)
        return params, sharding.distribute_tree(
            caches, sharding.cache_shardings(caches, cfg, mesh), mesh)

    return step, place
