"""The train and serve steps on one device, on the JAX package's
`train/train_step.py`.

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

The reference's `jit_step`, with its shardings and donation, waits for
the sharding slice (ROADMAP queue 1 item 8b), as do the sharded serve
steps; `make_serve_step` here is a thin wrapper of `lm.prefill` and
`lm.decode_step` on one device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models import modules as nn
from repro_torch.parallel import compression
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
    grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(names, grads))


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
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.named_parameters()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(gsum.values())).device)
            for i in range(microbatch):
                mbatch = {k: x[i * (x.shape[0] // microbatch):
                               (i + 1) * (x.shape[0] // microbatch)]
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
