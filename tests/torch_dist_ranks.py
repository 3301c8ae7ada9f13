"""The rank programs of `tests/test_torch_dist.py`, and the inputs both
sides of each comparison use.

    python tests/torch_dist_ranks.py CASE[,CASE...] OUT_DIR

runs in each of WORLD_SIZE processes (RANK, MASTER_ADDR and MASTER_PORT
set, as `torchrun` sets them) of a gloo group on the CPU; rank 0 writes
what the test compares to OUT_DIR/CASE.pt for each case. The module
imports torch and the port only, so each rank starts quickly.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.models import lm
from repro_torch.parallel import compression
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

TRAIN_ARCHS = ("phi3-mini-3.8b", "deepseek-v2-lite-16b", "mamba2-780m")
SERVE_ARCHS = ("recurrentgemma-9b", "deepseek-v2-lite-16b", "mamba2-780m")
KNOBS = {"microbatch": {"microbatch": 2}, "int8": {"grad_compression": "int8"},
         "cast": {"cast_params": "bfloat16"}}
STEPS = 3
BATCH, SEQ = 4, 32
PROMPT, DECODE, MAX_LEN = 16, 3, 32
# AdamW's eps is 1e-4 here: at the default 1e-8 an update is lr * sign(g)
# wherever |g| >> 1e-8, so a gradient element at rounding-noise level
# (~1e-9, where two layouts sum in another order) moves its parameter by
# +-lr either way; with eps 1e-4 the update is a smooth function of the
# gradient there, and the comparison sees the gradients' arithmetic
OPT = opt.AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=10,
                      eps=1e-4)


def smoke(arch):
    return configs.get_smoke_config(arch, dtype="float32")


def init(cfg, seed: int = 0):
    return lm.lm_init(cfg, torch.Generator().manual_seed(seed), device="cpu")


def batches(cfg, n: int, seed: int = 0, batch: int = BATCH):
    rng = np.random.RandomState(seed)
    shape = ((batch, cfg.n_codebooks, SEQ) if cfg.n_codebooks > 1
             else (batch, SEQ))
    out = []
    for _ in range(n):
        tok = rng.randint(0, cfg.vocab, size=shape)
        out.append({"tokens": torch.from_numpy(tok),
                    "labels": torch.from_numpy(np.roll(tok, -1, axis=-1))})
    return out


def prompts(cfg, seed: int = 1):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, size=(2, PROMPT + DECODE))
    return torch.from_numpy(tok)


def train(step, params, opt_state, data):
    """(losses, full parameters) after a step on each batch of `data`."""
    losses = []
    for b in data:
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    full = {k: shd.full_tensor(v.detach()).clone()
            for k, v in params.named_parameters()}
    return losses, full


def serve(prefill, decode, params, caches, tokens):
    """The prefill's last logits, then each decode step's."""
    logits, caches = prefill(params, tokens[:, :PROMPT], caches)
    out = [logits]
    for i in range(DECODE):
        logits, caches = decode(params, tokens[:, PROMPT + i], PROMPT + i,
                                caches)
        out.append(logits)
    return torch.stack(out)


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def case_train():
    mesh = _mesh((2, 2))
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = smoke(arch)
        step, place = ts.make_sharded_train_step(cfg, OPT, mesh)
        params = init(cfg).requires_grad_(True)
        params, state = place(params, opt.adamw_init(params))
        out[arch] = train(step, params, state, batches(cfg, STEPS))
    cfg = smoke(TRAIN_ARCHS[0])
    for name, kw in KNOBS.items():
        step, place = ts.make_sharded_train_step(cfg, OPT, mesh, **kw)
        params = init(cfg).requires_grad_(True)
        params, state = place(params, opt.adamw_init(params))
        out[name] = train(step, params, state, batches(cfg, 1))
    return out


def case_serve():
    mesh = _mesh((2, 2))
    out = {}
    for arch in SERVE_ARCHS:
        cfg = smoke(arch)
        prefill, place = ts.make_sharded_serve_step(cfg, mesh, "prefill")
        decode, _ = ts.make_sharded_serve_step(cfg, mesh, "decode")
        params, caches = place(init(cfg), lm.init_caches(
            cfg, 2, MAX_LEN, dtype=torch.float32, device="cpu"))
        with torch.no_grad():
            out[arch] = serve(prefill, decode, params, caches, prompts(cfg))
    return out


def case_remesh():
    """A checkpoint of a trained state written on a 2 x 2 mesh, restored
    onto 4 x 1: the restored tensors, gathered, and the saved ones."""
    cfg = smoke(TRAIN_ARCHS[0])
    path = os.path.join(sys.argv[2], "ckpt")
    step, place = ts.make_sharded_train_step(cfg, OPT, _mesh((2, 2)))
    params = init(cfg).requires_grad_(True)
    params, state = place(params, opt.adamw_init(params))
    for b in batches(cfg, 2):
        params, state, _ = step(params, state, b)
    ckpt.save(path, (params, state), 2)
    _, place4 = ts.make_sharded_train_step(cfg, OPT, _mesh((4, 1)))
    fresh = init(cfg, seed=7).requires_grad_(True)
    like = place4(fresh, opt.adamw_init(fresh))
    (p4, s4), n, _ = ckpt.restore(path, like)
    first = next(p4.parameters())
    assert tuple(first.device_mesh.shape) == (4, 1), first.device_mesh

    def whole(named):
        return {k: shd.full_tensor(v.detach()).clone()
                for k, v in named.items()}
    return {"step": n, "saved": (whole(dict(params.named_parameters())),
                                 whole(state.m), whole(state.v)),
            "restored": (whole(dict(p4.named_parameters())), whole(s4.m),
                         whole(s4.v)),
            "placements": [str(p.placements) for p in p4.parameters()]}


def psum_input(rank: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.RandomState(10 + rank).randn(64, 32).astype(np.float32)
        * (rank + 1))


def case_psum():
    import torch.distributed as dist
    return {"sum": compression.compressed_psum(psum_input(dist.get_rank()))}


def main(cases: str, out_dir: str) -> None:
    """Run each of the comma-separated cases in one group."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        for case in cases.split(","):
            result = globals()[f"case_{case}"]()
            if dist.get_rank() == 0:
                torch.save(result, os.path.join(out_dir, f"{case}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
