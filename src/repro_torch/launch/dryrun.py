"""Multi-pod dry-run, on the JAX package's `launch/dryrun.py`: build and
run every (architecture x input shape) cell once on a production mesh of
a fake process group, with no memory, and record what the roofline
(`launch/roofline.py`) reads.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      [--out build/repro_torch/dryrun_results.json]

For each cell it opens a fake process group of 256 (16 x 16) or 512
(2 x 16 x 16) ranks (`torch.testing._internal.distributed.fake_pg`: every
collective returns at once, with the right shapes), builds the
parameters, the optimizer state, the inputs and the caches as DTensors
on their placements over fake tensors (`FakeTensorMode`: shapes and
dtypes, no storage), and runs the cell's sharded step once
(`train/train_step.py`: forward, backward and AdamW for a train cell, a
prefill or a decode step otherwise) as rank 0. A dispatch mode below
DTensor sees the ops on the local shards, and counts:

  * dot_flops_per_dev: the matrix products' FLOPs (mm, bmm, addmm,
    baddbmm; einsums lower to them) on the local shards;
  * dot_bytes_per_dev: their operands' and outputs' bytes;
  * collective_bytes: the output bytes of each collective DTensor issues
    (all-gather, all-reduce, reduce-scatter, all-to-all), per device;
  * memory: the local shards' bytes of the step's arguments.

Layer loops are Python loops, so every op is counted as often as it
runs (the reference weights its HLO loop bodies by trip counts). On fake
tensors the models take the plain forms at the kernel sites
(`models/modules.py::plain_forms`), as the reference's dry-run lowers
them. The fake group is process-global: run the dry-run in a process of
its own, never in one that holds another process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.shapes import SHAPES, applicable
from repro_torch.models import lm
from repro_torch.models import modules as nn
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as optim
from repro_torch.train import train_step as ts

#: the default record, in the checkout's `build/` (listed in .gitignore)
OUT = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch"
          / "dryrun_results.json")

_DOTS = ("mm", "bmm", "addmm", "baddbmm")
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _fake_mode():
    """The active FakeTensorMode, or a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for m in _get_current_dispatch_mode_stack():
        if isinstance(m, FakeTensorMode):
            return m
    return FakeTensorMode()


def abstract_params(cfg):
    """The model's parameters as fake tensors (shapes and dtypes only)."""
    with _fake_mode():
        return lm.lm_init(cfg, torch.Generator(), device="cpu")


def input_specs(arch: str, shape_name: str, cfg=None) -> Dict[str, Any]:
    """Fake stand-ins for every model input of the cell (tokens as int64,
    the port's index dtype)."""
    cfg = cfg or configs.get_config(arch)
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    i64 = torch.int64
    out: Dict[str, Any] = {"kind": spec.kind}
    with _fake_mode():
        def tok(*shape):
            return torch.zeros(shape, dtype=i64)

        if spec.kind in ("train", "prefill"):
            n_pre = cfg.n_prefix_embeds
            s_txt = S - n_pre
            shape = (B, cfg.n_codebooks, s_txt) if cfg.n_codebooks > 1 \
                else (B, s_txt)
            pre = (torch.zeros((B, n_pre, cfg.d_model), dtype=torch.bfloat16)
                   if n_pre else None)
            if spec.kind == "train":
                out["batch"] = {"tokens": tok(*shape), "labels": tok(*shape)}
                if pre is not None:
                    out["batch"]["prefix_embeds"] = pre
                return out
            out["tokens"] = tok(*shape)
            if pre is not None:
                out["prefix_embeds"] = pre
            out["caches"] = lm.init_caches(cfg, B, S, device="cpu")
            return out
        # decode: one new token against a cache of size S
        out["token"] = tok(*((B, cfg.n_codebooks) if cfg.n_codebooks > 1
                             else (B,)))
        out["pos"] = S - 1
        out["kv_valid"] = torch.full((B,), S, dtype=torch.int32)
        out["caches"] = lm.init_caches(cfg, B, S, device="cpu")
        return out


def production_variant(arch: str, shape_name: str, cfg) -> dict:
    """The per-arch 'optimized' profile, the reference's:
      * MoE archs: shard-local dispatch (moe_shards=16) but in decode
      * train cells: dots-remat (not recurrentgemma), bf16 weights with
        fp32 masters; mamba2 without sequence parallelism
      * serve cells: bf16 checkpoint; MLA archs decode weight-absorbed
    """
    v: dict = {}
    kind = SHAPES[shape_name].kind
    if cfg.mlp_type == "moe" and kind != "decode":
        v["moe_shards"] = 16
    if kind == "train":
        if arch != "recurrentgemma-9b":
            v["remat"] = "dots"
        v["bf16_params"] = True
        if arch == "mamba2-780m":
            v["sequence_parallel"] = False
    else:
        v["bf16_params"] = True
        if cfg.attn_impl == "mla" and kind == "decode":
            v["mla_absorb"] = True
    return v


def apply_variant(cfg, variant: Optional[dict]):
    """Apply a variant to the model config. Keys: remat, moe_shards,
    mla_absorb, shard_strategy (model-level); bf16_params, cast_params,
    sequence_parallel (step-level, read by `lower_cell`). The reference's
    `use_pallas` has no counterpart: the port has no kernel knob."""
    if not variant:
        return cfg
    upd = {k: variant[k] for k in ("remat", "mla_absorb", "shard_strategy")
           if k in variant}
    if "moe_shards" in variant and cfg.moe is not None:
        upd["moe"] = dataclasses.replace(
            cfg.moe, n_dispatch_shards=variant["moe_shards"])
    return dataclasses.replace(cfg, **upd) if upd else cfg


@functools.lru_cache(maxsize=None)
def _counts(cfg):
    """(parameters, active parameters) of the config's model."""
    params = abstract_params(cfg)
    return lm.param_count(params), lm.active_param_count(cfg, params)


def model_flops_for_cell(cfg, shape_name: str) -> Dict[str, float]:
    """Analytic MODEL_FLOPS: 6*N_active*tokens (train) / 2*N_active*tokens
    (inference), the reference's accounting for the useful-compute
    ratio."""
    spec = SHAPES[shape_name]
    n_total, n_active = _counts(cfg)
    if spec.kind == "train":
        mf = 6.0 * n_active * spec.global_batch * spec.seq_len
    elif spec.kind == "prefill":
        mf = 2.0 * n_active * spec.global_batch * spec.seq_len
    else:  # decode: one token per sequence
        mf = 2.0 * n_active * spec.global_batch
    return {"n_params": float(n_total), "n_active_params": float(n_active),
            "model_flops_global": mf}


# ---------------------------------------------------------------------------
# counting on the local shards
# ---------------------------------------------------------------------------
def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matrix products and the collectives one rank runs. An op
    on DTensors is let through (NotImplemented) so that DTensor runs it,
    and its local products and its collectives come back here as ops on
    plain (local) tensors."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.collective_bytes: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in _DOTS:
            a, b = args[-2], args[-1]
            batch = a.shape[0] if a.ndim == 3 else 1
            m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
            self.dot_flops += 2.0 * batch * m * k * n
            self.dot_bytes += sum(_nbytes(t) for t in args
                                  if isinstance(t, torch.Tensor)) \
                + _nbytes(out)
        elif name in _COLLECTIVES:
            outs = out if isinstance(out, (list, tuple)) else [out]
            kind = _COLLECTIVES[name]
            self.collective_bytes[kind] = self.collective_bytes.get(
                kind, 0.0) + sum(_nbytes(t) for t in outs
                                 if isinstance(t, torch.Tensor))
        return out


def _local_bytes(*trees) -> int:
    total = 0

    def add(_, t):
        nonlocal total
        total += _nbytes(getattr(t, "_local_tensor", t))
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            tree = dict(tree.named_parameters())
        sharding.map_tree(add, tree)
    return total


def _fake_group(world: int) -> None:
    """A fake process group of `world` ranks, this process rank 0 (the
    one in place if it has that size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               cfg=None, opt_override: Optional[dict] = None,
               variant: Optional[dict] = None, mesh_shape=None):
    """Build the cell on a fake group, its arguments placed: returns
    (run, meta), where run() runs the cell's step once and returns the
    arguments' local bytes.
    `mesh_shape` (data, model) replaces the production mesh (tests run a
    small cell on 2 x 2)."""
    cfg = apply_variant(cfg or configs.get_config(arch), variant)
    variant = variant or {}
    skip = applicable(cfg, shape_name)
    if skip:
        raise ValueError(f"cell skipped: {skip}")
    if mesh_shape is None:
        _fake_group(512 if multi_pod else 256)
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                            device="cpu")
    else:
        from torch.distributed.device_mesh import init_device_mesh
        _fake_group(math.prod(mesh_shape))
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
    mode = _fake_mode()
    kind = SHAPES[shape_name].kind
    with mode:
        spec = input_specs(arch, shape_name, cfg)
        params = abstract_params(cfg)
        if variant.get("bf16_params"):
            params = nn.map_params(params, lambda p: p.to(torch.bfloat16)
                                   if p.dtype == torch.float32 else p)
    if kind == "train":
        step, place = ts.make_sharded_train_step(
            cfg, optim.AdamWConfig(**(opt_override or {})), mesh,
            sequence_parallel=variant.get("sequence_parallel", True),
            cast_params=variant.get("cast_params"))
        with mode:
            p, _ = place(params.requires_grad_(True), None)
            state = optim.adamw_init(
                p, keep_master=bool(variant.get("bf16_params")))
            batch = ts.place_batch(spec["batch"], mesh, cfg)
        args = (p, state, batch)
        arg_bytes = _local_bytes(p, state.m, state.v, state.master, batch)
    else:
        step, place = ts.make_sharded_serve_step(cfg, mesh, kind)
        with mode:
            p, caches = place(params, spec["caches"])
            if kind == "prefill":
                tokens = ts.place_batch({"t": spec["tokens"]}, mesh)["t"]
                args = (p, tokens, caches, spec.get("prefix_embeds"))
            else:
                tokens = ts.place_batch({"t": spec["token"]}, mesh)["t"]
                args = (p, tokens, spec["pos"], caches, spec["kv_valid"])
        arg_bytes = _local_bytes(p, caches, tokens)

    def run():
        with mode:
            step(*args)
        return arg_bytes
    meta = {"arch": arch, "shape": shape_name, "kind": kind,
            "multi_pod": multi_pod, "n_devices": mesh.size()}
    return run, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, variant: Optional[dict] = None,
             mesh_shape=None, cfg=None) -> Dict[str, Any]:
    t0 = time.time()
    cfg = apply_variant(cfg or configs.get_config(arch), variant)
    skip = applicable(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": skip}
    run, meta = lower_cell(arch, shape_name, multi_pod, cfg=cfg,
                           variant=variant, mesh_shape=mesh_shape)
    t_build = time.time() - t0
    counter = Counter()
    with counter:
        arg_bytes = run()
    res: Dict[str, Any] = dict(meta)
    res["status"] = "ok"
    res["build_s"] = round(t_build, 1)
    res["run_s"] = round(time.time() - t0 - t_build, 1)
    res["dot_flops_per_dev"] = counter.dot_flops
    res["dot_bytes_per_dev"] = counter.dot_bytes
    res["collective_bytes"] = counter.collective_bytes
    res["memory"] = {"argument_size_in_bytes": float(arg_bytes)}
    res.update(model_flops_for_cell(cfg, shape_name))
    if verbose:
        print(f"[{arch} x {shape_name} x "
              f"{'2pod' if multi_pod else '1pod'}] ok "
              f"run {res['run_s']:.0f}s "
              f"dotflops/dev {res['dot_flops_per_dev']:.4g} "
              f"args/dev {arg_bytes / 1e9:.2f}GB "
              f"coll {sum(counter.collective_bytes.values()) / 1e9:.3f}GB",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                try:
                    variant = None
                    if args.profile == "optimized":
                        variant = production_variant(a, s,
                                                     configs.get_config(a))
                    res = run_cell(a, s, multi_pod=mp, variant=variant)
                    res["profile"] = args.profile
                except Exception as e:  # a failing cell is a bug: record it
                    print(f"[{a} x {s} x {'2pod' if mp else '1pod'}] "
                          f"FAILED: {type(e).__name__}: {e}", flush=True)
                    where = "".join(traceback.format_tb(e.__traceback__)
                                    [-6:])
                    res = {"arch": a, "shape": s, "multi_pod": mp,
                           "status": "failed",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "where": where[-4000:]}
                results.append(res)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "failed" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED of {len(results)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
