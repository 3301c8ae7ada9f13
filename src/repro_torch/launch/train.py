"""Training launcher, the port of `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 20 --batch 4 --seq 2048 [--ckpt-dir DIR] [--resume]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch phi3-mini-3.8b --smoke --data-parallel 2 --model-parallel 2

Trains over a (--data-parallel, --model-parallel) mesh of the process
group (`launch/mesh.py::make_local_mesh`, clamped to the group's size):
under `torchrun` (WORLD_SIZE set) it joins the group, otherwise it
starts a group of one (`nccl` on `--device cuda`, the default; `gloo` on
`--device cpu`, which runs the plain PyTorch path on the CPU). --smoke
uses the reduced same-family config. Fault-tolerance flags:
--inject-failure-at N simulates a node failure, --microbatch M enables
gradient accumulation, --compress int8 enables gradient compression.
"""
from __future__ import annotations

import argparse
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.device import resolve
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import mesh as meshlib
from repro_torch.train import optimizer as optim
from repro_torch.train import trainer as tr


def _join_group(device: str):
    """Join the process group `torchrun` describes (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR/PORT), or start one of a single rank on a free
    local port. Returns (this rank's device, whether a group was started
    here; an existing group is used as it is)."""
    dev = resolve(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, world_size=1, rank=0,
                                init_method=f"tcp://localhost:{port}")
    return dev, True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=tr.CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress", default=None, choices=[None, "int8"])
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    device, own_group = _join_group(args.device)
    mesh = meshlib.make_local_mesh(args.data_parallel, args.model_parallel,
                                   device=device.type)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"devices={dist.get_world_size()} device={device}")

    data = Prefetcher(SyntheticLM(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
        n_codebooks=cfg.n_codebooks))
    tcfg = tr.TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatch=args.microbatch,
        grad_compression=args.compress)
    ocfg = optim.AdamWConfig(lr_peak=args.lr, warmup_steps=args.steps // 10,
                             total_steps=args.steps)
    t = tr.Trainer(tcfg, cfg, ocfg, data, device=device, mesh=mesh)
    if args.inject_failure_at is not None:
        t.inject_failure_at = args.inject_failure_at
    try:
        out = t.fit(resume=args.resume)
    finally:
        data.close()
        if own_group:
            dist.destroy_process_group()
    print(f"done at step {out['step']}; restarts={out['restarts']} "
          f"stragglers={out['straggler_events']} "
          f"final loss={out['metrics'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
