"""Training launcher, the port of `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 20 --batch 4 --seq 2048 [--ckpt-dir DIR] [--resume]

Trains on one card (`--device cuda`, the default; `--device cpu` runs the
plain PyTorch path on the CPU). --smoke uses the reduced same-family
config. Fault-tolerance flags: --inject-failure-at N simulates a node
failure, --microbatch M enables gradient accumulation, --compress int8
enables gradient compression. --data-parallel and --model-parallel take
only 1: a mesh of cards is the sharding slice's (ROADMAP queue 1 item
8b).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.train import optimizer as optim
from repro_torch.train import trainer as tr


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
    if args.data_parallel != 1 or args.model_parallel != 1:
        raise ValueError(
            f"--data-parallel {args.data_parallel} --model-parallel "
            f"{args.model_parallel}: the port trains on one device; a mesh "
            "of cards waits for the sharding slice (ROADMAP queue 1 item "
            "8b)")

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"device={args.device}")

    data = Prefetcher(SyntheticLM(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
        n_codebooks=cfg.n_codebooks))
    tcfg = tr.TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatch=args.microbatch,
        grad_compression=args.compress)
    ocfg = optim.AdamWConfig(lr_peak=args.lr, warmup_steps=args.steps // 10,
                             total_steps=args.steps)
    t = tr.Trainer(tcfg, cfg, ocfg, data, device=args.device)
    if args.inject_failure_at is not None:
        t.inject_failure_at = args.inject_failure_at
    try:
        out = t.fit(resume=args.resume)
    finally:
        data.close()
    print(f"done at step {out['step']}; restarts={out['restarts']} "
          f"stragglers={out['straggler_events']} "
          f"final loss={out['metrics'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
