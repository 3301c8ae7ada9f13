"""End-to-end training example: train a reduced-config model for a few
hundred steps with checkpointing, failure injection and resume, the full
loop at toy scale. The port of `examples/train_tiny_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm \
        [--arch yi-34b] [--steps 300] [--compress] [--fail-at 150] \
        [--device cpu]
"""
import argparse
import shutil

from repro_torch import configs
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.train import optimizer as optim
from repro_torch.train import trainer as tr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-34b", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=tr.CKPT_DIR + "_example")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = configs.get_smoke_config(args.arch, n_layers=4, d_model=128,
                                   vocab=512)
    data = Prefetcher(SyntheticLM(vocab=cfg.vocab, batch=8, seq_len=128,
                                  n_codebooks=cfg.n_codebooks))
    tcfg = tr.TrainerConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 5, 10),
        ckpt_dir=args.ckpt_dir, log_every=25,
        grad_compression="int8" if args.compress else None)
    ocfg = optim.AdamWConfig(lr_peak=3e-3, warmup_steps=args.steps // 10,
                             total_steps=args.steps)

    t = tr.Trainer(tcfg, cfg, ocfg, data, device=args.device)
    if args.fail_at:
        t.inject_failure_at = args.fail_at
    try:
        out = t.fit(resume=True)
    finally:
        data.close()
    print(f"\nfinished: step {out['step']}, restarts {out['restarts']}, "
          f"loss {out['metrics'][0]['loss']:.3f} -> "
          f"{out['metrics'][-1]['loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
