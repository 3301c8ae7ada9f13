"""LM training on one device, with a checkpoint, an injected failure and
the restore, for every registered config.

Builds the model from a seed on a CPU generator and moves it to the
device (`Trainer.init_state`), then trains it `steps` steps through
`train.trainer.Trainer` on `data.pipeline.SyntheticLM` batches of
[batch, seq] tokens, with a checkpoint every `ckpt_every` steps
(`keep_ckpts` kept) and a failure injected before step `fail_at + 1`:
the trainer restores the latest checkpoint and replays the steps after
it, so the steps between the checkpoint and the failure run twice, from
the same state on the same batches. Then it scores one held-out batch
with the trained weights: the loss and the logits under
`inference_mode` (the kernels' route: the SSD kernel in each Mamba-2
layer, flash and the RG-LRU scan where the model has them), the same
with autograd recording (the training route, the plain forms), no
backward, and the logits on the training route in fp32 (the control: how
far the compute dtype's own rounding moves them).

Run on the GPU with `python -m repro_torch.bench.lm_train [--arch
mamba2-780m] [--steps 18] [--batch 4] [--seq 2048] [--remat dots]`; `run(device="cpu",
cfg=...)` with a small config takes the plain path on the CPU. `run`
returns its numbers: step times and tokens per second (the median step,
after the first, which builds the library handles; and over the whole
window of `fit`, replayed steps, checkpoints and the restore included),
the seconds the failure cost (the restore and the replayed steps), peak
device memory, each checkpoint's bytes and seconds, the restore's
seconds, the loss curve, each replayed step's loss beside the first
run's, the held-out losses and the logits' relative RMS differences,
and the kernels' launches during training and during the held-out
scoring. It never resets the launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import time

import torch

from repro_torch import configs
from repro_torch.bench.lm_serve import launches, _diff, _sync
from repro_torch.core.device import resolve
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import lm
from repro_torch.train import optimizer as optim
from repro_torch.train import train_step as ts
from repro_torch.train import trainer as tr


def run(device="cuda", cfg=None, arch: str = "mamba2-780m", seed: int = 0,
        batch: int = 4, seq: int = 2048, steps: int = 18,
        ckpt_every: int = 10, fail_at: int = 15, keep_ckpts: int = 1,
        lr: float = 1e-3, ckpt_dir: str = tr.CKPT_DIR + "_bench") -> dict:
    """Train `cfg` (default: the full config of `arch`) as the module's
    docstring says, in a fresh `ckpt_dir`, deleted at the end."""
    dev = resolve(device)
    cfg = cfg or configs.get_config(arch)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = {"arch": cfg.name, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "dtype": cfg.dtype, "remat": cfg.remat, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "batch": batch,
           "seq": seq, "steps": steps, "ckpt_every": ckpt_every,
           "fail_at": fail_at}
    data = SyntheticLM(vocab=cfg.vocab, batch=batch, seq_len=seq,
                       n_codebooks=cfg.n_codebooks, seed=seed)
    t = tr.Trainer(
        tr.TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=ckpt_dir, keep_ckpts=keep_ckpts,
                         log_every=steps + 1),
        cfg, optim.AdamWConfig(lr_peak=lr, warmup_steps=max(steps // 10, 1),
                               total_steps=steps),
        data, seed=seed, device=dev)
    t.inject_failure_at = fail_at
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n0 = launches()
    t0 = time.perf_counter()
    try:
        res = t.fit(resume=False)
        _sync(dev)
        out["fit_s"] = time.perf_counter() - t0
        out["train_launches"] = _diff(launches(), n0)
        if dev.type == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        p = res["params"]
        out["params"] = lm.param_count(p)
        out["restarts"], out["final_step"] = res["restarts"], res["step"]
        log = res["metrics"]
        out["losses"] = [(m["step"], m["loss"]) for m in log]
        first = {}
        replay = []
        replay_s = 0.0
        for m in log:
            if m["step"] in first and m["step"] <= fail_at:
                replay.append((m["step"], first[m["step"]], m["loss"]))
                replay_s += m["step_time_s"]
            first.setdefault(m["step"], m["loss"])
        out["replayed"] = replay
        times = [m["step_time_s"] for m in log[1:]]
        out["step_s_median"] = statistics.median(times)
        out["step_s_min"] = min(times)
        out["tok_per_s"] = batch * seq / out["step_s_median"]
        # the whole window: every step run, the replayed ones included,
        # and the steps that count, over fit's seconds
        out["tok_per_s_window"] = len(log) * batch * seq / out["fit_s"]
        out["goodput_tok_per_s"] = res["step"] * batch * seq / out["fit_s"]
        out["saves"] = t.ckpter.saves
        out["restores"] = t.restores
        out["failure_cost_s"] = sum(r["seconds"] for r in t.restores) \
            + replay_s

        held = ts.to_device(SyntheticLM(
            vocab=cfg.vocab, batch=batch, seq_len=seq,
            n_codebooks=cfg.n_codebooks, seed=seed + 1000).__next__(), dev)

        def score(c):
            loss, _ = lm.loss_fn(p, c, held)
            logits, _, _ = lm.forward(
                p, c, held["tokens"], prefix_embeds=held.get("prefix_embeds"))
            # the padded vocabulary's columns (-1e9) left out
            return float(loss.detach()), logits[..., :c.vocab].detach().float()

        n0 = launches()
        with torch.inference_mode():
            loss_k, logits_k = score(cfg)
        _sync(dev)
        out["heldout_launches"] = _diff(launches(), n0)
        n0 = launches()
        with torch.enable_grad():
            loss_t, logits_t = score(cfg)
            _, logits_32 = score(dataclasses.replace(cfg, dtype="float32"))
        out["heldout_train_route_launches"] = _diff(launches(), n0)
        out["heldout_loss_kernels"] = loss_k
        out["heldout_loss_train_route"] = loss_t
        out["heldout_rel"] = abs(loss_k - loss_t) / abs(loss_t)
        out["heldout_logits_rel"] = _rel_rms(logits_k, logits_t)
        out["heldout_logits_rel_fp32"] = _rel_rms(logits_t, logits_32)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def _rel_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref|| / ||ref|| over every element."""
    return float((x - ref).norm() / ref.norm())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="mamba2-780m", choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=18)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", choices=("none", "full", "dots"),
                    default=None, help="default: the config's")
    a = ap.parse_args()
    cfg = configs.get_config(a.arch)
    if a.remat:
        cfg = dataclasses.replace(cfg, remat=a.remat)
    out = run(a.device, cfg=cfg, steps=a.steps, batch=a.batch, seq=a.seq)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
