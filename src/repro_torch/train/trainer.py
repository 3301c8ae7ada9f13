"""Fault-tolerant training loop, on one device or over a device mesh, on
the JAX package's `train/trainer.py`.

As in the reference:
  * checkpoint/restart: async atomic checkpoints every `ckpt_every`
    steps; `Trainer.fit` resumes from the latest checkpoint.
  * failure handling: a step that raises `RuntimeError` (which includes
    `torch.OutOfMemoryError` and a CUDA error) restores the latest
    checkpoint and goes on, up to `max_restarts` times;
    `inject_failure_at` simulates node loss in tests.
  * straggler mitigation: per-step wall times tracked with an EWMA;
    outliers (z > threshold) raise a straggler event, and `DASGate` (a
    depth-2 decision tree over event rate and step-time inflation, the
    paper's fast/slow split at the cluster level) decides whether to run
    the expensive re-plan.
  * the loop never blocks on I/O: data prefetch + async checkpointer.

The state is the model (`lm.LM`, fp32 at rest, gradients on) and its
`AdamWState`; both are updated in place, and a restore fills the model
in place. With a `mesh`, the state lives as DTensors on `param_spec`'s
placements and the step is `train_step.make_sharded_train_step`; a
restore puts the checkpoint (saved whole) on the placements of the
trainer's *current* mesh and rebuilds the step: the reference's elastic
re-mesh, since a restart may bring another mesh (set `trainer.mesh`).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.device import resolve
from repro_torch.models import lm
from repro_torch.train import optimizer as optim
from repro_torch.train import train_step as ts


#: checkpoints default to the checkout's `build/` (listed in .gitignore)
CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch"
               / "ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = CKPT_DIR
    keep_ckpts: int = 3
    log_every: int = 10
    microbatch: int = 0
    grad_compression: Optional[str] = None
    straggler_z: float = 3.0
    straggler_ewma: float = 0.9
    max_restarts: int = 3


class DASGate:
    """DAS-style fast/slow gate for the re-shard planning decision.

    Features: (straggler-event rate, relative step-time inflation).
    Fast path (LUT analog): keep the current plan — O(ns) decision.
    Slow path (ETF analog): run `replan` — expensive global planning.
    The depth-2 thresholds play the role of the trained classifier; they
    can be refit from logged events via core.classifier.DecisionTree.
    """

    def __init__(self, rate_thr: float = 0.2, inflation_thr: float = 1.5,
                 replan: Optional[Callable[[], None]] = None):
        self.rate_thr = rate_thr
        self.inflation_thr = inflation_thr
        self.replan = replan
        self.events = 0
        self.decisions = 0
        self.slow_calls = 0

    def decide(self, event_rate: float, inflation: float) -> str:
        self.decisions += 1
        if event_rate >= self.rate_thr and inflation >= self.inflation_thr:
            self.slow_calls += 1
            if self.replan is not None:
                self.replan()
            return "slow"
        return "fast"


class Trainer:
    def __init__(self, cfg, model_cfg, opt_cfg: optim.AdamWConfig,
                 data: Iterator, seed: int = 0, device="cuda", mesh=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data = data
        self.seed = seed
        self.device = resolve(device)
        self.mesh = mesh
        self.ckpter = ckpt.AsyncCheckpointer(cfg.ckpt_dir)
        self.gate = DASGate()
        self.inject_failure_at: Optional[int] = None
        self.metrics_log: list = []
        self.straggler_events = 0
        #: each restore from a checkpoint: {"step", "seconds"}
        self.restores: list = []

    # -- setup ---------------------------------------------------------------
    def init_state(self):
        """The model drawn from `seed` on a CPU generator, then moved to
        the device (so every device and every layout starts from the same
        weights), with gradients on, and zero AdamW moments; with a mesh,
        on `param_spec`'s placements."""
        gen = torch.Generator().manual_seed(self.seed)
        params = lm.lm_init(self.model_cfg, gen, device="cpu")
        params.to(self.device).requires_grad_(True)
        if self.mesh is not None:
            ts.place_state(params, None, self.model_cfg, self.mesh)
        return params, optim.adamw_init(params)

    def _compile(self):
        kw = dict(microbatch=self.cfg.microbatch,
                  grad_compression=self.cfg.grad_compression)
        if self.mesh is None:
            return ts.make_train_step(self.model_cfg, self.opt_cfg, **kw)
        return ts.make_sharded_train_step(self.model_cfg, self.opt_cfg,
                                          self.mesh, **kw)[0]

    # -- main loop -----------------------------------------------------------
    def fit(self, resume: bool = True) -> Dict[str, Any]:
        params, opt_state = self.init_state()
        start_step = 0
        if resume and ckpt.latest_step(self.cfg.ckpt_dir) is not None:
            (params, opt_state), start_step, _ = self._restore(
                (params, opt_state))
        restarts = 0
        step = start_step
        ewma, ewvar = None, 0.0
        compiled = None
        if hasattr(self.data, "set_step"):
            self.data.set_step(step)
        data_it = iter(self.data)

        while step < self.cfg.total_steps:
            try:
                batch = ts.to_device(next(data_it), self.device)
                if compiled is None:
                    compiled = self._compile()
                if (self.inject_failure_at is not None
                        and step == self.inject_failure_at):
                    self.inject_failure_at = None
                    raise RuntimeError("injected node failure")
                t0 = time.perf_counter()
                params, opt_state, metrics = compiled(params, opt_state,
                                                      batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0

                # straggler detection (EWMA z-score on step time)
                if ewma is None:
                    ewma = dt
                else:
                    d = dt - ewma
                    a = 1 - self.cfg.straggler_ewma
                    ewma += a * d
                    ewvar = (1 - a) * (ewvar + a * d * d)
                    z = d / (np.sqrt(ewvar) + 1e-9)
                    if z > self.cfg.straggler_z and step > start_step + 5:
                        self.straggler_events += 1
                        rate = self.straggler_events / max(
                            step - start_step, 1)
                        self.gate.decide(rate, dt / ewma)

                step += 1
                metrics["step"] = step
                metrics["step_time_s"] = dt
                self.metrics_log.append(metrics)
                if step % self.cfg.log_every == 0:
                    print(f"step {step:6d} loss {metrics.get('loss', 0):.4f}"
                          f" lr {metrics.get('lr', 0):.2e} {dt*1e3:.0f}ms")
                if step % self.cfg.ckpt_every == 0:
                    self.ckpter.save_async((params, opt_state), step,
                                           meta={"seed": self.seed})
                    ckpt.prune_old(self.cfg.ckpt_dir, self.cfg.keep_ckpts)
            except RuntimeError as e:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                print(f"[trainer] step {step} failed ({e}); "
                      f"restart {restarts}/{self.cfg.max_restarts}")
                self.ckpter.wait()
                if ckpt.latest_step(self.cfg.ckpt_dir) is not None:
                    (params, opt_state), step, _ = self._restore(
                        (params, opt_state))
                else:
                    params, opt_state = self.init_state()
                    step = 0
                if hasattr(self.data, "set_step"):
                    self.data.set_step(step)
                data_it = iter(self.data)
                compiled = None

        self.ckpter.wait()
        self.ckpter.save_async((params, opt_state), step,
                               meta={"seed": self.seed})
        self.ckpter.wait()
        return {
            "params": params, "opt_state": opt_state, "step": step,
            "metrics": self.metrics_log, "restarts": restarts,
            "straggler_events": self.straggler_events,
            "gate": (self.gate.decisions, self.gate.slow_calls),
        }

    def _restore(self, like):
        """The latest checkpoint: the model filled in place, the optimizer
        state's tensors on the trainer's device (and, with a mesh, on the
        placements of `like`, rebuilt here if the mesh has changed)."""
        t0 = time.perf_counter()
        first = next(like[0].parameters())
        if getattr(first, "device_mesh", None) is not self.mesh:
            like = self.init_state()
        out = ckpt.restore(self.cfg.ckpt_dir, like, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.restores.append({"step": out[1],
                              "seconds": time.perf_counter() - t0})
        return out
