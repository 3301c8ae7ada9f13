"""The system under test: the port's sweep entry, fed the benchmark's
arrays as the port's own types (`Program`), and the port's language
model, holding the benchmark's weights, with its serving entry points
(`LMProgram`).

The only module of the benchmark that imports the program
(`repro_torch`); `harness` imports it once the environment is set, and
the reference never does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.bench import common, lm_serve
from repro_torch.configs import base as model_base
from repro_torch.core import campaign, faults, simulator as sim, soc
from repro_torch.core import workloads as port_wl
from repro_torch.models import lm, transformer

from dasbench.check import ROW_FIELDS


def soc_config(config: dict) -> soc.SoCConfig:
    """The configuration's SoC tables as the port's `SoCConfig`: PE to
    cluster, membership mask, execution times, cluster power, task
    energies and the LUT's most energy-efficient cluster a task type."""
    s = config["soc"]
    per = s["pes_per_cluster"]
    pe_cluster = np.concatenate([np.full(n, c, np.int32)
                                 for c, n in enumerate(per)])
    mask = np.stack([pe_cluster == c for c in range(len(per))])
    exec_t = np.array([[np.inf if v is None else v for v in row]
                       for row in s["exec_time_us"]], np.float32)
    power = np.array(s["cluster_power_w"], np.float32)
    energy = np.where(np.isfinite(exec_t), exec_t * power[None, :],
                      np.float32(np.inf)).astype(np.float32)
    return soc.SoCConfig(
        n_pes=int(pe_cluster.shape[0]), n_clusters=len(per),
        n_task_types=len(s["task_types"]), pe_cluster=pe_cluster,
        cluster_pe_mask=mask, exec_time=exec_t, cluster_power=power,
        task_energy=energy,
        lut_cluster=np.argmin(energy, axis=1).astype(np.int32),
        us_per_kb=float(np.float32(s["noc_us_per_kb"])))


class Program:
    """The port on one device, set up for one configuration."""

    def __init__(self, config: dict, device: str = "cuda"):
        self.device = device
        self.params = sim.make_params(soc_config(config), device=device)
        self.modes = {v: k for k, v in sim.MODE_NAMES.items()}
        self._trees = {}

    def chunk(self) -> int:
        """The chunk size every sweep of the port's benchmark pipeline
        uses (`bench.common.batch_size`: autotuned once a device, then
        read from its cache)."""
        return common.batch_size(self.device)

    def tree(self, policy) -> sim.DTree:
        """A policy's tree (`inputs.Policy`) as the port's `DTree`, on the
        device; made at its first sweep (the warm-up) and kept."""
        if policy not in self._trees:
            dev = self.params.exec_pe.device
            self._trees[policy] = sim.DTree(
                feat=torch.tensor(policy.feat, dtype=torch.int32, device=dev),
                thr=torch.tensor(policy.thr, dtype=torch.float32, device=dev),
                leaf=torch.tensor(policy.leaf, dtype=torch.int32, device=dev))
        return self._trees[policy]

    def sweep(self, mode: str, wl, plan, batch: int, policy=None):
        """One sweep through `campaign.run_campaign`: (host numpy result,
        campaign stats). DAS runs the policy's tree and refuses to run
        without one, where the port would fall back to its always-fast
        tree; no other mode takes one."""
        if (self.modes[mode] == sim.MODE_DAS) != (policy is not None):
            raise ValueError(f"mode {mode} with policy {policy!r}")
        pwl = port_wl.FlatWorkload(*wl)
        pplan = None if plan is None else faults.FaultPlan(*plan)
        kw = {} if policy is None else {"tree": self.tree(policy)}
        out = campaign.run_campaign(
            self.modes[mode], pwl, self.params, plan=pplan,
            batch_size=batch, device=self.device, **kw)
        return out.result, out.stats

    @staticmethod
    def rows(result, lanes) -> list:
        """The fields the check reads, of the given lanes."""
        return [{k: np.asarray(getattr(result, k)[j]).copy()
                 for k in ROW_FIELDS} for j in lanes]


# the dataclass of each nested group of the port's `ModelConfig`
_GROUPS = {"mla": model_base.MLAConfig, "moe": model_base.MoEConfig,
           "rglru": model_base.RGLRUConfig, "ssd": model_base.SSDConfig}


def model_config(block: dict) -> model_base.ModelConfig:
    """A configuration file's `port` block as the port's `ModelConfig`:
    its fields by name, a nested group as its dataclass, a list as a
    tuple."""
    kw = {k: (_GROUPS[k](**v) if k in _GROUPS and v is not None
              else tuple(v) if isinstance(v, list) else v)
          for k, v in block.items()}
    cfg = model_base.ModelConfig(**kw)
    cfg.validate()
    return cfg


def _layer(cfg, w: dict, i: int) -> dict:
    """Layer i of the benchmark's weights (`reference/lm_ref.specs`) in
    the port's tree: the same tensors, viewed in the port's shapes."""
    p = f"layers.{i}."
    H, m = cfg.n_heads, cfg.mla
    attn = {"w_q": w[p + "q"].view(cfg.d_model, H, -1),
            "w_dkv": w[p + "kv_a"], "kv_norm": w[p + "kv_norm"],
            "w_uk": w[p + "k_b"].view(m.kv_lora_rank, H, -1),
            "w_uv": w[p + "v_b"].view(m.kv_lora_rank, H, -1),
            "w_kr": w[p + "k_rope"], "wo": w[p + "o"]}
    if p + "router" in w:
        mlp = {"router": w[p + "router"],
               **{f"w_{k}": w[f"{p}experts.{k}"]
                  for k in ("gate", "up", "down")}}
        if p + "shared.gate" in w:
            mlp["shared"] = {f"w_{k}": w[f"{p}shared.{k}"]
                             for k in ("gate", "up", "down")}
    else:
        mlp = {f"w_{k}": w[f"{p}mlp.{k}"] for k in ("gate", "up", "down")}
    return {"ln1": w[p + "attn_norm"], "attn": attn,
            "ln2": w[p + "mlp_norm"], "mlp": mlp}


class LMProgram:
    """The port's language model on one device, serving the way the
    configuration file's `port` block states: `lm.prefill` into the
    port's caches (with the `port_prefill` fields changed), then
    `lm.decode_step`s, a MoE at the port's no-drop serving capacity
    (`bench.lm_serve.serving_config`). Its parameters are the
    benchmark's weights themselves, viewed, not copied."""

    def __init__(self, config: dict, weights: dict, device: str = "cuda"):
        if (config["port"].get("attn_impl") != "mla"
                or config["port"]["mla"]["q_lora_rank"]):
            raise ValueError("the lane maps MLA blocks without q_lora only")
        self.device = device
        self.cfg = lm_serve.serving_config(model_config(config["port"]))
        self.prefill_cfg = dataclasses.replace(
            self.cfg, **config.get("port_prefill", {}))
        stack = transformer.empty_stack(self.cfg)
        for layers, i, _, idx in transformer.init_order(self.cfg, stack):
            layers[i] = _layer(self.cfg, weights, idx)
        self.params = lm.LM({"embed": weights["embed"], "stack": stack,
                             "final_norm": weights["norm"],
                             "head": weights["head"]})

    def prefill(self, tokens: torch.Tensor, max_len: int,
                rows: int | None = None, calls: int | None = None):
        """(last logits [B, V], caches) of prompts [B, P] in fresh caches
        of `max_len` positions, in the compute dtype: `lm.prefill` of
        `rows` requests a call (all by default) into their rows of the
        caches, the first `calls` calls only where given (a warm-up's;
        the other rows' logits are then zero)."""
        B = tokens.shape[0]
        rows = rows or B
        caches = lm.init_caches(self.cfg, B, max_len,
                                dtype=lm.compute_dtype(self.cfg),
                                device=self.device)
        if rows >= B:
            return lm.prefill(self.params, self.prefill_cfg, tokens, caches)
        last = None
        for i, b in enumerate(range(0, B, rows)):
            if calls is not None and i >= calls:
                break
            part = pytree.tree_map(lambda t: t[b:b + rows], caches)
            logits, _ = lm.prefill(self.params, self.prefill_cfg,
                                   tokens[b:b + rows], part)
            if last is None:
                last = logits.new_zeros((B, logits.shape[-1]))
            last[b:b + rows] = logits
        return last, caches

    def decode_step(self, token: torch.Tensor, pos: int, caches):
        """(logits [B, V], caches) of tokens [B] at cache offset `pos`."""
        return lm.decode_step(self.params, self.cfg, token, pos, caches)
