"""The system under test: the port's sweep entry, fed the benchmark's
arrays as the port's own types.

The only module of the benchmark that imports the program
(`repro_torch`); `harness` imports it once the environment is set, and
the reference never does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import campaign, faults, simulator as sim, soc
from repro_torch.core import workloads as port_wl

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
