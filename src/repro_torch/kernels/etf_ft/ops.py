"""Dispatch for the decision-path kernels, by the device of the inputs.

A CUDA tensor launches the hand-written kernel (`kernel.py`) or raises;
a CPU tensor takes the plain PyTorch version (`ref.py`). There is no
switch and no fall back: a build or launch failure on the GPU is an
error. Every function takes an explicit leading scenario axis `[S]`
where the JAX reference (`repro/kernels/etf_ft/ops.py`) relied on
`vmap`, and all paths share the first-global-minimum tie-break and the
push-row operation order, so GPU and CPU runs agree bit for bit.

`LAUNCHES` counts kernel launches per kernel (the CPU path never adds);
`reset_launches()` zeroes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.etf_ft import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def _on_gpu(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"etf_ft: unsupported device {t.device}")


def etf_decide(avail, free, exec_t, now, slot_ok, pe_alive=None):
    """Masked ETF decision per scenario: avail/exec_t [S, R, P], free
    [S, P], now [S], slot_ok [S, R] bool, pe_alive [S, P] bool or None
    (all alive). Returns (slot, pe, feasible): int32, int32, bool, [S]."""
    if _on_gpu(avail):
        _, slot, pe, ok = kernel.etf_ft_search_masked(
            avail, free, exec_t, now, slot_ok, pe_alive)
    else:
        _, slot, pe, ok = ref.etf_ft_masked_reference(
            avail, free, exec_t, now, slot_ok, pe_alive)
    return slot, pe, ok


def push_rows(pfin, cost, pcl, pv, pe_cluster, bases, n_clusters):
    """Push-time availability rows: pfin/cost/pcl/pv [S, K, MP],
    pe_cluster [P], bases [S, K]. Returns [S, K, P]. `n_clusters` is
    unused (the reference's signature)."""
    if _on_gpu(pfin):
        return kernel.push_rows(pfin, cost, pcl, pv, pe_cluster, bases)
    return ref.push_rows_reference(pfin, cost, pcl, pv, pe_cluster, bases,
                                   n_clusters)


def avail_rows(tasks, finish, pe_of, preds, n_preds, out_kb, us_per_kb,
               pe_cluster, bases):
    """Push-time availability rows gathered from the simulator's state
    (`ref.avail_rows_reference` for the arguments): [S, K, P]. On the GPU
    one launch does the gathers and the push rows."""
    args = (tasks, finish, pe_of, preds, n_preds, out_kb, us_per_kb,
            pe_cluster, bases)
    if _on_gpu(tasks):
        return kernel.avail_rows(*args)
    return ref.avail_rows_reference(*args)


def etf_ft(avail, free, exec_t, now):
    """Unmasked search: [B, R, P] -> (ft_min, slot, pe), each [B]."""
    if _on_gpu(avail):
        return kernel.etf_ft_search(avail, free, exec_t, now)
    return ref.etf_ft_reference(avail, free, exec_t, now)
