"""Plain PyTorch versions of the decision kernels (`kernel.py`).

They mirror `repro/kernels/etf_ft/ref.py` operation for operation, so on
the CPU the port's schedules match the JAX reference bit for bit, and on
the GPU each CUDA kernel is held to these functions bit for bit. All
three take any number of leading batch axes.

The argmin is a first-global-minimum rule written out (minimum value,
then the smallest flat index holding it), not a reliance on how
`torch.argmin` breaks ties. Masked cells become `BIG` as in the
reference; invalid predecessors contribute -inf to the push rows.
"""
from __future__ import annotations

import torch

BIG = 3.4e38


def _first_min(flat: torch.Tensor):
    """(value, index) of the first minimum along the last axis."""
    m = flat.amin(dim=-1, keepdim=True)
    n = flat.shape[-1]
    ar = torch.arange(n, device=flat.device)
    idx = torch.where(flat == m, ar, n).amin(dim=-1)
    return flat.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


def _finish_times(avail, free, exec_t, now):
    return torch.maximum(torch.maximum(avail, free.unsqueeze(-2)),
                         now[..., None, None]) + exec_t


def etf_ft_reference(avail, free, exec_t, now):
    """avail/exec_t [..., R, P], free [..., P], now [...] ->
    (ft_min, slot, pe); non-finite finish times become BIG."""
    ft = _finish_times(avail, free, exec_t, now)
    ft = torch.where(torch.isfinite(ft), ft, BIG)
    P = ft.shape[-1]
    ft_min, idx = _first_min(ft.flatten(-2))
    return ft_min, (idx // P).to(torch.int32), (idx % P).to(torch.int32)


def etf_ft_masked_reference(avail, free, exec_t, now, slot_ok,
                            pe_alive=None):
    """Masked decision search: avail/exec_t [..., R, P], free [..., P],
    now [...], slot_ok [..., R] bool, pe_alive [..., P] bool or None (all
    alive). Returns (ft_min, slot, pe, feasible): the first global minimum
    of the flattened masked [R, P] matrix; slot 0 / pe 0 with
    feasible=False when every cell is masked."""
    ft = _finish_times(avail, free, exec_t, now)
    mask = slot_ok.unsqueeze(-1)
    if pe_alive is not None:
        mask = mask & pe_alive.unsqueeze(-2)
    ft = torch.where(mask & torch.isfinite(ft), ft, BIG)
    P = ft.shape[-1]
    ft_min, idx = _first_min(ft.flatten(-2))
    return (ft_min, (idx // P).to(torch.int32), (idx % P).to(torch.int32),
            ft_min < BIG)


def push_rows_reference(pfin, cost, pcl, pv, pe_cluster, bases,
                        n_clusters):
    """Push-time availability rows: pfin/cost/pcl/pv [..., K, MP] (pred
    finish, NoC transfer cost, pred cluster id, validity), pe_cluster
    [P], bases [..., K]; `n_clusters` is unused and kept for the
    reference's signature. Returns rows [..., K, P] =
    max(max over valid preds of (pfin + cost * (pcl != cluster(p))),
        bases)."""
    del n_clusters
    cross = pcl.unsqueeze(-1) != pe_cluster            # [..., K, MP, P]
    contrib = torch.where(pv.unsqueeze(-1),
                          pfin.unsqueeze(-1) + cost.unsqueeze(-1) * cross,
                          float("-inf"))
    return torch.maximum(contrib.amax(dim=-2), bases.unsqueeze(-1))
