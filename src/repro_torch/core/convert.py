"""Carry state from the JAX reference into the port.

DAS has no weights: what both packages must share are the SoC tables,
the trained decision tree and the workloads. The reference's arrays
arrive here as numpy (`np.asarray` of each field) and leave as the
port's objects, with the reference's dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.core.simulator import DTree, SimParams
from repro_torch.core.workloads import FlatWorkload, validate_workload

_PARAM_DTYPES = (np.float32, np.int32, np.float32, np.int32, np.bool_,
                 np.float32, np.float32)


def sim_params_from_numpy(exec_pe, pe_cluster, pe_power, lut_cluster,
                          cluster_pe_mask, us_per_kb, cluster_energy,
                          device="cuda") -> SimParams:
    """`repro.core.simulator.SimParams` fields (numpy) -> `SimParams`."""
    dev = resolve(device)
    fields = (exec_pe, pe_cluster, pe_power, lut_cluster, cluster_pe_mask,
              us_per_kb, cluster_energy)
    return SimParams(*[torch.as_tensor(np.array(x, dtype=dt), device=dev)
                       for x, dt in zip(fields, _PARAM_DTYPES)])


def dtree_from_numpy(feat, thr, leaf, device="cuda") -> DTree:
    """`repro.core.simulator.DTree` fields (numpy; [3]/[3]/[4] or with a
    leading scenario axis) -> `DTree`."""
    dev = resolve(device)
    return DTree(
        feat=torch.as_tensor(np.array(feat, dtype=np.int32), device=dev),
        thr=torch.as_tensor(np.array(thr, dtype=np.float32), device=dev),
        leaf=torch.as_tensor(np.array(leaf, dtype=np.int32), device=dev))


def workload_from_numpy(*fields) -> FlatWorkload:
    """`repro.core.workloads.FlatWorkload` fields (numpy, in field order)
    -> the port's host-side `FlatWorkload`, validated when unstacked."""
    if len(fields) != len(FlatWorkload._fields):
        raise ValueError(f"workload_from_numpy: expected "
                         f"{len(FlatWorkload._fields)} fields, got "
                         f"{len(fields)}")
    wl = FlatWorkload(*[np.array(x) for x in fields])
    if wl.task_type.ndim == 1:
        validate_workload(wl)
    return wl
