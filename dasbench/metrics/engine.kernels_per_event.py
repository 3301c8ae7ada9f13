"""Kernels a simulated event: the kernels that ran in the traced slice,
over the events its sweeps retired (the sum of `SimResult.n_iters`)."""


def read(r):
    if r.trace is None:
        return None
    events = sum(s["events"] for s in r.traced)
    if not events or not r.trace["n_kernels"]:
        return None
    return r.trace["n_kernels"] / events
