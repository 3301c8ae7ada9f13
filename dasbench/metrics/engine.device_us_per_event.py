"""Device-busy microseconds a simulated event: the union of the kernels'
intervals over the traced slice, over the events the slice's sweeps
retired (the sum of `SimResult.n_iters`). The events are fixed by the
inputs, whatever kernels the engine runs them with."""


def read(r):
    if r.trace is None:
        return None
    events = sum(s["events"] for s in r.traced)
    if not events or not r.trace["n_kernels"]:
        return None
    return r.trace["kernel_busy_s"] * 1e6 / events
