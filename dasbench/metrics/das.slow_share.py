"""The DAS policy's slow share: decisions that the tree sent to the slow
scheduler (ETF), over every decision, summed over the window's DAS
sweeps (the program's counters `n_slow` and `n_decisions`, summed on the
host from each sweep's result)."""


def read(r):
    das = [s for s in r.sweeps if s["mode"] == "DAS"]
    decisions = sum(s["decisions"] for s in das)
    if not decisions:
        return None
    return sum(s["slow"] for s in das) / decisions
