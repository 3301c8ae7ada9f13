"""Scenarios completed over the measured window: every scenario of every
sweep, over the window's whole length (host clock, closed by the copy of
the last sweep's results to the host)."""


def read(r):
    return sum(s["scenarios"] for s in r.sweeps) / r.window_s
