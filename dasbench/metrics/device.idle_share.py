"""The share of a sweep in which no operation ran on the device: one minus
the union of the device's operation intervals in the traced sweep, over
the host wall of the same inputs swept untraced just before it (the
profiler's record of each kernel slows the sweep it traces, so the traced
slice's own length would count that cost as idle)."""


def read(r):
    if r.trace is None or not r.traced:
        return None
    return 1.0 - r.trace["busy_s"] / r.traced[0]["untraced_wall_s"]
