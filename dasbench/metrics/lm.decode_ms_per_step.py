"""Milliseconds a decode step: the decode phases' host wall (from the
prefill's synchronisation to the batch's last) over their steps, every
batch served untraced in the window."""


def read(r):
    done = [b for b in r.batches if not b["traced"]]
    steps = sum(b["new_tokens"] - 1 for b in done)
    if not steps:
        return None
    return 1e3 * sum(b["decode_s"] for b in done) / steps
