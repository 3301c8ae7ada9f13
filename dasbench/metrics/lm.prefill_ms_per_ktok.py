"""Milliseconds a thousand prompt tokens: the prefill phases' host wall
(the caches' allocation and `lm.prefill`, to its synchronisation) over
the prompt tokens, every batch served untraced in the window."""


def read(r):
    done = [b for b in r.batches if not b["traced"]]
    tokens = sum(b["batch"] * b["prompt_len"] for b in done)
    if not tokens:
        return None
    return 1e6 * sum(b["prefill_s"] for b in done) / tokens
