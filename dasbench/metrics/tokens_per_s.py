"""Output tokens completed over the measured window: each request's
first token (from the prefill) and one a decode step, every request of
every batch the window served, over the window's whole length (host
clock, closed by the copy of the last batch's tokens to the host)."""


def read(r):
    done = [b for b in r.batches if not b["traced"]]
    return sum(b["batch"] * b["new_tokens"] for b in done) / r.window_s
