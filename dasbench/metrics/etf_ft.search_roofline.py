"""The ETF search kernel's share of its roofline, in percent: the least
time a call could take on the H100 for its [S, R, P] shape (`roofline`:
its bytes over HBM bandwidth), over the mean time of the traced calls of
`etf_search_fixed`. S is the lanes of the traced sweeps' chunk, R the
ready slots the search scans, P the configuration's PEs; the PE mask is
read where the sweep carries fault plans."""
from dasbench import roofline


def read(r):
    if r.trace is None:
        return None
    calls = [v for k, v in r.trace["by_name"].items()
             if "etf_search_fixed" in k]
    n = sum(c for c, _ in calls)
    if not n:
        return None
    mean_us = sum(s for _, s in calls) * 1e6 / n
    sw = r.traced[0]
    P = sum(r.config["soc"]["pes_per_cluster"])
    bound = roofline.etf_search_bound_us(sw["chunk_lanes"],
                                         roofline.ETF_ROWS, P,
                                         alive=sw["plan"])
    return 100.0 * bound / mean_us
