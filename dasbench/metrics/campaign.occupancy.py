"""The campaign's occupancy: lane super-steps on which the lane was still
running, over lane super-steps run, summed over every sweep of the
window (`run_campaign`'s own counters `active_trips` / `lane_trips`)."""


def read(r):
    lanes = sum(s["lane_trips"] for s in r.sweeps)
    if not lanes:
        return None
    return sum(s["active_trips"] for s in r.sweeps) / lanes
