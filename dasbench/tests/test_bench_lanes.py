"""Where the card's sweep departs from the float64 reference, and that the
departure is the program's float32 arithmetic and not the card: the same
lanes of a full-grid sweep (560 lanes, the timed path) are run alone on
the card, eagerly on the card, and by the port on the CPU, and must be
equal; each lane's gaps to the reference are printed beside it.

    python -m pytest -s -m card dasbench/tests/test_bench_lanes.py
"""
import json

import numpy as np
import pytest

from dasbench import check, inputs
from dasbench.reference import ref_sim

from dasbench.tests.conftest import ROOT

SEED = 2**31 + 253
FIELDS = check.ROW_FIELDS + ("pe_of", "n_slow")


def _rows(res, idx):
    return [{k: np.asarray(getattr(res, k)[j]) for k in FIELDS} for j in idx]


def _equal(a, b, rel_mean=0.0):
    """Every field bit for bit, the mean latency within `rel_mean`."""
    for k in FIELDS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if k == "avg_exec_us" and rel_mean:
            if abs(float(x) - float(y)) > rel_mean * abs(float(y)):
                return False
        elif x.tobytes() != y.tobytes():
            return False
    return True


@pytest.mark.card
@pytest.mark.parametrize("mode", ["ETF", "LUT", "DAS"])
def test_card_lanes_equal_alone_eager_and_cpu(mode, card):
    from dasbench.program import Program
    from repro_torch.core import simulator as sim
    from repro_torch.core import workloads as pwl

    cfg = json.loads((ROOT / "dasbench" / "configs" / "dssoc19-healthy.json")
                     .read_text())
    soc = ref_sim.Soc.from_config(cfg["soc"])
    gpu, cpu = Program(cfg, "cuda"), Program(cfg, "cpu")
    # DAS runs the das-grid cell's tree
    das = json.loads((ROOT / "dasbench" / "traffic" / "das-grid.json")
                     .read_text())["policy"]
    sw = inputs.Traffic(cfg, {"modes": [mode], "shape": "grid",
                              "policy": das if mode == "DAS" else {}}
                        ).sweep(SEED, 0)
    pol = sw.policy
    full, _ = gpu.sweep(mode, sw.wl, None, 1024, pol)
    # the eight longest lanes, where the gaps sit, and eight across the grid
    longest = np.argsort(-np.asarray(full.n_iters), kind="stable")[:8]
    lanes = np.unique(np.concatenate([longest, np.arange(3, 560, 70)]))
    sub = pwl.FlatWorkload(*[np.asarray(x)[lanes] for x in sw.wl])
    alone, _ = gpu.sweep(mode, sub, None, 1024, pol)
    eager = sim.to_numpy(sim._run_batch(
        sim._simulate_eager, gpu.modes[mode], sub, gpu.params,
        tree=None if pol is None else gpu.tree(pol), device="cuda"))
    host, _ = cpu.sweep(mode, sub, None, 1024, pol)
    n = len(lanes)
    a_full, a_alone = _rows(full, lanes), _rows(alone, range(n))
    a_eager, a_cpu = _rows(eager, range(n)), _rows(host, range(n))
    same = {
        "560 lanes vs alone": [_equal(x, y) for x, y in zip(a_full, a_alone)],
        "graph vs eager": [_equal(x, y) for x, y in zip(a_alone, a_eager)],
        "card vs cpu": [_equal(x, y, 1e-6) for x, y in zip(a_alone, a_cpu)],
    }
    print(f"\n== {mode}, seed {SEED}, lanes {lanes.tolist()}")
    for k, v in same.items():
        print(f"  equal, {k}: {sum(v)} of {n}")
    mean_rel = max(abs(float(x["avg_exec_us"]) - float(y["avg_exec_us"]))
                   / float(y["avg_exec_us"]) for x, y in zip(a_alone, a_cpu))
    print(f"  card vs cpu, worst avg_exec_us gap: {mean_rel:.3e}")
    for i, j in enumerate(lanes):
        wl, _ = inputs.scenario(sw, int(j))
        nt = int(wl.n_tasks)
        ref = ref_sim.simulate_ref(ref_sim.MODES[mode], wl, soc,
                                   policy=pol)
        cols = []
        for tag, out in (("card", a_full[i]), ("cpu", a_cpu[i])):
            num = check.numbers(out, ref, nt)
            fin = np.asarray(out["finish"], np.float64)[:nt]
            fref = np.asarray(ref["finish"], np.float64)[:nt]
            worst = np.abs(fin - fref).max() / np.abs(fref).max()
            pe = float((np.asarray(out["pe_of"])[:nt]
                        != np.asarray(ref["pe_of"])[:nt]).mean())
            cols.append(f"{tag} avg {num['avg_exec_rel']:.2e} off "
                        f"{num['tasks_off']}/{nt} worst fin {worst:.2e} "
                        f"pe {pe:.3f}")
        print(f"  lane {int(j)} ({int(a_full[i]['n_iters'])} events): "
              + " | ".join(cols))
    assert all(all(v) for v in same.values()), {k: sum(v) for k, v in
                                                 same.items()}
