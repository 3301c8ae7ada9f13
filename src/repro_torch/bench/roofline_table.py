"""The dry-run roofline table, on the JAX package's
`benchmarks/roofline_table.py`: reads the dry-run's record (made by
`python -m repro_torch.launch.dryrun --all --both-meshes`; the path is
`REPRO_DRYRUN_JSON`, read at call time, or `launch/dryrun.py`'s `OUT`)
and prints its roofline terms with the H100 constants."""
from __future__ import annotations

import os

from repro_torch.launch import dryrun, roofline


def path() -> str:
    return os.environ.get("REPRO_DRYRUN_JSON", dryrun.OUT)


def run(bench=None, csv=False):
    """The table's rows (none without a record). `bench` and `csv` are
    the harness's arguments; the table reads neither."""
    p = path()
    if not os.path.exists(p):
        print(f"  (no {p}; run `python -m repro_torch.launch.dryrun --all "
              f"--both-meshes --out {p}` first)")
        return []
    rows = roofline.main(p)
    ok = [r for r in rows if r.get("status") == "ok"]
    n_skip = sum(r.get("status") == "skipped" for r in rows)
    print(f"\n  {len(ok)} cells analyzed, {n_skip} documented skips")
    return rows


if __name__ == "__main__":
    run()
