"""The controls of an LM cell's check, on the card: the reference computed
in the program's place, in float8 (the precision below the
configuration's bfloat16) and with two planted faults (`lm_ref.VARIANTS`).

    python3 dasbench/lm_control.py --workload NAME --seeds 1,2,3 \
        [--seconds 1] [--controls fp8,no_shared,no_rope_k]

For each seed, in one process, it runs the cell as a benchmark run does
(weights from the seed, the traffic at the cell's load), with a short
window (`--seconds`: the window still ends on a whole cycle of the
traffic's prompt lengths), draws the run's sample, and holds the program
and each control to the float32 reference on the same prompts and served
tokens. It prints one JSON line a seed: the program's readings and
`correct`, and each control's, which have to come out not correct. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from dasbench import harness, lm_lane  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--controls", default="fp8,no_shared,no_rope_k")
    args = ap.parse_args(argv)
    spec = harness.resolve_cell(harness.ROOT, args.workload)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("lm_control: needs a CUDA device", file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = lm_lane.run(spec, seed, args.seconds, False, "cuda", t0,
                          log=lambda *a: print(*a, file=sys.stderr),
                          controls=controls)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": out["correct"], "readings": out["readings"],
            "check": out["check"], "controls": out["controls"],
            "metrics": out["metrics"], "device": out["device"],
            "seconds": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
