"""Kill-and-resume smoke test of the campaign layer, with a real SIGKILL.

  1. compute an uninterrupted reference sweep in-process
     (`sim.run_batch`; on the card this also builds the kernels, so the
     child only loads them);
  2. launch a child process running the same sweep as a checkpointed
     campaign, throttled (`chunk_delay_s`) so chunks land one at a time;
  3. SIGKILL the child once some — but not all — chunks are checkpointed;
  4. resume the campaign in-process and assert (a) completed chunks were
     reused, not recomputed, and (b) every `SimResult` field is
     byte-identical to the uninterrupted reference.

    PYTHONPATH=src python -m repro_torch.bench.kill_resume_smoke \
        [--device cuda] [--dir DIR]

The port of `benchmarks/kill_resume_smoke.py`. Exit status 0 on
success. `--child DIR` is the internal child entry.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.core import campaign as camp, simulator as sim, workloads
from repro_torch.kernels.etf_ft import ops

MODE = sim.MODE_LUT
N_INSTANCES = 5
CELLS = [(mi, ri) for mi in range(4) for ri in (0, 5, 9, 13)]  # 16 scenarios
BATCH = 2                                                      # -> 8 chunks
CHUNK_DELAY_S = 0.6
SRC = Path(__file__).resolve().parents[2]      # the `src` directory


def _workloads():
    suite = workloads.default_suite(n_instances=N_INSTANCES)
    return [suite.build(mi, ri) for mi, ri in CELLS]


def child(cdir: str, device: str) -> None:
    """Run the campaign slowly so the parent can SIGKILL it mid-grid."""
    camp.run_campaign(MODE, _workloads(), batch_size=BATCH,
                      checkpoint_dir=cdir, chunk_delay_s=CHUNK_DELAY_S,
                      device=device)


def _chunk_files(cdir: str):
    return glob.glob(os.path.join(cdir, "*", "chunk_*.npz"))


def main(cdir: str, device: str) -> dict:
    wls = _workloads()
    n_chunks = -(-len(CELLS) // BATCH)
    print(f"# reference sweep on {device}: {len(CELLS)} scenarios, "
          f"{n_chunks} chunks")
    ref = sim.to_numpy(sim.run_batch(MODE, wls, batch_size=BATCH,
                                     device=device))

    print("# launching child campaign (throttled)...")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.bench.kill_resume_smoke",
         "--child", cdir, "--device", device], env=env)
    deadline = time.time() + 300
    try:
        while True:
            done = len(_chunk_files(cdir))
            if done >= 2:
                break
            if proc.poll() is not None:
                raise SystemExit(
                    f"child exited early (rc={proc.returncode}) with only "
                    f"{done} chunk(s) checkpointed — widen CHUNK_DELAY_S?")
            if time.time() > deadline:
                raise SystemExit("timed out waiting for the first chunks")
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    done = len(_chunk_files(cdir))
    print(f"# SIGKILLed child after {done}/{n_chunks} chunks")
    if done >= n_chunks:
        raise SystemExit("child finished before the kill — not a mid-grid "
                         "interruption; widen CHUNK_DELAY_S")

    print("# resuming in-process...")
    out = camp.run_campaign(MODE, wls, batch_size=BATCH, checkpoint_dir=cdir,
                            device=device)
    st = out.stats
    assert st["chunks_reused"] >= done - 1, st
    assert st["chunks_reused"] < n_chunks, st
    assert st["chunks_computed"] + st["chunks_reused"] == n_chunks, st
    for name in sim.SimResult._fields:
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out.result, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
            f"field {name} differs after resume"
    print(f"# resume reused {st['chunks_reused']} chunk(s), "
          f"recomputed {st['chunks_computed']}; all "
          f"{len(sim.SimResult._fields)} result fields byte-identical "
          "to the uninterrupted sweep: PASS")
    # the decision kernels' launches in this process (0 on the CPU)
    print("# launches " + json.dumps(dict(ops.LAUNCHES)))
    return st


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", default=None,
                    help="campaign dir (default: a fresh temp dir)")
    ap.add_argument("--child", default=None, metavar="DIR",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.device)
    elif args.dir:
        main(args.dir, args.device)
    else:
        with tempfile.TemporaryDirectory(prefix="repro-campaign-") as d:
            main(d, args.device)
