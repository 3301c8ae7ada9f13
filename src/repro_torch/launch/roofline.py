"""Roofline analysis over the dry-run's records, on the JAX package's
`launch/roofline.py`.

Per (arch x shape x mesh) cell, three per-card time bounds, with the
NVIDIA H100 constants of `launch/mesh.py`:

  compute_s    = dot_flops_per_dev / PEAK_FLOPS_BF16
  memory_s     = dot_bytes_per_dev / HBM_BW
  collective_s = collective_bytes_per_dev / ICI_BW

dot_flops / dot_bytes are the matrix products' FLOPs and operand+output
bytes on one card's shards, counted as the dry-run's step runs
(`launch/dryrun.py`); dot_bytes is an HBM-traffic model that assumes
every elementwise chain fuses into its product. The collective bytes are
the outputs of every collective one card takes part in. The dominant
term is the bottleneck; `useful_ratio` = MODEL_FLOPS / (dot_flops *
n_devices) exposes remat, padding, replicated and attention compute
against the 6*N*D (or 2*N*D) ideal. The reference's `collective_bytes_tpu`
(its correction for XLA:CPU storing bf16 as fp32) has no counterpart: a
torch program's collectives move the dtypes it holds.

    PYTHONPATH=src python -m repro_torch.launch.roofline [RECORD] [--markdown]
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.launch import mesh as meshlib


def roofline_terms(cell: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if cell.get("status") != "ok" or "dot_flops_per_dev" not in cell:
        return None
    n_dev = cell["n_devices"]
    compute_s = cell["dot_flops_per_dev"] / meshlib.PEAK_FLOPS_BF16
    memory_s = cell["dot_bytes_per_dev"] / meshlib.HBM_BW
    coll_bytes = sum(cell["collective_bytes"].values())
    collective_s = coll_bytes / meshlib.ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    model_flops_per_dev = cell["model_flops_global"] / n_dev
    useful_ratio = (model_flops_per_dev / cell["dot_flops_per_dev"]
                    if cell["dot_flops_per_dev"] else 0.0)
    # fraction of peak the card would sustain if the dominant bound holds
    mfu_bound = model_flops_per_dev / meshlib.PEAK_FLOPS_BF16 / step_s \
        if step_s else 0.0
    return {
        **terms,
        "dominant": dominant,
        "step_time_bound_s": step_s,
        "useful_ratio": useful_ratio,
        "roofline_fraction": mfu_bound,
        "coll_bytes_per_dev": coll_bytes,
    }


def build_table(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    rows = []
    for cell in results:
        mesh = "2pod" if cell.get("multi_pod") else "1pod"
        head = {"arch": cell["arch"], "shape": cell["shape"], "mesh": mesh}
        t = roofline_terms(cell)
        if t is None:
            rows.append({**head, "status": cell.get("status", "?")})
            continue
        rows.append({
            **head, "status": "ok", **t,
            "n_active_params": cell["n_active_params"],
            "arg_gb_per_dev": cell["memory"].get(
                "argument_size_in_bytes", 0) / 1e9,
            # the step's peak on a card: its arguments and what it
            # allocates beyond them (the dry-run's live-byte count)
            "mem_gb_per_dev": (cell["memory"].get("argument_size_in_bytes", 0)
                               + cell["memory"].get("temp_size_in_bytes", 0))
            / 1e9,
        })
    return rows


def format_table(rows: List[Dict[str, Any]], mesh: str = "1pod") -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s}"
           f" {'coll_s':>10s} {'bound':>12s} {'useful':>7s} {'RF':>6s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(f"{r['arch']:22s} {r['shape']:12s} "
                         f"{'— skipped (sub-quadratic rule)':>40s}")
            continue
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:22s} {r['shape']:12s} {r['status']}")
            continue
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant'][:-2]:>12s} {r['useful_ratio']:7.3f} "
            f"{r['roofline_fraction']:6.3f}")
    return "\n".join(lines)


def format_markdown(rows: List[Dict[str, Any]]) -> str:
    """One Markdown row a cell, the 16 x 16 terms beside the 2 x 16 x 16
    ones (seconds a step on each H100; RF the roofline fraction; GB the
    step's peak memory on each card, argument + temp, against an H100's
    80 GB)."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    out = ["| arch | shape | 16×16 compute s | memory s | collective s "
           "| bound | useful | RF | GB | 2×16×16 compute s | memory s "
           "| collective s | RF | GB |", "|" + "---|" * 14]
    for arch, shape in dict.fromkeys((r["arch"], r["shape"]) for r in rows):
        one, two = by.get((arch, shape, "1pod")), by.get((arch, shape,
                                                          "2pod"))
        if one is None or one.get("status") != "ok":
            out.append(f"| {arch} | {shape} | "
                       f"{(one or two or {}).get('status', '?')} |"
                       + " |" * 11)
            continue
        cells = [f"{one['compute_s']:.4g}", f"{one['memory_s']:.4g}",
                 f"{one['collective_s']:.4g}", one["dominant"][:-2],
                 f"{one['useful_ratio']:.3f}",
                 f"{one['roofline_fraction']:.4f}",
                 f"{one['mem_gb_per_dev']:.4g}"]
        if two is not None and two.get("status") == "ok":
            cells += [f"{two['compute_s']:.4g}", f"{two['memory_s']:.4g}",
                      f"{two['collective_s']:.4g}",
                      f"{two['roofline_fraction']:.4f}",
                      f"{two['mem_gb_per_dev']:.4g}"]
        else:
            cells += [(two or {}).get("status", "?"), "", "", "", ""]
        out.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def pick_hillclimb_cells(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    ok = [r for r in rows if r.get("status") == "ok"
          and r.get("mesh") == "1pod"]
    worst_rf = min(ok, key=lambda r: r["roofline_fraction"])
    coll_bound = [r for r in ok if r["dominant"] == "collective_s"]
    most_coll = max(coll_bound or ok,
                    key=lambda r: r["collective_s"]
                    / max(r["step_time_bound_s"], 1e-12))
    return {"worst_roofline": worst_rf, "most_collective": most_coll}


def main(path: Optional[str] = None, markdown: bool = False):
    from repro_torch.launch.dryrun import OUT
    with open(path or OUT) as f:
        results = json.load(f)
    rows = build_table(results)
    if markdown:
        print(format_markdown(rows))
        return rows
    print("single-pod (16x16 = 256 H100):")
    print(format_table(rows, "1pod"))
    print("\nmulti-pod (2x16x16 = 512 H100):")
    print(format_table(rows, "2pod"))
    if any(r.get("status") == "ok" and r.get("mesh") == "1pod"
           for r in rows):
        picks = pick_hillclimb_cells(rows)
        print("\nhillclimb candidates:")
        for k, r in picks.items():
            print(f"  {k}: {r['arch']} x {r['shape']} "
                  f"(RF {r['roofline_fraction']:.3f}, "
                  f"dominant {r['dominant']})")
    return rows


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--markdown"]
    main(*args, markdown="--markdown" in sys.argv[1:])
