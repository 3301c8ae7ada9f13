"""The hill-climb runner, on the JAX package's `launch/hillclimb.py`:
each experiment runs one cell of the dry-run (`launch/dryrun.py`, on the
16 x 16 mesh) under a variant and prints its roofline terms
(`launch/roofline.py`). Results accumulate in
build/repro_torch/hillclimb_results.json; an experiment already there is
not run again.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [NAME ...]

NAMEs pick experiments by variant name or arch. The cells, variant
names and variants are the reference's; its hypotheses quote times it
measured for its own hardware, which are left out here: the hypothesis
says what the variant changes, and this runner measures it.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

from repro_torch.launch import dryrun, roofline

OUT = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch"
          / "hillclimb_results.json")

# (cell, variant-name, variant dict, hypothesis)
EXPERIMENTS = [
    ("deepseek-v2-lite-16b", "train_4k", "headshard+localsort",
     {"moe_shards": 16},
     "shard-local router top_k and dispatch: the collective term falls"),
    ("qwen2-72b", "train_4k", "tpu-dtype+dots", {"remat": "dots"},
     "dots-remat: no forward recompute in the backward"),
    ("deepseek-v2-lite-16b", "train_4k", "tpu-dtype+localsort",
     {"moe_shards": 16},
     "the local-sort dispatch re-measured"),
    ("minicpm3-4b", "decode_32k", "tpu-dtype+absorb", {"mla_absorb": True},
     "absorbed decode re-measured"),
    ("qwen2-72b", "train_4k", "bf16params",
     {"bf16_params": True},
     "bf16 weights (fp32 masters in the optimizer state): every parameter "
     "gather and gradient reduce halves"),
    ("qwen2-72b", "train_4k", "bf16params+dots",
     {"bf16_params": True, "remat": "dots"},
     "stack the compute win on the bf16 parameters"),
    ("deepseek-v2-lite-16b", "train_4k", "bf16params+localsort",
     {"bf16_params": True, "moe_shards": 16},
     "bf16 parameters + local dispatch: the collective term falls"),
    ("minicpm3-4b", "decode_32k", "bf16serve+absorb",
     {"bf16_params": True, "mla_absorb": True},
     "serve a bf16 checkpoint on the absorbed decode: parameter "
     "collectives halve"),
    ("qwen2-72b", "train_4k", "pet-bf16", {},
     "products with fp32 accumulation and no fp32 operand upcasts"),
    ("qwen2-72b", "train_4k", "pet-bf16+dots", {"remat": "dots"},
     "the same with dots-remat"),
    ("deepseek-v2-lite-16b", "train_4k", "pet+localsort",
     {"moe_shards": 16},
     "bf16 dot operands + local dispatch"),
    ("minicpm3-4b", "decode_32k", "pet+absorb", {"mla_absorb": True},
     "bf16 score products on the absorbed decode path"),
    ("qwen2-72b", "train_4k", "base", {},
     "baseline: fp32 parameter gathers and gradient reduces"),
    ("qwen2-72b", "train_4k", "bf16cast", {"cast_params": "bfloat16"},
     "cast the fp32 masters to bf16 before the FSDP all-gather: parameter "
     "gather and gradient reduce bytes halve"),
    ("qwen2-72b", "train_4k", "bf16cast+dots",
     {"cast_params": "bfloat16", "remat": "dots"},
     "save the products' outputs instead of full remat: fewer dot FLOPs "
     "and no parameter re-gathers in the backward, at more activation "
     "memory"),
    ("deepseek-v2-lite-16b", "train_4k", "base", {},
     "baseline: one dispatch group over the whole batch"),
    ("deepseek-v2-lite-16b", "train_4k", "localsort", {"moe_shards": 16},
     "shard-local dispatch (16 groups aligned with DP): the sorts, cumsums "
     "and scatters stay on each card; only the tokens move to their "
     "experts"),
    ("deepseek-v2-lite-16b", "train_4k", "localsort+bf16",
     {"moe_shards": 16, "cast_params": "bfloat16"},
     "add the bf16 gather cast: parameter and gradient collectives halve"),
    ("minicpm3-4b", "decode_32k", "base", {},
     "baseline: per-step up-projection of the whole 32k latent cache"),
    ("minicpm3-4b", "decode_32k", "absorb", {"mla_absorb": True},
     "weight-absorbed MLA decode: attention in the compressed latent "
     "space, one read of the cache a step"),
]


def main(out_path: str = OUT, only=None):
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["variant"]) for r in results}
    for arch, shape, vname, variant, hypothesis in EXPERIMENTS:
        if only and vname not in only and arch not in only:
            continue
        if (arch, shape, vname) in done:
            continue
        t0 = time.time()
        print(f"\n=== {arch} x {shape} [{vname}] ===")
        print(f"hypothesis: {hypothesis}")
        try:
            cell = dryrun.run_cell(arch, shape, multi_pod=False,
                                   variant=variant)
            terms = roofline.roofline_terms(cell)
            rec = {"arch": arch, "shape": shape, "variant": vname,
                   "hypothesis": hypothesis, "variant_cfg": variant,
                   "cell": cell, "terms": terms,
                   "wall_s": round(time.time() - t0, 1)}
            print(f"  compute {terms['compute_s']:.3f}s | memory "
                  f"{terms['memory_s']:.3f}s | collective "
                  f"{terms['collective_s']:.3f}s | bound "
                  f"{terms['dominant']} | RF {terms['roofline_fraction']:.3f}"
                  f" | useful {terms['useful_ratio']:.3f}")
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "variant": vname,
                   "hypothesis": hypothesis,
                   "error": f"{type(e).__name__}: {e}"[:1000]}
            print(f"  FAILED: {e}")
        results.append(rec)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\nwrote {out_path}")


if __name__ == "__main__":
    main(only=set(sys.argv[1:]) or None)
