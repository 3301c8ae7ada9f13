"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `src/repro_torch/kernels/*/csrc/*.cu` into
`build/repro_torch/` (one nvcc per source, all at once), holds each
kernel to its plain PyTorch version on the card, and drives the port's
paths through them:

  * the DAS scheduling pipeline (summary40 at the benchmark's full size:
    40 mixes x 14 rates, 60 frames per workload, 19 PEs, at the chunk
    size the autotune's probe picks from an empty cache, which a second
    resolution must read back from the cache file), checked against
    `benchmarks/BENCH_sweep.json`, its super-steps and launches counted,
    and the card's schedules against the CPU's; on the card the simulator
    replays each block of super-steps from one CUDA graph, which phase 4
    times against the eager loop (one oracle-sized sweep, in turns) and
    phase 5 holds to it in every result field; phase 5b runs the fault
    path (16 fault plans on one cell in LUT, ETF and DAS: kills,
    retries, drops, deadlines, the search fed a real live-PE mask),
    graph against eager and card against CPU, its launches per
    super-step asserted; phase 5c runs every DAS section of the
    benchmark (`repro_torch.bench.run`: fig2, fig3, table2, summary40,
    heuristic, overhead, faults) at its full size and holds each to
    `benchmarks/BENCH_sweep.json`, checks the record's campaign block
    and holds `serving_das`, the reference's replica injected, to its
    record; phase 5d runs the campaign layer on the card (the
    kill-and-resume smoke test, campaign against `run_batch` bit for
    bit, packed, resumed and under fault plans, a real CUDA
    out-of-memory (the retry starting with the failed attempt's memory
    freed, a cyclic collection inside each of its captures) and a
    watchdog trip inside a graph capture, the
    scenario split, `bench.run --resume` twice) and reads the idle
    card's power draw;
  * RecurrentGemma-9B inference at full width and depth (38 layers,
    d_model 4096, vocab 256,000, random weights from a seed): scoring
    4096 tokens, then serving 4 prompts of 4096 tokens with 32 greedy
    decode steps, the served logits checked against scoring; and the
    model cut to one period (3 layers) in fp32, card against CPU, in a
    forward and in a prefill of two chunks whose second carries the
    recurrent state;
  * Mamba-2 780M inference at full width and depth (48 SSD layers,
    d_model 1536, vocab 50,280, random weights from a seed): scoring
    4 x 4096 tokens through the SSD kernel and serving 4 prompts of 4096
    tokens with 32 greedy decode steps in bf16 (timed; the served logits
    held to the reference's own bf16 gap), then the same in fp32 with the
    served logits checked against scoring at 1e-4; and the model cut to 3
    layers in fp32, card against CPU;
  * DeepSeek-V2-Lite-16B at full width and depth (27 layers, MLA with
    kv_lora 512, 64 routed experts top-6 + 2 shared, a dense layer 0,
    vocab 102,400; bf16 at rest, random weights from a seed): scoring
    4096 tokens and its loss, serving 4 prompts of 4096 with 32 greedy
    decode steps at the no-drop MoE capacity, expanded and again
    weight-absorbed, the served logits held to 1.5x the bf16 model's own
    rounding and, in fp32, to 1e-4; no kernel launch (MLA
    runs the plain attention, as in the reference); then the model cut
    to 3 layers in fp32, card against CPU (logits, aux, loss, prefill,
    both decodes, the experts chosen in every call), and bf16 at rest
    bit-equal to fp32 at rest;
  * the other configs at full width (MiniCPM3-4B, PaliGemma-3B with 256
    prefix embeddings, MusicGen-medium with 4 codebooks, Phi-3-mini and
    Yi-34B at full depth; Qwen2-72B cut to 32 of 80 layers and DBRX-132B
    to 8 of 40, which one card cannot hold whole): scoring 4096 tokens
    and its loss, serving 2 prompts of 1024 with 8 greedy steps, served
    against scored, flash launches counted per attention layer;
  * training on the card (phase 13): the trainer's failure-recovery run
    (a 2-layer Phi-3 smoke model, fp32, 40 steps, a checkpoint every
    10, a failure at 25) on the card and on the CPU from the same
    weights, losses held step by step; one step each of microbatching,
    int8 gradient compression and bf16 parameter casts, card against
    CPU; and Mamba-2 780M trained at full width and depth (4 x 2048
    tokens a step, fp32 AdamW, remat), a checkpoint at step 10, a
    failure at 15, the restore and the replayed steps held to the first
    run bit for bit (1e-6), then its held-out loss and logits through
    the SSD kernel held to the training route's, and the kernel's
    outputs in two of its layers held to the plain version on the same
    inputs, where the planted faults must fail. Training takes the plain
    forms and launches no kernel (asserted); the held-out loss and
    logits launch the SSD kernel 48 times each;
  * the sharded steps (phase 14): Mamba-2's train step and
    RecurrentGemma's prefill and decode on a 1 x 1 NCCL mesh against one
    device, the dry-run of three production cells on a fake 16 x 16
    group (roofline terms and each card's memory), and the dry-run's
    count of the Mamba-2 step's memory, held within 15% of the peak the
    card measured for it.

Phase 2 also builds three planted faults of the bf16 SSD kernel and
three of the RG-LRU scan's TMA ring (copies of their sources with one
step broken), prints the ptxas registers and
spills of the libraries built with -Xptxas -v, and fails unless flash
attention's and the SSD scan's SASS hold wgmma that ptxas did not
serialise and the bf16 SSD kernel spills nothing. Phase 3 holds the
decision kernels (the fixed and the generic search, the fused push rows)
to their plain versions bit for bit, and the three LM wrappers, on
widths and dtypes the models do not make (flash with Dv != Dh, the scans
with mixed dtypes), to theirs, and checks that each of the three refuses
a CUDA input that requires grad (none has a backward) and launches as
before under `inference_mode`. Phase 3 also times
flash attention beside PyTorch's SDPA (the same band mask) and fails
unless the kernel is the faster; it holds the RG-LRU scan bit for bit to
its plain version on both routes (the TMA ring and, for inputs TMA
cannot take, the generic kernel), at the forward's and the prefill's
shapes among others, fails unless the planted faults are rejected, and
times the ring beside the generic kernel at both shapes in turns,
failing unless the ring is the faster; it holds every SSD case's y to its
dtype's limit and h_last to the fp32 one, fails unless the planted
faults are rejected, and times the bf16 SSD kernel beside the fp32
CUDA-core route at the same shape, failing unless it is the faster. It
holds flash to its plain version at the full-causal shapes of the GQA
configs (MusicGen, Phi-3, Yi, Qwen2, DBRX at 1 x 4096) and times it there
beside SDPA with `is_causal`, without failing when SDPA is the faster.
Each phase prints its result and seconds; any failure raises and the
exit code is not 0. The last line of standard output is `{"ok": true,
"device": {...}}`; the line before it lists each kernel with its
launches on its path, its error against the plain version, its time per
call, the plain version's, the bound and the library call's time.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
MAIN_S = 560            # scenarios in one oracle sweep (40 mixes x 14 rates)
# the chunk-size autotune's cache, and the most its probe may take
AUTOTUNE_DIR = ROOT / "build" / "repro_torch" / "autotune"
PROBE_S = 30.0
TOL_DERIVED = 1e-3      # the four ratios against BENCH_sweep.json
SUMMARY40_STEPS = 14208  # super-steps of the eight summary40 sweeps
TOL_AGG = 1e-6          # card vs CPU float aggregates (reduction order)
# flash attention against its plain version: both fp32 inside, summed in
# another order; a bf16 output rounds to 2^-8 relative
TOL_FLASH = {"float32": 1e-4, "bfloat16": 2e-2}
# and, for every case, each output row (b, position, head) against an fp32
# plain version on the same inputs, as max |error| over the row / the
# row's RMS: a long row averages ~2048 keys and its values are ~0.036,
# where 2e-2 is about one value. The kernel's rounding (P and the output
# to bf16, 2^-9 each) reads 1.6e-2 in a CPU emulation of its algorithm;
# one 64-key tile missing from a 2048-key row reads about 0.5.
TOL_FLASH_ROW = 5e-2
# served logits (bf16, 38 layers) against scoring the same tokens: the
# JAX package's ring-cache tolerance (tests/test_lm_details.py)
TOL_SERVE = 5e-2
TOL_CROSS_F32 = 1e-4    # 3-layer fp32 model, card vs CPU, relative
# Mamba-2 served logits against scoring, in fp32 (the JAX package's fp32
# model tolerance). In bf16 the reference itself misses TOL_SERVE at 48
# layers: its gap is 1.036e-1 at the scaled width on the CPU, and
# tests/test_torch_mamba.py::test_served_vs_scored_at_full_depth holds the
# port to 1.5x it; the bf16 run here is held to the same limit, and its
# greedy tokens to a floor below the first card reading (84.1% of 132
# positions; three standard errors, 9.6%, under it).
TOL_SERVE_F32 = 1e-4
TOL_SERVE_MAMBA_BF16 = 1.5 * 1.036e-1
MIN_AGREE_MAMBA_BF16 = 0.75
# SSD scan against its plain version (the sequential recurrence): fp32 in
# both, summed in another order (tests/test_kernels.py's 1e-4); a bf16 y
# rounds to 2^-8 relative (its bf16 test's 3e-2). Max abs error over
# max(1, max |plain|). y is held to its dtype's limit, h_last (fp32 in
# both routes) to the fp32 one: the bf16 kernel takes every fp32 operand
# in two bf16 passes, and one pass would miss it (about 4e-4).
TOL_SSD = {"float32": 1e-4, "bfloat16": 3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()} | name, power limit:")
    log(smi)
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def libraries():
    from repro_torch.kernels.etf_ft import kernel as etf
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rg_lru import kernel as rg
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return (etf.LIBRARY, fa.LIBRARY, rg.LIBRARY, ssd.LIBRARY)


# planted faults of the bf16 SSD kernel: each is the kernel's source with
# these lines replaced, built beside it in phase 2 and run in phase 3,
# where the checks must reject it: (name, ((line, replacement), ...))
SSD_FAULTS = (
    ("diagonal dropped",
     (("m[e] = j <= i && i < Q", "m[e] = j < i && i < Q"),)),
    ("chunk 3's incoming state zeroed",
     (("const float e0 = ex2f(ci0), e1 = ex2f(ci1);",
       "const float e0 = c == 3 ? 0.f : ex2f(ci0),\n"
       "                e1 = c == 3 ? 0.f : ex2f(ci1);"),
      ("ha[k][e] *= ae;", "ha[k][e] *= c == 3 ? 0.f : ae;"))),
    ("state update in one bf16 pass",
     (("*reinterpret_cast<uint32_t*>(wl + o) = lo;",
       "*reinterpret_cast<uint32_t*>(wl + o) = 0u;"),)),
)


# planted faults of the RG-LRU scan's TMA ring, in the same form. A
# fault in the ring's mbarrier parities can deadlock the kernel, which
# would hang the run: these break the data path only.
RG_FAULTS = (
    ("one tile consumed twice",
     (("const int off = s * TILE + lane;",
       "const int off = (k == 2 ? 1 : s) * TILE + lane;"),)),
    ("the tail tile's steps dropped",
     (("const int n = min(TS, S - k * TS);",
       "const int n = S - k * TS < TS ? 0 : TS;"),)),
    ("the carry reset at each tile",
     (("ptx::mbar_wait(full + s, (k / NST) & 1);",
       "ptx::mbar_wait(full + s, (k / NST) & 1);\n        h = 0.f;"),)),
)


def fault_libraries(kernel, faults):
    """One library per planted fault of `kernel`'s library, from a copy of
    its source under `build/repro_torch/faults/` (each replaced line must
    occur once)."""
    from repro_torch.kernels import _build
    lib = kernel.LIBRARY
    src = lib.src.read_text()
    libs = []
    for i, (name, edits) in enumerate(faults):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"planted fault '{name}': '{old}' "
                                     f"occurs {text.count(old)} times")
            text = text.replace(old, new)
        path = (_build.BUILD_DIR / "faults" / f"{lib.name}{i}"
                / lib.src.name)
        path.parent.mkdir(parents=True, exist_ok=True)
        if not path.exists() or path.read_text() != text:
            path.write_text(text)
        libs.append(_build.Library(f"{lib.name}_fault{i}", path, lib.flags,
                                   kernel._bind, lib.include_dirs))
    return libs


def _sass_counts(path: Path) -> dict:
    """wgmma (HGMMA) and mma.sync (HMMA) instructions in a library's SASS
    (cuobjdump ships with the nvcc that built it)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise FileNotFoundError(f"cuobjdump not found ({tool})")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass))
            for op in ("HGMMA", "HMMA")}


def _ptxas_usage(lib, kernel: str) -> dict:
    """Registers and spill bytes that ptxas reported for the entry whose
    name contains `kernel` (the library is built with -Xptxas -v)."""
    import re
    out, inside = {}, False
    for line in lib.ptxas_lines():
        if "Compiling entry" in line:
            inside = kernel in line
        elif inside and "spill" in line:
            out["spill_stores"] = int(re.search(
                r"(\d+) bytes spill stores", line).group(1))
            out["spill_loads"] = int(re.search(
                r"(\d+) bytes spill loads", line).group(1))
        elif inside and "registers" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    if set(out) != {"registers", "spill_stores", "spill_loads"}:
        raise AssertionError(f"{lib.name}: no ptxas report for {kernel}")
    return out


def phase_build() -> dict:
    """One nvcc per source (and per planted SSD and RG-LRU fault), all
    started together, then load each; show the ptxas registers and spills
    of the libraries built with -Xptxas -v, and the tensor-core
    instructions (wgmma) in the SASS of flash attention and of the SSD
    scan."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.rg_lru import kernel as rg
    from repro_torch.kernels.ssd_scan import kernel as ssd
    libs = list(libraries())
    ssd_faults = fault_libraries(ssd, SSD_FAULTS)
    rg_faults = fault_libraries(rg, RG_FAULTS)
    faults = ssd_faults + rg_faults
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + len(faults)) as pool:
        futs = [pool.submit(lib.build) for lib in libs + faults]
        built = [f.result() for f in futs]
    for lib in libs + faults:
        lib.load()
    secs = {lib.name: s for lib, (_, s) in zip(libs, built)}
    for lib, (path, s) in zip(libs + faults, built):
        log(f"[2 build] {path.relative_to(ROOT)} nvcc {s:.2f}s")
        if lib in libs:
            for line in lib.ptxas_lines():   # built with -Xptxas -v
                log(f"[2 build]   {lib.name} ptxas: {line}")
    by_name = {lib.name: lib for lib in libs}
    for name in ("flash_attention", "ssd_scan"):
        path = by_name[name].path()
        counts = _sass_counts(path)
        log(f"[2 build] {path.name} tensor-core instructions in the SASS: "
            f"{counts}")
        if not counts["HGMMA"]:
            raise AssertionError(f"{name} compiled without wgmma")
        # ptxas serialises a wgmma sequence it cannot prove warpgroup-
        # uniform (C7520), which costs the kernel its overlap
        serial = [ln for ln in by_name[name].ptxas_lines()
                  if "serialized" in ln]
        if serial:
            raise AssertionError(f"{name}: {serial[0]}")
    use = _ptxas_usage(by_name["ssd_scan"], "ssd_scan_wgmma_kernel")
    log(f"[2 build] ssd_scan_wgmma_kernel (bf16): {use['registers']} "
        f"registers, spill stores {use['spill_stores']} bytes, spill loads "
        f"{use['spill_loads']} bytes")
    if use["spill_stores"] or use["spill_loads"]:
        raise AssertionError(f"ssd_scan_wgmma_kernel spills: {use}")
    log(f"[2 build] phase {time.perf_counter() - t0:.2f}s")
    return {"secs": secs, "ssd_ptxas": use, "ssd_faults": ssd_faults,
            "rg_faults": rg_faults}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def _bits_equal(a, b) -> bool:
    """Bit equality; NaN cells must be NaN on both sides."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a = torch.where(na, 0.0, a)
        b = torch.where(nb, 0.0, b)
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _max_abs_err(a, b) -> float:
    import torch
    if a.is_floating_point():
        ok = torch.isfinite(a) & torch.isfinite(b)
        return float((a[ok].double() - b[ok].double()).abs().max()) \
            if bool(ok.any()) else 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def search_case(S, R=16, P=19, seed=0, ties=False, special=False):
    """Random masked-search inputs on the card, built from numpy."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    avail = (rng.uniform(size=(S, R, P)) * 10).astype(np.float32)
    free = (rng.uniform(size=(S, P)) * 10).astype(np.float32)
    ex = np.where(rng.uniform(size=(S, R, P)) < 0.3, np.inf,
                  rng.uniform(size=(S, R, P)) * 5).astype(np.float32)
    if ties:
        avail = np.round(avail / 5) * 5
        free = np.round(free / 5) * 5
        ex = np.round(ex)
    now = (rng.uniform(size=S) * 3).astype(np.float32)
    slot_ok = rng.uniform(size=(S, R)) < 0.7
    alive = rng.uniform(size=(S, P)) < 0.8
    if special:
        slot_ok[0] = False                       # an all-masked lane
        avail.reshape(-1)[rng.randint(avail.size, size=8)] = np.inf
        avail.reshape(-1)[rng.randint(avail.size, size=8)] = -np.inf
        ex.reshape(-1)[rng.randint(ex.size, size=8)] = -np.inf
        avail.reshape(-1)[rng.randint(avail.size, size=4)] = np.nan
        free.reshape(-1)[rng.randint(free.size, size=2)] = np.nan
    dev = "cuda"
    return tuple(torch.as_tensor(x, device=dev) for x in
                 (avail, free, ex, now, slot_ok, alive))


def push_case(S, K=4, MP=4, P=19, seed=0, all_patterns=False, nan=False):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    pfin = (rng.uniform(size=(S, K, MP)) * 100).astype(np.float32)
    cost = (rng.uniform(size=(S, K, MP)) * 10).astype(np.float32)
    pcl = rng.randint(0, 6, size=(S, K, MP)).astype(np.int32)
    pv = rng.uniform(size=(S, K, MP)) < 0.6
    if all_patterns:      # every validity pattern of the MP predecessors
        pats = (np.arange(2 ** MP)[:, None] >> np.arange(MP)) & 1
        pv = pats[np.arange(S * K) % 2 ** MP].reshape(S, K, MP) > 0
    if nan:
        pfin.reshape(-1)[rng.randint(pfin.size, size=4)] = np.nan
        cost.reshape(-1)[rng.randint(cost.size, size=4)] = np.inf
    pecl = rng.randint(0, 6, size=P).astype(np.int32)
    bases = (rng.uniform(size=(S, K)) * 50).astype(np.float32)
    return tuple(torch.as_tensor(x, device="cuda") for x in
                 (pfin, cost, pcl, pv, pecl, bases))


def rows_case(S, T=1200, K=4, MP=4, seed=0, nan=False):
    """Random `avail_rows` inputs on the card at the simulator's layout:
    tasks [S, K], the flat finish/pe_of buffers [S*T + 1], preds [S, T, MP]
    (-1 pads), n_preds [S, T] in 0..MP (so every validity pattern of a
    prefix), out_kb [S, T], the SoC's us_per_kb and PE clusters, bases
    [S, K]; unscheduled predecessors (finish inf, pe_of -1) and, with
    `nan`, NaN finish times and inf sizes."""
    import numpy as np
    import torch
    from repro_torch.core import soc
    rng = np.random.RandomState(seed)
    cfg = soc.default_soc()
    tasks = rng.randint(0, T, size=(S, K))
    finish = (rng.uniform(size=S * T + 1) * 1000).astype(np.float32)
    pe_of = rng.randint(-1, len(cfg.pe_cluster), size=S * T + 1)
    finish[pe_of < 0] = np.inf
    preds = rng.randint(-1, T, size=(S, T, MP))
    n_preds = rng.randint(0, MP + 1, size=(S, T))
    out_kb = (rng.uniform(size=(S, T)) * 64).astype(np.float32)
    if nan:
        finish[rng.randint(finish.size, size=8 + S)] = np.nan
        out_kb.reshape(-1)[rng.randint(out_kb.size, size=8 + S)] = np.inf
    bases = (rng.uniform(size=(S, K)) * 500).astype(np.float32)
    dev = "cuda"
    return tuple(torch.as_tensor(x, device=dev) for x in (
        tasks, finish, pe_of, preds, n_preds, out_kb,
        np.float32(cfg.us_per_kb), np.asarray(cfg.pe_cluster, np.int32),
        bases))


def _rows_work(case) -> tuple[int, int]:
    """(bytes, operations) that `avail_rows` needs on these inputs: each
    task and its predecessor count, each valid predecessor's index,
    finish time, size and PE, the cluster table, bases and rows, read or
    written once; a multiply per valid predecessor, then per output and
    predecessor a multiply, an add and a max, and the max with the base."""
    import torch
    tasks, finish, pe_of, preds, n_preds, out_kb, upk, pecl, bases = case
    S, K = tasks.shape
    MP = preds.shape[2]
    P = pecl.shape[0]
    lane = torch.arange(S, device=tasks.device)[:, None]
    valid = int(n_preds[lane, tasks].sum())
    nbytes = (_nbytes(tasks, upk, pecl, bases) + S * K * 8
              + valid * (8 + 4 + 4 + 8) + S * K * P * 4)
    return nbytes, valid + S * K * P * (3 * MP + 1)


def _device_ms(fn, iters=200) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph,
    replayed between two events (launch overhead amortised)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / iters)
    return best


def _call_ms(fn, iters=200) -> float:
    """Wall time per call as a caller sees it (launch overhead included)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound_ms(nbytes: int, *work: tuple[int, float]) -> tuple[float, str]:
    """The larger of the bytes over the HBM rate and the operations, each
    (count, peak rate) pair of `work` over its own rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = sum(ops / rate for ops, rate in work) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels.etf_ft import kernel, ref
    t0 = time.perf_counter()
    err = {"etf_ft_search_masked": 0.0, "etf_ft_search": 0.0,
           "push_rows": 0.0, "avail_rows": 0.0}
    n_cases = 0

    def check_search(case, tag):
        """Both searches against their plain versions, masked with and
        without pe_alive, bit for bit."""
        for alive in (case[5], None):
            c = case[:5] + (alive,)
            got = kernel.etf_ft_search_masked(*c)
            want = ref.etf_ft_masked_reference(*c)
            for a, b in zip(got, want):
                if not _bits_equal(a, b):
                    raise AssertionError(f"etf_ft_search_masked {tag} alive="
                                         f"{alive is not None}: kernel != "
                                         "plain")
                err["etf_ft_search_masked"] = max(
                    err["etf_ft_search_masked"], _max_abs_err(a, b))
        got = kernel.etf_ft_search(*case[:4])
        want = ref.etf_ft_reference(*case[:4])
        for a, b in zip(got, want):
            if not _bits_equal(a, b):
                raise AssertionError(f"etf_ft_search {tag}: kernel != plain")
            err["etf_ft_search"] = max(err["etf_ft_search"],
                                       _max_abs_err(a, b))

    # the generic kernel: other [R, P] shapes, and the path's shape at
    # pointers that are not 16-byte aligned (no float4 loads)
    for i, (S, R, P) in enumerate(((7, 5, 19), (33, 24, 7), (MAIN_S, 16, 20),
                                   (4, 1, 1), (65, 40, 19))):
        for ties, special in ((False, False), (True, True)):
            check_search(search_case(S, R, P, seed=500 + i, ties=ties,
                                     special=special),
                         f"S={S} R={R} P={P} ties={ties} special={special}")
            n_cases += 3
    case = search_case(MAIN_S, seed=9, ties=True, special=True)
    shifted = []
    for x in case[:3]:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        shifted.append(buf[1:].view(x.shape).copy_(x))
    before = dict(kernel.LAUNCHES)
    check_search(tuple(shifted) + case[3:], "misaligned")
    routed = {k: kernel.LAUNCHES[k] - n for k, n in before.items()
              if kernel.LAUNCHES[k] != n}
    if routed != {"etf_ft_search_masked_generic": 2,
                  "etf_ft_search_generic": 1}:
        raise AssertionError(f"misaligned inputs launched {routed}, "
                             "expected only the generic kernels")
    n_cases += 3
    for S in (1, 7, MAIN_S, 4096):
        for seed, (ties, special) in enumerate(
                [(False, False), (True, False), (False, True),
                 (True, True)]):
            check_search(search_case(S, seed=1000 * S + seed, ties=ties,
                                     special=special),
                         f"S={S} ties={ties} special={special}")
            n_cases += 3
        for seed, (pats, nan) in enumerate([(False, False), (True, False),
                                            (True, True)]):
            case = push_case(S, seed=2000 * S + seed, all_patterns=pats,
                             nan=nan)
            got = kernel.push_rows(*case)
            want = ref.push_rows_reference(*case, 6)
            if not _bits_equal(got, want):
                raise AssertionError(f"push_rows S={S} patterns={pats} "
                                     f"nan={nan}: kernel != plain")
            err["push_rows"] = max(err["push_rows"], _max_abs_err(got, want))
            n_cases += 1
        for seed, nan in enumerate((False, True)):
            case = rows_case(S, seed=3000 * S + seed, nan=nan)
            got = kernel.avail_rows(*case)
            want = ref.avail_rows_reference(*case)
            if not _bits_equal(got, want):
                raise AssertionError(f"avail_rows S={S} nan={nan}: kernel "
                                     "!= plain")
            err["avail_rows"] = max(err["avail_rows"],
                                    _max_abs_err(got, want))
            n_cases += 1
    # an all-masked lane: slot 0, pe 0, infeasible
    case = search_case(4, seed=7)
    case = case[:4] + (torch.zeros_like(case[4]), case[5])
    _, sl, pe, ok = kernel.etf_ft_search_masked(*case)
    if bool(sl.any()) or bool(pe.any()) or bool(ok.any()):
        raise AssertionError("all-masked lanes must give (0, 0, False)")
    torch.cuda.synchronize()

    # time per call at the main path's shapes (one oracle sweep's lanes)
    sc = search_case(MAIN_S, seed=3)
    pc = push_case(MAIN_S, seed=4)
    rc = rows_case(MAIN_S, seed=5)
    rows_bytes, rows_ops = _rows_work(rc)
    if kernel._search_route("", sc[0], sc[2])[1] != 1:
        raise AssertionError("timing inputs must take the fixed search")
    S, R, P = sc[0].shape
    cells = S * R * P
    timing = {}
    for name, fk, fp, nb, ops in (
            ("etf_ft_search_masked",
             lambda: kernel.etf_ft_search_masked(*sc[:5], None),
             lambda: ref.etf_ft_masked_reference(*sc[:5], None),
             _nbytes(*sc[:5]) + S * (4 + 4 + 4 + 1), 6 * cells),
            ("etf_ft_search",
             lambda: kernel.etf_ft_search(*sc[:4]),
             lambda: ref.etf_ft_reference(*sc[:4]),
             _nbytes(*sc[:4]) + S * (4 + 4 + 4), 5 * cells),
            ("push_rows",
             lambda: kernel.push_rows(*pc),
             lambda: ref.push_rows_reference(*pc, 6),
             _nbytes(*pc) + pc[0].shape[0] * pc[0].shape[1] * P * 4,
             pc[0].numel() * P * 3 + pc[0].shape[0] * pc[0].shape[1] * P),
            ("avail_rows",
             lambda: kernel.avail_rows(*rc),
             lambda: ref.avail_rows_reference(*rc), rows_bytes, rows_ops)):
        bound, by = _bound_ms(nb, (ops, F32_OPS_PER_S))
        timing[name] = {
            "ms": _device_ms(fk), "plain_ms": _device_ms(fp),
            "call_ms": _call_ms(fk), "plain_call_ms": _call_ms(fp),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    for name, t in timing.items():
        log(f"[3 kernels] {name}: bit-equal to plain, device "
            f"{t['ms'] * 1e3:.2f} us/call (plain {t['plain_ms'] * 1e3:.2f} "
            f"us), per call incl. launch {t['call_ms'] * 1e3:.2f} us (plain "
            f"{t['plain_call_ms'] * 1e3:.2f} us), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
    log(f"[3 kernels] {n_cases} cases bit-equal at S in (1, 7, {MAIN_S}, "
        f"4096), other [R, P] shapes and misaligned inputs "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"err": err, "timing": timing}



# flash attention cases: B, S, H, K, Dh, window, softcap, dtype
FLASH_MAIN = (1, 4096, 16, 1, 256, 2048, 0.0, "bfloat16")  # RG-9B local
FLASH_CASES = (
    FLASH_MAIN,
    (1, 4096, 16, 1, 256, 2048, 0.0, "float32"),  # f32 at the main shape
    (1, 4095, 16, 1, 256, 2048, 0.0, "bfloat16"),  # S not a tile multiple
    (1, 512, 4, 4, 64, 0, 0.0, "float32"),         # MHA, full causal
    (2, 512, 8, 2, 128, 0, 0.0, "bfloat16"),       # GQA
    (1, 1024, 8, 1, 256, 256, 0.0, "float32"),     # MQA, short window
    (1, 512, 4, 2, 64, 0, 30.0, "float32"),        # tanh softcap
    (1, 300, 4, 2, 96, 64, 50.0, "bfloat16"),      # Dh 96, softcap, window
    (2, 33, 2, 1, 16, 0, 0.0, "float32"),          # Dh 16, one ragged tile
    (1, 1, 2, 2, 32, 0, 0.0, "float32"),           # S = 1
    # the edges of the bf16 tensor-core kernel (128 query rows a block, 64
    # keys a tile, Dh padded to 64, 128 or 256; TMA loads for rows of a
    # multiple of 16 bytes, element copies for the others)
    (1, 1024, 8, 1, 64, 0, 0.0, "bfloat16"),       # Dh 64, full causal
    (1, 1024, 4, 2, 128, 0, 0.0, "bfloat16"),      # Dh 128, full causal, G 2
    (2, 300, 4, 1, 40, 0, 0.0, "bfloat16"),        # Dh 40: 80-byte rows
    (2, 300, 4, 2, 20, 0, 0.0, "bfloat16"),        # Dh 20: 40-byte rows
    (1, 77, 6, 3, 20, 16, 30.0, "bfloat16"),       # Dh 20, W 16, softcap
    (1, 512, 16, 1, 256, 16, 0.0, "bfloat16"),     # W 16, below a tile
    (1, 4097, 16, 1, 256, 2048, 0.0, "bfloat16"),  # S 4097: one row over
    (1, 65, 4, 4, 128, 0, 0.0, "bfloat16"),        # S 65, MHA
    (2, 512, 8, 4, 256, 256, 0.0, "bfloat16"),     # GQA G 2, W 256
    (1, 512, 8, 8, 256, 0, 0.0, "bfloat16"),       # MHA, Dh 256
    (1, 1, 2, 1, 256, 0, 0.0, "bfloat16"),         # S = 1
    (1, 333, 3, 1, 64, 100, 0.0, "bfloat16"),      # G 3: one head a block
)
# without the causal mask (no path runs it; the kernels take it): the
# key range is all of S, with or without a window
FLASH_NONCAUSAL = ((1, 300, 4, 2, 64, 0, 0.0, "bfloat16"),
                   (1, 200, 4, 1, 128, 50, 0.0, "bfloat16"),
                   (1, 100, 2, 1, 32, 16, 0.0, "float32"))
FLASH_PREFILL = (4, 4096, 16, 1, 256, 2048, 0.0, "bfloat16")  # RG-9B prefill
# full-causal attention of the GQA paths that phase 12 runs, one sequence
# of 4096 at each config's heads, KV heads and head width
FLASH_PATHS = {
    "musicgen-medium": (1, 4096, 24, 24, 64, 0, 0.0, "bfloat16"),
    "phi3-mini-3.8b": (1, 4096, 32, 32, 96, 0, 0.0, "bfloat16"),
    "yi-34b": (1, 4096, 56, 8, 128, 0, 0.0, "bfloat16"),
    "qwen2-72b": (1, 4096, 64, 8, 128, 0, 0.0, "bfloat16"),
    "dbrx-132b": (1, 4096, 48, 8, 128, 0, 0.0, "bfloat16"),
}
# a value width Dv other than the head width Dh (the wrapper pads the
# narrower operands): B, S, H, K, Dh, Dv, window, softcap, dtype
FLASH_DV_CASES = ((1, 300, 4, 2, 64, 32, 64, 0.0, "bfloat16"),
                  (1, 300, 4, 2, 64, 128, 0, 0.0, "bfloat16"),
                  (2, 129, 4, 1, 128, 64, 0, 30.0, "float32"),
                  (1, 65, 2, 2, 32, 96, 16, 0.0, "float32"))
# RG-LRU cases: B, S, C, dtype, and the route the wrapper must take: the
# TMA ring for rows of a multiple of 16 bytes at aligned pointers, else
# the generic kernel
RG_MAIN = (1, 4096, 4096, "float32")       # RG-9B forward, one sequence
RG_PREFILL = (4, 4096, 4096, "float32")    # RG-9B prefill, 4 sequences
RG_CASES = (
    (*RG_MAIN, "rg_lru"), (*RG_PREFILL, "rg_lru"),
    (2, 1000, 512, "bfloat16", "rg_lru"),
    (3, 257, 1000, "float32", "rg_lru"),    # channel tail (8 of 32), step tail
    (2, 77, 520, "bfloat16", "rg_lru"),     # bf16 channel tail
    (2, 1, 64, "bfloat16", "rg_lru"),       # S = 1
    (3, 257, 999, "float32", "rg_lru_generic"),  # rows of 3996 bytes
    (1, 37, 33, "float32", "rg_lru_generic"),
)
# a and b one element into their storage (4-byte aligned): the generic
# kernel on purpose
RG_OFFSET_CASE = (1, 300, 4096, "float32")
# the planted faults (RG_FAULTS) run on the ring with a partial last tile
RG_FAULT_CASE = (1, 4095, 4096, "float32")


def _flash_inputs(case, seed):
    import torch
    B, S, H, K, D, _, _, dt = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, n, D), generator=g, device="cuda")
            .to(getattr(torch, dt)) for n in (H, K, K)]


def _rg_inputs(case, seed):
    import torch
    B, S, C, dt = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((B, S, C), generator=g, device="cuda") * 0.2 + 0.8
    b = torch.randn((B, S, C), generator=g, device="cuda") * 0.1
    return a.to(getattr(torch, dt)), b.to(getattr(torch, dt))


def _rg_launch(lib, a, b, tma: int, fill=None):
    """A library's RG-LRU entry point on one route, launched as
    `kernel.rg_lru_fwd` launches it (not counted); the output starts as
    `fill` when given, so that a step left unwritten cannot pass on what
    an earlier launch left in the memory."""
    import torch
    from repro_torch.kernels import _build
    B, S, C = a.shape
    y = torch.empty_like(a) if fill is None else torch.full_like(a, fill)
    err = lib.load().rg_lru_launch(
        _build.ptr(a), _build.ptr(b), _build.ptr(y), B, S, C,
        int(a.dtype == torch.bfloat16), tma, _build.stream(a.device))
    if err:
        raise RuntimeError(f"{lib.name}: CUDA error {err}")
    return y


def _rg_check(a, b, route: str, tag: str) -> None:
    """The wrapper on a and b must take `route` (one launch counted there)
    and equal the plain version bit for bit."""
    import torch
    from repro_torch.kernels.rg_lru import kernel as rg, ref as rgr
    n0 = dict(rg.LAUNCHES)
    got = rg.rg_lru_fwd(a, b)
    want = rgr.rg_lru_reference(a, b)
    torch.cuda.synchronize()
    took = {k: v - n0[k] for k, v in rg.LAUNCHES.items() if v != n0[k]}
    if took != {route: 1}:
        raise AssertionError(f"rg_lru {tag}: launches {took}, expected "
                             f"{{'{route}': 1}}")
    if not _bits_equal(got, want):
        raise AssertionError(f"rg_lru {tag}: kernel != plain "
                             f"(max abs err {_max_abs_err(got, want)})")
    log(f"[3 kernels] rg_lru {tag} ({route}): bit-equal to plain")


def _rg_timing(case) -> dict:
    """The ring (through the wrapper) and the generic kernel at one shape,
    in turns (generic, ring, ring, generic), with the plain version and
    the bound: a, b and h once each over the HBM rate, against 2 FLOP a
    step at the fp32 rate."""
    import torch
    from repro_torch.kernels.rg_lru import kernel as rg, ref as rgr
    B, S, C, dt = case
    a, b = _rg_inputs(case, 2)
    nbytes = _nbytes(a, b, a)
    bound, by = _bound_ms(nbytes, (2 * B * S * C, F32_OPS_PER_S))
    ring, generic = [], []
    for turn in ("generic", "ring", "ring", "generic"):
        if turn == "ring":
            ring.append(_device_ms(lambda: rg.rg_lru_fwd(a, b), iters=20))
        else:
            generic.append(_device_ms(
                lambda: _rg_launch(rg.LIBRARY, a, b, 0), iters=20))
    t = {"ms": min(ring), "ring_turns": ring, "generic_ms": min(generic),
         "generic_turns": generic,
         "plain_ms": _device_ms(lambda: rgr.rg_lru_reference(a, b), iters=1),
         "library_ms": None,
         "call_ms": _call_ms(lambda: rg.rg_lru_fwd(a, b), iters=20),
         "bound_ms": bound, "bound_by": by,
         "shape": f"a/b [{B},{S},{C}] {dt}", "flop": 2 * B * S * C,
         "bytes": nbytes}
    del a, b
    torch.cuda.empty_cache()
    return t


def _flash_timing(case, iters, plain_iters) -> dict:
    """The flash kernel, its plain version and SDPA (the yardstick; the
    port never calls it: with the same band mask, or `is_causal` without
    a window) at one shape, with the bound: the in-band pairs' FLOP at
    the bf16 rate against the bytes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa, ref as far
    B, S, H, K, D, W, cap, dt = case
    q, k, v = _flash_inputs(case, 1)
    ok = far.band_mask(S, True, W, q.device)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = dict(is_causal=True) if W == 0 else dict(attn_mask=ok)
    lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                         **mask).transpose(1, 2)
    lib_err = _max_abs_err(lib.float(), far.mha_reference(
        q, k, v, causal=True, window=W).float())
    del lib
    pairs = int(ok.sum())
    nbytes = _nbytes(q, k, v, q)
    flop = 4 * D * pairs * B * H
    bound, by = _bound_ms(nbytes, (flop, BF16_OPS_PER_S))
    t = {"ms": _device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=True, window=W), iters=iters),
         "plain_ms": _device_ms(lambda: far.mha_reference(
             q, k, v, causal=True, window=W), iters=plain_iters),
         "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, enable_gqa=True, **mask), iters=iters),
         "call_ms": _call_ms(lambda: fa.flash_attention_fwd(
             q, k, v, causal=True, window=W), iters=iters),
         "bound_ms": bound, "bound_by": by,
         "shape": f"q [{B},{S},{H},{D}] k/v [{B},{S},{K},{D}] {dt} W={W}",
         "flop": flop, "bytes": nbytes, "library_err": lib_err}
    del q, k, v, qt, kt, vt, ok
    torch.cuda.empty_cache()
    return t


def _row_err(got, want32) -> float:
    """Max over the rows (b, position, head) of max |got - want32| over
    the row divided by the row's RMS in want32 (NaN when a row is 0)."""
    d = (got.float() - want32).abs().amax(-1)
    return float((d / want32.pow(2).mean(-1).sqrt()).max())


def _flash_planted_faults() -> dict:
    """Three wrong outputs at the forward's shape, which the row check
    must reject: the kernel run with W - 64 (one 64-key tile fewer in
    every long row), the plain version without the interior keys 1024 ..
    1087 (a skipped tile), and the kernel's output with its 2048-key rows
    scaled by 0.97 (a normaliser that counts one of their 32 tiles twice).
    -> {fault: (max abs err against the plain version, row error)}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa, ref as far
    B, S, H, K, D, W, cap, dt = FLASH_MAIN
    q, k, v = _flash_inputs(FLASH_MAIN, 100)   # phase 3's first case
    want = far.mha_reference(q, k, v, causal=True, window=W)
    want32 = far.mha_reference(q.float(), k.float(), v.float(), causal=True,
                               window=W)
    good = fa.flash_attention_fwd(q, k, v, causal=True, window=W)
    ok = far.band_mask(S, True, W, q.device)
    ok[:, 1024:1088] = False
    qt, kt, vt = (x.float().transpose(1, 2) for x in (q, k, v))
    long_rows = (torch.arange(S, device=q.device) >= W - 1)[:, None, None]
    faults = {
        "kernel at W - 64": fa.flash_attention_fwd(q, k, v, causal=True,
                                                   window=W - 64),
        "keys 1024..1087 skipped": F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=ok, enable_gqa=True).transpose(1, 2)
        .to(q.dtype),
        "long rows x 0.97": torch.where(long_rows, good.float() * 0.97,
                                        good.float()).to(q.dtype)}
    out = {}
    for name, f in faults.items():
        out[name] = (_max_abs_err(f.float(), want.float()),
                     _row_err(f, want32))
        if not out[name][1] > TOL_FLASH_ROW:
            raise AssertionError(f"flash_attention: the row check passes "
                                 f"the planted fault '{name}' "
                                 f"({out[name][1]} <= {TOL_FLASH_ROW})")
        log(f"[3 kernels] flash_attention planted fault '{name}': max abs "
            f"err {out[name][0]:.3e} (TOL_FLASH {TOL_FLASH[dt]}), row err "
            f"{out[name][1]:.3e} > {TOL_FLASH_ROW}: rejected")
    del q, k, v, want, want32, good, ok, qt, kt, vt, faults
    torch.cuda.empty_cache()
    return out


def phase_lm_kernels(rg_fault_libs) -> dict:
    """Flash attention and the RG-LRU scan against their plain versions
    on the card, the RG-LRU planted faults rejected, then each timed at
    the RecurrentGemma-9B path's shapes."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa, ref as far
    from repro_torch.kernels.rg_lru import kernel as rg, ref as rgr
    t0 = time.perf_counter()
    err = {"flash_attention": 0.0, "rg_lru": 0.0}
    row_err = 0.0
    cases = ([(c, True) for c in FLASH_CASES + (FLASH_PREFILL,)]
             + [(c, False) for c in FLASH_NONCAUSAL])
    for i, (case, causal) in enumerate(cases):
        _, _, _, _, _, W, cap, dt = case
        q, k, v = _flash_inputs(case, 100 + i)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=W,
                                     softcap=cap)
        want = far.mha_reference(q, k, v, causal=causal, window=W,
                                 softcap=cap)
        want32 = want if dt == "float32" else far.mha_reference(
            q.float(), k.float(), v.float(), causal=causal, window=W,
            softcap=cap)
        torch.cuda.synchronize()
        e = _max_abs_err(got.float(), want.float())
        r = _row_err(got, want32)
        if got.dtype != want.dtype or not bool(torch.isfinite(got).all()) \
                or e > TOL_FLASH[dt] or not r <= TOL_FLASH_ROW:
            raise AssertionError(f"flash_attention {case} causal={causal}: "
                                 f"max abs err {e} (limit {TOL_FLASH[dt]}), "
                                 f"row err {r} (limit {TOL_FLASH_ROW})")
        err["flash_attention"] = max(err["flash_attention"], e)
        row_err = max(row_err, r)
        log(f"[3 kernels] flash_attention {case}"
            f"{'' if causal else ' not causal'}: max abs err {e:.3e}, row "
            f"err {r:.3e}")
        del q, k, v, got, want, want32
    torch.cuda.empty_cache()
    faults = _flash_planted_faults()
    for i, (*case, route) in enumerate(RG_CASES):
        a, b = _rg_inputs(case, 200 + i)
        _rg_check(a, b, route, str(tuple(case)))
        del a, b
    B, S, C, dt = RG_OFFSET_CASE
    a, b = _rg_inputs(RG_OFFSET_CASE, 240)
    a1, b1 = (torch.empty(B * S * C + 1, dtype=x.dtype, device=x.device)
              [1:].view(B, S, C).copy_(x) for x in (a, b))
    _rg_check(a1, b1, "rg_lru_generic",
              f"{RG_OFFSET_CASE} one element into its storage")
    del a, b, a1, b1
    # the planted faults on the ring: each must be rejected
    a, b = _rg_inputs(RG_FAULT_CASE, 250)
    want = rgr.rg_lru_reference(a, b)
    rg_faults = {}
    for (name, _), lib in zip(RG_FAULTS, rg_fault_libs):
        got = _rg_launch(lib, a, b, 1, fill=float("nan"))
        torch.cuda.synchronize()
        if _bits_equal(got, want):
            raise AssertionError(f"rg_lru: the bit check passes the planted "
                                 f"fault '{name}'")
        ok = torch.isfinite(got)
        rg_faults[name] = {"max_abs_err": _max_abs_err(got, want),
                           "steps_unwritten": int((~ok).any(-1).sum())}
        log(f"[3 kernels] rg_lru planted fault '{name}' at {RG_FAULT_CASE}: "
            f"max abs err {rg_faults[name]['max_abs_err']:.3e} over the "
            f"written steps, {rg_faults[name]['steps_unwritten']} steps "
            "unwritten: rejected")
        del got
    del a, b, want
    torch.cuda.empty_cache()

    for i, (B, S, H, K, Dh, Dv, W, cap, dt) in enumerate(FLASH_DV_CASES):
        g = torch.Generator(device="cuda").manual_seed(150 + i)
        q, k, v = (torch.randn((B, S, n, d), generator=g, device="cuda")
                   .to(getattr(torch, dt))
                   for n, d in ((H, Dh), (K, Dh), (K, Dv)))
        got = fa.flash_attention_fwd(q, k, v, causal=True, window=W,
                                     softcap=cap)
        want = far.mha_reference(q, k, v, causal=True, window=W, softcap=cap)
        torch.cuda.synchronize()
        e = _max_abs_err(got.float(), want.float())
        if got.shape != (B, S, H, Dv) or got.dtype != want.dtype \
                or e > TOL_FLASH[dt]:
            raise AssertionError(f"flash_attention Dh {Dh} Dv {Dv} {dt}: "
                                 f"{tuple(got.shape)}, max abs err {e}")
        err["flash_attention"] = max(err["flash_attention"], e)
        log(f"[3 kernels] flash_attention Dh {Dh}, Dv {Dv}, {dt}: max abs "
            f"err {e:.3e}")
    for i, (dta, dtb) in enumerate((("bfloat16", "float32"),
                                    ("float32", "bfloat16"))):
        a, _ = _rg_inputs((2, 1000, 512, dta), 260 + i)
        _, b = _rg_inputs((2, 1000, 512, dtb), 260 + i)
        got = rg.rg_lru_fwd(a, b)
        want = rgr.rg_lru_reference(a, b)
        torch.cuda.synchronize()
        if not _bits_equal(got, want):
            raise AssertionError(f"rg_lru a {dta}, b {dtb}: kernel != plain")
        log(f"[3 kernels] rg_lru a {dta}, b {dtb}: bit-equal to plain")

    timing = {"flash_attention": _flash_timing(FLASH_MAIN, iters=20,
                                               plain_iters=5)}
    prefill = _flash_timing(FLASH_PREFILL, iters=5, plain_iters=1)
    timing["rg_lru"] = _rg_timing(RG_MAIN)
    rg_prefill = _rg_timing(RG_PREFILL)
    for name, t in (*timing.items(), ("rg_lru", rg_prefill)):
        lib_ms = ("none" if t["library_ms"] is None
                  else f"{t['library_ms'] * 1e3:.1f} us")
        log(f"[3 kernels] {name} at {t['shape']}: device "
            f"{t['ms'] * 1e3:.1f} us/call (plain {t['plain_ms'] * 1e3:.1f} "
            f"us, library {lib_ms}), per call incl. launch "
            f"{t['call_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.1f} "
            f"us ({t['bound_by']}: {t['flop']:.3e} FLOP, "
            f"{t['bytes'] / 1e6:.1f} MB); {t['bound_ms'] / t['ms']:.1%} of "
            "the bound")
    t = timing["flash_attention"]
    if not t["ms"] < t["library_ms"]:
        raise AssertionError(f"flash_attention {t['ms']} ms per call, not "
                             f"below SDPA's {t['library_ms']} ms")
    for t in (timing["rg_lru"], rg_prefill):
        log(f"[3 kernels] rg_lru at {t['shape']} in turns: the generic "
            f"kernel {', '.join(f'{x * 1e3:.1f}' for x in t['generic_turns'])}"
            f" us, the ring {', '.join(f'{x * 1e3:.1f}' for x in t['ring_turns'])}"
            f" us/call")
        if not max(t["ring_turns"]) < min(t["generic_turns"]):
            raise AssertionError(f"rg_lru at {t['shape']}: the ring "
                                 f"{t['ring_turns']} ms, not below the "
                                 f"generic kernel's {t['generic_turns']}")
    t = prefill
    log(f"[3 kernels] flash_attention at the prefill shape {t['shape']}: "
        f"device {t['ms'] * 1e3:.1f} us/call (plain "
        f"{t['plain_ms'] * 1e3:.1f} us, library {t['library_ms'] * 1e3:.1f} "
        f"us), per call incl. launch {t['call_ms'] * 1e3:.1f} us, bound "
        f"{t['bound_ms'] * 1e3:.1f} us ({t['bound_by']}: {t['flop']:.3e} "
        f"FLOP, {t['bytes'] / 1e6:.1f} MB); {t['bound_ms'] / t['ms']:.1%} "
        f"of the bound; sdpa max abs err vs plain {t['library_err']:.3e}")
    log(f"[3 kernels] sdpa yardstick max abs err vs plain "
        f"{timing['flash_attention']['library_err']:.3e}; "
        f"{len(cases)} flash cases within tolerance (max abs err "
        f"{err['flash_attention']:.3e}, row err {row_err:.3e}), "
        f"{len(faults)} planted faults rejected, {len(RG_CASES) + 1} "
        f"rg_lru cases bit-equal, {len(rg_faults)} rg_lru planted faults "
        f"rejected ({time.perf_counter() - t0:.1f}s)")
    torch.cuda.empty_cache()
    paths = _flash_paths(err)
    return {"err": err, "timing": timing, "flash_prefill": prefill,
            "rg_prefill": rg_prefill, "flash_row_err": row_err,
            "flash_faults": faults, "rg_faults": rg_faults,
            "flash_paths": paths}


def _flash_paths(err: dict) -> dict:
    """The flash kernel at the full-causal shapes of phase 12's GQA paths:
    held to its plain version (TOL_FLASH and the row check), then timed
    beside the plain version, SDPA with `is_causal` and the bound. SDPA
    may be the faster here: that is written down, not failed."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa, ref as far
    t0 = time.perf_counter()
    out = {}
    for i, (arch, case) in enumerate(FLASH_PATHS.items()):
        _, _, _, _, _, W, cap, dt = case
        q, k, v = _flash_inputs(case, 300 + i)
        got = fa.flash_attention_fwd(q, k, v, causal=True, window=W)
        want = far.mha_reference(q, k, v, causal=True, window=W)
        want32 = far.mha_reference(q.float(), k.float(), v.float(),
                                   causal=True, window=W)
        torch.cuda.synchronize()
        e = _max_abs_err(got.float(), want.float())
        r = _row_err(got, want32)
        del q, k, v, got, want, want32
        torch.cuda.empty_cache()
        if e > TOL_FLASH[dt] or not r <= TOL_FLASH_ROW:
            raise AssertionError(f"flash_attention at {arch}'s shape {case}: "
                                 f"max abs err {e}, row err {r}")
        err["flash_attention"] = max(err["flash_attention"], e)
        t = _flash_timing(case, iters=10, plain_iters=1)
        t.update(max_abs_err=e, row_err=r)
        out[arch] = t
        log(f"[3 kernels] flash_attention at {arch}'s {t['shape']} causal: "
            f"max abs err {e:.3e}, row err {r:.3e}; device "
            f"{t['ms'] * 1e3:.1f} us/call (plain {t['plain_ms'] * 1e3:.1f} "
            f"us, SDPA is_causal {t['library_ms'] * 1e3:.1f} us: flash "
            f"{t['library_ms'] / t['ms']:.2f}x SDPA's speed), bound "
            f"{t['bound_ms'] * 1e3:.1f} us ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.1%} of the bound")
    log(f"[3 kernels] flash_attention at {len(out)} full-causal path shapes "
        f"({time.perf_counter() - t0:.1f}s)")
    return out


# SSD scan cases: B, S, H, P, N, chunk, G, dtype
SSD_MAIN = (4, 4096, 48, 64, 128, 128, 1, "bfloat16")  # Mamba-2 780M scoring
SSD_CASES = (
    SSD_MAIN,
    (1, 32, 2, 8, 4, 16, 2, "float32"),      # tests/test_kernels.py shapes,
    (2, 64, 3, 16, 8, 16, 3, "float32"),     # B and C per head (G = H)
    (1, 128, 2, 16, 16, 32, 2, "float32"),
    (1, 64, 2, 16, 8, 16, 2, "bfloat16"),    # its bf16 case
    (1, 1024, 8, 64, 128, 128, 1, "float32"),  # fp32 at the path's widths
    (2, 256, 8, 64, 128, 64, 2, "bfloat16"),   # G = 2 of 8 heads
    (1, 300, 4, 64, 128, 4, 1, "bfloat16"),    # S = 300: chunk 4
    (1, 33, 4, 16, 16, 1, 1, "float32"),       # S = 33: chunk 1
    (2, 1, 4, 64, 128, 1, 1, "float32"),       # S = 1
    (1, 64, 2, 24, 12, 32, 1, "float32"),      # P, N not multiples of 32, 4
    # the bf16 tensor-core kernel's edges (rows and state padded to 16, 32
    # state columns a block, cp.async loads when N and P are multiples of
    # 8, element loads otherwise)
    (2, 512, 8, 64, 128, 128, 8, "bfloat16"),  # G = H at the path's widths
    (1, 1024, 8, 64, 128, 64, 1, "bfloat16"),  # chunk 64, the path's widths
    (1, 64, 2, 24, 12, 32, 1, "bfloat16"),     # P, N not multiples of 8
    (1, 200, 3, 40, 96, 40, 3, "bfloat16"),    # P 40: a slice of 8; chunk 40
    (1, 33, 4, 16, 16, 1, 1, "bfloat16"),      # chunk 1
    (2, 1, 4, 64, 128, 1, 1, "bfloat16"),      # S = 1
)
# the planted faults (SSD_FAULTS) run at the path's widths
SSD_FAULT_CASE = (1, 1024, 4, 64, 128, 128, 1, "bfloat16")


def _ssd_inputs(case, seed):
    """x, dt, A, Bg, Cg on the card, as tests/test_kernels.py draws them."""
    import torch
    import torch.nn.functional as F
    B, S, H, P, N, _, G, dt = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (rn(B, S, H, P) * 0.5).to(getattr(torch, dt))
    dts = F.softplus(rn(B, S, H)) * 0.1
    A = -torch.exp(rn(H))
    Bg = (rn(B, S, G, N) * 0.5).to(getattr(torch, dt))
    Cg = (rn(B, S, G, N) * 0.5).to(getattr(torch, dt))
    return x, dts, A, Bg, Cg


def _ssd_errors(got, want, case) -> tuple[float, float]:
    """(y, h_last) max abs error over max(1, max |plain|)."""
    import torch
    errs = []
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape \
                or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"ssd_scan {case}: {a.dtype} "
                                 f"{tuple(a.shape)} vs {b.dtype} "
                                 f"{tuple(b.shape)}, or not finite")
        e = _max_abs_err(a.float(), b.float())
        errs.append(e / max(1.0, float(b.float().abs().max())))
    return errs[0], errs[1]


def _ssd_passes(case, errs) -> bool:
    return errs[0] <= TOL_SSD[case[7]] and errs[1] <= TOL_SSD["float32"]


def _ssd_launch(lib, x, dts, A, Bg, Cg, chunk):
    """A planted fault's library, launched as `kernel.ssd_fwd` launches the
    kernel's (not counted)."""
    import torch
    from repro_torch.kernels import _build
    B, S, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    err = lib.load().ssd_scan_launch(
        _build.ptr(x), _build.ptr(dts), _build.ptr(A), _build.ptr(Bg),
        _build.ptr(Cg), _build.ptr(y), _build.ptr(h), B, S, H, P, G, N,
        chunk, int(x.dtype == torch.bfloat16), _build.stream(x.device))
    if err:
        raise RuntimeError(f"{lib.name}: CUDA error {err}")
    return y, h


def phase_ssd_kernels(fault_libs) -> dict:
    """The SSD scan against its plain version on the card, the planted
    faults rejected, then the bf16 kernel timed at the Mamba-2 780M scoring
    shape beside the fp32 CUDA-core route at the same shape."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd, ops as ssd_ops
    t0 = time.perf_counter()
    err = 0.0
    for i, case in enumerate(SSD_CASES):
        Q, dt = case[5], case[7]
        args = _ssd_inputs(case, 300 + i)
        got = ssd.ssd_fwd(*args, chunk=Q)
        want = ssd_ops.ssd_plain(*args)
        torch.cuda.synchronize()
        errs = _ssd_errors(got, want, case)
        if not _ssd_passes(case, errs):
            raise AssertionError(f"ssd_scan {case}: y, h_last error {errs} "
                                 f"> {TOL_SSD[dt]}, {TOL_SSD['float32']}")
        err = max(err, max(errs))
        log(f"[3 kernels] ssd_scan {case}: error y {errs[0]:.3e}, h_last "
            f"{errs[1]:.3e}")
        del args, got, want
    # x, B and C in mixed dtypes: `ops.ssd` takes the fp32 route and
    # rounds y to x's dtype
    for i, (dx, db, dc) in enumerate((("bfloat16", "float32", "float32"),
                                      ("float32", "bfloat16", "bfloat16"),
                                      ("bfloat16", "bfloat16", "float32"))):
        case = (2, 256, 8, 64, 128, 64, 2, dx)
        x, dts, A, Bg, Cg = _ssd_inputs((*case[:7], "float32"), 350 + i)
        x, Bg, Cg = (v.to(getattr(torch, d))
                     for v, d in ((x, dx), (Bg, db), (Cg, dc)))
        got = ssd_ops.ssd(x, dts, A, Bg, Cg, chunk=case[5])
        want = ssd_ops.ssd_plain(x, dts, A, Bg, Cg)
        torch.cuda.synchronize()
        errs = _ssd_errors(got, want, case)
        if not _ssd_passes(case, errs):
            raise AssertionError(f"ssd_scan x {dx}, B {db}, C {dc}: y, "
                                 f"h_last error {errs}")
        err = max(err, max(errs))
        log(f"[3 kernels] ssd_scan x {dx}, B {db}, C {dc} (the fp32 route): "
            f"error y {errs[0]:.3e}, h_last {errs[1]:.3e}")
        del x, dts, A, Bg, Cg, got, want
    try:
        ssd.ssd_fwd(*_ssd_inputs((1, 48, 2, 8, 4, 0, 1, "float32"), 0),
                    chunk=32)
        raise AssertionError("ssd_scan took a chunk that does not divide S")
    except ValueError:
        pass

    # the planted faults, at the path's widths: each must be rejected
    case = SSD_FAULT_CASE
    args = _ssd_inputs(case, 400)
    want = ssd_ops.ssd_plain(*args)
    good = _ssd_errors(ssd.ssd_fwd(*args, chunk=case[5]), want, case)
    log(f"[3 kernels] ssd_scan planted faults at {case}: the kernel's error "
        f"y {good[0]:.3e}, h_last {good[1]:.3e}")
    faults = {}
    for (name, _), lib in zip(SSD_FAULTS, fault_libs):
        got = _ssd_launch(lib, *args, case[5])
        torch.cuda.synchronize()
        faults[name] = _ssd_errors(got, want, case)
        if _ssd_passes(case, faults[name]):
            raise AssertionError(f"ssd_scan: the checks pass the planted "
                                 f"fault '{name}' ({faults[name]})")
        log(f"[3 kernels] ssd_scan planted fault '{name}': error y "
            f"{faults[name][0]:.3e} (limit {TOL_SSD['bfloat16']}), h_last "
            f"{faults[name][1]:.3e} (limit {TOL_SSD['float32']}): rejected")
        del got
    del args, want

    B, S, H, P, N, Q, G, dt = SSD_MAIN
    x, dts, A, Bg, Cg = _ssd_inputs(SSD_MAIN, 1)
    # the causal half only (j <= i), as the kernels compute it: C B^T is a
    # product of bf16 inputs (exact on the tensor cores with fp32
    # accumulation); the masked scores times x, C h and the state update
    # have one fp32 operand each, which the tensor cores take in two bf16
    # passes. The CUDA-core design's bound: those at the 67 TFLOP/s fp32
    # rate.
    chunks = B * H * (S // Q)
    cb_flop = chunks * Q * (Q + 1) * N
    f32_flop = chunks * (Q * (Q + 1) * P + 4 * Q * N * P)
    nbytes = _nbytes(x, dts, Bg, Cg, x) + B * H * N * P * 4
    bound, by = _bound_ms(nbytes, (cb_flop, BF16_OPS_PER_S),
                          (2 * f32_flop, BF16_OPS_PER_S))
    f32_rate_bound = _bound_ms(nbytes, (cb_flop, BF16_OPS_PER_S),
                               (f32_flop, F32_OPS_PER_S))[0]
    x32, B32, C32 = x.float(), Bg.float(), Cg.float()
    t = {"ms": _device_ms(lambda: ssd.ssd_fwd(x, dts, A, Bg, Cg, chunk=Q),
                          iters=20),
         "cuda_core_ms": _device_ms(
             lambda: ssd.ssd_fwd(x32, dts, A, B32, C32, chunk=Q), iters=5),
         "plain_ms": _device_ms(
             lambda: ssd_ops.ssd_plain(x, dts, A, Bg, Cg), iters=1),
         "library_ms": None,
         "call_ms": _call_ms(lambda: ssd.ssd_fwd(x, dts, A, Bg, Cg, chunk=Q),
                             iters=20),
         "bound_ms": bound, "bound_by": by,
         "f32_rate_bound_ms": f32_rate_bound, "faults": faults}
    del x, dts, A, Bg, Cg, x32, B32, C32
    log(f"[3 kernels] ssd_scan at x [{B},{S},{H},{P}] B/C [{B},{S},{G},{N}] "
        f"{dt} chunk {Q}: device {t['ms'] * 1e3:.1f} us/call (the fp32 "
        f"CUDA-core route at the same shape {t['cuda_core_ms'] * 1e3:.1f} "
        f"us, plain {t['plain_ms'] * 1e3:.1f} us, library none), per call "
        f"incl. launch {t['call_ms'] * 1e3:.1f} us, bound "
        f"{t['bound_ms'] * 1e3:.1f} us ({by}: C B^T {cb_flop:.3e} FLOP and "
        f"2 x {f32_flop:.3e} FLOP at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e6:.1f} MB; with the fp32 operands' products at 67 "
        f"TFLOP/s fp32 {f32_rate_bound * 1e3:.1f} us); "
        f"{t['bound_ms'] / t['ms']:.1%} of the bound; {len(SSD_CASES)} cases "
        f"within tolerance, {len(faults)} planted faults rejected "
        f"({time.perf_counter() - t0:.1f}s)")
    if not t["ms"] < t["cuda_core_ms"]:
        raise AssertionError(f"ssd_scan bf16 {t['ms']} ms per call, not "
                             f"below the CUDA-core route's "
                             f"{t['cuda_core_ms']} ms")
    torch.cuda.empty_cache()
    return {"err": {"ssd_scan": err}, "timing": {"ssd_scan": t}}


# ---------------------------------------------------------------------------
# phase 4: the DAS pipeline at full size
# ---------------------------------------------------------------------------
def _eager_vs_graph() -> dict:
    """One oracle-sized sweep (ETF over 40 mixes x 14 rates, 60 frames) in
    turns: eager, graph, graph, eager, each a host clock around the sweep
    and its copy to the host. Returns ms per super-step of each run, and
    fails unless the two give the same results bit for bit and the graph
    is the faster in both pairs."""
    import numpy as np
    from repro_torch.core import simulator as sim, workloads
    suite = workloads.default_suite(n_instances=60)
    stacked = suite.build_many([(m, r) for m in range(40) for r in range(14)])
    params = sim.make_params(device="cuda")
    runs, results = [], {}
    for kind in ("eager", "graph", "graph", "eager"):
        simulate = (sim._simulate_eager if kind == "eager"
                    else sim.simulate_batch)
        tel = []
        t0 = time.perf_counter()
        res = sim.to_numpy(sim._run_batch(simulate, sim.MODE_ETF, stacked,
                                          params, device="cuda",
                                          telemetry=tel))
        wall = time.perf_counter() - t0
        steps = sum(x["steps"] for x in tel)
        runs.append((kind, wall * 1e3 / steps, steps))
        results.setdefault(kind, res)
    for f in sim.SimResult._fields:
        a, b = getattr(results["graph"], f), getattr(results["eager"], f)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"ETF sweep {f}: graph != eager")
    eager = [ms for k, ms, _ in runs if k == "eager"]
    graph = [ms for k, ms, _ in runs if k == "graph"]
    log(f"[4 das] one oracle-sized ETF sweep ({runs[0][2]} super-steps), in "
        f"turns: " + ", ".join(f"{k} {ms:.3f}" for k, ms, _ in runs)
        + " ms/step; graph and eager results bit-equal")
    if not max(graph) < min(eager):
        raise AssertionError(f"the captured step is not faster: {runs}")
    return {"eager_ms_per_step": eager, "graph_ms_per_step": graph,
            "steps": runs[0][2]}


def _use_autotune_dir() -> None:
    """Every `Bench` of this run keeps its chunk-size autotune cache in
    the checkout's `build/`, and none is pinned by `REPRO_BENCH_BATCH`."""
    import os
    os.environ["REPRO_BENCH_CACHE_DIR"] = str(AUTOTUNE_DIR)
    os.environ.pop("REPRO_BENCH_BATCH", None)


def _autotune() -> dict:
    """The chunk-size autotune on the card from an empty cache: the probe
    runs (its `#` line gives each candidate's seconds) and stores its
    pick; resolved again with the in-process cache cleared, the pick
    comes from the file. Before the pipeline's launches are counted: the
    probe's sweeps launch `avail_rows`."""
    from repro_torch.bench import common
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    _use_autotune_dir()
    common._autotuned.cache_clear()
    t0 = time.perf_counter()
    batch, source = common.resolve_batch_size("cuda")
    probe_s = time.perf_counter() - t0
    common._autotuned.cache_clear()
    again = common.resolve_batch_size("cuda")
    cache = json.loads((AUTOTUNE_DIR / "autotune.json").read_text())
    log(f"[4 das] chunk-size autotune: probe of "
        f"{common._BATCH_CANDIDATES['cuda']} on "
        f"{len(common._probe_cells('cuda'))} scenarios at "
        f"{common._PROBE_FRAMES} frames in {probe_s:.2f}s (limit "
        f"{PROBE_S:.0f}s), chose {batch} ({source}); resolved again with "
        f"the in-process cache cleared: {again}; cache file {cache}")
    if source != "probe" or again != (batch, "cache") or probe_s > PROBE_S:
        raise AssertionError(f"autotune: {batch} ({source}) in {probe_s}s, "
                             f"then {again}")
    return {"batch": batch, "probe_s": probe_s}


def phase_main() -> dict:
    import torch
    from repro_torch.bench import summary40
    from repro_torch.kernels.etf_ft import ops
    ref = json.loads((ROOT / "benchmarks" / "BENCH_sweep.json")
                     .read_text())["derived"]
    turns = _eager_vs_graph()
    tuned = _autotune()
    if tuned["batch"] < MAIN_S:
        raise AssertionError(f"the autotune chose {tuned['batch']}, less "
                             f"than one chunk a sweep ({MAIN_S})")
    t0 = time.perf_counter()
    ops.reset_launches()
    out = summary40.run(device="cuda")
    torch.cuda.synchronize()
    # the simulator counts each graph replay's launches, those it recorded
    # while capturing the graph (capture itself launches nothing)
    launches = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    for sw in out["sweeps"]:
        if sw["stalled"] or sw["unfinished"] or sw["ready_drop"]:
            raise AssertionError(f"unhealthy sweep: {sw}")
        log(f"[4 das] sweep {sw['label']}: {sw['scenarios']} scenarios, "
            f"{sw['wall_s']:.2f}s, {sw['steps']} super-steps, "
            f"{sw['events']} events, "
            f"{sw['wall_s'] * 1e3 / max(sw['steps'], 1):.3f} ms/step")
    for k in summary40.DERIVED:
        log(f"[4 das] {k}: port {out[k]!r} reference {ref[k]!r} "
            f"diff {out[k] - ref[k]:+.3e}")
    if out["das_matches_best_frac"] != ref["das_matches_best_frac"]:
        raise AssertionError("das_matches_best_frac differs")
    for k in summary40.DERIVED[:4]:
        if abs(out[k] - ref[k]) > TOL_DERIVED:
            raise AssertionError(f"{k}: {out[k]} vs {ref[k]}")
    if out["n_samples"] != {"avg_exec_us": 420168, "edp": 420168}:
        raise AssertionError(f"oracle samples {out['n_samples']}")
    steps = sum(sw["steps"] for sw in out["sweeps"])
    sweep_s = sum(sw["wall_s"] for sw in out["sweeps"])
    # one avail_rows a super-step (the completion phase), one fixed masked
    # search a super-step in every mode but LUT, nothing else of the library
    want = {"avail_rows": steps,
            "etf_ft_search_masked": sum(sw["steps"] for sw in out["sweeps"]
                                        if sw["mode"] != "LUT"),
            "push_rows": 0, "etf_ft_search": 0,
            # the simulator's search inputs are aligned [16, 19] matrices
            "etf_ft_search_masked_generic": 0, "etf_ft_search_generic": 0}
    if steps != SUMMARY40_STEPS or launches != want:
        raise AssertionError(f"{steps} super-steps (expected "
                             f"{SUMMARY40_STEPS}), launches {launches}, "
                             f"expected {want}")
    log(f"[4 das] oracle samples {out['n_samples']} (reference 420168); "
        f"{out['n_cells']} cells; launches {launches}; "
        f"{steps} super-steps in {sweep_s:.2f}s of sweeps = "
        f"{sweep_s * 1e3 / steps:.3f} ms/step; pipeline {wall:.1f}s at "
        f"the autotuned chunk of {tuned['batch']}")
    return {"launches": launches, "out": out, "turns": turns,
            "autotune": tuned}


# ---------------------------------------------------------------------------
# phase 5: the DAS engine, card against CPU, per scenario
# ---------------------------------------------------------------------------
EXACT_FIELDS = ("n_done", "pe_of", "finish", "log_feat", "log_policy",
                "log_agree", "log_task", "n_fast", "n_slow", "n_iters",
                "n_decisions", "stall_reason", "ready_drop", "makespan_us",
                "inst_exec_us")
AGG_FIELDS = ("avg_exec_us", "task_energy_uj", "sched_energy_uj",
              "total_energy_uj", "edp", "sched_time_us")


def phase_cross(trees: dict) -> None:
    import numpy as np
    from repro_torch.core import convert, simulator as sim, workloads
    t0 = time.perf_counter()
    suite = workloads.default_suite(n_instances=60)
    cells = [(m, r) for m in (0, 5, 17, 39) for r in (0, 13)]
    stacked = suite.build_many(cells)
    worst = 0.0
    for mode in (sim.MODE_LUT, sim.MODE_ETF, sim.MODE_DAS):
        res = {}
        for dev in ("cuda", "cpu"):
            tree = (convert.dtree_from_numpy(**trees["DAS"], device=dev)
                    if mode == sim.MODE_DAS else None)
            res[dev] = sim.to_numpy(sim.run_batch(mode, stacked, tree=tree,
                                                  device=dev))
            if dev == "cuda":   # the card's eager loop: the same kernels
                eager = sim.to_numpy(sim._run_batch(
                    sim._simulate_eager, mode, stacked, tree=tree,
                    device=dev))
        for f in sim.SimResult._fields:
            a, b = getattr(res["cuda"], f), getattr(eager, f)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"{sim.MODE_NAMES[mode]} {f}: card "
                                     "graph != card eager")
        for f in EXACT_FIELDS:
            a, b = getattr(res["cuda"], f), getattr(res["cpu"], f)
            if a.dtype != b.dtype or not np.array_equal(a, b,
                                                        equal_nan=True):
                raise AssertionError(f"{sim.MODE_NAMES[mode]} {f}: card != "
                                     "CPU")
        for f in AGG_FIELDS:
            a = getattr(res["cuda"], f).astype(np.float64)
            b = getattr(res["cpu"], f).astype(np.float64)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            worst = max(worst, float(rel.max()))
            if (rel > TOL_AGG).any():
                raise AssertionError(f"{sim.MODE_NAMES[mode]} {f}: rel "
                                     f"{rel.max():.2e} > {TOL_AGG}")
    log(f"[5 das-cross] {len(cells)} cells x LUT/ETF/DAS at 60 instances: "
        f"every field bit-equal card graph vs card eager; "
        f"schedules bit-equal card vs CPU, float aggregates within "
        f"{worst:.2e} relative ({time.perf_counter() - t0:.1f}s)")


# ---------------------------------------------------------------------------
# phase 5b: the fault path on the card
# ---------------------------------------------------------------------------
# the fault path: `bench.faults.stress_plans()` (16 scenarios) on that
# section's cell (mix 5, rate 6) at 60 frames. What one super-step launches under these plans, which can fail, kill
# and drop (`faults.plan_capabilities` = (True, True, True)): `avail_rows`
# twice (the completion push and the retry re-push of a killed task); the
# masked search with the live-PE mask twice in every mode that searches
# (the feasibility check before the decide, whose result the decide
# reuses, and the one after it); the LUT never searches
FAULT_ROWS_PER_STEP = 2
FAULT_SEARCHES_PER_STEP = {"LUT": 0, "ETF": 2, "DAS": 2}
FAULT_EXACT = EXACT_FIELDS + ("job_dropped", "n_faults", "n_retries",
                              "n_dropped_jobs", "n_dropped_tasks",
                              "n_recovered")
FAULT_AGG = AGG_FIELDS + ("reexec_us", "recovery_us")


def phase_faults(trees: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.bench import faults as fault_bench
    from repro_torch.core import convert, faults, simulator as sim
    from repro_torch.core import workloads
    from repro_torch.kernels.etf_ft import ops
    t0 = time.perf_counter()
    suite = workloads.default_suite(n_instances=60)
    cell = (fault_bench.MIX_IDX, fault_bench.RATE_IDX)
    plan = fault_bench.stress_plans()
    n = plan.pe_fail_at.shape[0]
    stacked = workloads.stack_workloads([suite.build(*cell)] * n)
    if faults.plan_capabilities(plan) != faults.FULL_CAPS:
        raise AssertionError("the fault plans must build every phase")
    total = {}
    worst = 0.0
    for mode in (sim.MODE_LUT, sim.MODE_ETF, sim.MODE_DAS):
        name = sim.MODE_NAMES[mode]
        res = {}
        for dev in ("cuda", "cpu"):
            tree = (convert.dtree_from_numpy(**trees["DAS"], device=dev)
                    if mode == sim.MODE_DAS else None)
            tel = []
            ops.reset_launches()
            t1 = time.perf_counter()
            res[dev] = sim.to_numpy(sim.run_batch(
                mode, stacked, tree=tree, plan=plan, device=dev,
                telemetry=tel))
            if dev == "cuda":
                wall = time.perf_counter() - t1
                steps = sum(x["steps"] for x in tel)
                launches = dict(ops.LAUNCHES)
                eager = sim.to_numpy(sim._run_batch(
                    sim._simulate_eager, mode, stacked, tree=tree,
                    plan=plan, device=dev))
        want = {k: 0 for k in launches}
        want["avail_rows"] = FAULT_ROWS_PER_STEP * steps
        want["etf_ft_search_masked"] = FAULT_SEARCHES_PER_STEP[name] * steps
        if launches != want:
            raise AssertionError(f"fault path {name}: launches {launches} "
                                 f"over {steps} super-steps, expected "
                                 f"{want}")
        for k, count in launches.items():
            total[k] = total.get(k, 0) + count
        for f in sim.SimResult._fields:
            a, b = getattr(res["cuda"], f), getattr(eager, f)
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"fault path {name} {f}: card graph "
                                     "!= card eager")
        for f in FAULT_EXACT:
            a, b = getattr(res["cuda"], f), getattr(res["cpu"], f)
            if a.dtype != b.dtype or not np.array_equal(a, b,
                                                        equal_nan=True):
                raise AssertionError(f"fault path {name} {f}: card != CPU")
        for f in FAULT_AGG:
            a = getattr(res["cuda"], f).astype(np.float64)
            b = getattr(res["cpu"], f).astype(np.float64)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            worst = max(worst, float(rel.max()))
            if (rel > TOL_AGG).any():
                raise AssertionError(f"fault path {name} {f}: rel "
                                     f"{rel.max():.2e} > {TOL_AGG}")
        r = res["cuda"]
        if not (r.n_faults.sum() and r.n_retries.sum()
                and r.n_dropped_jobs.sum()):
            raise AssertionError(f"fault path {name}: no kill, retry or "
                                 "drop happened")
        if r.stalled.any() or (r.n_done != stacked.n_tasks).any():
            raise AssertionError(f"fault path {name}: a scenario stalled")
        log(f"[5b faults] {name}: {n} scenarios, {steps} "
            f"super-steps in {wall:.2f}s ({wall * 1e3 / steps:.3f} ms/step "
            f"captured); kills {int(r.n_faults.sum())}, retries "
            f"{int(r.n_retries.sum())}, dropped jobs "
            f"{int(r.n_dropped_jobs.sum())} / tasks "
            f"{int(r.n_dropped_tasks.sum())}; launches {launches}")
    torch.cuda.synchronize()
    log(f"[5b faults] mix {cell[0]} rate {cell[1]} at 60 frames x "
        f"LUT/ETF/DAS under stress_plans(): every field bit-equal "
        f"card graph vs card eager; schedules and fault counts bit-equal "
        f"card vs CPU, float aggregates within {worst:.2e} relative "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"launches": total}


# ---------------------------------------------------------------------------
# phase 5c: every DAS section of the benchmark at its full size
# ---------------------------------------------------------------------------
SECTION_REL = 1e-5      # a float of a section against BENCH_sweep.json
LR_ABS = 1e-3           # an LR accuracy (tests/test_torch_oracle_das.py)
# floats that are counts, fractions of counts or table entries: equal
SECTION_EQUAL = ("fast_frac", "slow_frac", "das_matches_best_frac",
                 "threshold", "rate_mbps", "storage_kb")
BENCH_RUN_JSON = ROOT / "build" / "repro_torch" / "bench_run.json"


def _timing_key(key: str) -> bool:
    return key in ("us_per_call", "wall_s") or "_us_per_" in key


def _hold(ref, got, path: str, gaps: list, row=None) -> None:
    """Hold `got` to the reference's `ref` (a section's result): equal
    for counts, booleans, strings and `SECTION_EQUAL`, DT accuracies
    equal, LR ones within `LR_ABS`, every other float within
    `SECTION_REL` relative; timing keys skipped. Appends each float's
    relative gap to `gaps`; raises on a miss."""
    if isinstance(ref, dict):
        for k, v in ref.items():
            if _timing_key(k):
                continue
            if k not in got:
                raise AssertionError(f"{path}.{k}: missing in the port")
            _hold(v, got[k], f"{path}.{k}", gaps, row=ref)
        return
    if isinstance(ref, list):
        if len(ref) != len(got):
            raise AssertionError(f"{path}: {len(got)} entries, reference "
                                 f"{len(ref)}")
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(a, b, f"{path}[{i}]", gaps, row=row)
        return
    key = path.rsplit(".", 1)[-1].split("[")[0]
    if isinstance(ref, float) and not isinstance(ref, bool):
        gap = abs(got - ref) / max(abs(ref), 1e-30)
        gaps.append(gap)
        lr = (key == "accuracy" and row is not None
              and str(row.get("classifier", "")).startswith("LR"))
        if lr:
            if abs(got - ref) > LR_ABS:
                raise AssertionError(f"{path}: {got!r} vs {ref!r}")
        elif key in SECTION_EQUAL or key == "accuracy":
            if got != ref:
                raise AssertionError(f"{path}: {got!r} != {ref!r}")
        elif not gap <= SECTION_REL:
            raise AssertionError(f"{path}: {got!r} vs {ref!r}, rel {gap:.2e}")
        return
    if got != ref:
        raise AssertionError(f"{path}: {got!r} != {ref!r}")


# the reference's serving replica: TPU v5e constants of
# `src/repro/launch/mesh.py` and `src/repro/serve/costmodel.py`, injected
# to hold `serving_das` to its section of `BENCH_sweep.json`
V5E_REPLICA = dict(name="v5e-8", n_chips=8, peak_flops=197e12,
                   hbm_bw=819e9, power_w=200.0, idle_w=60.0, efficiency=0.5)
SERVE_REL = 1e-9        # a serving latency or EDP against the record


def _check_campaign(camp: dict, tag: str) -> None:
    """The run record's `campaign` block of a clean run: every chunk
    computed (or, resumed, reused), no retry, timeout, out of memory or
    stall trip, occupancy in (0, 1]."""
    done = camp["chunks_computed"] + camp["chunks_reused"]
    bad = {k: camp[k] for k in ("retries", "timeouts", "oom_events",
                                "shrinks", "stall_trips") if camp[k]}
    occ = camp["occupancy"]
    if done != camp["n_chunks"] or bad or (
            camp["chunks_computed"] and not 0 < occ <= 1):
        raise AssertionError(f"{tag} campaign block: {done} of "
                             f"{camp['n_chunks']} chunks, {bad}, "
                             f"occupancy {occ}")


def phase_sections() -> dict:
    import os
    from repro_torch.bench import run as bench_run, serving_das
    from repro_torch.serve import costmodel
    t0 = time.perf_counter()
    for knob in ("REPRO_BENCH_INSTANCES", "REPRO_BENCH_FULL",
                 "REPRO_BENCH_BATCH", "REPRO_BENCH_DEVICES",
                 "REPRO_BENCH_CAMPAIGN_DIR", "REPRO_BENCH_WATCHDOG_S",
                 "REPRO_BENCH_STEP_BUDGET", "REPRO_BENCH_PACK"):
        os.environ.pop(knob, None)     # the benchmark's own size
    _use_autotune_dir()
    record = bench_run.main(["--device", "cuda", "--json",
                             str(BENCH_RUN_JSON)])
    env = record["env"]
    if env["batch_size_source"] != "cache" or env["batch_size"] < MAIN_S:
        raise AssertionError(f"5c chunk size {env['batch_size']} from "
                             f"{env['batch_size_source']}: not phase 4's "
                             "cached pick of one chunk a sweep")
    ref = json.loads((ROOT / "benchmarks" / "BENCH_sweep.json")
                     .read_text())["sections"]
    for name, _, _ in bench_run.SECTIONS:
        if name == "serving_das":
            continue        # its H100 rows have no reference; held below
        gaps = []
        _hold(ref[name]["result"], record["sections"][name]["result"],
              name, gaps)
        log(f"[5c sections] {name}: {record['sections'][name]['wall_s']:.1f}s"
            f", {len(gaps)} floats held, largest relative gap "
            f"{max(gaps, default=0.0):.3e}")
    if bench_run.NOT_PORTED:
        raise AssertionError(f"not ported: {bench_run.NOT_PORTED}")
    camp = record["campaign"]
    _check_campaign(camp, "5c")
    log(f"[5c sections] campaign: {camp['n_sweeps']} sweeps, "
        f"{camp['n_chunks']} chunks computed, occupancy "
        f"{camp['occupancy']:.4f} ({camp['active_trips']} of "
        f"{camp['lane_trips']} lane super-steps), chunk wall max "
        f"{camp['chunk_wall_s_max']:.3f}s mean "
        f"{camp['chunk_wall_s_mean']:.3f}s; env {record['env']}")
    # serving: the H100 run's rows, then the reference's replica injected
    # and held to the record
    for row in record["sections"]["serving_das"]["result"]:
        log(f"[5c serving] h100-8 {row}")
    rows = serving_das.run(spec=costmodel.ReplicaSpec(**V5E_REPLICA))
    want = ref["serving_das"]["result"]
    worst = 0.0
    if [r["rate"] for r in rows] != [r["rate"] for r in want]:
        raise AssertionError("serving_das: rates differ")
    for got, exp in zip(rows, want):
        for k, v in exp.items():
            if k == "rate":
                continue
            rel = abs(got[k] - v) / abs(v)
            worst = max(worst, rel)
            if not rel <= SERVE_REL:
                raise AssertionError(f"serving_das rate {exp['rate']} {k}:"
                                     f" {got[k]!r} vs {v!r}")
    log(f"[5c serving] v5e-8 injected: {len(rows)} rates x 6 latencies and "
        f"EDPs against BENCH_sweep.json, largest relative gap {worst:.3e}")
    launches = record["kernels"]
    if not (launches["etf_ft_search"] and launches["etf_ft_search_masked"]):
        raise AssertionError(f"sections launched {launches}")
    log(f"[5c sections] all eight at 60 frames on the 40 x 14 grid in "
        f"{record['total_s']:.1f}s, record in {BENCH_RUN_JSON}; launches "
        f"{launches} ({time.perf_counter() - t0:.1f}s)")
    return {"launches": launches, "record": record}


# ---------------------------------------------------------------------------
# phase 5d: the campaign layer on the card
# ---------------------------------------------------------------------------
CAMPAIGN_DIR = ROOT / "build" / "repro_torch" / "campaign"
CAMP_MIXES = range(10)          # 10 mixes x 14 rates at 20 frames
CAMP_FRAMES = 20
CAMP_BATCH = 32                 # -> 5 chunks of 32 (the last padded)
# well above a small chunk's time: the retry runs under it too, and a held
# attempt has one more WATCHDOG_S, after its flag is set, to reach its poll
WATCHDOG_S = 10.0


def _same(a, b, tag: str) -> None:
    """Every `SimResult` field equal, dtype and bytes."""
    from repro_torch.core import simulator as sim
    for f in sim.SimResult._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            raise AssertionError(f"{tag}: field {f} differs")


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _idle_power() -> list:
    """`power.draw` of the idle card, five reads a second apart after
    five seconds without work."""
    import torch
    torch.cuda.synchronize()
    time.sleep(5.0)
    reads = []
    for _ in range(5):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()
        reads.append(float(out[0]))
        time.sleep(1.0)
    return reads


def _kill_resume() -> dict:
    """`bench/kill_resume_smoke.py` on the card, in a process of its own
    (its child is SIGKILLed mid-campaign); returns its resume's stats."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.kill_resume_smoke",
         "--device", "cuda"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        print(out.stderr, file=sys.stderr, flush=True)
        raise AssertionError(f"kill_resume_smoke exited {out.returncode}")
    launches = json.loads(out.stdout.split("# launches ", 1)[1]
                          .splitlines()[0])
    if not launches["avail_rows"]:
        raise AssertionError(f"kill_resume_smoke launched {launches}")
    return launches


def phase_campaign(trees: dict, sections: dict) -> dict:
    import gc
    import shutil
    import torch
    from repro_torch.bench import faults as fault_bench
    from repro_torch.bench import run as bench_run
    from repro_torch.core import campaign as camp, convert
    from repro_torch.core import simulator as sim, workloads
    from repro_torch.kernels.etf_ft import ops
    t00 = time.perf_counter()
    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    kr = _kill_resume()
    log(f"[5d campaign] kill_resume_smoke on the card: PASS, its launches "
        f"{kr} ({time.perf_counter() - t00:.1f}s)")

    ops.reset_launches()
    cells = [(m, r) for m in CAMP_MIXES for r in range(14)]
    stacked = workloads.default_suite(n_instances=CAMP_FRAMES).build_many(
        cells)
    das_tree = convert.dtree_from_numpy(**trees["DAS"], device="cuda")
    unsplit = {}
    for mode in (sim.MODE_LUT, sim.MODE_ETF, sim.MODE_DAS):
        name = sim.MODE_NAMES[mode]
        kw = {"tree": das_tree} if mode == sim.MODE_DAS else {}
        t0 = time.perf_counter()
        ref = sim.to_numpy(sim.run_batch(mode, stacked, device="cuda", **kw))
        t1 = time.perf_counter()
        root = str(CAMPAIGN_DIR / "grid")
        first = camp.run_campaign(mode, stacked, batch_size=CAMP_BATCH,
                                  checkpoint_dir=root, device="cuda", **kw)
        t2 = time.perf_counter()
        again = camp.run_campaign(mode, stacked, batch_size=CAMP_BATCH,
                                  checkpoint_dir=root, device="cuda", **kw)
        t3 = time.perf_counter()
        st, st2 = first.stats, again.stats
        if not (st["n_chunks"] >= 4 and st["packed"]
                and st["chunks_computed"] == st["n_chunks"]
                and st2["chunks_reused"] == st["n_chunks"]
                and st2["chunks_computed"] == 0):
            raise AssertionError(f"5d {name}: stats {st} / resumed {st2}")
        _check_campaign(st, f"5d {name}")
        _same(ref, first.result, f"5d {name} campaign vs run_batch")
        _same(ref, again.result, f"5d {name} resumed vs run_batch")
        unsplit[mode] = ref
        log(f"[5d campaign] {name}: {len(cells)} scenarios at "
            f"{CAMP_FRAMES} frames, run_batch one "
            f"chunk {t1 - t0:.2f}s; campaign {st['n_chunks']} packed chunks "
            f"of {CAMP_BATCH} {t2 - t1:.2f}s (occupancy "
            f"{st['occupancy']:.4f}, {st['checkpoint_bytes']} bytes written "
            f"in {st['checkpoint_write_s']:.3f}s); resumed, every chunk "
            f"reused, {t3 - t2:.2f}s ({st2['checkpoint_read_s']:.3f}s "
            "reading); all three bit-equal")

    # stacked fault plans: the fault path through the campaign
    plan = fault_bench.stress_plans()
    n = plan.pe_fail_at.shape[0]
    fstack = workloads.stack_workloads(
        [workloads.default_suite(n_instances=60).build(
            fault_bench.MIX_IDX, fault_bench.RATE_IDX)] * n)
    t0 = time.perf_counter()
    ref = sim.to_numpy(sim.run_batch(sim.MODE_DAS, fstack, tree=das_tree,
                                     plan=plan, device="cuda"))
    out = camp.run_campaign(sim.MODE_DAS, fstack, tree=das_tree, plan=plan,
                            batch_size=8, device="cuda")
    _check_campaign(out.stats, "5d fault plans")
    _same(ref, out.result, "5d stress_plans campaign vs run_batch")
    if not out.result.n_dropped_jobs.sum():
        raise AssertionError("5d stress_plans: no job dropped")
    log(f"[5d campaign] DAS under stress_plans(): {n} plans, "
        f"{out.stats['n_chunks']} chunks, bit-equal to run_batch "
        f"({time.perf_counter() - t0:.1f}s)")

    small = workloads.default_suite(n_instances=10).build_many(
        [(m, r) for m in range(4) for r in (0, 13)])
    small_ref = sim.to_numpy(sim.run_batch(sim.MODE_ETF, small,
                                           device="cuda"))
    # a real out-of-memory on the card: the first attempt allocates more
    # than the card holds while its graph is being captured, after the
    # block has recorded its kernels; classified, the half-recorded graph
    # dropped with its attempt and its recorded launches taken back out
    # of LAUNCHES, shrunk, finished. The retry starts with the failed
    # attempt's memory freed (`memory_allocated` back to its level before
    # the attempt), and a cyclic collection inside each of its captures
    # finds nothing of the failed attempt to destroy there: nothing holds
    # it in a cycle (`campaign._let_go`), so no capture pauses the
    # collector
    total = torch.cuda.get_device_properties(0).total_memory
    real_block, real_capture = sim._block, sim._capture
    real_compute = camp._compute_chunk
    hit = {"oom": 0, "held": 0, "recorded": 0, "left": None,
           "collected": 0, "starts": []}

    def collect_in_capture():
        if torch.cuda.is_current_stream_capturing():
            hit["collected"] += 1
            gc.collect()

    def oom_block(*a, **kw):
        out = real_block(*a, **kw)
        if torch.cuda.is_current_stream_capturing() and not hit["oom"]:
            hit["oom"] += 1
            hit["recorded"] = ops.LAUNCHES["avail_rows"] - hit["at"]
            hit["at_oom"] = torch.cuda.memory_allocated()
            torch.empty(total + (1 << 30), dtype=torch.uint8,
                        device="cuda")
        elif hit["oom"]:
            collect_in_capture()
        return out

    def measured(*a, **kw):
        """An attempt (or a shrunk attempt's part) starts: the card's
        allocated bytes."""
        torch.cuda.synchronize()
        hit["starts"].append(torch.cuda.memory_allocated())
        return real_compute(*a, **kw)

    def oom_capture(*a, **kw):
        hit["at"] = ops.LAUNCHES["avail_rows"]
        try:
            return real_capture(*a, **kw)
        except torch.OutOfMemoryError:
            hit["left"] = ops.LAUNCHES["avail_rows"] - hit["at"]
            raise

    sim._block, sim._capture = oom_block, oom_capture
    camp._compute_chunk = measured
    try:
        out = camp.run_campaign(sim.MODE_ETF, small, batch_size=8,
                                device="cuda")
    finally:
        sim._block, sim._capture = real_block, real_capture
        camp._compute_chunk = real_compute
    st = out.stats
    if not (hit["oom"] == 1 and st["oom_events"] == 1 and st["shrinks"] == 1
            and st["retries"] == 1 and hit["collected"] >= 2
            and len(hit["starts"]) == 3):
        raise AssertionError(f"5d OOM: {hit} {st}")
    before, retry_at = hit["starts"][:2]
    log(f"[5d campaign] allocated on the card: {before} bytes when the "
        f"failed attempt started, {hit['at_oom']} at its out-of-memory, "
        f"{retry_at} when the retry started; {hit['collected']} cyclic "
        "collections inside the retry's captures")
    if retry_at > before:
        raise AssertionError(f"5d OOM: the retry started with {retry_at} "
                             f"bytes allocated, {before} before the failed "
                             "attempt: its memory was not freed")
    if not (hit["recorded"] > 0 and hit["left"] == 0):
        raise AssertionError(
            f"5d OOM: the failed capture recorded {hit['recorded']} "
            f"avail_rows launches and left {hit['left']} in LAUNCHES "
            "(must be > 0 and 0)")
    _same(small_ref, out.result, "5d after a CUDA OOM")
    log(f"[5d campaign] a real CUDA out-of-memory ({total + (1 << 30)} "
        f"bytes asked of {total}) in the first attempt's graph capture, "
        f"after {hit['recorded']} avail_rows launches were recorded: "
        f"classified, LAUNCHES restored, batch 8 -> 4, retried; results "
        f"bit-equal")

    # the watchdog on the card: the first attempt is held in its graph
    # capture until the watchdog sets its stop flag; the flag ends it at
    # its next poll, the worker is joined, the retry captures anew. The
    # hold ends when the flag is set, not after a fixed sleep, so the
    # capture that follows it has the whole of the join's WATCHDOG_S
    stopped = {"n": 0, "flag": [], "after_flag_s": None}
    real_on = sim._simulate_on

    def held_block(*a, **kw):
        if torch.cuda.is_current_stream_capturing() and not hit["held"]:
            hit["held"] += 1
            if not stopped["flag"][-1].wait(2 * WATCHDOG_S):
                raise AssertionError("5d watchdog: no stop flag was set "
                                     f"within {2 * WATCHDOG_S}s")
            stopped["at"] = time.perf_counter()
        elif hit["held"]:
            collect_in_capture()     # the stopped attempt is freed too
        return real_block(*a, **kw)

    def counting(*a, **kw):
        # `_simulate_on`'s last argument is the watchdog's stop flag
        stopped["flag"].append(kw["stop"] if "stop" in kw else a[-1])
        try:
            return real_on(*a, **kw)
        except sim.Stopped:
            stopped["n"] += 1
            stopped["after_flag_s"] = time.perf_counter() - stopped["at"]
            raise

    sim._block, sim._simulate_on = held_block, counting
    try:
        t0 = time.perf_counter()
        out = camp.run_campaign(sim.MODE_ETF, small, batch_size=8,
                                watchdog_s=WATCHDOG_S, device="cuda")
    finally:
        sim._block, sim._simulate_on = real_block, real_on
    st = out.stats
    if not (hit["held"] == 1 and st["timeouts"] == 1 and st["retries"] == 1
            and stopped["n"] == 1 and hit["collected"] >= 3):
        raise AssertionError(f"5d watchdog: {hit} {stopped} {st}")
    _same(small_ref, out.result, "5d after a watchdog trip")
    log(f"[5d campaign] watchdog {WATCHDOG_S}s tripped during a graph "
        f"capture: stopped at the next poll "
        f"{stopped['after_flag_s']:.3f}s after the flag (of the join's "
        f"{WATCHDOG_S}s), joined, retried without a capture error; results "
        f"bit-equal ({time.perf_counter() - t0:.1f}s)")

    # the split: one card named twice, and two cards when there are two
    n_cards = torch.cuda.device_count()
    tel = []
    two = sim.to_numpy(sim.run_batch(sim.MODE_ETF, stacked,
                                     devices=["cuda:0", "cuda:0"],
                                     device="cuda", telemetry=tel))
    _same(unsplit[sim.MODE_ETF], two, "5d devices=[cuda:0, cuda:0]")
    if [t["lanes"] for t in tel] != [len(cells) // 2] * 2:
        raise AssertionError(f"5d split: parts {tel}")
    if n_cards >= 2:
        _same(unsplit[sim.MODE_ETF], sim.to_numpy(sim.run_batch(
            sim.MODE_ETF, stacked, devices=2, device="cuda")),
            "5d devices=2")
    log(f"[5d campaign] {n_cards} card(s); ETF split over [cuda:0, cuda:0]"
        + (" and over 2 cards" if n_cards >= 2 else "")
        + " equals devices=1 bit for bit")
    launches = dict(ops.LAUNCHES)
    if not (launches["avail_rows"] and launches["etf_ft_search_masked"]):
        raise AssertionError(f"5d launched {launches}")

    # bench.run --resume, twice: every chunk reused, identical sections
    rdir = CAMPAIGN_DIR / "resume"
    runs = []
    for k in (1, 2):
        t0 = time.perf_counter()
        rec = bench_run.main(["--device", "cuda", "--only", "fig3,faults",
                              "--resume", str(rdir), "--json",
                              str(CAMPAIGN_DIR / f"resume_{k}.json")])
        runs.append((rec, time.perf_counter() - t0))
    (r1, w1), (r2, w2) = runs
    c1, c2 = r1["campaign"], r2["campaign"]
    if not (c1["chunks_computed"] == c1["n_chunks"] == c2["chunks_reused"]
            and c2["chunks_computed"] == 0):
        raise AssertionError(f"5d --resume: {c1} / {c2}")
    def untimed(x):
        if isinstance(x, dict):
            return {k: untimed(v) for k, v in x.items()
                    if not _timing_key(k)}
        if isinstance(x, list):
            return [untimed(v) for v in x]
        return x

    def canon(x) -> str:
        """A section's result as JSON, its timing keys left out."""
        return json.dumps(untimed(json.loads(json.dumps(
            x, default=bench_run._jsonable))), sort_keys=True)

    base = sections["record"]["sections"]
    for name in ("fig3", "faults"):
        if not (canon(r1["sections"][name]["result"])
                == canon(r2["sections"][name]["result"])
                == canon(base[name]["result"])):
            raise AssertionError(f"5d --resume {name}: results differ")
    size = _dir_bytes(rdir)
    log(f"[5d campaign] bench.run --only fig3,faults --resume: run 1 "
        f"{w1:.1f}s ({c1['n_sweeps']} sweeps, {c1['n_chunks']} chunks, "
        f"{c1['checkpoint_bytes']} bytes written in "
        f"{c1['checkpoint_write_s']:.2f}s), run 2 {w2:.1f}s (every chunk "
        f"reused, {c2['checkpoint_read_s']:.2f}s reading); checkpoint "
        f"directory {size} bytes; fig3 and faults identical in both and to "
        f"phase 5c's")
    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    for k, v in r1["kernels"].items():
        launches[k] += v
    idle = _idle_power()
    log(f"[5d campaign] idle card power.draw {idle} W; launches {launches}"
        f" ({time.perf_counter() - t00:.1f}s)")
    return {"launches": launches, "idle_w": idle}


# ---------------------------------------------------------------------------
# phase 6: RecurrentGemma-9B inference at full width and depth
# ---------------------------------------------------------------------------
EXPECTED_LAUNCHES = {  # per call, at 38 layers: 12 local, 26 rglru
    "forward_launches": {"flash_attention": 12, "rg_lru": 26,
                         "rg_lru_generic": 0, "ssd_scan": 0},
    "prefill_launches": {"flash_attention": 12, "rg_lru": 26,
                         "rg_lru_generic": 0, "ssd_scan": 0},
    "decode_launches": {"flash_attention": 0, "rg_lru": 0,
                        "rg_lru_generic": 0, "ssd_scan": 0},
}
#: counted routes that no path may take
OFF_PATH = ("rg_lru_generic",)


def phase_lm() -> dict:
    import torch
    from repro_torch.bench import lm_serve
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops
    t0 = time.perf_counter()
    fa_ops.reset_launches()
    rg_ops.reset_launches()
    out = lm_serve.run(device="cuda")
    torch.cuda.synchronize()
    launches = {**fa_ops.LAUNCHES, **rg_ops.LAUNCHES}
    wall = time.perf_counter() - t0
    for name, n in launches.items():
        if (n > 0) == (name in OFF_PATH):
            raise AssertionError(f"the LM path launched {name} {n} times")
    for key, want in EXPECTED_LAUNCHES.items():
        if out[key] != want:
            raise AssertionError(f"{key}: {out[key]}, expected {want}")
    if not (out["forward_finite"] and out["serve_finite"]):
        raise AssertionError("non-finite logits")
    chk = out["check"]
    log(f"[6 lm] {out['arch']} {out['n_layers']} layers, d_model "
        f"{out['d_model']}, vocab {out['vocab']}, {out['params']:,} params "
        f"(fp32 at rest, {out['dtype']} compute), built from a seed in "
        f"{out['build_s']:.2f}s")
    log(f"[6 lm] forward 1 x {out['score_len']} tokens: "
        f"{out['forward_s']:.3f}s, "
        f"{out['score_tok_per_s']:.0f} tok/s, launches "
        f"{out['forward_launches']}")
    log(f"[6 lm] prefill {out['batch']} x {out['prompt_len']} tokens: "
        f"{out['prefill_s']:.3f}s, "
        f"{out['prefill_tok_per_s']:.0f} tok/s, launches "
        f"{out['prefill_launches']}")
    log(f"[6 lm] decode {out['decode_steps']} steps x {out['batch']} "
        "sequences: "
        f"{out['decode_ms_per_step']:.2f} ms/step, "
        f"{out['decode_tok_per_s']:.1f} tok/s, launches "
        f"{out['decode_launches']}")
    log(f"[6 lm] peak memory {out['peak_mem_bytes'] / 2**30:.2f} GiB; "
        f"served vs scored logits at {chk['positions']} positions: rel "
        f"max abs {chk['rel_max_abs']:.3e} (tol {TOL_SERVE}), greedy "
        f"argmax agrees at {chk['argmax_agree']:.1%}; launches in all "
        f"{launches} ({wall:.1f}s)")
    if chk["rel_max_abs"] > TOL_SERVE:
        raise AssertionError(f"served logits off by {chk['rel_max_abs']}")
    torch.cuda.empty_cache()
    return {"launches": launches, "out": out}


# ---------------------------------------------------------------------------
# phase 7: one period at full width, fp32, card against CPU
# ---------------------------------------------------------------------------
def _prefill_two_chunks(p, cfg, toks, half: int):
    """Prefill toks[:, :half] into fp32 caches, then feed toks[:, half:]
    from them, so that the second chunk's rglru layers start from the
    first's state (the carried-state branch, h0 != 0). Returns (the last
    position's logits [B, V], the rglru layers' final h stacked)."""
    import torch
    from repro_torch.models import lm, rglru
    caches = lm.init_caches(cfg, toks.shape[0], toks.shape[1],
                            dtype=torch.float32, device=toks.device)
    _, caches = lm.prefill(p, cfg, toks[:, :half], caches)
    last, caches, _ = lm.forward(p, cfg, toks[:, half:], caches=caches,
                                 cache_pos=half, head_mode="last")
    layers = caches["prologue"] + [c for g in caches["groups"] for c in g]
    hs = [c.h for c in layers if isinstance(c, rglru.RGLRUState)]
    return last[:, 0], torch.stack(hs)


def _rel(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max())


def phase_lm_cross() -> None:
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.models import lm
    # full fp32 matmuls on the card, as on the CPU (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config("recurrentgemma-9b"),
                              n_layers=3, dtype="float32")
    half = 128
    with torch.inference_mode():
        p = lm_serve.build(cfg, 7, "cuda")
        g = torch.Generator(device="cuda").manual_seed(8)
        toks = torch.randint(0, cfg.vocab, (1, 256), generator=g,
                             device="cuda")
        card, _, _ = lm.forward(p, cfg, toks)
        card = card.cpu()
        rg_ops.reset_launches()
        card_last, card_h = _prefill_two_chunks(p, cfg, toks, half)
        torch.cuda.synchronize()
        launched = dict(rg_ops.LAUNCHES)
        card_last, card_h = card_last.cpu(), card_h.cpu()
        p.to("cpu")
        torch.cuda.empty_cache()
        cpu, _, _ = lm.forward(p, cfg, toks.cpu())
        cpu_last, cpu_h = _prefill_two_chunks(p, cfg, toks.cpu(), half)
    rel = _rel(card, cpu)
    agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
    log(f"[7 lm-cross] 3 layers (rglru, rglru, local) at d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, fp32, 1 x 256 tokens: card vs "
        f"CPU rel max abs {rel:.3e} (tol {TOL_CROSS_F32}), argmax agrees at "
        f"{agree:.1%}")
    if not rel <= TOL_CROSS_F32:
        raise AssertionError(f"card vs CPU rel {rel}")
    # two rglru layers a chunk, each through the ring on the card
    if launched != {"rg_lru": 4, "rg_lru_generic": 0}:
        raise AssertionError(f"prefill in two chunks launched {launched}")
    rel_last, rel_h = _rel(card_last, cpu_last), _rel(card_h, cpu_h)
    log(f"[7 lm-cross] prefill of 2 x {half} tokens, the second chunk from "
        f"the first's state (the RG-LRU kernel on the card, {launched}; the "
        f"sequential plain scan on the CPU): card vs CPU rel max abs, last "
        f"logits {rel_last:.3e}, rglru states {rel_h:.3e} (tol "
        f"{TOL_CROSS_F32}); against the card's forward at the last position "
        f"{_rel(card_last, card[:, -1]):.3e} "
        f"({time.perf_counter() - t0:.1f}s)")
    if not (rel_last <= TOL_CROSS_F32 and rel_h <= TOL_CROSS_F32):
        raise AssertionError(f"prefill card vs CPU rel {rel_last}, {rel_h}")


# ---------------------------------------------------------------------------
# phase 8: Mamba-2 780M inference at full width and depth
# ---------------------------------------------------------------------------
MAMBA_PARAMS = 780_161_280
MAMBA_SCORE_BATCH = 4   # sequences scored at once: 4 x 4096 tokens
MAMBA_LAUNCHES = {  # per call, at 48 SSD layers
    "forward_launches": {"flash_attention": 0, "rg_lru": 0,
                         "rg_lru_generic": 0, "ssd_scan": 48},
    "prefill_launches": {"flash_attention": 0, "rg_lru": 0,
                         "rg_lru_generic": 0, "ssd_scan": 0},
    "decode_launches": {"flash_attention": 0, "rg_lru": 0,
                        "rg_lru_generic": 0, "ssd_scan": 0},
}


def _mamba_run(dtype: str) -> dict:
    import dataclasses
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    cfg = dataclasses.replace(configs.get_config("mamba2-780m"), dtype=dtype)
    out = lm_serve.run(device="cuda", cfg=cfg, score_batch=MAMBA_SCORE_BATCH)
    if out["params"] != MAMBA_PARAMS or out["n_layers"] != 48:
        raise AssertionError(f"{out['n_layers']} layers, {out['params']} "
                             f"params, expected 48 and {MAMBA_PARAMS}")
    for key, want in MAMBA_LAUNCHES.items():
        if out[key] != want:
            raise AssertionError(f"{dtype} {key}: {out[key]}, expected "
                                 f"{want}")
    if not (out["forward_finite"] and out["serve_finite"]):
        raise AssertionError(f"{dtype}: non-finite logits")
    return out


def phase_mamba() -> dict:
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    t0 = time.perf_counter()
    ssd_ops.reset_launches()
    out = _mamba_run("bfloat16")
    torch.cuda.synchronize()
    launches = dict(ssd_ops.LAUNCHES)
    wall = time.perf_counter() - t0
    if launches["ssd_scan"] <= 0:
        raise AssertionError("the Mamba-2 path never launched ssd_scan")
    chk = out["check"]
    log(f"[8 mamba] {out['arch']} {out['n_layers']} layers, d_model "
        f"{out['d_model']}, vocab {out['vocab']}, {out['params']:,} params "
        f"(fp32 at rest, {out['dtype']} compute), built from a seed in "
        f"{out['build_s']:.2f}s")
    log(f"[8 mamba] forward {out['score_batch']} x {out['score_len']} "
        f"tokens: {out['forward_s']:.3f}s, {out['score_tok_per_s']:.0f} "
        f"tok/s, launches {out['forward_launches']}")
    log(f"[8 mamba] prefill {out['batch']} x {out['prompt_len']} tokens: "
        f"{out['prefill_s']:.3f}s, {out['prefill_tok_per_s']:.0f} tok/s, "
        f"launches {out['prefill_launches']}")
    log(f"[8 mamba] decode {out['decode_steps']} steps x {out['batch']} "
        f"sequences: {out['decode_ms_per_step']:.2f} ms/step, "
        f"{out['decode_tok_per_s']:.1f} tok/s, launches "
        f"{out['decode_launches']}")
    log(f"[8 mamba] peak memory {out['peak_mem_bytes'] / 2**30:.2f} GiB; "
        f"bf16 served vs scored logits at {chk['positions']} positions: "
        f"rel max abs {chk['rel_max_abs']:.3e} (tol "
        f"{TOL_SERVE_MAMBA_BF16:.4g}: the reference misses {TOL_SERVE} at "
        f"this depth in bf16), greedy argmax agrees at "
        f"{chk['argmax_agree']:.1%} (floor {MIN_AGREE_MAMBA_BF16:.0%}); "
        f"launches in all {launches} ({wall:.1f}s)")
    if chk["rel_max_abs"] > TOL_SERVE_MAMBA_BF16 \
            or chk["argmax_agree"] < MIN_AGREE_MAMBA_BF16:
        raise AssertionError(f"bf16 served logits off by "
                             f"{chk['rel_max_abs']}, greedy agreement "
                             f"{chk['argmax_agree']}")
    # the same path in fp32, where served and scored logits must agree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out32 = _mamba_run("float32")
    chk32 = out32["check"]
    log(f"[8 mamba] fp32 at full size: forward {out32['forward_s']:.3f}s, "
        f"prefill {out32['prefill_s']:.3f}s, decode "
        f"{out32['decode_ms_per_step']:.2f} ms/step; served vs scored "
        f"logits at {chk32['positions']} positions: rel max abs "
        f"{chk32['rel_max_abs']:.3e} (tol {TOL_SERVE_F32}), greedy argmax "
        f"agrees at {chk32['argmax_agree']:.1%} "
        f"({time.perf_counter() - t0:.1f}s)")
    if chk32["rel_max_abs"] > TOL_SERVE_F32:
        raise AssertionError(f"fp32 served logits off by "
                             f"{chk32['rel_max_abs']}")
    torch.cuda.empty_cache()
    return {"launches": launches, "out": out, "out_f32": out32}


# ---------------------------------------------------------------------------
# phase 9: Mamba-2 cut to 3 layers at full width, fp32, card against CPU
# ---------------------------------------------------------------------------
def phase_mamba_cross() -> None:
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config("mamba2-780m"),
                              n_layers=3, dtype="float32")
    with torch.inference_mode():
        p = lm_serve.build(cfg, 9, "cuda")
        g = torch.Generator(device="cuda").manual_seed(10)
        toks = torch.randint(0, cfg.vocab, (1, 256), generator=g,
                             device="cuda")
        card, _, _ = lm.forward(p, cfg, toks)
        card = card.cpu()
        p.to("cpu")
        torch.cuda.empty_cache()
        cpu, _, _ = lm.forward(p, cfg, toks.cpu())
    # the padded vocab columns are -1e9 on both sides: compare the rest
    card, cpu = card[..., :cfg.vocab], cpu[..., :cfg.vocab]
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
    log(f"[9 mamba-cross] 3 ssd layers at d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, fp32, 1 x 256 tokens (the SSD kernel on the card, "
        f"the sequential plain scan on the CPU): card vs CPU rel max abs "
        f"{rel:.3e} (tol {TOL_CROSS_F32}), argmax agrees at {agree:.1%} "
        f"({time.perf_counter() - t0:.1f}s)")
    if not rel <= TOL_CROSS_F32:
        raise AssertionError(f"card vs CPU rel {rel}")


# ---------------------------------------------------------------------------
# phase 10: DeepSeek-V2-Lite-16B (MLA + MoE) at full width and depth
# ---------------------------------------------------------------------------
DEEPSEEK = "deepseek-v2-lite-16b"
NO_LAUNCHES = {"flash_attention": 0, "rg_lru": 0, "rg_lru_generic": 0,
               "ssd_scan": 0}
# DeepSeek's bf16 served logits against scoring: at full width a near tie
# among 64 routed experts flips under bf16 rounding, and the gap (0.14 on
# an H100 80GB HBM3 at 700 W) is far above TOL_SERVE, while the same
# model in fp32 agrees to 3.4e-6. The reference's own bf16 gap at 27
# layers and the test width (4 experts) is 0.0 for five seeds of six and
# 5.8e-2 for one: no yardstick. So the served gap is held to 1.5x the bf16 model's own
# rounding, its scored logits against the fp32 model's on the same
# tokens, and greedy agreement to a floor below the first readings
# (85.6-88.6% of 132 positions).
SERVE_OF_ROUNDING = 1.5
MIN_AGREE_DEEPSEEK_BF16 = 0.75


def _reset_lm_launches() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rg_lru import ops as rg_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    for ops in (fa_ops, rg_ops, ssd_ops):
        ops.reset_launches()


def _lm_launches() -> dict:
    from repro_torch.bench import lm_serve
    return lm_serve.launches()


def _log_serve(tag: str, out: dict) -> None:
    """The numbers of one `lm_serve.run`."""
    chk = out["check"]
    cut = (f" (cut from {out['full_layers']})"
           if out.get("full_layers", out["n_layers"]) != out["n_layers"]
           else "")
    log(f"[{tag}] {out['arch']} {out['n_layers']} layers{cut}, d_model "
        f"{out['d_model']}, vocab {out['vocab']}, {out['params']:,} params "
        f"({out['active_params']:,} active; {out['rest_dtype']} at rest, "
        f"{out['dtype']} compute), built from a seed in "
        f"{out['build_s']:.2f}s")
    shape = (f" x {out['n_codebooks']} codebooks" if out["n_codebooks"] > 1
             else "")
    if out["n_prefix_embeds"]:
        shape += f" after {out['n_prefix_embeds']} prefix embeddings"
    log(f"[{tag}] forward {out['score_batch']} x {out['score_len']} tokens"
        f"{shape}: {out['forward_s']:.3f}s, "
        f"{out['score_tok_per_s']:.0f} tok/s, "
        f"launches {out['forward_launches']}; loss_fn {out['loss']:.6f} "
        f"(ce {out['loss_ce']:.6f}, aux {out['aux']:.6f}) in "
        f"{out['loss_s']:.3f}s")
    log(f"[{tag}] prefill {out['batch']} x {out['prompt_len']} tokens: "
        f"{out['prefill_s']:.3f}s, {out['prefill_tok_per_s']:.0f} tok/s, "
        f"launches {out['prefill_launches']}; decode {out['decode_steps']} "
        f"steps: {out['decode_ms_per_step']:.2f} ms/step, "
        f"{out['decode_tok_per_s']:.1f} tok/s, launches "
        f"{out['decode_launches']}")
    log(f"[{tag}] peak memory {out['peak_mem_bytes'] / 2**30:.2f} GiB; "
        f"served vs scored logits at {chk['positions']} positions: rel max "
        f"abs {chk['rel_max_abs']:.3e} (tol {TOL_SERVE}), greedy argmax "
        f"agrees at {chk['argmax_agree']:.1%}")


def _scored_rows(p, cfg, tokens, P: int, T: int):
    """Each row of tokens [B, S] scored alone on the card (routing at the
    no-drop capacity depends on no other row), the head at positions
    P-1 .. P+T-2: [B, T, vocab] fp32 on the CPU."""
    from repro_torch.models import lm
    rows = []
    for b in range(tokens.shape[0]):
        h, _, _ = lm.forward(p, cfg, tokens[b:b + 1].cuda(), head_mode="none")
        rows.append(lm._head(p, cfg, h[:, P - 1:P - 1 + T])[..., :cfg.vocab]
                    .float().cpu())
        del h
    import torch
    return torch.cat(rows)


def phase_deepseek() -> dict:
    """Scoring 1 x 4096 and its loss at the published capacity factor,
    then serving 4 prompts of 4096 with 32 greedy decode steps at the
    no-drop capacity, expanded, and the same decode again weight-absorbed;
    bf16 at rest (fp32 would take 62.8 GB before any activation). MLA
    never calls flash. Then, with the same draws fp32 at rest, the checked
    tokens scored in bf16 and fp32 (the bf16 model's own rounding), the
    choices dropped at the published capacity, and the whole path in
    fp32 (2 prompts of 1024, 8 steps), served against scored at 1e-4."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    from repro_torch.models import lm, moe
    t0 = time.perf_counter()
    cfg = configs.get_config(DEEPSEEK)
    _reset_lm_launches()
    out = lm_serve.run(device="cuda", cfg=cfg, rest_dtype=torch.bfloat16)
    kept = out.pop("kept")
    torch.cuda.synchronize()
    launches = _lm_launches()
    if out["n_layers"] != 27 or out["d_model"] != 2048:
        raise AssertionError(f"{out['n_layers']} layers, d_model "
                             f"{out['d_model']}")
    if launches != NO_LAUNCHES:
        raise AssertionError(f"the DeepSeek path launched {launches}")
    if not (out["forward_finite"] and out["serve_finite"]
            and out["absorbed"]["serve_finite"]):
        raise AssertionError("non-finite logits")
    _log_serve("10 deepseek", out)
    ab = out["absorbed"]
    log(f"[10 deepseek] absorbed decode {out['decode_steps']} steps from the "
        f"same prefill: {ab['decode_ms_per_step']:.2f} ms/step (expanded "
        f"{out['decode_ms_per_step']:.2f}), served vs scored rel max abs "
        f"{ab['check']['rel_max_abs']:.3e}, greedy argmax agrees at "
        f"{ab['check']['argmax_agree']:.1%}; serving at capacity "
        f"{out['serve_capacity_factor']:.4g} (no choice can drop); launches "
        f"in all {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    torch.cuda.empty_cache()

    # the same draws fp32 at rest: bf16 compute casts them at use, bit for
    # bit what bf16 at rest gives (phase 11)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.perf_counter()
    P, T = out["prompt_len"], out["decode_steps"] + 1
    c16 = lm_serve.serving_config(cfg)
    c32 = dataclasses.replace(c16, dtype="float32")
    gaps = {}
    with torch.inference_mode():
        p = lm_serve.build(cfg, 0, "cuda")
        for name, (toks, served) in kept.items():
            s16 = _scored_rows(p, c16, toks, P, T)
            s32 = _scored_rows(p, c32, toks, P, T)
            chk = out["check"] if name == "expanded" else ab["check"]
            gaps[name] = {"served": _rel(served, s16),
                          "rounding": _rel(s16, s32),
                          "agree": chk["argmax_agree"]}
        with _expert_choices() as chosen:
            lm.forward(p, cfg, kept["expanded"][0][:1, :4096].cuda())
        kept_n = dropped = 0
        for idx in chosen:
            _, _, keep, _ = moe.dispatch(idx, cfg.moe.n_experts,
                                         moe.capacity(cfg, idx.shape[1]))
            kept_n, dropped = kept_n + keep.numel(), dropped + int(
                (~keep).sum())
        del p
    torch.cuda.empty_cache()
    for name, g in gaps.items():
        log(f"[10 deepseek] {name}: served vs scored (each row alone) rel "
            f"max abs {g['served']:.3e}; the bf16 model's own rounding, "
            f"scored bf16 vs fp32 on the same tokens, {g['rounding']:.3e}: "
            f"{g['served'] / g['rounding']:.2f}x it (limit "
            f"{SERVE_OF_ROUNDING}x); greedy argmax agrees at "
            f"{g['agree']:.1%} (floor {MIN_AGREE_DEEPSEEK_BF16:.0%})")
        if not (g["served"] <= SERVE_OF_ROUNDING * g["rounding"]
                and g["agree"] >= MIN_AGREE_DEEPSEEK_BF16):
            raise AssertionError(f"{name} served logits off by "
                                 f"{g['served']} (rounding {g['rounding']}), "
                                 f"greedy agreement {g['agree']}")
    log(f"[10 deepseek] scoring 1 x 4096 at the published capacity "
        f"{cfg.moe.capacity_factor}: {dropped} of {kept_n} expert choices "
        f"dropped ({dropped / kept_n:.1%}; random weights route unevenly, "
        f"aux {out['aux']:.4f}) ({time.perf_counter() - t1:.1f}s)")

    # the whole path in fp32, where served and scored must agree
    t1 = time.perf_counter()
    out32 = lm_serve.run(device="cuda", cfg=dataclasses.replace(
        cfg, dtype="float32"), score_len=1024, batch=2, prompt_len=1024,
        decode_steps=8)
    torch.cuda.empty_cache()
    chk32 = {"expanded": out32["check"],
             "absorbed": out32["absorbed"]["check"]}
    log(f"[10 deepseek] fp32 at full width and depth (fp32 at rest, peak "
        f"{out32['peak_mem_bytes'] / 2**30:.2f} GiB): forward 1 x 1024 "
        f"{out32['forward_s']:.3f}s, prefill 2 x 1024 {out32['prefill_s']:.3f}"
        f"s, decode {out32['decode_ms_per_step']:.2f} ms/step; served vs "
        f"scored rel max abs "
        + ", ".join(f"{k} {v['rel_max_abs']:.3e}" for k, v in chk32.items())
        + f" (tol {TOL_SERVE_F32}) ({time.perf_counter() - t1:.1f}s)")
    for name, chk in chk32.items():
        if chk["rel_max_abs"] > TOL_SERVE_F32:
            raise AssertionError(f"fp32 {name} served logits off by "
                                 f"{chk['rel_max_abs']}")
    return {"launches": launches, "out": out, "gaps": gaps,
            "dropped": dropped / kept_n, "out_f32": out32}


# ---------------------------------------------------------------------------
# phase 11: DeepSeek cut to 3 layers at full width, fp32, card against CPU
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _expert_choices():
    """Record the experts every MoE layer chooses, in call order."""
    from repro_torch.models import moe
    chosen = []
    real = moe.router_topk

    def recorded(logits, k):
        out = real(logits, k)
        chosen.append(out[1].cpu())
        return out
    moe.router_topk = recorded
    try:
        yield chosen
    finally:
        moe.router_topk = real


def _deepseek_cut_run(p, cfg, toks, prompts, steps: int) -> dict:
    """forward + aux, loss_fn, and prefill + `steps` decode steps expanded
    and absorbed from the same caches (fp32), with the experts chosen."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    out = {}
    with _expert_choices() as chosen:
        logits, _, aux = lm.forward(p, cfg, toks)
        out["forward"], out["aux"] = logits.cpu(), float(aux)
        out["loss"] = float(lm.loss_fn(p, cfg, {"tokens": toks,
                                                "labels": toks})[0])
        P = prompts.shape[1]
        caches = lm.init_caches(cfg, prompts.shape[0], P + steps,
                                dtype=torch.float32, device=toks.device)
        last, caches = lm.prefill(p, cfg, prompts, caches)
        out["prefill"] = last.cpu()
        for name, c in (("expanded", cfg),
                        ("absorbed", dataclasses.replace(cfg,
                                                         mla_absorb=True))):
            tok, served = last.argmax(-1), []
            for i in range(steps):
                logits, caches = lm.decode_step(p, c, tok, P + i, caches)
                served.append(logits.cpu())
                tok = logits.argmax(-1)
            out[name] = torch.stack(served, 1)
    out["experts"] = chosen
    return out


def phase_deepseek_cross() -> None:
    """The dense layer and two MoE layers at full width in fp32: card
    against CPU within 1e-4 (forward, aux, loss, prefill, decode expanded
    and absorbed), the same experts chosen in every call; and, in bf16
    compute, bf16 at rest against fp32 at rest on the card, bit for bit."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(DEEPSEEK), n_layers=3,
                              dtype="float32")
    with torch.inference_mode():
        p = lm_serve.build(cfg, 11, "cuda")
        g = torch.Generator(device="cuda").manual_seed(12)
        toks = torch.randint(0, cfg.vocab, (1, 256), generator=g,
                             device="cuda")
        prompts = torch.randint(0, cfg.vocab, (2, 64), generator=g,
                                device="cuda")
        card = _deepseek_cut_run(p, cfg, toks, prompts, 4)
        p.to("cpu")
        torch.cuda.empty_cache()
        cpu = _deepseek_cut_run(p, cfg, toks.cpu(), prompts.cpu(), 4)
        del p
        n_moe = len(card["experts"])
        same = (n_moe == len(cpu["experts"]) and all(
            torch.equal(a, b) for a, b in zip(card["experts"],
                                              cpu["experts"])))
        rels = {k: _rel(card[k][..., :cfg.vocab], cpu[k][..., :cfg.vocab])
                for k in ("forward", "prefill", "expanded", "absorbed")}
        rels["aux"] = abs(card["aux"] - cpu["aux"]) / abs(cpu["aux"])
        rels["loss"] = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        log(f"[11 deepseek-cross] 3 layers (dense, MoE, MoE) at d_model "
            f"{cfg.d_model}, 64 experts top-6, vocab {cfg.vocab}, fp32, "
            f"forward and loss 1 x 256, prefill 2 x 64 + 4 decode steps "
            f"expanded and absorbed: card vs CPU rel "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + f" (tol {TOL_CROSS_F32}); loss {card['loss']:.6f} / "
            f"{cpu['loss']:.6f}; experts chosen equal in all {n_moe} MoE "
            f"calls: {same}")
        if not same:
            raise AssertionError("card and CPU chose other experts")
        bad = {k: v for k, v in rels.items() if not v <= TOL_CROSS_F32}
        if bad:
            raise AssertionError(f"card vs CPU rel {bad}")
        # bf16 compute: bf16 at rest against fp32 at rest, bit for bit
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        p32 = lm_serve.build(cfg16, 13, "cuda")
        a, _, _ = lm.forward(p32, cfg16, toks)
        del p32
        torch.cuda.empty_cache()
        p16 = lm_serve.build(cfg16, 13, "cuda", torch.bfloat16)
        b, _, _ = lm.forward(p16, cfg16, toks)
        del p16
        equal = torch.equal(a, b)
        log(f"[11 deepseek-cross] bf16 compute, 1 x 256 tokens: bf16 at rest "
            f"against fp32 at rest on the card bit-equal: {equal} "
            f"({time.perf_counter() - t0:.1f}s)")
        if not equal:
            raise AssertionError("bf16 at rest changed the logits")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the other newly enabled configs at full width
# ---------------------------------------------------------------------------
# (arch, layers kept or None for all, flash launches per forward): one card
# holds neither Qwen2-72B (145 GB in bf16) nor DBRX-132B (263 GB), so they
# are cut in depth; MLA (MiniCPM3) and a prefix (PaliGemma) run the plain
# attention, as in the reference
PHASE12 = (
    ("minicpm3-4b", None, 0),
    ("paligemma-3b", None, 0),
    ("musicgen-medium", None, 48),
    ("phi3-mini-3.8b", None, 32),
    ("yi-34b", None, 60),
    ("qwen2-72b", 32, 32),
    ("dbrx-132b", 8, 8),
)


def phase_configs() -> dict:
    """Each config scoring 1 x 4096 with its loss, then serving 2 prompts
    of 1024 with 8 greedy steps (MoE at its no-drop capacity), served
    against scored at TOL_SERVE, bf16 at rest; flash launches asserted: one per
    attention layer per forward, loss and check, none in prefill and
    decode (attention over a cache is the plain `sdpa`, as in the
    reference)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    t0 = time.perf_counter()
    _reset_lm_launches()
    outs = {}
    for arch, keep, flash in PHASE12:
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=keep) if keep else full
        t1 = time.perf_counter()
        out = lm_serve.run(device="cuda", cfg=cfg, rest_dtype=torch.bfloat16,
                           batch=2, prompt_len=1024, decode_steps=8)
        out.pop("kept")
        out["full_layers"] = full.n_layers
        torch.cuda.empty_cache()
        _log_serve("12 configs", out)
        per_call = dict(NO_LAUNCHES, flash_attention=flash)
        for key, want in (("forward_launches", per_call),
                          ("loss_launches", per_call),
                          ("prefill_launches", NO_LAUNCHES),
                          ("decode_launches", NO_LAUNCHES)):
            if out[key] != want:
                raise AssertionError(f"{arch} {key}: {out[key]}, expected "
                                     f"{want}")
        if out["check"]["launches"] != per_call:
            raise AssertionError(f"{arch}: check {out['check']['launches']}")
        if not (out["forward_finite"] and out["serve_finite"]):
            raise AssertionError(f"{arch}: non-finite logits")
        checks = {"": out["check"]}
        if "absorbed" in out:              # MLA: the absorbed decode too
            ab = out["absorbed"]
            checks[" absorbed"] = ab["check"]
            log(f"[12 configs] absorbed decode: {ab['decode_ms_per_step']:.2f}"
                f" ms/step, served vs scored rel max abs "
                f"{ab['check']['rel_max_abs']:.3e}, greedy argmax agrees at "
                f"{ab['check']['argmax_agree']:.1%}")
        for name, chk in checks.items():
            if chk["rel_max_abs"] > TOL_SERVE:
                raise AssertionError(f"{arch}{name}: served logits off by "
                                     f"{chk['rel_max_abs']}")
        log(f"[12 configs] {arch} done ({time.perf_counter() - t1:.1f}s)")
        outs[arch] = out
    torch.cuda.synchronize()
    launches = _lm_launches()
    log(f"[12 configs] {len(outs)} configs, launches in all {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"launches": launches, "outs": outs}


# ---------------------------------------------------------------------------
# phase 3 (also): the LM kernels refuse inputs that require grad
# ---------------------------------------------------------------------------
def phase_grad_refusal() -> None:
    """Each of the three LM wrappers raises on a CUDA input that requires
    grad while autograd records (none has a backward), and launches as
    before under `inference_mode` on the same tensors' values."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rg_lru import kernel as rg
    from repro_torch.kernels.ssd_scan import kernel as ssd
    g = torch.Generator(device="cuda").manual_seed(400)

    def rand(*shape, lo=None):
        t = torch.rand(shape, generator=g, device="cuda")
        return -t if lo == "neg" else t

    q = rand(1, 256, 4, 64).to(torch.bfloat16)
    a, b = rand(1, 256, 512), rand(1, 256, 512)
    x, dt, A = rand(1, 256, 4, 64), rand(1, 256, 4), rand(4, lo="neg")
    Bg = rand(1, 256, 1, 128)
    calls = (("flash_attention", fa.LAUNCHES,
              lambda w: fa.flash_attention_fwd(w, q, q), q),
             ("rg_lru", rg.LAUNCHES, lambda w: rg.rg_lru_fwd(w, b), a),
             ("ssd_scan", ssd.LAUNCHES,
              lambda w: ssd.ssd_fwd(w, dt, A, Bg, Bg, chunk=128), x))
    for name, counts, call, t in calls:
        leaf = t.clone().requires_grad_(True)
        before = dict(counts)
        try:
            call(leaf)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: a CUDA input that requires grad "
                                 "was taken")
        if dict(counts) != before:
            raise AssertionError(f"{name}: launched on an input that "
                                 "requires grad")
        with torch.inference_mode():
            out = call(leaf)
        torch.cuda.synchronize()
        first = out[0] if isinstance(out, tuple) else out
        if sum(counts.values()) != sum(before.values()) + 1 \
                or not bool(torch.isfinite(first).all()):
            raise AssertionError(f"{name}: no finite launch under "
                                 "inference_mode")
        log(f"[3 kernels] {name}: refuses a CUDA input that requires grad "
            "(RuntimeError, no launch); launches once under inference_mode")


# ---------------------------------------------------------------------------
# phase 13: training on one card
# ---------------------------------------------------------------------------
TRAIN_DIR = ROOT / "build" / "repro_torch" / "train"
# (a) fp32 trainer, card against CPU: GEMMs summed in another order, which
# Adam carries on; the CPU port against the JAX trainer differs by at most
# 1.4e-6 a step over the same 45 steps (tests/test_torch_trainer.py's
# shape, on the CPU)
TOL_TRAIN_CROSS = 1e-4
# (b) one step of each option, card against CPU: the loss (same weights)
# and the gradient norm; the parameters as tests/test_torch_train_step.py
# holds them against JAX (within 2 lr, all but 0.5% within 1% of lr +
# 1e-6 of the leaf's max)
TOL_STEP_LOSS = 1e-5
TOL_STEP_GNORM = 1e-4
# (c) Mamba-2 780M: the replayed steps start from the restored state (bit
# for bit) on the same batches, and every reading on the card was
# bit-equal; 1e-6 leaves about 10 ULP of the loss. A restore that zeroes
# AdamW's moments moves a small model's replayed losses by 2.9e-4, one
# that resets its step count by 3.9e-3 (tests/test_torch_trainer.py::
# test_replay_check_rejects_a_faulty_restore)
TOL_REPLAY = 1e-6
# (c) the held-out logits, the SSD kernel's route against the training
# route (both bf16 compute), relative RMS over every logit, at most this
# share of the control: the training route in bf16 against fp32 on the
# same weights (how far bf16 alone moves them)
LOGITS_OF_ROUNDING = 1.0
# (c) the SSD kernel inside the trained model: layers 0 and 47 of the
# held-out loss, the kernel's outputs against the plain version on the
# same inputs, and the planted faults on them, rejected. y within
# TOL_SSD_TRAIN of max |y| (the kernel read 3.7e-4 and 1.6e-3 here, the
# training route's bf16 `ssd_chunked` 5.9e-3 and 3.2e-3; the smallest
# planted fault 2.83e-2, chunk 3's state zeroed in layer 0, which
# TOL_SSD's 3e-2 passes), h_last within TOL_SSD["float32"]
SSD_TRAIN_CASE = (4, 2048, 48, 64, 128, 128, 1, "bfloat16")
SSD_TRAIN_LAYERS = (0, 47)
TOL_SSD_TRAIN = 1e-2
MAMBA_TRAIN = dict(batch=4, seq=2048, steps=18, ckpt_every=10, fail_at=15,
                   keep_ckpts=1, lr=1e-3)
MAMBA_TRAIN_LAUNCHES = {"flash_attention": 0, "rg_lru": 0,
                        "rg_lru_generic": 0, "ssd_scan": 0}


def _phi3_train_cfg():
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke_config(
        "phi3-mini-3.8b", n_layers=2, d_model=64, vocab=128),
        dtype="float32")


def _train_cross() -> dict:
    """(a) tests/test_trainer_failure_recovery's run on the card and on
    the CPU from the same weights on the same batches."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as optim
    from repro_torch.train import trainer as tr
    cfg = _phi3_train_cfg()
    runs = {}
    for dev in ("cuda", "cpu"):
        d = TRAIN_DIR / f"cross_{dev}"
        shutil.rmtree(d, ignore_errors=True)
        t = tr.Trainer(tr.TrainerConfig(total_steps=40, ckpt_every=10,
                                        ckpt_dir=str(d), log_every=100),
                       cfg, optim.AdamWConfig(lr_peak=5e-3, warmup_steps=5,
                                              total_steps=40),
                       SyntheticLM(vocab=128, batch=4, seq_len=32),
                       device=dev)
        t.inject_failure_at = 25
        out = t.fit()
        shutil.rmtree(d, ignore_errors=True)
        if out["restarts"] != 1 or out["step"] != 40:
            raise AssertionError(f"trainer on {dev}: restarts "
                                 f"{out['restarts']}, step {out['step']}")
        runs[dev] = [m["loss"] for m in out["metrics"]]
    card, cpu = runs["cuda"], runs["cpu"]
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} card steps, {len(cpu)} CPU")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if not rel <= TOL_TRAIN_CROSS or not card[-1] < card[0]:
        raise AssertionError(f"card vs CPU losses rel {rel}, first "
                             f"{card[0]}, last {card[-1]}")
    return {"steps": len(card), "rel": rel, "first": card[0],
            "last": card[-1]}


def _train_options() -> dict:
    """(b) one step of microbatch=4, int8 and cast_params, card against
    CPU from the same weights on the same batch."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_step as ts
    cfg = _phi3_train_cfg()
    ocfg = optim.AdamWConfig(lr_peak=5e-3, warmup_steps=1, total_steps=10)
    batch = next(SyntheticLM(vocab=128, batch=8, seq_len=32, seed=7))
    out = {}
    for name, kw in (("microbatch=4", dict(microbatch=4)),
                     ("int8", dict(grad_compression="int8")),
                     ("cast_params=bfloat16",
                      dict(cast_params="bfloat16"))):
        step = ts.make_train_step(cfg, ocfg, **kw)
        res = {}
        for dev in ("cuda", "cpu"):
            p = lm.lm_init(cfg, torch.Generator().manual_seed(3),
                           device="cpu").to(dev).requires_grad_(True)
            p, _, m = step(p, optim.adamw_init(p), ts.to_device(batch, dev))
            res[dev] = (dict((k, t.detach().cpu()) for k, t in
                             p.named_parameters()),
                        float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"]))
        (pc, lc, gc, lr), (pp, lp, gp, _) = res["cuda"], res["cpu"]
        moved = n = 0
        for k, want in pp.items():
            d = (pc[k] - want).abs()
            near = 1e-6 * float(want.abs().max())
            moved += int((d > 1e-2 * lr + near).sum())
            n += d.numel()
            if float(d.max()) > 2 * lr + near:
                raise AssertionError(f"{name} {k}: off by {float(d.max())}")
        if abs(lc - lp) > TOL_STEP_LOSS or abs(gc - gp) > TOL_STEP_GNORM * gp \
                or moved > 5e-3 * n:
            raise AssertionError(f"{name}: loss {lc} vs {lp}, grad norm "
                                 f"{gc} vs {gp}, {moved} of {n} moved")
        out[name] = {"loss": lc, "loss_cpu": lp, "grad_norm": gc,
                     "grad_norm_cpu": gp, "moved": moved, "n": n}
    return out


@contextlib.contextmanager
def _capture_ssd(calls: tuple, into: dict):
    """`ssd_ops.ssd`'s inputs and outputs at the given call indices (0:
    the first call), kept in `into`; each call goes through unchanged."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    real, n = ssd_ops.ssd, [0]

    def ssd(*args, **kw):
        out = real(*args, **kw)
        if n[0] in calls:
            into[n[0]] = (args, kw["chunk"], out)
        n[0] += 1
        return out
    ssd_ops.ssd = ssd
    try:
        yield
    finally:
        ssd_ops.ssd = real


def _ssd_train_passes(errs) -> bool:
    return errs[0] <= TOL_SSD_TRAIN and errs[1] <= TOL_SSD["float32"]


def _ssd_in_model(caught: dict, fault_libs) -> dict:
    """The SSD kernel's outputs in the trained model against the plain
    version on the same inputs, the training route's `ssd_chunked` beside
    them, and the planted faults on the same inputs."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.ssd import ssd_chunked
    case = SSD_TRAIN_CASE
    out = {}
    with torch.inference_mode():
        for layer, ((x, dt, A, Bg, Cg), chunk, got) in sorted(caught.items()):
            if tuple(x.shape) != case[:4] or chunk != case[5] \
                    or tuple(Bg.shape) != (*case[:2], case[6], case[4]):
                raise AssertionError(f"SSD layer {layer}: x {tuple(x.shape)}"
                                     f", B {tuple(Bg.shape)}, chunk {chunk}")
            args = (x.contiguous(), dt.float().contiguous(),
                    A.float().contiguous(), Bg.contiguous(), Cg.contiguous())
            want = ssd_ops.ssd_plain(*args)
            row = {"kernel": _ssd_errors(got, want, case),
                   "train_route": _ssd_errors(
                       ssd_chunked(*args, chunk=chunk), want, case),
                   "faults": {}}
            for (name, _), lib in zip(SSD_FAULTS, fault_libs):
                row["faults"][name] = _ssd_errors(
                    _ssd_launch(lib, *args, chunk), want, case)
            torch.cuda.synchronize()
            out[layer] = row
    return out


def phase_train(smi: str, fault_libs) -> dict:
    """Training on the card: (a) the trainer's failure-recovery run, card
    against CPU; (b) one step of each option against the CPU; (c) Mamba-2
    780M at full width and depth, 4 x 2048 tokens a step, a checkpoint at
    step 10, a failure injected at 15, the restore and the replayed steps,
    then a held-out loss and logits through the SSD kernel against the
    training route, and the kernel's outputs in two layers against the
    plain version, with the planted faults (`fault_libs`) rejected at that
    shape. The launch counts are reset before each part: training reaches
    no kernel; the held-out scoring launches the SSD kernel 48 times a
    call, twice (the loss and the logits)."""
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _reset_lm_launches()
    cross = _train_cross()
    opts = _train_options()
    torch.cuda.synchronize()
    if _lm_launches() != MAMBA_TRAIN_LAUNCHES:
        raise AssertionError(f"training launched {_lm_launches()}")
    log(f"[13 train] (a) phi3-mini smoke (2 layers, d 64, vocab 128), "
        f"fp32, 4 x 32 tokens, 40 steps, checkpoint every 10, failure at 25:"
        f" card and CPU restart once and end at step 40; {cross['steps']} "
        f"losses card vs CPU rel max {cross['rel']:.3e} (tol "
        f"{TOL_TRAIN_CROSS}), loss {cross['first']:.4f} -> "
        f"{cross['last']:.4f}")
    for name, o in opts.items():
        log(f"[13 train] (b) one step {name} card vs CPU: loss "
            f"{o['loss']:.6f} vs {o['loss_cpu']:.6f}, grad norm "
            f"{o['grad_norm']:.6f} vs {o['grad_norm_cpu']:.6f}, "
            f"{o['moved']} of {o['n']} parameters moved apart")
    log(f"[13 train] (a)+(b) kernel launches {_lm_launches()} (the "
        f"training route takes the plain forms) "
        f"({time.perf_counter() - t0:.1f}s)")

    t1 = time.perf_counter()
    cfg = configs.get_config("mamba2-780m")
    ckpt_dir = TRAIN_DIR / "mamba"
    _reset_lm_launches()
    caught: dict = {}
    with _capture_ssd(SSD_TRAIN_LAYERS, caught):
        out = lm_train.run(device="cuda", cfg=cfg, ckpt_dir=str(ckpt_dir),
                           **MAMBA_TRAIN)
    torch.cuda.synchronize()
    launches = _lm_launches()
    in_model = _ssd_in_model(caught, fault_libs)
    if ckpt_dir.exists():
        raise AssertionError(f"{ckpt_dir} left behind")
    steps = MAMBA_TRAIN["steps"]
    losses = [x for _, x in out["losses"]]
    replay_rel = max(abs(b - a) / abs(a) for _, a, b in out["replayed"])
    log(f"[13 train] (c) {out['arch']} {out['n_layers']} layers, d_model "
        f"{out['d_model']}, vocab {out['vocab']}, {out['params']:,} params "
        f"(fp32 at rest, AdamW moments fp32, {out['dtype']} compute, remat "
        f"{out['remat']}), {out['batch']} x {out['seq']} tokens a step, "
        f"{steps} steps in {out['fit_s']:.1f}s with the checkpoints, the "
        f"failure and the restore | {smi}")
    log(f"[13 train] (c) step {out['step_s_median']:.3f}s median (min "
        f"{out['step_s_min']:.3f}s), {out['tok_per_s']:.0f} tok/s, peak "
        f"memory {out['peak_mem_bytes'] / 2**30:.2f} GiB | {smi}")
    log(f"[13 train] (c) the whole window: {len(out['losses'])} steps run "
        f"({steps} that count) in {out['fit_s']:.2f}s, "
        f"{out['tok_per_s_window']:.0f} tok/s run, "
        f"{out['goodput_tok_per_s']:.0f} tok/s that count; the failure "
        f"cost {out['failure_cost_s']:.2f}s (the restore and "
        f"{len(out['replayed'])} replayed steps) | {smi}")
    for sv in out["saves"]:
        log(f"[13 train] (c) checkpoint at step {sv['step']}: "
            f"{sv['bytes'] / 1e9:.3f} GB, snapshot to host "
            f"{sv['snapshot_s']:.2f}s, write {sv['write_s']:.2f}s "
            f"({sv['bytes'] / 1e9 / sv['write_s']:.2f} GB/s) | {smi}")
    for rs in out["restores"]:
        log(f"[13 train] (c) restore of step {rs['step']}: "
            f"{rs['seconds']:.2f}s | {smi}")
    log(f"[13 train] (c) loss curve "
        + ", ".join(f"{s}:{x:.4f}" for s, x in out["losses"]))
    log(f"[13 train] (c) replayed steps after the restore against the first"
        f" run: " + ", ".join(f"{s}: {a:.6f} / {b:.6f}"
                              for s, a, b in out["replayed"])
        + f"; rel max {replay_rel:.3e} (tol {TOL_REPLAY})")
    log(f"[13 train] (c) held-out loss, {out['batch']} x {out['seq']}: SSD "
        f"kernel route {out['heldout_loss_kernels']:.6f}, training route "
        f"{out['heldout_loss_train_route']:.6f}, rel "
        f"{out['heldout_rel']:.3e} (tol {TOL_SSD['bfloat16']}); launches "
        f"training {out['train_launches']}, held-out "
        f"{out['heldout_launches']}, held-out on the training route "
        f"{out['heldout_train_route_launches']} "
        f"({time.perf_counter() - t1:.1f}s)")
    logits_lim = LOGITS_OF_ROUNDING * out["heldout_logits_rel_fp32"]
    log(f"[13 train] (c) held-out logits, relative RMS: SSD kernel route "
        f"against the training route {out['heldout_logits_rel']:.3e} "
        f"(limit {logits_lim:.3e}: {LOGITS_OF_ROUNDING} x the control, the "
        f"training route in bf16 against fp32, "
        f"{out['heldout_logits_rel_fp32']:.3e})")
    for layer, row in in_model.items():
        log(f"[13 train] (c) SSD kernel in layer {layer} at "
            f"{SSD_TRAIN_CASE}: error y {row['kernel'][0]:.3e}, h_last "
            f"{row['kernel'][1]:.3e} (limits {TOL_SSD_TRAIN}, "
            f"{TOL_SSD['float32']}); the training route's ssd_chunked y "
            f"{row['train_route'][0]:.3e}, h_last {row['train_route'][1]:.3e}"
            "; planted faults " + ", ".join(
                f"'{n}' y {e[0]:.3e} h_last {e[1]:.3e}"
                for n, e in row["faults"].items()))
    want_held = dict(MAMBA_TRAIN_LAUNCHES, ssd_scan=2 * cfg.n_layers)
    if out["params"] != MAMBA_PARAMS or out["restarts"] != 1 \
            or out["final_step"] != steps \
            or [s for s, _, _ in out["replayed"]] != list(
                range(MAMBA_TRAIN["ckpt_every"] + 1,
                      MAMBA_TRAIN["fail_at"] + 1)):
        raise AssertionError(f"mamba training: {out['params']} params, "
                             f"{out['restarts']} restarts, step "
                             f"{out['final_step']}, replayed "
                             f"{out['replayed']}")
    if out["train_launches"] != MAMBA_TRAIN_LAUNCHES \
            or out["heldout_train_route_launches"] != MAMBA_TRAIN_LAUNCHES \
            or out["heldout_launches"] != want_held \
            or launches != want_held:
        raise AssertionError(f"launches: training {out['train_launches']}, "
                             f"held-out {out['heldout_launches']}, in all "
                             f"{launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"mamba losses {losses}")
    if not replay_rel <= TOL_REPLAY:
        raise AssertionError(f"replayed losses off by {replay_rel}")
    if not out["heldout_rel"] <= TOL_SSD["bfloat16"]:
        raise AssertionError(f"held-out loss kernel vs training route "
                             f"{out['heldout_rel']}")
    if not out["heldout_logits_rel"] <= logits_lim:
        raise AssertionError(f"held-out logits kernel vs training route "
                             f"{out['heldout_logits_rel']} > {logits_lim}")
    if sorted(in_model) != list(SSD_TRAIN_LAYERS):
        raise AssertionError(f"SSD calls caught: {sorted(in_model)}")
    for layer, row in in_model.items():
        if not _ssd_train_passes(row["kernel"]):
            raise AssertionError(f"SSD kernel in layer {layer}: "
                                 f"{row['kernel']}")
        for name, errs in row["faults"].items():
            if _ssd_train_passes(errs):
                raise AssertionError(f"SSD in layer {layer}: the checks pass"
                                     f" the planted fault '{name}' ({errs})")
    torch.cuda.empty_cache()
    log(f"[13 train] done ({time.perf_counter() - t0:.1f}s)")
    return {"launches": launches, "cross": cross, "options": opts,
            "mamba": out, "ssd_in_model": in_model}


# ---------------------------------------------------------------------------
# phase 14: the sharded steps on a 1 x 1 mesh over NCCL, and the dry-run
# ---------------------------------------------------------------------------
# (a) Mamba-2 780M, phase 13's initial weights and data and AdamW: the
# sharded step against the single-device one, losses (relative) and every
# parameter (absolute, all below 1 in magnitude); both are deterministic
# on the card, and a 1 x 1 mesh runs the same local ops
SHARD_TRAIN_STEPS = 4
TOL_SHARD_TRAIN = 1e-6
# (b) RecurrentGemma-9B: prefill 1 x 4096, then decode steps
SHARD_PROMPT, SHARD_DECODE = 4096, 8
# (c) the reference's hill-climb cells, on the 16 x 16 fake mesh
DRYRUN_CELLS = (("deepseek-v2-lite-16b", "train_4k"),
                ("qwen2-72b", "train_4k"),
                ("minicpm3-4b", "decode_32k"))
DRYRUN_JSON = ROOT / "build" / "repro_torch" / "phase14_dryrun.json"
DRYRUN_TIMEOUT_S = 600
# and (a)'s step counted by the dry-run on a fake group of one, as (a)
# builds it (`make_sharded_train_step`'s defaults: no sequence
# parallelism): its argument + temp bytes against (a)'s measured peak
TOL_DRYRUN_MEM = 0.15
DRYRUN_STEP = ("import json, sys\n"
               "from repro_torch.launch import dryrun\n"
               "from repro_torch.launch.shapes import ShapeSpec\n"
               "spec = ShapeSpec(sys.argv[1], 'train', int(sys.argv[3]),\n"
               "                 int(sys.argv[2]))\n"
               "r = dryrun.run_cell('mamba2-780m', spec, mesh_shape=(1, 1),\n"
               "                    variant={'sequence_parallel': False})\n"
               "json.dump(r, open(sys.argv[4], 'w'))\n")


def _nccl_group():
    """A process group of one rank over NCCL on card 0 (this process
    started it: True) or the one in place (False)."""
    import socket

    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    torch.cuda.set_device(0)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return True


def _timed_steps(step, params, state, batches) -> tuple:
    """(losses, seconds a step, peak bytes) of one step on each batch."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs, torch.cuda.max_memory_allocated()


def _shard_train(mesh, smi: str) -> dict:
    """(a): 4 steps of 4 x 2048 on the mesh and on one device."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    from repro_torch.train import optimizer as optim
    from repro_torch.train import train_step as ts
    cfg = configs.get_config("mamba2-780m")
    n = MAMBA_TRAIN["steps"]
    ocfg = optim.AdamWConfig(lr_peak=1e-3, warmup_steps=max(n // 10, 1),
                             total_steps=n)
    data = iter(SyntheticLM(vocab=cfg.vocab, batch=MAMBA_TRAIN["batch"],
                            seq_len=MAMBA_TRAIN["seq"], seed=0))
    batches = [ts.to_device(next(data), "cuda")
               for _ in range(SHARD_TRAIN_STEPS)]

    def init():     # phase 13's initial weights (`Trainer.init_state`)
        p = lm.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        return p.to("cuda").requires_grad_(True)

    p1 = init()
    one = _timed_steps(ts.make_train_step(cfg, ocfg), p1,
                       optim.adamw_init(p1), batches)
    want = {k: v.detach().cpu() for k, v in p1.named_parameters()}
    del p1
    torch.cuda.empty_cache()
    step, place = ts.make_sharded_train_step(cfg, ocfg, mesh)
    p2, state = place(init(), None)
    got = _timed_steps(step, p2, optim.adamw_init(p2), batches)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], one[0]))
    param_abs = max(
        float((sharding.full_tensor(v.detach()).cpu() - want[k]).abs().max())
        for k, v in p2.named_parameters())
    placements = {str(v.placements) for v in p2.parameters()}
    del p2, state
    torch.cuda.empty_cache()
    med = sorted(got[1][1:])[len(got[1][1:]) // 2]
    med1 = sorted(one[1][1:])[len(one[1][1:]) // 2]
    log(f"[14 shard] (a) {cfg.name} {cfg.n_layers} layers on mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (NCCL), "
        f"{MAMBA_TRAIN['batch']} x {MAMBA_TRAIN['seq']} tokens, "
        f"{SHARD_TRAIN_STEPS} steps; parameters as DTensors "
        f"{sorted(placements)}; losses sharded "
        + ", ".join(f"{x:.6f}" for x in got[0]) + " / one device "
        + ", ".join(f"{x:.6f}" for x in one[0])
        + f"; rel max {loss_rel:.3e}, parameters abs max {param_abs:.3e} "
        f"(tol {TOL_SHARD_TRAIN})")
    log(f"[14 shard] (a) step median of steps 2-{SHARD_TRAIN_STEPS}: "
        f"sharded {med:.3f}s, one device {med1:.3f}s (phase 13's trainer "
        f"above); peak memory sharded {got[2] / 2**30:.2f} GiB, one device "
        f"{one[2] / 2**30:.2f} GiB | {smi}")
    if not (loss_rel <= TOL_SHARD_TRAIN and param_abs <= TOL_SHARD_TRAIN):
        raise AssertionError(f"sharded Mamba-2 step: losses {loss_rel}, "
                             f"parameters {param_abs}")
    return {"losses": got[0], "losses_one": one[0], "step_s": med,
            "step_s_one": med1, "peak": got[2], "peak_one": one[2]}


def _shard_serve(mesh, smi: str) -> dict:
    """(b): RecurrentGemma-9B's prefill and decode steps on one device,
    then the same parameters placed on the mesh (in place) and the
    sharded steps on fresh caches: logits bit for bit, launches equal."""
    import torch
    from repro_torch import configs
    from repro_torch.bench import lm_serve
    from repro_torch.models import lm
    from repro_torch.train import train_step as ts
    cfg = configs.get_config("recurrentgemma-9b")
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, SHARD_PROMPT + SHARD_DECODE),
                         generator=gen, device="cuda")
    p = lm_serve.build(cfg, 0, "cuda")

    def serve(prefill, decode, params, make_caches):
        """The steps twice on fresh caches (the first warms the library
        handles and DTensor's sharding caches up), the second timed and
        counted."""
        warm = prefill(params, toks[:, :SHARD_PROMPT], make_caches())
        del warm
        caches = make_caches()
        _reset_lm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, toks[:, :SHARD_PROMPT], caches)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        pre_launches = _lm_launches()
        out = [logits]
        for i in range(SHARD_DECODE):
            logits, caches = decode(params, toks[:, SHARD_PROMPT + i],
                                    SHARD_PROMPT + i, caches)
            out.append(logits)
        torch.cuda.synchronize()
        return torch.stack(out), t_pre, pre_launches, _lm_launches()

    def caches():
        return lm.init_caches(cfg, 1, SHARD_PROMPT + SHARD_DECODE,
                              device="cuda")

    # the serve steps run under no_grad
    one = serve(ts.make_serve_step(cfg, "prefill"),
                ts.make_serve_step(cfg, "decode"), p, caches)
    prefill, place = ts.make_sharded_serve_step(cfg, mesh, "prefill")
    decode, _ = ts.make_sharded_serve_step(cfg, mesh, "decode")
    p, _ = place(p, None)

    def placed():
        return place(p, caches())[1]
    got = serve(prefill, decode, p, placed)
    del p
    torch.cuda.empty_cache()
    equal = torch.equal(got[0], one[0])
    log(f"[14 shard] (b) {cfg.name} {cfg.n_layers} layers (fp32 at rest) on "
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: prefill 1 x "
        f"{SHARD_PROMPT} sharded {got[1]:.3f}s, one device {one[1]:.3f}s; "
        f"{SHARD_DECODE} decode steps; logits bit-equal {equal} (max abs "
        f"{float((got[0] - one[0]).abs().max()):.3e}); launches sharded "
        f"prefill {got[2]}, all {got[3]}; one device prefill {one[2]}, all "
        f"{one[3]} | {smi}")
    if not equal:
        raise AssertionError("sharded RecurrentGemma logits differ")
    if got[2] != one[2] or got[3] != one[3] \
            or got[2]["flash_attention"] != EXPECTED_LAUNCHES[
                "prefill_launches"]["flash_attention"] \
            or got[2]["rg_lru"] != EXPECTED_LAUNCHES[
                "prefill_launches"]["rg_lru"]:
        raise AssertionError(f"sharded launches {got[2]} {got[3]}, one "
                             f"device {one[2]} {one[3]}")
    return {"launches": got[3], "prefill_s": got[1], "prefill_s_one": one[1]}


def _dryrun_cells(smi: str, train: dict) -> dict:
    """(c): the dry-run of the three cells, each in a process of its own
    (a fake process group is process-global), then `bench.run`'s
    roofline section on their record; beside them, in a process too, the
    dry-run's count of (a)'s step (Mamba-2 780M, fp32 AdamW, the same
    batch, on a fake group of one), whose argument + temp bytes must lie
    within `TOL_DRYRUN_MEM` of the peak (a) measured."""
    import os
    from repro_torch.bench import run as bench_run
    from repro_torch.launch import roofline
    DRYRUN_JSON.parent.mkdir(parents=True, exist_ok=True)
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "r = dryrun.run_cell(sys.argv[1], sys.argv[2])\n"
            "json.dump(r, open(sys.argv[3], 'w'))\n")
    t0 = time.perf_counter()
    parts = [DRYRUN_JSON.with_suffix(f".{i}.json")
             for i in range(len(DRYRUN_CELLS) + 1)]
    step_name = f"train_{MAMBA_TRAIN['batch']}x{MAMBA_TRAIN['seq']}"
    argvs = [["-c", code, a, s, str(part)]
             for (a, s), part in zip(DRYRUN_CELLS, parts)]
    argvs.append(["-c", DRYRUN_STEP, step_name, str(MAMBA_TRAIN["batch"]),
                  str(MAMBA_TRAIN["seq"]), str(parts[-1])])
    procs = [subprocess.Popen(      # one process a cell, side by side
        [sys.executable, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""))
        for argv in argvs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=DRYRUN_TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for proc, (out, err) in zip(procs, outs):
        for line in out.splitlines():
            if line.startswith("["):
                log(f"[14 dryrun] {line}")
        if proc.returncode != 0:
            raise AssertionError(f"dry-run exited {proc.returncode}:\n"
                                 f"{out[-4000:]}\n{err[-4000:]}")
    cells = [json.loads(part.read_text()) for part in parts]
    step = cells.pop()
    DRYRUN_JSON.write_text(json.dumps(cells))
    os.environ["REPRO_DRYRUN_JSON"] = str(DRYRUN_JSON)
    try:
        results, failures = bench_run.run_sections(None, only={"roofline"})
    finally:
        os.environ.pop("REPRO_DRYRUN_JSON")
    if failures:
        raise AssertionError(f"roofline section: {failures}")
    rows = results["roofline"]["result"]
    for cell, row in zip(cells, rows):
        t = roofline.roofline_terms(cell)
        log(f"[14 dryrun] {cell['arch']} x {cell['shape']} on "
            f"{cell['n_devices']} H100 (16 x 16): dot FLOPs/card "
            f"{cell['dot_flops_per_dev']:.4e}, dot bytes/card "
            f"{cell['dot_bytes_per_dev']:.4e}, collective bytes/card "
            f"{cell['collective_bytes']}, argument bytes/card "
            f"{cell['memory']['argument_size_in_bytes']:.4e}, temp "
            f"{cell['memory']['temp_size_in_bytes']:.4e}, output "
            f"{cell['memory']['output_size_in_bytes']:.4e}: "
            f"{row['mem_gb_per_dev']:.2f} GB a card (argument + temp) of "
            f"an H100's 80; compute "
            f"{t['compute_s']:.4f}s, memory {t['memory_s']:.4f}s, collective "
            f"{t['collective_s']:.4f}s, bound {t['dominant']} "
            f"{t['step_time_bound_s']:.4f}s, useful {t['useful_ratio']:.3f}, "
            f"roofline fraction {t['roofline_fraction']:.3f} (H100 "
            f"constants; fake process group on the host, no card)")
        if cell["status"] != "ok" or row.get("status") != "ok" \
                or cell["dot_flops_per_dev"] * cell["n_devices"] \
                < cell["model_flops_global"] \
                or not t["step_time_bound_s"] > 0 \
                or not 0 <= t["roofline_fraction"] <= 1.5:
            raise AssertionError(f"dry-run cell {cell['arch']} x "
                                 f"{cell['shape']}: {cell} {t}")
    mem = step["memory"]
    counted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    gap = counted / train["peak"] - 1
    log(f"[14 dryrun] (a)'s step counted on a fake group of one "
        f"({step_name}): argument {mem['argument_size_in_bytes']:.0f} + "
        f"temp {mem['temp_size_in_bytes']:.0f} = {counted / 2**30:.3f} GiB "
        f"(output {mem['output_size_in_bytes'] / 2**30:.3f} GiB); (a) "
        f"measured {train['peak'] / 2**30:.3f} GiB sharded, "
        f"{train['peak_one'] / 2**30:.3f} GiB on one device "
        f"(max_memory_allocated): gap {gap:+.2%} (limit "
        f"{TOL_DRYRUN_MEM:.0%}) | {smi}")
    if step["status"] != "ok" or not abs(gap) <= TOL_DRYRUN_MEM:
        raise AssertionError(f"dry-run memory of (a)'s step: {mem}, "
                             f"measured {train['peak']}")
    log(f"[14 dryrun] {len(cells) + 1} cells in {wall:.1f}s (a process "
        f"each, side by side) | {smi}")
    return {"cells": cells, "rows": rows, "wall_s": wall, "step": step,
            "step_gap": gap}


def phase_shard(smi: str) -> dict:
    """Phase 14: the sharded steps on a 1 x 1 mesh over NCCL at full
    width and depth, (a) Mamba-2 780M's train step and (b)
    RecurrentGemma-9B's prefill and decode, each against the
    single-device step; then (c) the dry-run of three cells on the
    16 x 16 production mesh of a fake process group, and its roofline."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    own = _nccl_group()
    try:
        mesh = meshlib.make_local_mesh(1, 1)
        train = _shard_train(mesh, smi)
        serve = _shard_serve(mesh, smi)
    finally:
        if own:
            dist.destroy_process_group()
    t1 = time.perf_counter()
    dry = _dryrun_cells(smi, train)
    log(f"[14 shard] done: (a)+(b) {t1 - t0:.1f}s, (c) "
        f"{time.perf_counter() - t1:.1f}s")
    return {"launches": serve["launches"], "train": train, "serve": serve,
            "dryrun": dry}


ETF_SRC = "src/repro_torch/kernels/etf_ft/csrc/etf_ft.cu"
KERNELS = (  # name, source, TPU kernel replaced, path
    ("etf_ft_search_masked", ETF_SRC,
     "src/repro/kernels/etf_ft/kernel.py:122", "das"),
    ("etf_ft_search", ETF_SRC, "src/repro/kernels/etf_ft/kernel.py:72",
     "das"),
    ("push_rows", ETF_SRC, "src/repro/kernels/etf_ft/kernel.py:181", "das"),
    ("avail_rows", ETF_SRC, "src/repro/kernels/etf_ft/kernel.py:181", "das"),
    ("flash_attention",
     "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:84", "lm"),
    ("rg_lru", "src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu",
     "src/repro/kernels/rg_lru/kernel.py:48", "lm"),
    ("ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan/kernel.py:65", "mamba"),
)


def main() -> int:
    import torch
    smi = phase_device()
    built = phase_build()
    kern = phase_kernels()
    lm_kern = phase_lm_kernels(built["rg_faults"])
    ssd_kern = phase_ssd_kernels(built["ssd_faults"])
    phase_grad_refusal()
    das_path = phase_main()
    phase_cross(das_path["out"]["trees"])
    fault_path = phase_faults(das_path["out"]["trees"])
    sections = phase_sections()
    campaign_path = phase_campaign(das_path["out"]["trees"], sections)
    lm_path = phase_lm()
    phase_lm_cross()
    mamba_path = phase_mamba()
    phase_mamba_cross()
    ds_path = phase_deepseek()
    phase_deepseek_cross()
    cfg_path = phase_configs()
    train_path = phase_train(smi, built["ssd_faults"])
    shard_path = phase_shard(smi)
    checked = {"das": kern, "lm": lm_kern, "mamba": ssd_kern}
    # the DAS kernels' launches over its four paths: summary40 (phase
    # 4), the fault path (5b), the benchmark's sections (5c) and the
    # campaign on the card (5d)
    das_launches = {k: das_path["launches"][k] + fault_path["launches"][k]
                    + sections["launches"][k] + campaign_path["launches"][k]
                    for k in das_path["launches"]}
    # flash and the RG-LRU scan over their model paths: RecurrentGemma
    # (phase 6) and its sharded steps (phase 14), and the GQA configs of
    # phase 12; DeepSeek (phase 10) launches none
    lm_launches = {k: lm_path["launches"][k] + ds_path["launches"][k]
                   + cfg_path["launches"][k] + shard_path["launches"][k]
                   for k in lm_path["launches"]}
    # the SSD kernel over its two paths: Mamba-2 serving (phase 8) and the
    # trained Mamba-2's held-out loss and logits (phase 13)
    mamba_launches = {k: mamba_path["launches"][k]
                      + train_path["launches"][k]
                      for k in mamba_path["launches"]}
    launched = {"das": das_launches, "lm": lm_launches,
                "mamba": mamba_launches}
    rows = []
    for name, source, replaces, path in KERNELS:
        t = checked[path]["timing"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched[path][name],
            "max_abs_err": checked[path]["err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
