"""The port's launch-and-analysis tools against the JAX package's: the
shape suite and its cells, `model_flops_for_cell` for all 32 cells, the
variants, the roofline's arithmetic with the H100 constants, a dry-run
cell on a fake 2 x 2 process group (in a process of its own: the fake
group is process-global), and the full dry-run record when one is there.

The reference's `test_tpu_corrected_bytes_preferred` has no counterpart:
it reads `collective_bytes_tpu`, the reference's correction for XLA:CPU
storing bf16 as fp32, and a torch program's collectives move the dtypes
it holds.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline  # noqa: E402
from repro_torch.launch.shapes import SHAPES, applicable, cells  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = jshapes.cells({a: jconfigs.get_config(a) for a in jconfigs.ARCH_IDS})


def _jax_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices for backends started later; this process's backend is
    started first, and the variable is put back."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return jdryrun


def test_cell_enumeration_and_skips():
    cfgs = {a: configs.get_config(a) for a in configs.ARCH_IDS}
    cs = cells(cfgs)
    # 10 archs x 4 shapes = 40; 8 full-attention archs skip long_500k
    assert len(cs) == 40 - 8
    for a in ("mamba2-780m", "recurrentgemma-9b"):
        assert (a, "long_500k") in cs
    for a in ("yi-34b", "qwen2-72b", "dbrx-132b"):
        assert (a, "long_500k") not in cs
        assert applicable(cfgs[a], "long_500k") is not None
    assert cs == CELLS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


def test_roofline_terms_math():
    """The reference's case, rescaled to the H100 constants: 1 s of
    compute, 0.5 s of memory, 0.25 s of collectives."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW) == \
        (989e12, 3.35e12, 50e9)
    cell = {
        "status": "ok", "n_devices": 256,
        "dot_flops_per_dev": 989e12,
        "dot_bytes_per_dev": 3.35e12 / 2,
        "collective_bytes": {"all-gather": 50e9 / 4},
        "model_flops_global": 989e12 * 256 / 2,
    }
    t = roofline.roofline_terms(cell)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(0.25)
    assert t["dominant"] == "compute_s"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert t["useful_ratio"] == pytest.approx(0.5)
    # collective-bound: the bound and the fraction follow the dominant
    cell["collective_bytes"] = {"all-reduce": 50e9 * 2, "all-gather": 50e9}
    t = roofline.roofline_terms(cell)
    assert t["dominant"] == "collective_s"
    assert t["step_time_bound_s"] == pytest.approx(3.0)
    assert t["roofline_fraction"] == pytest.approx(0.5 / 3.0)
    assert roofline.roofline_terms({"status": "failed"}) is None


_JAX_PARAMS: dict = {}     # config -> the reference's abstract params


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda x: x)
def test_model_flops_for_cell_matches_jax(arch, shape, monkeypatch):
    """Each cell through the reference's function, its `eval_shape` of
    the parameters kept for the arch's other cells."""
    jdryrun = _jax_dryrun()
    real = jdryrun.abstract_params

    def kept(cfg):
        if cfg not in _JAX_PARAMS:
            _JAX_PARAMS[cfg] = real(cfg)
        return _JAX_PARAMS[cfg]
    monkeypatch.setattr(jdryrun, "abstract_params", kept)
    want = jdryrun.model_flops_for_cell(jconfigs.get_config(arch), shape)
    got = dryrun.model_flops_for_cell(configs.get_config(arch), shape)
    assert got == want


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    for k in ("scan_layers", "use_pallas"):
        d.pop(k, None)
    return d


def test_variants_match_jax():
    """`production_variant` and `apply_variant` (with it, and with every
    hill-climb experiment's variant) for every cell."""
    jdryrun = _jax_dryrun()
    from repro.launch import hillclimb as jhill
    from repro_torch.launch import hillclimb
    for arch, shape in CELLS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        v = dryrun.production_variant(arch, shape, cfg)
        assert v == jdryrun.production_variant(arch, shape, jcfg)
        assert _fields(dryrun.apply_variant(cfg, v)) == \
            _fields(jdryrun.apply_variant(jcfg, v))
    assert [e[:4] for e in hillclimb.EXPERIMENTS] == \
        [e[:4] for e in jhill.EXPERIMENTS]
    for arch, _, _, v, _ in hillclimb.EXPERIMENTS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert _fields(dryrun.apply_variant(cfg, v)) == \
            _fields(jdryrun.apply_variant(jcfg, v))


def test_dryrun_small_cell_on_fake_mesh(tmp_path):
    """A smoke Phi-3 train_4k cell on a fake 2 x 2 group, in a process of
    its own: the record has the reference's fields, the products'
    FLOPs cover the model's, and the step moved bytes between ranks."""
    code = (
        "import json, sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import dryrun\n"
        "cfg = configs.get_smoke_config('phi3-mini-3.8b')\n"
        "r = dryrun.run_cell('phi3-mini-3.8b', 'train_4k', cfg=cfg,\n"
        "                    mesh_shape=(2, 2), verbose=False)\n"
        "json.dump(r, open(sys.argv[1], 'w'))\n")
    out = tmp_path / "cell.json"
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    r = json.loads(out.read_text())
    for k in ("dot_flops_per_dev", "dot_bytes_per_dev", "collective_bytes",
              "memory", "n_devices", "model_flops_global", "n_params",
              "n_active_params", "status"):
        assert k in r, k
    assert r["status"] == "ok" and r["n_devices"] == 4
    assert r["dot_flops_per_dev"] * r["n_devices"] >= r["model_flops_global"]
    assert r["dot_bytes_per_dev"] > 0
    assert r["collective_bytes"]["all-gather"] > 0
    assert r["memory"]["argument_size_in_bytes"] > 0
    assert r["memory"]["temp_size_in_bytes"] > 0
    assert r["memory"]["output_size_in_bytes"] > 0
    t = roofline.roofline_terms(r)
    assert t["step_time_bound_s"] > 0 and 0 < t["roofline_fraction"] <= 1.5


def test_dryrun_counts_do_not_depend_on_earlier_cells(tmp_path):
    """The same cell twice in one process counts the same: DTensor
    infers an op's output shape the first time a process meets it, by
    running the op on global-shape fake tensors (a smoke Mamba-2
    `decode_32k` on a 2 x 2 group counted 4.4x the products on its
    first run), so the dry-run counts a second run of the step."""
    code = (
        "import json, sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import dryrun\n"
        "cfg = configs.get_smoke_config('mamba2-780m')\n"
        "rs = [dryrun.run_cell('mamba2-780m', 'decode_32k', cfg=cfg,\n"
        "                      mesh_shape=(2, 2), verbose=False)\n"
        "      for _ in range(2)]\n"
        "json.dump(rs, open(sys.argv[1], 'w'))\n")
    out = tmp_path / "cells.json"
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    first, again = json.loads(out.read_text())
    for k in ("dot_flops_per_dev", "dot_bytes_per_dev", "collective_bytes",
              "memory"):
        assert first[k] == again[k], k
    assert first["dot_flops_per_dev"] > 0


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
def test_counter_live_bytes_are_exact(fake):
    """The dry-run's live bytes on allocations known by construction:
    counted by storage (a view adds nothing), freed when the storage
    dies, tensors made before the count never counted, on real tensors
    and on fake ones alike."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import contextlib
    ctx = FakeTensorMode() if fake else contextlib.nullcontext()
    with ctx:
        before = torch.ones(100)
        counter = dryrun.Counter()
        with counter:
            a = torch.ones(1000)                       # 4,000 live
            b = a * 2                                  # 8,000: the peak
            del a                                      # 4,000
            d = torch.zeros(250, dtype=torch.float64)  # 6,000
            v = d[10:20].view(2, 5)                    # a view: none
            w = before.view(10, 10)                    # none
            before.add_(1)                             # in place: none
        assert (counter.peak_bytes, counter.live_bytes) == (8000, 6000)
        assert dryrun._storage_bytes((b, [v, w], {"d": d})) == 6400
        del b
        assert counter.live_bytes == 2000
        del v, d
        assert counter.live_bytes == 0


def _smoke_step_counts(fake: bool) -> tuple:
    """One single-device train step of a smoke Phi-3 (2 x 32 tokens)
    under the dry-run's counter: its dot FLOPs and bytes, its peak live
    bytes and its outputs' bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import contextlib
    from repro_torch.models import lm
    from repro_torch.train import optimizer as optim, train_step as ts
    cfg = configs.get_smoke_config("phi3-mini-3.8b")
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    with mode:
        params = lm.lm_init(cfg, torch.Generator().manual_seed(0),
                            device="cpu").requires_grad_(True)
        state = optim.adamw_init(params)
        tokens = torch.zeros((2, 32), dtype=torch.int64)
        batch = {"tokens": tokens, "labels": tokens}
    step = ts.make_train_step(cfg, optim.AdamWConfig())
    counter = dryrun.Counter()
    with counter, mode:
        out = step(params, state, batch)
    return (counter.dot_flops, counter.dot_bytes, counter.peak_bytes,
            dryrun._storage_bytes(out))


def test_counter_same_on_real_and_fake_tensors():
    """The same smoke step counts the same products and the same bytes
    on real CPU tensors as on the fake ones the dry-run runs."""
    real, fake = _smoke_step_counts(False), _smoke_step_counts(True)
    assert real == fake and real[2] > 0 and real[3] > 0


@pytest.mark.skipif(not os.path.exists(dryrun.OUT),
                    reason="dry-run record not present")
def test_dryrun_artifact_complete_and_clean():
    with open(dryrun.OUT) as f:
        results = json.load(f)
    assert len(results) == 80                      # 40 cells x 2 meshes
    assert sum(r["status"] == "failed" for r in results) == 0
    assert sum(r["status"] == "skipped" for r in results) == 16
    ok = [r for r in results if r["status"] == "ok"]
    assert len(ok) == 64
    rows = roofline.build_table(results)
    for r in rows:
        if r.get("status") == "ok":
            assert r["step_time_bound_s"] > 0
            assert 0 <= r["roofline_fraction"] <= 1.5
