"""`BENCHMARK.json` and the files it names, the benchmark's isolation
from the JAX package, and the decision kernel's byte count."""
import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from dasbench import harness, roofline

from dasbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "dasbench/run.py"]
    assert BENCH["paths"] == ["dasbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["file"].startswith("dasbench/")
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        if cfg.get("kind", "dssoc") == "dssoc":
            assert cfg["time_dtype"] == "float32"
        else:
            assert cfg["kind"] == "lm" and cfg["source"] == c["source"]
            assert (ROOT / "dasbench" / "reference"
                    / f"{cfg['reference']}.py").is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "dasbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        assert (ROOT / "dasbench" / "limits" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {c["config"] for c in BENCH["workloads"]} == names
    metric_names = []
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.append(m["name"])
    assert "setup_s" in metric_names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        metric_names.append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "dasbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len(metric_names) == len(set(metric_names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    spec = harness.resolve_cell(ROOT, name)
    assert spec["end_to_end"] and spec["per_layer"] and spec["limits"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("traffic", sorted(
    p.name for p in (ROOT / "dasbench" / "traffic").glob("*.json")))
def test_a_policy_is_written_in_float32(traffic):
    """A traffic's DAS policy: each threshold is written as the float32
    value the port compares with."""
    import numpy as np

    t = json.loads((ROOT / "dasbench" / "traffic" / traffic).read_text())
    for mode, p in t.get("policy", {}).items():
        assert mode == "DAS" and mode in t["modes"]
        for v in p["thr"]:
            assert v is None or float(np.float32(v)) == v, v


def test_the_reference_charges_the_ports_classifier_energy():
    """The reference's classifier energy a DAS decision is the port's
    constant, as float32."""
    import numpy as np
    from dasbench.reference import ref_sim
    from repro_torch.core import soc

    assert np.float32(ref_sim.CLS_ENERGY_UJ) == soc.DAS_CLS_ENERGY_UJ


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_run_imports_jax_or_the_jax_package():
    """By whole top-level names: `repro_torch` is the port, `repro` the
    JAX package."""
    files = [p for p in (ROOT / "dasbench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def lm_references(root):
    """The reference modules that the LM configurations of `root`'s
    `BENCHMARK.json` name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfgs = [json.loads((root / c["file"]).read_text())
            for c in bench["configs"]]
    return {c["reference"] for c in cfgs if c.get("kind") == "lm"}


def reference_imports_are_plain(root):
    """Every module under `root`'s `dasbench/reference/` imports only what
    its lane allows: an LM configuration's reference plain torch, every
    other module (the DSSoC reference) numpy alone."""
    lm = lm_references(root)
    assert lm
    for p in (root / "dasbench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        allowed = {"__future__", "dataclasses", "typing", "numpy",
                   "dasbench"}
        if p.stem in lm:
            allowed = {"__future__", "math", "re", "typing", "torch"}
        assert tops <= allowed, (p, tops)


def test_the_reference_imports_nothing_of_the_program():
    """The DSSoC reference is numpy alone; the LM lane's is plain torch."""
    reference_imports_are_plain(ROOT)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import dasbench.reference.ref_sim, dasbench.reference.workloads\n"
            "import dasbench.check, dasbench.inputs, dasbench.roofline\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'torch'}\n"
            "assert not bad, bad\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_an_lm_reference_added_as_files_is_allowed_torch(tmp_path):
    """A later configuration that brings its own LM reference as new
    files (its module, its configuration naming it, an entry in
    `BENCHMARK.json`) passes the import rule with no existing file of
    `dasbench/` edited; a DSSoC module that imports torch still fails."""
    shutil.copytree(ROOT / "dasbench", tmp_path / "dasbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out",
                                                  ".cache"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "dasbench").rglob("*") if p.is_file()}
    d = tmp_path / "dasbench"
    (d / "reference" / "moonlight_ref.py").write_text(
        (d / "reference" / "lm_ref.py").read_text())
    cfg = json.loads((d / "configs" / "deepseek-v2-lite-shaped.json")
                     .read_text())
    cfg.update(name="moonlight-16b-a3b", reference="moonlight_ref")
    (d / "configs" / "moonlight-16b-a3b.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "moonlight-16b-a3b", "source": cfg["source"],
        "file": "dasbench/configs/moonlight-16b-a3b.json", "reduced": [],
        "why": "a second LM configuration with a reference of its own"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert lm_references(tmp_path) == {"lm_ref", "moonlight_ref"}
    reference_imports_are_plain(tmp_path)
    assert all((tmp_path / p).read_bytes() == b for p, b in before.items())
    (d / "reference" / "stray.py").write_text("import torch\n")
    with pytest.raises(AssertionError, match="stray"):
        reference_imports_are_plain(tmp_path)


def test_a_run_loads_no_jax(small_batch):
    """A whole CPU run of a cell in a fresh process leaves no forbidden
    module loaded."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from dasbench import harness\n"
        "spec = harness.resolve_cell(harness.ROOT, 'healthy.etf-grid')\n"
        "spec['config'] = dict(spec['config'], frames=4, n_mixes=1)\n"
        "harness.run(spec, 3, 0.1, False, 'cpu', time.perf_counter(),"
        " log=lambda *a: None)\n"
        "assert harness.loaded_forbidden() == [], harness.loaded_forbidden()\n"
        "assert 'repro_torch' in sys.modules\n" % (str(ROOT),
                                                   str(ROOT / "src")))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.loaded_forbidden()


def test_search_bound_reproduces_the_kernel_table():
    """PERF.md's kernel table: `etf_search_fixed<16, 19>` at the main
    path's 560 lanes, bound 0.425 us by bytes."""
    assert roofline.etf_search_bytes(560, 16, 19) == 1_422_960
    assert round(roofline.etf_search_bound_us(560, 16, 19), 3) == 0.425
    assert roofline.etf_search_bound_us(560, 16, 19) > \
        roofline.etf_search_ops(560, 16, 19) / roofline.F32_OPS_PER_S * 1e6
    assert roofline.etf_search_bytes(560, 16, 19, alive=True) == \
        1_422_960 + 560 * 19


def test_trace_reduction_unions_intervals_and_names_gaps():
    from dasbench import trace

    class E:
        def __init__(self, name, dev, t0, dur):
            self._n, self._d, self._t, self._u = name, dev, t0, dur

        def name(self):
            return self._n

        def device_type(self):
            return "DeviceType." + self._d

        def start_ns(self):
            return self._t

        def duration_ns(self):
            return self._u

        def is_user_annotation(self):
            return False

    class R:
        def __init__(self, extra=()):
            self.extra = list(extra)

        def events(self):
            return [E("cudaLaunchKernel", "CPU", 250, 10),
                    E("k1", "CUDA", 300, 100), E("k2", "CUDA", 350, 100),
                    E("Memcpy DtoH", "CUDA", 600, 50),
                    E("k1", "CUDA", 900, 50)] + self.extra

    spans = [("draw", 0, 200), ("run_campaign", 200, 800),
             ("slice", 0, 1000)]
    s = trace.reduce(R(), spans)
    assert s["window_s"] == pytest.approx(1e-6)
    # busy: 300-450, 600-650 and 900-950; host records are not the device's
    assert s["busy_s"] == pytest.approx(250e-9)
    assert s["kernel_busy_s"] == pytest.approx(200e-9)
    assert s["n_kernels"] == 3
    assert s["by_name"]["k1"][0] == 2
    gaps = dict((round(g * 1e9), w) for w, g in s["gaps"])
    assert gaps[300] == "run_campaign" or gaps[300] == "draw"
    assert gaps[150] == "run_campaign" and gaps[50] == "slice"
    # device records far outside the host span: the clocks disagree
    late = trace.CLOCK_SLACK_NS + 2000
    with pytest.raises(RuntimeError, match="clock"):
        trace.reduce(R([E("k1", "CUDA", late, 10)]), spans)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] in ("k1", "k2") and len(b["idle_gaps"]) == 4
