"""The sharded steps of the port over gloo process groups on the CPU.

Each case starts 2 or 4 processes of `tests/torch_dist_ranks.py` (each
with a time limit of its own) and holds what rank 0 wrote against the
single-device steps on the same inputs: the sharded train step on a
2 x 2 mesh (3 steps of smoke Phi-3, DeepSeek-V2-Lite with MoE and MLA,
and Mamba-2; one step each of microbatch, int8 and cast_params), the
sharded prefill and decode, a checkpoint written on 2 x 2 and restored
onto 4 x 1 (the elastic re-mesh), `compressed_psum` against a numpy
restatement of the reference's and, on one rank, against JAX's under
`shard_map`, and `launch/train.py` under a 2-rank group and a group of
one, whose checkpoint is the single-device trainer's byte for byte.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n: int, argv, cwd=None):
    """Start `argv` in n processes of one group (torchrun's variables)."""
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC), str(HERE),
                                           os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, *argv], cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(n)]


def _finish(procs, timeout: float):
    """Wait for each process, killed after `timeout` seconds; every one
    must exit 0. Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def _spawn(n: int, argv, timeout: float, cwd=None):
    return _finish(_start(n, argv, cwd), timeout)


# the cases each group runs, one group a world size
GROUPS = {4: "train,serve,remesh", 2: "psum"}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups started at once, running while the tests compute the
    single-device sides: {n: [processes, out dir, finished]}."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    running = {n: [_start(n, [str(HERE / "torch_dist_ranks.py"), cases,
                              tmp]), tmp, False]
               for n, cases in GROUPS.items()}
    yield running
    for procs, _, _ in running.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _case(case: str, n: int, groups):
    group = groups[n]
    if not group[2]:
        group[2] = True
        _finish(group[0], timeout=300)
    return torch.load(os.path.join(group[1], f"{case}.pt"),
                      weights_only=False)


def _single_train(cfg, data, **kw):
    step = ts.make_train_step(cfg, ranks.OPT, **kw)
    params = ranks.init(cfg).requires_grad_(True)
    return ranks.train(step, params, opt.adamw_init(params), data)


def _close(got, want, tol=TOL):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale <= tol


def _hold(got, want):
    """Losses within TOL relative, parameters (all of magnitude below 1)
    within TOL absolute."""
    (gl, gp), (wl, wp) = got, want
    np.testing.assert_allclose(gl, wl, rtol=TOL)
    assert gp.keys() == wp.keys()
    bad = {k: float((gp[k] - wp[k]).abs().max()) for k in wp
           if float((gp[k] - wp[k]).abs().max()) > TOL}
    assert not bad, bad


@pytest.mark.parametrize("arch", ranks.TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(arch, groups):
    """3 steps on a 2 x 2 mesh (FSDP on "data", TP/EP on "model", remat
    and AdamW over DTensors) against the single-device step."""
    cfg = ranks.smoke(arch)
    want = _single_train(cfg, ranks.batches(cfg, ranks.STEPS))
    got = _case("train", 4, groups)[arch]
    _hold(got, want)
    assert len(got[0]) == ranks.STEPS


def _hold_rounded(got, want, lr):
    """The hold of `tests/test_torch_train_step.py` for steps whose
    gradients are rounded (int8 quanta, bf16 copies), where one rounding
    that falls the other way moves an element's update: losses within
    TOL, every parameter within 2 lr, all but 0.5% of them within 1% of
    lr + 1e-6 of the leaf's max."""
    (gl, gp), (wl, wp) = got, want
    np.testing.assert_allclose(gl, wl, rtol=TOL)
    moved = n = 0
    for k in wp:
        d = (gp[k] - wp[k]).abs()
        near = 1e-6 * float(wp[k].abs().max())
        assert float(d.max()) <= 2 * lr + near, k
        moved += int((d > 1e-2 * lr + near).sum())
        n += d.numel()
    assert moved <= 5e-3 * n, (moved, n)


@pytest.mark.parametrize("knob", sorted(ranks.KNOBS))
def test_sharded_train_step_knobs(knob, groups):
    """One step with each knob on 2 x 2; microbatch slices of the global
    batch are held as the plain steps, int8 and bf16 ones as rounded."""
    cfg = ranks.smoke(ranks.TRAIN_ARCHS[0])
    want = _single_train(cfg, ranks.batches(cfg, 1), **ranks.KNOBS[knob])
    got = _case("train", 4, groups)[knob]
    if knob == "microbatch":
        _hold(got, want)
    else:
        _hold_rounded(got, want, float(opt.lr_at(ranks.OPT, 1)))


@pytest.mark.parametrize("arch", ranks.SERVE_ARCHS)
def test_sharded_prefill_and_decode(arch, groups):
    """Prefill and decode on a 2 x 2 mesh (caches on `cache_spec`'s
    placements, the kernel wrappers' plain versions on local shards)."""
    import torch
    from repro_torch.models import lm
    cfg = ranks.smoke(arch)
    prefill = ts.make_serve_step(cfg, "prefill")
    decode = ts.make_serve_step(cfg, "decode")
    caches = lm.init_caches(cfg, 2, ranks.MAX_LEN, dtype=torch.float32,
                            device="cpu")
    want = ranks.serve(prefill, decode, ranks.init(cfg), caches,
                       ranks.prompts(cfg))
    got = _case("serve", 4, groups)[arch]
    assert got.shape == want.shape
    for i in range(len(want)):
        assert _close(got[i], want[i]), (arch, i)


def test_checkpoint_restores_onto_another_mesh(groups):
    """The elastic re-mesh: written from a 2 x 2 mesh, restored onto
    4 x 1, every parameter and moment bit for bit, on the new mesh."""
    out = _case("remesh", 4, groups)
    assert out["step"] == 2
    for saved, restored in zip(out["saved"], out["restored"]):
        assert saved.keys() == restored.keys()
        for k in saved:
            assert torch.equal(saved[k], restored[k]), k
    # the embedding [V, D] shards D over "data" (size 4): Shard(1) on the
    # mesh's first dim; "model" (size 1) replicates
    assert out["placements"][0] == "(Shard(dim=1), Replicate())"


def _q8(x):
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))
                       / np.float32(127.0))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def test_compressed_psum_two_ranks(groups):
    """`compressed_psum` on 2 ranks against a numpy restatement of
    `src/repro/parallel/compression.py:40-50`."""
    got = _case("psum", 2, groups)["sum"]
    xs = [ranks.psum_input(r).numpy() for r in range(2)]
    qs = [_q8(x) for x in xs]
    s_max = max(s for _, s in qs)
    total = sum(np.round(q.astype(np.float32) * (s / s_max)).astype(np.int32)
                for q, s in qs)
    want = total.astype(np.float32) * s_max
    np.testing.assert_array_equal(got.numpy(), want)
    exact = xs[0] + xs[1]
    assert np.abs(want - exact).max() <= 2 * s_max


def test_compressed_psum_one_rank_matches_jax(tmp_path):
    """On one rank, the port's group sum equals JAX's `compressed_psum`
    under `shard_map` on a 1-device mesh (as `tests/test_train_stack.py`
    runs it)."""
    import torch.distributed as dist
    from jax.sharding import PartitionSpec as P

    from repro.parallel import compression as jcomp
    from repro_torch.parallel import compression

    x = ranks.psum_input(0).numpy()
    mesh = jax.make_mesh((1,), ("data",))
    f = jax.shard_map(lambda v: jcomp.compressed_psum(v, "data"), mesh=mesh,
                      in_specs=P("data"), out_specs=P())
    want = np.asarray(f(jnp.asarray(x)))
    store = dist.FileStore(str(tmp_path / "store"), 1)
    group_was = dist.is_initialized()
    if not group_was:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = compression.compressed_psum(torch.from_numpy(x)).numpy()
    finally:
        if not group_was:
            dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)


def _launch(n, ckpt_dir, *extra):
    return _spawn(n, ["-m", "repro_torch.launch.train", "--arch",
                      "phi3-mini-3.8b", "--smoke", "--steps", "4",
                      "--batch", "4", "--seq", "16", "--ckpt-every", "2",
                      "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
                      *extra], timeout=240)


def test_launch_train_two_ranks(tmp_path):
    outs = _launch(2, tmp_path / "ck", "--data-parallel", "2")
    assert "mesh={'data': 2, 'model': 1} devices=2" in outs[0]
    assert "done at step 4" in outs[0] and "done at step 4" in outs[1]
    assert sorted(os.listdir(tmp_path / "ck"))[-1] == "step_00000004"


def test_launch_train_one_rank_checkpoint_is_single_devices(tmp_path):
    """Without torchrun the launcher starts a group of one and trains on
    a 1 x 1 mesh: its checkpoint's arrays are, byte for byte, those the
    single-device trainer writes."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import trainer as tr

    env_keep = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK")
                if k in os.environ}
    try:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "phi3-mini-3.8b", "--smoke", "--steps", "4", "--batch", "4",
             "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
             "--ckpt-dir", str(tmp_path / "mesh")],
            env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=240)
    finally:
        os.environ.update(env_keep)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mesh={'data': 1, 'model': 1} devices=1" in out.stdout
    cfg = configs.get_smoke_config("phi3-mini-3.8b")
    t = tr.Trainer(
        tr.TrainerConfig(total_steps=4, ckpt_every=2,
                         ckpt_dir=str(tmp_path / "one")),
        cfg, opt.AdamWConfig(lr_peak=3e-3, warmup_steps=0, total_steps=4),
        SyntheticLM(vocab=cfg.vocab, batch=4, seq_len=16), device="cpu")
    t.fit(resume=False)
    for step in ("step_00000002", "step_00000004"):
        a = (tmp_path / "mesh" / step / "arrays.npz").read_bytes()
        b = (tmp_path / "one" / step / "arrays.npz").read_bytes()
        assert a == b, step
