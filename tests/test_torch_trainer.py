"""The port's trainer, data pipeline and gradient compression
(`repro_torch/train/trainer.py`, `data/pipeline.py`,
`parallel/compression.py`) on the CPU: the reference's cases of
tests/test_train_stack.py, and against the JAX package on the same
inputs:

  * `SyntheticLM` batches equal to the reference's, array for array;
    `TokenFileDataset` too, resumed by `set_step`;
  * int8 requantisation bit-equal to JAX's `fake_requantize` run op by
    op (under `jit` XLA may turn the division by 127 into a product with
    its reciprocal, one ULP off in some fusions), on plain trees and on
    a model's gradients, where one scale serves each pattern slot's
    layers as the reference's stacked leaf does;
  * a 10-step loss curve in fp32 against the JAX `Trainer` on the same
    data from the same weights (the JAX mesh built with Auto axes, as
    jax 0.9's Explicit default fails in the reference's own sharding
    constraint): 1e-5 relative a step;
  * the launcher, the example and `bench/lm_train` at a small size, and
    the replay check of `bench/lm_train` against a restore that loses
    AdamW's moments or its step count.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bench import lm_train  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher, SyntheticLM,  # noqa: E402
                                       TokenFileDataset)
from repro_torch.examples import train_tiny_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402
from repro_torch.train import optimizer as optim  # noqa: E402
from repro_torch.train import trainer as tr  # noqa: E402

CURVE_REL = 1e-5
# chip_smoke.py's phase 13 holds the replayed steps' losses to the first
# run's at this relative limit (bit-equal in every reading on the card)
REPLAY_REL = 1e-6


def _phi3():
    return configs.get_smoke_config("phi3-mini-3.8b", n_layers=2,
                                    d_model=64, vocab=128)


def test_trainer_failure_recovery(tmp_path):
    tc = tr.TrainerConfig(total_steps=40, ckpt_every=10,
                          ckpt_dir=str(tmp_path), log_every=100)
    oc = optim.AdamWConfig(lr_peak=5e-3, warmup_steps=5, total_steps=40)
    data = SyntheticLM(vocab=128, batch=4, seq_len=32)
    t = tr.Trainer(tc, _phi3(), oc, data, device="cpu")
    t.inject_failure_at = 25
    out = t.fit()
    assert out["restarts"] == 1
    assert out["step"] == 40
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0]
    # the replayed steps ran from the restored state on the same batches
    assert [m["step"] for m in out["metrics"]][20:26] == [21, 22, 23, 24,
                                                          25, 21]
    assert losses[25:30] == losses[20:25]
    assert t.restores[0]["step"] == 20


def test_trainer_resume_from_checkpoint(tmp_path):
    cfg = _phi3()
    oc = optim.AdamWConfig(lr_peak=5e-3, warmup_steps=5, total_steps=30)
    tc1 = tr.TrainerConfig(total_steps=20, ckpt_every=10,
                           ckpt_dir=str(tmp_path), log_every=100)
    tr.Trainer(tc1, cfg, oc, SyntheticLM(vocab=128, batch=4, seq_len=32),
               device="cpu").fit()
    tc2 = tr.TrainerConfig(total_steps=30, ckpt_every=10,
                           ckpt_dir=str(tmp_path), log_every=100)
    out = tr.Trainer(tc2, cfg, oc, SyntheticLM(vocab=128, batch=4,
                                               seq_len=32),
                     device="cpu").fit(resume=True)
    assert out["step"] == 30
    # resumed run performed only 10 new steps
    assert len(out["metrics"]) == 10


def test_trainer_gives_up_after_max_restarts(tmp_path):
    class Failing(tr.Trainer):
        def _compile(self):
            def step(*a):
                raise torch.OutOfMemoryError("out of memory")
            return step

    tc = tr.TrainerConfig(total_steps=4, ckpt_every=2,
                          ckpt_dir=str(tmp_path), max_restarts=2)
    t = Failing(tc, _phi3(), optim.AdamWConfig(),
                SyntheticLM(vocab=128, batch=2, seq_len=8), device="cpu")
    with pytest.raises(torch.OutOfMemoryError):
        t.fit()


def test_das_gate_fast_slow():
    calls = []
    g = tr.DASGate(rate_thr=0.5, inflation_thr=2.0,
                   replan=lambda: calls.append(1))
    assert g.decide(0.1, 3.0) == "fast"
    assert g.decide(0.9, 1.0) == "fast"
    assert g.decide(0.9, 3.0) == "slow"
    assert len(calls) == 1
    assert (g.decisions, g.slow_calls) == (3, 1)


@pytest.mark.parametrize("kw", [dict(vocab=64, batch=2, seq_len=16, seed=3),
                                dict(vocab=50280, batch=3, seq_len=40),
                                dict(vocab=128, batch=2, seq_len=8,
                                     n_codebooks=4, noise=0.3)],
                         ids=["small", "mamba_vocab", "codebooks"])
def test_synthetic_data_equals_reference(kw):
    mine, ref = SyntheticLM(**kw), jpipe.SyntheticLM(**kw)
    for step in (0, 1, 7):
        mine.set_step(step)
        ref.set_step(step)
        for _ in range(2):
            a, b = next(mine), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["tokens"][..., 1:], a["labels"][..., :-1])


def test_token_file_dataset(tmp_path):
    toks = np.arange(1000, dtype=np.int32)
    paths = []
    for i, part in enumerate((toks[:600], toks[600:])):
        p = tmp_path / f"shard{i}.bin"
        part.tofile(str(p))
        paths.append(str(p))
    ds = TokenFileDataset(paths, batch=2, seq_len=9, seed=5)
    ref = jpipe.TokenFileDataset(paths, batch=2, seq_len=9, seed=5)
    b = next(ds)
    assert b["tokens"].shape == (2, 9)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    np.testing.assert_array_equal(b["tokens"], next(ref)["tokens"])
    ds.set_step(40)
    ref.set_step(40)
    for _ in range(3):
        np.testing.assert_array_equal(next(ds)["labels"],
                                      next(ref)["labels"])


def test_prefetcher_delivers_in_order():
    src = iter([{"x": np.array([i])} for i in range(5)])
    pf = Prefetcher(src, depth=2)
    got = [int(b["x"][0]) for b in pf]
    assert got == list(range(5))
    pf = Prefetcher(SyntheticLM(vocab=64, batch=2, seq_len=8, seed=1))
    want = SyntheticLM(vocab=64, batch=2, seq_len=8, seed=1)
    for _ in range(4):
        np.testing.assert_array_equal(next(pf)["tokens"],
                                      next(want)["tokens"])
    pf.close()


def test_int8_compression_bit_equal_to_reference():
    rs = np.random.RandomState(0)
    tree = {"lin": np.linspace(-3, 3, 1000).astype(np.float32),
            "normal": rs.standard_normal((300, 70)).astype(np.float32),
            "cauchy": rs.standard_cauchy((64, 33)).astype(np.float32),
            "zeros": np.zeros(17, np.float32)}
    want = jcomp.fake_requantize(jax.tree.map(jnp.asarray, tree))
    got = compression.fake_requantize({k: torch.from_numpy(v)
                                       for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    err = float((got["lin"] - torch.from_numpy(tree["lin"])).abs().max())
    assert err <= 3 / 127.0 + 1e-6
    g16 = torch.from_numpy(tree["normal"]).to(torch.bfloat16)
    w16 = jcomp.fake_requantize({"g": jnp.asarray(tree["normal"]).astype(
        jnp.bfloat16)})["g"]
    got16 = compression.fake_requantize({"g": g16})["g"]
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(w16.astype(jnp.float32)))
    q, s = compression.quantize_tree({"normal": torch.from_numpy(
        tree["normal"])})["normal"]
    jq, js = jcomp.quantize_tree({"n": jnp.asarray(tree["normal"])})["n"]
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_int8_scale_per_stacked_leaf():
    """A model's gradients: the reference stacks each slot's layers in one
    leaf, whose one scale the port's layers of that slot share."""
    jc = jconfigs.get_smoke_config("recurrentgemma-9b", n_layers=7)
    tree = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(1), jc))
    tree = jax.tree.map(lambda a: a * np.float32(1.7) - np.float32(0.3),
                        tree)
    want = convert.named_from_tree(
        jax.tree.map(np.asarray, jcomp.fake_requantize(
            jax.tree.map(jnp.asarray, tree))), jc)
    got = compression.fake_requantize(
        {k: torch.from_numpy(np.array(v)) for k, v in
         convert.named_from_tree(tree, jc).items()})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert convert.reference_leaf("stack.groups.2.1.attn.w_x") \
        == "stack.groups.2.attn.w_x"
    assert convert.reference_leaf("stack.prologue.0.ln1") \
        == "stack.prologue.0.ln1"


def test_loss_curve_matches_jax_trainer(tmp_path):
    """10 steps of the fp32 smoke model in both trainers from the same
    weights on the same batches, per-step losses within CURVE_REL."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jc = jconfigs.get_smoke_config("phi3-mini-3.8b", n_layers=2,
                                   d_model=64, vocab=128, dtype="float32")
    tc = dataclasses.replace(_phi3(), dtype="float32")
    oc = dict(lr_peak=5e-3, warmup_steps=5, total_steps=10)
    jt = jtr.Trainer(jtr.TrainerConfig(total_steps=10, ckpt_every=5,
                                       ckpt_dir=str(tmp_path / "jax"),
                                       log_every=100),
                     jc, jopt.AdamWConfig(**oc), mesh,
                     jpipe.SyntheticLM(vocab=128, batch=4, seq_len=32))
    want = [m["loss"] for m in jt.fit()["metrics"]]
    start = jax.tree.map(np.asarray, jt.init_state()[0])

    class FromJax(tr.Trainer):
        def init_state(self):
            p = convert.lm_params_from_numpy(start, tc, "cpu")
            p.requires_grad_(True)
            return p, optim.adamw_init(p)

    t = FromJax(tr.TrainerConfig(total_steps=10, ckpt_every=5,
                                 ckpt_dir=str(tmp_path / "port"),
                                 log_every=100),
                tc, optim.AdamWConfig(**oc),
                SyntheticLM(vocab=128, batch=4, seq_len=32), device="cpu")
    got = [m["loss"] for m in t.fit()["metrics"]]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=CURVE_REL)
    assert got[-1] < got[0]


def test_launcher_trains_and_refuses_a_mesh(tmp_path):
    out = launch_train.main(["--arch", "mamba2-780m", "--smoke", "--steps",
                             "4", "--batch", "2", "--seq", "32",
                             "--ckpt-every", "2", "--ckpt-dir",
                             str(tmp_path), "--inject-failure-at", "3",
                             "--device", "cpu"])
    assert out["step"] == 4 and out["restarts"] == 1
    assert ckpt.latest_step(str(tmp_path)) == 4
    # a mesh larger than the process group is clamped to it, as the
    # reference clamps to its devices (a group of one here: 1 x 1)
    for flag in ("--data-parallel", "--model-parallel"):
        out = launch_train.main(["--arch", "yi-34b", "--smoke", flag, "2",
                                 "--steps", "1", "--seq", "16",
                                 "--ckpt-dir", str(tmp_path / flag),
                                 "--device", "cpu"])
        assert out["step"] == 1


def test_example_and_train_bench(tmp_path):
    out = train_tiny_lm.main(["--arch", "recurrentgemma-9b", "--steps", "10",
                              "--fail-at", "6", "--compress", "--fresh",
                              "--ckpt-dir", str(tmp_path / "ex"),
                              "--device", "cpu"])
    assert out["step"] == 10 and out["restarts"] == 1
    cfg = configs.get_smoke_config("mamba2-780m", n_layers=2)
    res = lm_train.run("cpu", cfg=cfg, batch=2, seq=32, steps=6,
                       ckpt_every=3, fail_at=5,
                       ckpt_dir=str(tmp_path / "bench"))
    assert res["restarts"] == 1 and res["final_step"] == 6
    assert [s for s, _, _ in res["replayed"]] == [4, 5]
    assert all(a == b for _, a, b in res["replayed"])   # CPU: exact
    assert res["heldout_rel"] <= 3e-2                  # bf16 compute
    # the plain scan's logits no farther from the training route's than
    # the bf16 compute is from fp32
    assert 0 < res["heldout_logits_rel"] <= res["heldout_logits_rel_fp32"]
    assert res["failure_cost_s"] > res["restores"][0]["seconds"] > 0
    assert 0 < res["goodput_tok_per_s"] < res["tok_per_s_window"]
    assert [s["step"] for s in res["saves"]] == [3, 6, 6]   # + the last
    assert all(s["bytes"] > 0 for s in res["saves"])
    assert not (tmp_path / "bench").exists()


def _faulty_restore(fault):
    real = tr.Trainer._restore

    def restore(self, like):
        (params, st), step, meta = real(self, like)
        if fault == "moments zeroed":
            for t in (*st.m.values(), *st.v.values()):
                t.zero_()
        elif fault == "step count reset":
            st = st._replace(step=0)
        return (params, st), step, meta
    return restore


@pytest.mark.parametrize("fault", [None, "moments zeroed",
                                   "step count reset"])
def test_replay_check_rejects_a_faulty_restore(tmp_path, monkeypatch, fault):
    """A restore that loses AdamW's moments or its step count moves the
    replayed losses past the limit that phase 13 holds them to (moments
    zeroed: 2.9e-4, under the 1e-3 this limit replaced); the sound restore
    replays them bit for bit."""
    monkeypatch.setattr(tr.Trainer, "_restore", _faulty_restore(fault))
    cfg = configs.get_smoke_config("mamba2-780m", n_layers=2)
    res = lm_train.run("cpu", cfg=cfg, batch=2, seq=32, steps=8,
                       ckpt_every=4, fail_at=7, ckpt_dir=str(tmp_path))
    assert res["restarts"] == 1
    assert [s for s, _, _ in res["replayed"]] == [5, 6, 7]
    rel = max(abs(b - a) / abs(a) for _, a, b in res["replayed"])
    if fault is None:
        assert rel == 0.0
    else:
        assert rel > REPLAY_REL
