"""The port's AdamW (`repro_torch/train/optimizer.py`) against the JAX
package's on the same numpy inputs, on the CPU.

Held:
  * `lr_at` over steps 0-300 of four schedules, bit for bit in fp32
    against the reference run op by op (under `jit` XLA rewrites the
    divisions and fuses multiply-adds: held there to 4 ULP of the peak
    rate), and the bias corrections `1 - b ** step` bit for bit against
    the jitted reference;
  * `adamw_update` on identical params and grads, with and without
    `keep_master` and with bf16 params, over three steps: params, m, v
    and masters within 1e-6 relative of the jitted reference (XLA fuses
    multiply-adds; a bf16 param is held to one bf16 rounding);
  * clipping and `global_norm` (summed leaf by leaf in another order than
    the reference's sorted, group-stacked leaves: 1e-6 relative);
  * `_decay_mask` over every parameter name of all ten configs against
    the reference's mask on its tree paths.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

SCHEDULES = (
    dict(),
    dict(lr_peak=5e-3, warmup_steps=5, total_steps=40),
    dict(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10, total_steps=100),
    dict(lr_peak=3e-3, warmup_steps=30, total_steps=300),
)
UPDATE_REL = 1e-6


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: str(kw or "default"))
def test_lr_at_matches_reference(kw):
    jc, tc = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jit_lr = jax.jit(lambda s: jopt.lr_at(jc, s))
    for s in range(301):
        got = opt.lr_at(tc, s)
        assert got.dtype == torch.float32
        want = np.float32(jopt.lr_at(jc, s))
        assert np.float32(got.item()) == want, (s, got.item(), want)
        jit = float(np.float32(jit_lr(s)))
        assert abs(got.item() - jit) <= 4 * 2.0 ** -23 * jc.lr_peak, s


def test_bias_corrections_match_reference():
    f = jax.jit(lambda b, s: 1.0 - b ** s.astype(jnp.float32),
                static_argnums=0)
    for b in (0.9, 0.95, 0.999):
        for s in range(1, 2001):
            got = np.float32(float(1.0 - opt._f32(b) ** opt._f32(s)))
            assert got == np.float32(f(b, jnp.int32(s))), (b, s)


def _tree(rs):
    """A params-like tree with decayed and undecayed leaves."""
    def f(*shape):
        return rs.standard_normal(shape).astype(np.float32)
    return {"embed": f(16, 8), "final_norm": f(8),
            "stack": {"ln1": f(8), "attn": {"wq": f(8, 2, 4), "A_log": f(4),
                                           "conv": {"w": f(4, 8), "b": f(8)}},
                      "mlp": {"b_up": f(12), "w_up": f(8, 12)}}}


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_named(v, name))
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("mode", ["fp32", "keep_master", "bf16_master"])
def test_adamw_update_matches_reference(mode):
    rs = np.random.RandomState(0)
    params = _tree(rs)
    grads = [_tree(rs) for _ in range(3)]
    grads[1] = jax.tree.map(lambda g: 40.0 * g, grads[1])   # clipped
    cfg = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10)
    jc, tc = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    bf16 = mode == "bf16_master"
    keep = mode != "fp32"
    jp = jax.tree.map(jnp.asarray, params)
    if bf16:
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in _named(params).items()}
    if bf16:
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    js = jopt.adamw_init(jp, keep_master=keep)
    ts = opt.adamw_init(tp, keep_master=keep)
    upd = jax.jit(lambda g, s, p: jopt.adamw_update(jc, g, s, p))
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        if bf16:
            jg = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jg)
        jp, js, jm = upd(jg, js, jp)
        tg = {k: torch.from_numpy(np.array(v)) for k, v in _named(g).items()}
        if bf16:
            tg = {k: v.to(torch.bfloat16) for k, v in tg.items()}
        tp, ts, tm = opt.adamw_update(tc, tg, ts, tp)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= UPDATE_REL
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 4 * 2.0 ** -23 \
            * jc.lr_peak
        assert ts.step == int(js.step)
        jn = {k: np.asarray(jnp.asarray(v, jnp.float32))
              for k, v in _named(jp).items()}
        for k, t in tp.items():
            assert t.dtype == (torch.bfloat16 if bf16 else torch.float32)
            got = t.float().numpy()
            if bf16:   # the same fp32 master up to one bf16 rounding
                assert np.abs(got - jn[k]).max() <= 2.0 ** -8 * np.abs(
                    jn[k]).max(), k
            else:
                assert _rel(got, jn[k]) <= UPDATE_REL, k
        for field in ("m", "v") + (("master",) if keep else ()):
            want = _named(jax.tree.map(np.asarray, getattr(js, field)))
            for k, t in getattr(ts, field).items():
                assert t.dtype == torch.float32
                assert _rel(t.numpy(), want[k]) <= UPDATE_REL, (field, k)


def test_adamw_decreases_quadratic():
    cfg = opt.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.adamw_init(params)
    for _ in range(100):
        params, state, _ = opt.adamw_update(cfg, {"w": 2 * params["w"]},
                                            state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_lr_schedule_shape():
    cfg = opt.AdamWConfig(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10,
                          total_steps=100)
    lrs = [float(opt.lr_at(cfg, s)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-5, rel=1e-2)


def test_grad_clipping_and_global_norm():
    cfg = opt.AdamWConfig(clip_norm=1.0, lr_peak=1.0, warmup_steps=0,
                          total_steps=1, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = opt.adamw_init(params)
    p2, _, m = opt.adamw_update(cfg, {"w": torch.full((4,), 100.0)}, state,
                                params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    # a clipped step moves each element by lr: m^/sqrt(v^) is 1
    np.testing.assert_allclose(p2["w"].numpy(), -float(m["lr"]), rtol=1e-6)
    # global_norm over a model's worth of leaves, against the reference's
    jc = jconfigs.get_smoke_config("deepseek-v2-lite-16b", dtype="float32")
    tree = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(3), jc))
    want = float(jax.jit(jopt.global_norm)(tree))
    got = opt.global_norm({k: torch.from_numpy(np.array(v)) for k, v in
                           convert.named_from_tree(tree, jc).items()})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_decay_mask_matches_reference(arch):
    jc = jconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: jlm.lm_init(k, jc),
                            jax.random.PRNGKey(0))
    mask = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, jopt._decay_mask(path)), shapes)
    want = convert.named_from_tree(mask, jc)
    tc = configs.get_smoke_config(arch)
    names = [n for n, _ in lm.lm_init(tc, torch.Generator(),
                                      device="cpu").named_parameters()]
    assert sorted(names) == sorted(want)
    decayed = set()
    for name in names:
        ref = want[name]
        assert ref.all() or not ref.any(), name
        assert opt._decay_mask(name) == bool(ref.all()), name
        if ref.all():
            decayed.add(name.rsplit(".", 1)[-1])
    assert decayed and not decayed & {"ln1", "ln2", "final_norm", "norm"}


def test_state_layout():
    cfg = configs.get_smoke_config("mamba2-780m")
    p = lm.lm_init(cfg, torch.Generator(), device="cpu")
    s = opt.adamw_init(p, keep_master=True)
    names = [n for n, _ in p.named_parameters()]
    assert s.step == 0 and list(s.m) == names == list(s.v) == list(s.master)
    assert all(t.dtype == torch.float32 and not t.any() for t in s.m.values())
    assert dataclasses.asdict(opt.AdamWConfig()) == dataclasses.asdict(
        jopt.AdamWConfig())
