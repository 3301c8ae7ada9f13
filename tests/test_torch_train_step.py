"""The port's training step (`repro_torch/train/train_step.py`) against
the JAX package's, on the CPU, on the same numpy-seeded inputs and the
reference's parameters perturbed leaf by leaf (0.05 x seeded noise) and
carried over (`models/convert.py`); the JAX side trains as it does, under
`use_pallas=False`, jitted. Compared in stages, since Adam amplifies
ULPs (step 1 moves an element by about lr x sign(g), so a gradient
element near 0 that differs by one rounding moves by 2 lr):

  1. `loss_and_grad` against `jax.value_and_grad(lm.loss_fn)` in fp32,
     leaf by leaf, on one smoke config per block family: per-leaf
     gradients within 1e-4 relative (to the leaf's max |value|), losses
     within 1e-5;
  2. the update on identical gradients (tests/test_torch_optimizer.py);
  3. whole steps: `microbatch=2`, int8 compression, `cast_params` and
     three plain AdamW steps, the losses within 1e-5, the gradient norm
     within 1e-4, and every parameter within 2 lr per step, all but 0.5%
     of them within 1% of the steps' learning rates (+ 1e-6 of the
     leaf's max): an update's direction is a ratio of gradients, which
     one rounding of an element near 0 moves. With `cast_params`
     the bf16 gradients are held to two bf16 roundings (2^-7 of the
     leaf's max): the two frameworks round bf16 sums differently.

Also the reference's bf16-master step (tests/test_lm_details.py), the
three `remat` modes giving the same gradients, the kernel wrappers
refusing inputs that require grad, and the model reaching no kernel
while autograd records (on the CPU each `ops` call is counted).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as rg  # noqa: E402
from repro_torch.kernels.rg_lru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.models import modules as nn  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

FAMILIES = ("phi3-mini-3.8b", "mamba2-780m", "recurrentgemma-9b",
            "deepseek-v2-lite-16b", "musicgen-medium", "paligemma-3b")
GRAD_REL = 1e-4
LOSS_ABS = 1e-5
PARAM_REL = 1e-6
MOVED_REL = 1e-2          # of the steps' learning rates
MAX_MOVED = 5e-3          # share of elements an Adam step may move apart
B, S = 2, 32
OCFG = dict(lr_peak=5e-3, warmup_steps=1, total_steps=10)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jc = jconfigs.get_smoke_config(arch, dtype="float32")
    jp = jax.jit(lambda k: jlm.lm_init(k, jc))(jax.random.PRNGKey(0))
    leaves, tree = jax.tree.flatten(jp)
    rs = np.random.RandomState(1)
    leaves = [np.asarray(a) + 0.05 * rs.standard_normal(a.shape)
              .astype(np.float32) for a in leaves]
    return jax.tree.unflatten(tree, [jnp.asarray(a) for a in leaves])


def _port(arch, cfg):
    jp = _jax_params(arch)
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        "cpu").requires_grad_(True)


def _batch(cfg, seed=2, b=B):
    rs = np.random.RandomState(seed)
    K = cfg.n_codebooks
    toks = rs.randint(0, cfg.vocab, (b, K, S) if K > 1 else (b, S)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = (0.02 * rs.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model))).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaf_rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grad_matches_jax(arch):
    jc = jconfigs.get_smoke_config(arch, dtype="float32")
    tc = configs.get_smoke_config(arch, dtype="float32")
    batch = _batch(tc)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jc, _jb(batch)), has_aux=True))(
            _jax_params(arch))
    (tl, tm), tg = ts.loss_and_grad(tc, _port(arch, tc),
                                    ts.to_device(batch, "cpu"))
    assert abs(float(tl) - float(jl)) <= LOSS_ABS
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= LOSS_ABS
    want = convert.named_from_tree(jax.tree.map(np.asarray, jg), tc)
    assert set(tg) == set(want)
    for k, g in tg.items():
        assert g.dtype == torch.float32
        assert _leaf_rel(g.numpy(), want[k]) <= GRAD_REL, k
    if tc.mlp_type == "moe":   # the aux loss reaches the router
        assert any("router" in k and float(g.abs().max()) > 0
                   for k, g in tg.items())


def _hold_params(tp, jp, cfg, lr_sum):
    """The port's parameters against the reference's after some steps,
    whose learning rates sum to lr_sum: every element within 2 lr_sum
    (a step moves an element by about lr x m^/sqrt(v^)), and all but
    MAX_MOVED of them within MOVED_REL x lr_sum + PARAM_REL of the
    leaf's max (an update's direction is a ratio of gradients, which
    the rounding of a small gradient element moves)."""
    want = convert.named_from_tree(jax.tree.map(np.asarray, jp), cfg)
    moved = n = 0
    for k, t in tp.named_parameters():
        d = np.abs(t.detach().float().numpy() - want[k])
        near = PARAM_REL * np.abs(want[k]).max()
        moved += int((d > MOVED_REL * lr_sum + near).sum())
        n += d.size
        assert d.max() <= 2 * lr_sum + near, k
    assert moved <= MAX_MOVED * n, (moved, n)


def _steps(kw, n_steps, arch="phi3-mini-3.8b"):
    jc = jconfigs.get_smoke_config(arch, dtype="float32")
    tc = configs.get_smoke_config(arch, dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jstep = jax.jit(jts.make_train_step(jc, jopt.AdamWConfig(**OCFG), mesh,
                                        **kw)[0])
    tstep = ts.make_train_step(tc, opt.AdamWConfig(**OCFG), **kw)
    jp = _jax_params(arch)
    js = jopt.adamw_init(jp)
    tp = _port(arch, tc)
    tstate = opt.adamw_init(tp)
    lr_sum = 0.0
    for i in range(n_steps):
        batch = _batch(tc, seed=10 + i, b=4)
        jp, js, jm = jstep(jp, js, _jb(batch))
        tp, tstate, tm = tstep(tp, tstate, ts.to_device(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ABS, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= GRAD_REL * float(jm["grad_norm"]), i
        lr_sum += float(tm["lr"])
        _hold_params(tp, jp, tc, lr_sum)
        assert tstate.step == int(js.step) == i + 1
    return tp, tstate


def test_three_adamw_steps_match_jax():
    tp, state = _steps({}, 3)
    assert all(t.dtype == torch.float32 for t in tp.parameters())
    assert all(float(m.abs().max()) > 0 for m in state.m.values())


@pytest.mark.parametrize("kw", [dict(microbatch=2),
                                dict(grad_compression="int8")],
                         ids=lambda kw: next(iter(kw)))
def test_train_step_variants_match_jax(kw):
    _steps(kw, 2)


def test_cast_params_step_matches_jax():
    """cast_params="bfloat16": the gradients are the bf16 copies' (bf16,
    within two bf16 roundings of the reference's), the optimizer updates
    the fp32 parameters."""
    arch = "phi3-mini-3.8b"
    jc = jconfigs.get_smoke_config(arch, dtype="float32")
    tc = configs.get_smoke_config(arch, dtype="float32")
    batch = _batch(tc, b=4)
    j16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), _jax_params(arch))
    _, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jc, _jb(batch)), has_aux=True))(j16)
    t16 = nn.map_params(_port(arch, tc), lambda p: p.to(torch.bfloat16))
    _, tg = ts.loss_and_grad(tc, t16.requires_grad_(True),
                             ts.to_device(batch, "cpu"))
    want = convert.named_from_tree(
        jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)), jg), tc)
    for k, g in tg.items():
        assert g.dtype == torch.bfloat16
        assert _leaf_rel(g.float().numpy(), want[k]) <= 2.0 ** -7, k
    tp, _ = _steps(dict(cast_params="bfloat16"), 1)
    assert all(t.dtype == torch.float32 for t in tp.parameters())


def test_bf16_master_training_step():
    """bf16 weights + fp32 masters: loss decreases, params stay bf16 (the
    reference's tests/test_lm_details.py case)."""
    cfg = configs.get_smoke_config("phi3-mini-3.8b", n_layers=2,
                                   d_model=64, vocab=128)
    p = lm.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = nn.map_params(p, lambda t: t.to(torch.bfloat16))
    params.requires_grad_(True)
    state = opt.adamw_init(params, keep_master=True)
    ocfg = opt.AdamWConfig(lr_peak=5e-3, warmup_steps=1, total_steps=20)
    toks = torch.randint(0, cfg.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    l0 = None
    for _ in range(8):
        (loss, _), g = ts.loss_and_grad(cfg, params, batch)
        params, state, _ = opt.adamw_update(ocfg, g, state, params)
        l0 = float(loss) if l0 is None else l0
    assert float(loss) < l0
    assert all(x.dtype == torch.bfloat16 for x in params.parameters())
    assert all(x.dtype == torch.float32 for x in state.master.values())


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-v2-lite-16b"])
def test_remat_modes_give_the_same_gradients(arch):
    import dataclasses
    base = configs.get_smoke_config(arch, dtype="float32")
    batch = ts.to_device(_batch(base), "cpu")
    grads = {}
    for mode in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=mode)
        (loss, _), grads[mode] = ts.loss_and_grad(cfg, _port(arch, cfg),
                                                  batch)
    for mode in ("full", "dots"):
        for k, g in grads["none"].items():
            torch.testing.assert_close(grads[mode][k], g, rtol=0, atol=0)


def test_kernel_wrappers_refuse_grad():
    """Each CUDA wrapper raises on an input that requires grad while
    autograd records, before its device check, so CPU tensors show it;
    under no_grad the device check is what refuses a CPU tensor."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    a = torch.rand(1, 8, 4, requires_grad=True)
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    dt, A = torch.rand(1, 8, 2), -torch.rand(2)
    Bg = torch.randn(1, 8, 1, 4)
    calls = (("flash_attention", lambda: fa.flash_attention_fwd(q, q, q)),
             ("rg_lru", lambda: rg.rg_lru_fwd(a, a.detach())),
             ("ssd_scan", lambda: ssd.ssd_fwd(x, dt, A, Bg, Bg, chunk=4)))
    for name, call in calls:
        with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                           "grad, and the kernel has no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.fixture
def counted(monkeypatch):
    """Every call of the three kernel dispatchers, counted."""
    counts = {"flash": 0, "rg_lru": 0, "ssd": 0}
    for key, mod, name in (("flash", fa_ops, "flash_attention"),
                           ("rg_lru", rg_ops, "rg_lru_scan"),
                           ("ssd", ssd_ops, "ssd")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            counts[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return counts


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-780m",
                                  "phi3-mini-3.8b"])
def test_training_reaches_no_kernel(arch, counted):
    cfg = configs.get_smoke_config(arch, dtype="float32")
    p = _port(arch, cfg)
    batch = ts.to_device(_batch(cfg), "cpu")
    ts.loss_and_grad(cfg, p, batch)
    assert counted == {"flash": 0, "rg_lru": 0, "ssd": 0}
    with torch.no_grad():
        want, _, _ = lm.forward(p, cfg, batch["tokens"])
    assert sum(counted.values()) == cfg.n_layers
    # the training route's forward is the serving route's function
    got, _, _ = lm.forward(p, cfg, batch["tokens"])
    assert got.grad_fn is not None
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-5)


def test_serve_steps_are_lm_prefill_and_decode():
    cfg = configs.get_smoke_config("recurrentgemma-9b", dtype="float32")
    p = _port("recurrentgemma-9b", cfg)          # gradients on
    toks = torch.from_numpy(_batch(cfg)["tokens"]).long()
    prefill = ts.make_serve_step(cfg, "prefill")
    decode = ts.make_serve_step(cfg, "decode")
    caches = lm.init_caches(cfg, B, S + 1, dtype=torch.float32, device="cpu")
    last, caches = prefill(p, toks, caches)
    logits, _ = decode(p, last.argmax(-1), S, caches)
    assert last.grad_fn is None and logits.grad_fn is None
    with torch.no_grad():
        c2 = lm.init_caches(cfg, B, S + 1, dtype=torch.float32,
                            device="cpu")
        want_last, c2 = lm.prefill(p, cfg, toks, c2)
        want, _ = lm.decode_step(p, cfg, want_last.argmax(-1), S, c2)
    torch.testing.assert_close(last, want_last, rtol=0, atol=0)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ts.make_serve_step(cfg, "score")


def test_convert_both_ways_and_resume_from_a_jax_state():
    """`lm_params_to_numpy` and `opt_state_to_numpy` invert the carry-over
    into the port; a port step from the reference's params and AdamW
    state after its first step matches the reference's second step."""
    arch = "recurrentgemma-9b"                  # a prologue and 3 slots
    jc = jconfigs.get_smoke_config(arch, n_layers=5)
    tc = configs.get_smoke_config(arch, n_layers=5)
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: jlm.lm_init(k, jc))(
        jax.random.PRNGKey(4)))
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(jp, tc, "cpu"), tc)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    jax.tree.map(np.testing.assert_array_equal, back, jp)

    arch = "phi3-mini-3.8b"
    jc = jconfigs.get_smoke_config(arch, dtype="float32")
    tc = configs.get_smoke_config(arch, dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jstep = jax.jit(jts.make_train_step(jc, jopt.AdamWConfig(**OCFG),
                                        mesh)[0])
    b1, b2 = _batch(tc, seed=20), _batch(tc, seed=21)
    jp = _jax_params(arch)
    jp1, js1, _ = jstep(jp, jopt.adamw_init(jp), _jb(b1))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp1), tc,
                                      "cpu").requires_grad_(True)
    tstate = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js1),
                                          tc, "cpu")
    mine = convert.opt_state_to_numpy(tstate, tc)
    assert int(mine["step"]) == 1 and mine["master"] is None
    jax.tree.map(np.testing.assert_array_equal, mine["m"],
                 jax.tree.map(np.asarray, js1.m))
    jp2, js2, jm = jstep(jp1, js1, _jb(b2))
    tp, tstate, tm = ts.make_train_step(tc, opt.AdamWConfig(**OCFG))(
        tp, tstate, ts.to_device(b2, "cpu"))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ABS
    _hold_params(tp, jp2, tc, float(tm["lr"]))
    got = convert.opt_state_to_numpy(tstate, tc)
    for field in ("m", "v"):
        want = convert.named_from_tree(
            jax.tree.map(np.asarray, getattr(js2, field)), tc)
        for k, a in convert.named_from_tree(got[field], tc).items():
            assert _leaf_rel(a, want[k]) <= GRAD_REL, (field, k)
