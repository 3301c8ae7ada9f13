"""The port's Mamba-2 780M against the JAX package's, whole model, on the
CPU: a scaled-down config of the same family (`scaled_down`: d_state 16,
head_dim 16, chunk 16), the reference's parameters carried over by
`models/convert.py`, the JAX side built with `use_pallas=True` (its SSD
kernel in interpret mode on the scoring path).

Tolerances: fp32 compute 1e-4 relative max-abs (XLA on the CPU fuses
multiply-adds and sums in another order than torch); bf16 compute 5e-2
relative, the JAX package's own ring-cache tolerance.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm, ssd, transformer  # noqa: E402

ARCH = "mamba2-780m"
REL = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(n_layers=3, dtype="float32", **kw):
    kw = dict(n_layers=n_layers, dtype=dtype, **kw)
    jc = jconfigs.scaled_down(jconfigs.get_config(ARCH), use_pallas=True,
                              **kw)
    return jc, configs.scaled_down(configs.get_config(ARCH), **kw)


@functools.lru_cache(maxsize=None)
def _params(n_layers=3):
    jc, tc = _cfgs(n_layers)
    jp = jax.jit(lambda key: jlm.lm_init(key, jc))(jax.random.PRNGKey(1))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                      "cpu")
    return jp, tp


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _tokens(seed, shape, vocab):
    t = np.random.RandomState(seed).randint(0, vocab, shape)
    return jnp.asarray(t.astype(np.int32)), torch.from_numpy(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [40, 33])
def test_forward_matches_jax(dtype, S):
    """S = 40 runs the scan in chunks of 8, S = 33 in chunks of 1 (the
    chunk is halved from 16 until it divides S)."""
    jc, tc = _cfgs(dtype=dtype)
    jp, tp = _params()
    jt, tt = _tokens(S, (2, S), jc.vocab)
    want, _, _ = jax.jit(lambda p, t: jlm.forward(p, jc, t))(jp, jt)
    with torch.inference_mode():
        got, caches, aux = lm.forward(tp, tc, tt)
    assert caches is None and aux == 0.0
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, S, jc.vocab_padded)
    assert _rel(got, want) <= REL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jc, tc = _cfgs(dtype=dtype)
    jp, tp = _params()
    B, S, n = 2, 24, 3
    jt, tt = _tokens(7, (B, S + n), jc.vocab)
    prefill = jax.jit(lambda p, t, c: jlm.prefill(p, jc, t, c))
    decode = jax.jit(lambda p, t, i, c: jlm.decode_step(p, jc, t, i, c))
    jcaches = jlm.init_caches(jc, B, S + n, dtype=getattr(jnp, dtype))
    tcaches = lm.init_caches(tc, B, S + n, dtype=getattr(torch, dtype),
                             device="cpu")
    state = tcaches["groups"][0][0]
    assert isinstance(state, ssd.SSDState)
    assert all(t.dtype == torch.float32 for t in state)
    jl, jcaches = prefill(jp, jt[:, :S], jcaches)
    with torch.inference_mode():
        tl, tcaches = lm.prefill(tp, tc, tt[:, :S], tcaches)
        assert _rel(tl, jl) <= REL[dtype]
        for i in range(n):
            jl, jcaches = decode(jp, jt[:, S + i], S + i, jcaches)
            tl, tcaches = lm.decode_step(tp, tc, tt[:, S + i], S + i,
                                         tcaches)
            assert tl.shape == (B, jc.vocab_padded)
            assert _rel(tl, jl) <= REL[dtype], i
        for g in range(tc.n_layers):
            t_h = tcaches["groups"][0][g].h
            j_h = jcaches["groups"][0].h[g]
            assert _rel(t_h, j_h) <= REL[dtype], g


def test_vocab_padding_masked_in_head():
    """tests/test_lm_details.py's case: vocab 100 pads to 112 and the
    padded logits are masked."""
    tc = configs.get_smoke_config(ARCH, vocab=100)
    assert tc.vocab_padded == 112
    p = lm.lm_init(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, tc.vocab, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, _, _ = lm.forward(p, tc, toks)
    assert logits.shape[-1] == 112
    assert float(logits[..., 100:].max()) < -1e8
    assert float(logits[..., :100].min()) > -1e8


def test_registry_config_copy_and_param_shapes():
    cfg = configs.get_config(ARCH)
    ref = jconfigs.get_config(ARCH)
    assert ARCH in configs.ARCH_IDS
    dropped = {"scan_layers", "use_pallas"}
    fields = {f.name for f in dataclasses.fields(cfg)}
    ref_values = dataclasses.asdict(ref)
    assert {k: ref_values[k] for k in fields - dropped} \
        == dataclasses.asdict(cfg)
    assert transformer.stack_layout(cfg) == ([], ["ssd"], 48)
    # the full model's parameter count, from the reference's shapes
    shapes = jax.eval_shape(lambda k: jlm.lm_init(k, ref),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == 780_161_280
    # a fresh port init has the reference's parameter names and shapes
    jc, tc = _cfgs()
    jp, tp = _params()
    fresh = lm.lm_init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert lm.param_count(fresh) == jlm.param_count(jp) == lm.param_count(tp)
    got = {n: tuple(t.shape) for n, t in fresh.named_parameters()}
    assert got == {n: tuple(t.shape) for n, t in tp.named_parameters()}
    layer = fresh["stack"]["groups"][0][0]
    assert "ln2" not in layer and "mlp" not in layer
    # the init's decays and step sizes are the reference's
    a = layer["attn"]
    assert torch.allclose(-torch.exp(a["A_log"]),
                          -torch.linspace(1.0, 16.0, a["A_log"].numel()))
    dt = torch.nn.functional.softplus(a["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 1e-1 + 1e-7


@pytest.mark.parametrize("vocab", [512, 100])
def test_lm_serve_small_on_cpu(vocab):
    """The serving bench's Mamba-2 path at a small size: finite outputs,
    served logits equal to `forward`'s at the same positions (at vocab
    100 the check leaves out the 12 masked columns), and no kernel launch
    on the CPU."""
    from repro_torch.bench import lm_serve
    _, tc = _cfgs(vocab=vocab)
    out = lm_serve.run("cpu", cfg=tc, score_len=40, batch=2, prompt_len=24,
                       decode_steps=4, score_batch=2)
    assert out["arch"] == ARCH and out["score_batch"] == 2
    assert out["forward_finite"] and out["serve_finite"]
    if vocab == 512:
        assert out["params"] == lm.param_count(_params()[1])
    assert out["check"]["positions"] == 2 * 5
    assert out["check"]["rel_max_abs"] <= REL["float32"]
    assert out["check"]["argmax_agree"] == 1.0
    zero = {"flash_attention": 0, "rg_lru": 0, "rg_lru_generic": 0,
            "ssd_scan": 0}
    assert out["forward_launches"] == zero
    assert out["decode_launches"] == zero


def _served_and_scored_jax(jc, jp, toks, P):
    """Serve (prefill P tokens, then one decode step per further token,
    teacher-forced) and score the same tokens, on the JAX side."""
    B, T = toks.shape[0], toks.shape[1] - P + 1
    caches = jlm.init_caches(jc, B, P + T, dtype=getattr(jnp, jc.dtype))
    jt = jnp.asarray(toks.astype(np.int32))
    last, caches = jax.jit(lambda p, t, c: jlm.prefill(p, jc, t, c))(
        jp, jt[:, :P], caches)
    served = [last]
    decode = jax.jit(lambda p, t, i, c: jlm.decode_step(p, jc, t, i, c))
    for i in range(T - 1):
        last, caches = decode(jp, jt[:, P + i], P + i, caches)
        served.append(last)
    scored, _, _ = jax.jit(lambda p, t: jlm.forward(p, jc, t))(jp, jt)
    return (np.stack([np.asarray(s.astype(jnp.float32)) for s in served], 1),
            np.asarray(scored.astype(jnp.float32))[:, P - 1:])


def _served_and_scored_port(tc, tp, toks, P):
    B, T = toks.shape[0], toks.shape[1] - P + 1
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        caches = lm.init_caches(tc, B, P + T, dtype=lm.compute_dtype(tc),
                                device="cpu")
        last, caches = lm.prefill(tp, tc, tt[:, :P], caches)
        served = [last]
        for i in range(T - 1):
            last, caches = lm.decode_step(tp, tc, tt[:, P + i], P + i, caches)
            served.append(last)
        scored, _, _ = lm.forward(tp, tc, tt)
    return (torch.stack(served, 1).float().numpy(),
            scored.float().numpy()[:, P - 1:])


def _gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_vs_scored_at_full_depth(dtype):
    """All 48 layers (at the scaled-down width): serving against scoring
    the same tokens, on both sides. In fp32 both agree within 1e-4 and the
    port equals JAX. In bf16 the reference itself misses the 5e-2 of its
    shallow ring-cache test (decode runs in fp32 through the fp32 windows
    and state, scoring in bf16, and the bf16 error grows with depth), so
    the full-depth bf16 model is held to the reference's own gap: the
    port's is at most 1.5x it."""
    jc, tc = _cfgs(n_layers=48, dtype=dtype)
    jc32, tc32 = _cfgs(n_layers=48)
    jp = jax.jit(lambda key: jlm.lm_init(key, jc32))(jax.random.PRNGKey(5))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc32,
                                      "cpu")
    P = 32
    toks = np.random.RandomState(6).randint(0, jc.vocab, (2, P + 5))
    j_served, j_scored = _served_and_scored_jax(jc, jp, toks, P)
    t_served, t_scored = _served_and_scored_port(tc, tp, toks, P)
    j_gap, t_gap = _gap(j_served, j_scored), _gap(t_served, t_scored)
    msg = f"{dtype}: served vs scored JAX {j_gap:.3e}, port {t_gap:.3e}"
    if dtype == "float32":
        assert j_gap <= 1e-4 and t_gap <= 1e-4, msg
        assert _gap(t_scored, j_scored) <= 1e-4, msg
        assert _gap(t_served, j_served) <= 1e-4, msg
    else:
        assert j_gap > 5e-2, msg
        assert t_gap <= 1.5 * j_gap, msg
    print(msg)
