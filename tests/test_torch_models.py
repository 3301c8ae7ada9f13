"""The port's RecurrentGemma modules against the JAX package's, on the
same inputs (numpy seeds) and the same parameters (`models/convert.py`),
on the CPU. The JAX side runs with `use_pallas=True`, its Pallas kernels
in interpret mode, as the port's semantics follow that branch.

Tolerances: fp32 compute 1e-4 relative max-abs for whole models (XLA on
the CPU fuses multiply-adds and sums in another order than torch), tighter
for single modules; bf16 compute 5e-2 relative, the JAX package's own
ring-cache tolerance (bf16 keeps 8 bits, and the two frameworks round at
different places).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm, modules as jnn  # noqa: E402
from repro.models import rglru as jrglru, transformer as jtr  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, convert, lm  # noqa: E402
from repro_torch.models import modules as nn, rglru, transformer  # noqa: E402

ARCH = "recurrentgemma-9b"
REL = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(n_layers=4, window=8, dtype="float32"):
    kw = dict(n_layers=n_layers, window=window, dtype=dtype)
    jc = jconfigs.scaled_down(jconfigs.get_config(ARCH), use_pallas=True,
                              **kw)
    return jc, configs.scaled_down(configs.get_config(ARCH), **kw)


@functools.lru_cache(maxsize=None)
def _params(n_layers, window):
    """JAX parameters (fp32 at rest whatever the compute dtype) and the
    port's copy of them."""
    jc, tc = _cfgs(n_layers, window)
    jp = jax.jit(lambda key: jlm.lm_init(key, jc))(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                      "cpu")
    return jp, tp


def _model(n_layers=4, window=8, dtype="float32"):
    return (*_cfgs(n_layers, window, dtype), *_params(n_layers, window))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _tree(d):
    """A JAX layer's param dict as tensors (`convert`'s leaf rule)."""
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in d.items()}


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _tokens(seed, shape, vocab):
    t = np.random.RandomState(seed).randint(0, vocab, shape)
    return jnp.asarray(t.astype(np.int32)), torch.from_numpy(t)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------
def test_rms_norm():
    rng = np.random.RandomState(0)
    jx, tx = _pair(rng, (2, 5, 64), 3.0)
    js, ts = _pair(rng, (64,))
    for zc in (False, True):
        assert _rel(nn.rms_norm(tx, ts, 1e-6, zc),
                    jnn.rms_norm(jx, js, 1e-6, zc)) <= 1e-6


@pytest.mark.parametrize("pct", [1.0, 0.5])
def test_apply_rope(pct):
    rng = np.random.RandomState(1)
    jx, tx = _pair(rng, (2, 7, 4, 16))
    pos = (np.arange(7)[None] + np.array([[0], [100]])).astype(np.int32)
    got = nn.apply_rope(tx, torch.from_numpy(pos), 10000.0, pct)
    want = jnn.apply_rope(jx, jnp.asarray(pos), 10000.0, pct)
    # cos/sin of angles up to ~100 rad: the two libraries' float32
    # range reductions differ by an ulp of the angle
    assert np.abs(_np(got) - _np(want)).max() <= 1e-5


def test_conv1d_apply_and_step():
    rng = np.random.RandomState(2)
    jp = jnn.conv1d_init(jax.random.PRNGKey(0), 4, 24)
    jp["b"] = jnp.asarray(rng.standard_normal(24).astype(np.float32))
    tp = _tree(jp)
    jx, tx = _pair(rng, (2, 9, 24))
    got = nn.conv1d_apply(tp, tx)
    assert _rel(got, jnn.conv1d_apply(jp, jx)) <= 1e-6
    # stepping one token at a time gives the same sequence
    jw = jnp.zeros((2, 3, 24))
    tw = torch.zeros(2, 3, 24)
    for t in range(9):
        jy, jw = jnn.conv1d_step(jp, jx[:, t], jw)
        ty, tw = nn.conv1d_step(tp, tx[:, t], tw)
        assert _rel(ty, jy) <= 1e-6
        assert _rel(ty, got[:, t]) <= 1e-6
    assert _rel(tw, jw) == 0.0


@pytest.mark.parametrize("kind", ["geglu", "swiglu", "gelu"])
def test_mlp(kind):
    rng = np.random.RandomState(3)
    jp = jnn.mlp_init(jax.random.PRNGKey(1), 32, 96, kind)
    jx, tx = _pair(rng, (2, 6, 32))
    assert _rel(nn.mlp_apply(_tree(jp), tx, kind),
                jnn.mlp_apply(jp, jx, kind)) <= 1e-5


# ---------------------------------------------------------------------------
# attention and the RG-LRU block
# ---------------------------------------------------------------------------
def _local_layer():
    """A local-attention layer of the 4-layer model (slot 2, group 0)."""
    jc, tc, jp, tp = _model()
    return (jc, tc, jax.tree.map(lambda a: a[0], jp["stack"]["groups"][2]),
            tp["stack"]["groups"][2][0])


def test_attn_apply_no_cache():
    jc, tc, jl, tl = _local_layer()
    rng = np.random.RandomState(4)
    jx, tx = _pair(rng, (2, 32, jc.d_model))
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    jy, _ = jax.jit(lambda p, x, q: jattn.attn_apply(
        p, jc, x, q, window=jc.window))(jl["attn"], jx, jnp.asarray(pos))
    ty, tcache = attention.attn_apply(tl["attn"], tc, tx,
                                      torch.from_numpy(pos.copy()),
                                      window=tc.window)
    assert tcache is None
    assert _rel(ty, jy) <= 1e-5


def test_attn_window_cache_prefill_and_ring_decode():
    jc, tc, jl, tl = _local_layer()
    B, S, W = 2, 24, jc.window
    rng = np.random.RandomState(5)
    jx, tx = _pair(rng, (B, S + 5, jc.d_model))
    jcache = jattn.WindowKVCache.init(B, W, jc.n_kv_heads, jc.d_head,
                                      jnp.float32)
    tcache = attention.WindowKVCache.init(B, W, tc.n_kv_heads, tc.d_head,
                                          torch.float32)
    pos = np.tile(np.arange(S + 5, dtype=np.int32), (B, 1))
    apply_j = jax.jit(functools.partial(jattn.attn_apply, cfg=jc, window=W))
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + 5)]:
        jy, jcache = apply_j(jl["attn"], x=jx[:, lo:hi],
                             positions=jnp.asarray(pos[:, lo:hi]),
                             cache=jcache, cache_pos=lo)
        ty, tcache = attention.attn_apply(
            tl["attn"], tc, tx[:, lo:hi],
            torch.from_numpy(pos[:, lo:hi].copy()),
            window=W, cache=tcache, cache_pos=lo)
        assert _rel(ty, jy) <= 1e-5, (lo, hi)
        assert np.array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
        assert _rel(tcache.k, jcache.k) <= 1e-6
        assert _rel(tcache.v, jcache.v) <= 1e-6


def test_rglru_stateless_stateful_and_decode():
    jc, tc, jp, tp = _model()
    jl = jp["stack"]["prologue"][0]["attn"]
    tl = tp["stack"]["prologue"][0]["attn"]
    B, S = 2, 20
    rng = np.random.RandomState(6)
    jx, tx = _pair(rng, (B, S, jc.d_model))
    # stateless: the scan kernel (interpret) against the port's plain scan
    apply_j = jax.jit(lambda x, s: jrglru.rglru_apply(jl, jc, x, state=s))
    jy, _ = apply_j(jx, None)
    ty, tstate = rglru.rglru_apply(tl, tc, tx)
    assert tstate is None and _rel(ty, jy) <= 1e-5
    # prefill in two chunks carrying state, then one-token decode steps
    r = jc.rglru.d_rnn
    js = jrglru.RGLRUState.init(B, r, jc.rglru.conv_width)
    ts = rglru.RGLRUState.init(B, r, tc.rglru.conv_width)
    for lo, hi in [(0, 12), (12, 16)] + [(t, t + 1) for t in range(16, S)]:
        jy, js = apply_j(jx[:, lo:hi], js)
        ty, ts = rglru.rglru_apply(tl, tc, tx[:, lo:hi], state=ts)
        assert _rel(ty, jy) <= 1e-5, (lo, hi)
        assert _rel(ts.h, js.h) <= 1e-5 and _rel(ts.conv, js.conv) <= 1e-6
        assert ts.h.dtype == torch.float32 and ts.conv.dtype == torch.float32


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jc, tc, jp, tp = _model(dtype=dtype)
    jt, tt = _tokens(8, (2, 32), jc.vocab)
    want, _, _ = jax.jit(lambda p, t: jlm.forward(p, jc, t))(jp, jt)
    with torch.inference_mode():
        got, caches, aux = lm.forward(tp, tc, tt)
    assert caches is None and aux == 0.0
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 32, jc.vocab_padded)
    assert _rel(got, want) <= REL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jc, tc, jp, tp = _model(dtype=dtype)
    B, S, n = 2, 24, 3
    cdt = getattr(jnp, dtype)
    jt, tt = _tokens(9, (B, S + n), jc.vocab)
    prefill = jax.jit(lambda p, t, c: jlm.prefill(p, jc, t, c))
    decode = jax.jit(lambda p, t, i, c: jlm.decode_step(p, jc, t, i, c))
    jcaches = jlm.init_caches(jc, B, S + n, dtype=cdt)
    tcaches = lm.init_caches(tc, B, S + n, dtype=getattr(torch, dtype),
                             device="cpu")
    assert isinstance(tcaches["groups"][2][0], attention.WindowKVCache)
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


def test_ragged_prologue_runs_first():
    """Layers after the last full period join the prologue and run before
    the groups (at 38 layers, the two trailing rglru layers of
    `pattern_full` run first). 5 layers: prologue (rglru, rglru), then one
    (rglru, rglru, local) group."""
    for n in range(1, 10):
        jc, tc = _cfgs(n_layers=n)
        assert transformer.stack_layout(tc) == jtr.stack_layout(jc), n
    full = configs.get_config(ARCH)
    pro, period, groups = transformer.stack_layout(full)
    assert (pro, period, groups) == (["rglru", "rglru"],
                                     ["rglru", "rglru", "local"], 12)
    jc, tc, jp, tp = _model(n_layers=5)
    jt, tt = _tokens(10, (1, 32), jc.vocab)
    want, _, _ = jax.jit(lambda p, t: jlm.forward(p, jc, t))(jp, jt)
    with torch.inference_mode():
        got, _, _ = lm.forward(tp, tc, tt)
        assert _rel(got, want) <= REL["float32"]
        # the same layers in pattern_full order give other logits
        stack = tp["stack"]
        in_pattern_order = ([stack["groups"][s][0] for s in range(3)]
                            + list(stack["prologue"]))
        x = lm._embed(tp, tc, tt)
        pos = torch.arange(32, dtype=torch.int32)[None]
        for layer, kind in zip(in_pattern_order, tc.pattern_full):
            x, _, _ = transformer.block_apply(layer, tc, kind, x, pos)
        other = lm._head(tp, tc, nn.rms_norm(x, tp["final_norm"]))
    assert _rel(other, want) > 1e-2


def test_registry_and_config_copy():
    cfg = configs.get_config(ARCH)
    ref = jconfigs.get_config(ARCH)
    dropped = {"scan_layers", "use_pallas"}
    fields = {f.name for f in dataclasses.fields(cfg)}
    assert fields == {f.name for f in dataclasses.fields(ref)} - dropped
    ref_values = dataclasses.asdict(ref)
    assert {k: ref_values[k] for k in fields} == dataclasses.asdict(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (38, 4096, 256000)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    # MoE and MLA blocks are built like the others (held to the reference
    # in tests/test_torch_moe.py, test_torch_mla.py and test_torch_arch.py):
    # a MoE model's first `first_k_dense` layers take a dense SwiGLU
    moe = configs.get_smoke_config("deepseek-v2-lite-16b")
    dense = transformer.block_init(torch.Generator(), moe, "attn", 0)
    routed = transformer.block_init(torch.Generator(), moe, "attn", 1)
    assert "router" not in dense["mlp"]
    assert tuple(dense["mlp"]["w_up"].shape) == (moe.d_model, moe.d_ff)
    assert tuple(routed["mlp"]["w_up"].shape) == (
        moe.moe.n_experts, moe.d_model, moe.moe.d_expert)
    assert "w_uk" in dense["attn"] and "w_q" in dense["attn"]
    mla = configs.get_smoke_config("minicpm3-4b")
    assert "w_dq" in transformer.block_init(torch.Generator(), mla, "attn",
                                            0)["attn"]
    with pytest.raises(ValueError):
        transformer.block_init(torch.Generator(), cfg, "conv", 0)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_registered_config_is_the_references(arch):
    """All ten configs of the reference's registry, field by field, less
    the layer-scan and kernel fields the port drops."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    cfg, ref = configs.get_config(arch), jconfigs.get_config(arch)
    dropped = {"scan_layers", "use_pallas"}
    fields = {f.name for f in dataclasses.fields(cfg)}
    assert fields == {f.name for f in dataclasses.fields(ref)} - dropped
    ref_values = dataclasses.asdict(ref)
    assert {k: ref_values[k] for k in fields} == dataclasses.asdict(cfg)


def test_param_count_and_init_match_jax_shapes():
    jc, tc, jp, tp = _model()
    assert lm.param_count(tp) == jlm.param_count(jp)
    fresh = lm.lm_init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert lm.param_count(fresh) == jlm.param_count(jp)
    shapes = {n: tuple(t.shape) for n, t in fresh.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tp.named_parameters()}
    # the decay init keeps a = exp(-c softplus(lam)) in (0.9, 0.999)
    lam = fresh["stack"]["prologue"][0]["attn"]["lam"]
    a = torch.exp(-tc.rglru.c * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    w = fresh["stack"]["groups"][0][0]["mlp"]["w_up"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tc.d_model) + 1e-6


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the error path needs none")
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="GPU"):
        lm.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="GPU"):
        lm.lm_init(cfg, torch.Generator())
    from repro_torch.bench import lm_serve
    with pytest.raises(RuntimeError, match="GPU"):
        lm_serve.run()


def test_lm_serve_small_on_cpu():
    """The serving bench's path at a small size: finite outputs, and the
    served logits agree with `forward` at the same positions."""
    from repro_torch.bench import lm_serve
    _, tc = _cfgs(window=8)
    out = lm_serve.run("cpu", cfg=tc, score_len=40, batch=2, prompt_len=24,
                       decode_steps=4)
    assert out["forward_finite"] and out["serve_finite"]
    assert out["params"] == lm.param_count(_model()[3])
    assert out["check"]["positions"] == 2 * 5
    assert out["check"]["rel_max_abs"] <= REL["float32"]
    assert out["check"]["argmax_agree"] == 1.0
    assert out["forward_launches"] == {"flash_attention": 0, "rg_lru": 0,
                                       "rg_lru_generic": 0, "ssd_scan": 0}
