"""The port's multi-head latent attention (`models/mla.py`) against the
JAX package's, on the same inputs (numpy seeds) and the same perturbed
parameters, on the CPU: without a cache, and with one (a prefill, then
one-token decode steps), with and without the q low-rank path
(MiniCPM3 and DeepSeek-V2-Lite), expanded and weight-absorbed.

Tolerances: fp32 1e-5 relative for one layer (XLA sums in another
order); bf16 5e-2, the JAX package's own; absorbed against expanded 2e-2,
as `tests/test_lm_details.py::test_mla_absorbed_decode_matches_expanded`.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm, mla as jmla  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm, mla  # noqa: E402

ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")   # with / without q_lora
REL = {"float32": 1e-5, "bfloat16": 5e-2}


def _cfgs(arch, dtype="float32", absorb=False):
    jc = jconfigs.get_smoke_config(arch, use_pallas=True, dtype=dtype,
                                   mla_absorb=absorb)
    tc = configs.get_smoke_config(arch, dtype=dtype, mla_absorb=absorb)
    return jc, tc


def _params(jc, seed=0):
    """One MLA layer's parameters, every leaf (the norm scales too)
    perturbed by seeded noise, and the port's copy."""
    jp = jmla.mla_init(jax.random.PRNGKey(seed), jc)
    rs = np.random.RandomState(seed + 50)
    jp = {k: jnp.asarray(np.asarray(v) + 0.05 * rs.standard_normal(v.shape)
                         .astype(np.float32)) for k, v in sorted(jp.items())}
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _x(seed, shape, dtype):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _pos(B, lo, hi):
    p = np.broadcast_to(np.arange(lo, hi, dtype=np.int32), (B, hi - lo))
    return jnp.asarray(p), torch.from_numpy(p.copy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_no_cache(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(jc, 1)
    jx, tx = _x(2, (2, 20, jc.d_model), dtype)
    jpos, tpos = _pos(2, 0, 20)
    jy, _ = jax.jit(lambda p, x, q: jmla.mla_apply(p, jc, x, q))(jp, jx, jpos)
    ty, cache = mla.mla_apply(tp, tc, tx, tpos)
    assert cache is None and ty.dtype == tx.dtype
    assert _rel(ty, jy) <= REL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_cache_prefill_and_decode(arch, absorb, dtype):
    """A 12-token prefill into the compressed cache, then 4 decode steps,
    the cache in the compute dtype; the cache contents equal too."""
    jc, tc = _cfgs(arch, dtype, absorb)
    jp, tp = _params(jc, 3)
    B, S, n = 2, 12, 4
    jx, tx = _x(4, (B, S + n, jc.d_model), dtype)
    m = jc.mla
    jcache = jmla.MLACache.init(B, S + n, m.kv_lora_rank,
                                m.qk_rope_head_dim, getattr(jnp, dtype))
    tcache = mla.MLACache.init(B, S + n, m.kv_lora_rank, m.qk_rope_head_dim,
                               getattr(torch, dtype))
    apply_j = jax.jit(lambda p, x, q, c, i: jmla.mla_apply(
        p, jc, x, q, cache=c, cache_pos=i), static_argnums=4)
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + n)]:
        jpos, tpos = _pos(B, lo, hi)
        jy, jcache = apply_j(jp, jx[:, lo:hi], jpos, jcache, lo)
        ty, tcache = mla.mla_apply(tp, tc, tx[:, lo:hi], tpos, cache=tcache,
                                   cache_pos=lo)
        assert _rel(ty, jy) <= REL[dtype], (lo, hi)
        assert _rel(tcache.c_kv, jcache.c_kv) <= REL[dtype]
        assert _rel(tcache.k_rope, jcache.k_rope) <= REL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_absorbed_decode_matches_expanded(arch):
    """The reference's own check on the port: smoke config (bf16 compute),
    fp32 caches, a 12-token prefill and one decode step through the whole
    model, absorbed against expanded within 2e-2."""
    cfg = configs.get_smoke_config(arch)
    cfga = dataclasses.replace(cfg, mla_absorb=True)
    p = lm.lm_init(cfg, torch.Generator().manual_seed(7), device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (B, S + 1)))
    out = {}
    with torch.inference_mode():
        for name, c in [("exp", cfg), ("abs", cfga)]:
            caches = lm.init_caches(c, B, S + 1, dtype=torch.float32,
                                    device="cpu")
            _, caches = lm.prefill(p, c, toks[:, :S], caches)
            out[name], _ = lm.decode_step(p, c, toks[:, S], S, caches)
    rel = float((out["exp"].float() - out["abs"].float()).abs().max()
                / out["exp"].float().abs().max())
    assert rel < 2e-2, rel


def test_mla_cache_matches_jax_init():
    jc, tc = _cfgs("deepseek-v2-lite-16b")
    jcaches = jlm.init_caches(jc, 2, 10, dtype=jnp.float32)
    tcaches = lm.init_caches(tc, 2, 10, dtype=torch.float32, device="cpu")
    jc0, tc0 = jcaches["prologue"][0], tcaches["prologue"][0]
    assert isinstance(tc0, mla.MLACache)
    assert tuple(tc0.c_kv.shape) == jc0.c_kv.shape
    assert tuple(tc0.k_rope.shape) == jc0.k_rope.shape
    # the reference stacks the group caches on a leading axis
    assert (len(tcaches["groups"][0]),
            *tcaches["groups"][0][0].c_kv.shape) == jcaches["groups"][0] \
        .c_kv.shape
