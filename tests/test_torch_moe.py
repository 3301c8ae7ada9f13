"""The port's MoE MLP (`models/moe.py`) against the JAX package's, on the
same inputs (numpy seeds) and the same parameters, on the CPU.

Exact where the reference is exact: the experts chosen (the top k with
the lower index first on a tie, as `jax.lax.top_k`), the tokens kept at
capacity (a stable sort by expert, as `jnp.argsort`) and the router's
load counts. Floats: fp32 1e-5 relative (XLA sums in another order);
bf16 outputs within 2^-7 relative of the output's scale, the width of a
few bf16 roundings (the k outputs are summed in the reference's order,
rounded after each add, so the port rounds where the reference does).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm, moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")


def _cfgs(arch, dtype="float32", **moe_kw):
    jc = jconfigs.get_smoke_config(arch, use_pallas=True, dtype=dtype)
    tc = configs.get_smoke_config(arch, dtype=dtype)
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _params(jc, seed=0):
    """The reference's MoE parameters, every leaf perturbed by seeded noise
    (the shared experts' weights too), and the port's copy."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    leaves, tree = jax.tree.flatten(jp)
    rs = np.random.RandomState(seed + 100)
    leaves = [np.asarray(a) + 0.05 * rs.standard_normal(a.shape)
              .astype(np.float32) for a in leaves]
    jp = jax.tree.unflatten(tree, [jnp.asarray(a) for a in leaves])
    return jp, _tree(jp)


def _tree(d):
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in d.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _x(seed, shape, dtype="float32"):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(a).astype(getattr(jnp, dtype))
    return jx, torch.from_numpy(a).to(getattr(torch, dtype))


def np_keep(idx, n_experts, cap):
    """The reference's capacity rule in numpy on [G, Tl, k] expert choices:
    a stable sort by expert, each pair's position in its expert's
    segment, kept when below `cap`. Returns keep [G, Tl, k]."""
    G, Tl, K = idx.shape
    out = np.zeros((G, Tl * K), bool)
    for g in range(G):
        flat = idx[g].reshape(-1)
        order = np.argsort(flat, kind="stable")
        se = flat[order]
        start = np.searchsorted(se, np.arange(n_experts), side="left")
        pos = np.arange(Tl * K) - start[se]
        out[g, order] = pos < cap
    return out.reshape(G, Tl, K)


def _port_keep(idx, n_experts, cap):
    order, _, keep, _ = moe.dispatch(idx, n_experts, cap)
    out = torch.zeros_like(keep)
    out.scatter_(1, order, keep)
    return out.reshape(idx.shape).numpy()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
def test_router_topk_fp32():
    jl, tl = _x(0, (3, 50, 64), "float32")
    jw, ji, ja = jmoe.router_topk(jl, 6)
    tw, ti, ta = moe.router_topk(tl, 6)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tw, jw) <= 1e-6 and abs(float(ta) - float(ja)) <= 1e-6


def test_router_topk_bf16_ties_at_kth_place():
    """bf16 logits with ties planted across the k-th place: the reference
    keeps the lower expert index, and so does the port."""
    rs = np.random.RandomState(1)
    E, k = 64, 6
    logits = (rs.standard_normal((200, E)) * 0.5).astype(np.float32)
    logits = np.array(jnp.asarray(logits).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    for t in range(200):          # tie the k-th largest with 1-3 others
        row = logits[t]
        kth = np.sort(row)[::-1][k - 1]
        others = rs.choice(np.flatnonzero(row < kth), rs.randint(1, 4),
                           replace=False)
        row[others] = kth
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    jw, ji, ja = jmoe.router_topk(jl, k)
    tw, ti, ta = moe.router_topk(tl, k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tw, jw) <= 1e-6 and abs(float(ta) - float(ja)) <= 1e-6
    # torch.topk's own order would not be pinned: the ties are real
    desc = np.sort(logits, -1)[:, ::-1]
    assert (desc[:, k - 1] == desc[:, k]).all()


# ---------------------------------------------------------------------------
# the MoE MLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["cf1.25", "drops", "shards4"])
def test_moe_apply_matches_jax(arch, case):
    """moe_apply on [4, 24] tokens: at the published capacity factor, at
    one small enough to drop choices, and dispatched in 4 groups."""
    kw = {"cf1.25": {}, "drops": {"capacity_factor": 0.3},
          "shards4": {"n_dispatch_shards": 4}}[case]
    jc, tc = _cfgs(arch, **kw)
    jp, tp = _params(jc, seed=3)
    jx, tx = _x(4, (4, 24, jc.d_model))
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jc, x))(jp, jx)
    ty, taux = moe.moe_apply(tp, tc, tx)
    assert ty.dtype == torch.float32 and ty.shape == tx.shape
    assert _rel(ty, jy) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6
    # the same experts chosen and the same choices kept
    G = 4 if case == "shards4" else 1
    logits = jnp.einsum("gtd,de->gte", jx.reshape(G, -1, jc.d_model),
                        jp["router"])
    _, ji, _ = jmoe.router_topk(logits, jc.moe.top_k)
    _, ti, _ = moe.router_topk(
        tx.reshape(G, -1, tc.d_model) @ tp["router"], tc.moe.top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    cap = moe.capacity(tc, 4 * 24 // G)
    keep = _port_keep(ti, tc.moe.n_experts, cap)
    assert np.array_equal(keep, np_keep(np.asarray(ji), jc.moe.n_experts,
                                        cap))
    if case == "drops":
        assert 0 < (~keep).sum() < keep.size


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16(arch):
    """bf16 activations at a capacity that drops: the same choices and
    drops, outputs within a few bf16 roundings, the k outputs summed in
    the reference's order."""
    jc, tc = _cfgs(arch, "bfloat16", capacity_factor=0.5)
    jp, tp = _params(jc, seed=5)
    jx, tx = _x(6, (2, 40, jc.d_model), "bfloat16")
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jc, x))(jp, jx)
    ty, taux = moe.moe_apply(tp, tc, tx)
    assert ty.dtype == torch.bfloat16
    assert _rel(ty, jy) <= 2 ** -7
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_dense_matches_jax_and_sorted_dispatch(arch):
    jc, tc = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _params(jc, seed=7)
    jx, tx = _x(8, (2, 16, jc.d_model))
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply_dense(p, jc, x))(jp, jx)
    ty, taux = moe.moe_apply_dense(tp, tc, tx)
    assert _rel(ty, jy) <= 1e-5 and abs(float(taux) - float(jaux)) <= 1e-6
    # with nothing dropped the sorted dispatch computes the same function
    ys, auxs = moe.moe_apply(tp, tc, tx)
    assert _rel(ys, ty) <= 1e-5 and float(auxs) == float(taux)


def test_moe_sharded_dispatch_matches_global():
    """tests/test_lm_details.py's case: the loss with the dispatch in 4
    groups against one global group, at capacity 4.0, on the port and on
    the reference."""
    jc0, tc0 = _cfgs("dbrx-132b", capacity_factor=4.0)
    jc4, tc4 = _cfgs("dbrx-132b", capacity_factor=4.0, n_dispatch_shards=4)
    jp = jax.jit(lambda k: jlm.lm_init(k, jc0))(jax.random.PRNGKey(0))
    from repro_torch.models import convert
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc0,
                                      "cpu")
    toks = np.random.RandomState(9).randint(0, jc0.vocab, (4, 32))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    with torch.inference_mode():
        l1, _ = lm.loss_fn(tp, tc0, tb)
        l4, _ = lm.loss_fn(tp, tc4, tb)
    assert abs(float(l1) - float(l4)) < 2e-2
    j1, _ = jlm.loss_fn(jp, jc0, jb)
    j4, _ = jlm.loss_fn(jp, jc4, jb)
    assert abs(float(l1) - float(j1)) <= 1e-5
    assert abs(float(l4) - float(j4)) <= 1e-5
