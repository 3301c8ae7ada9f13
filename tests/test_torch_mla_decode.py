"""The MLA decode kernel's plain version and its route in the model, on
the CPU (the CUDA kernel itself runs on the card only: `chip_smoke.py`
holds it to the plain version there).

- **The plain version** (`kernels/mla_decode/ref.py`) is the absorbed
  attention that `models/mla.py` ran before the kernel, moved: bit for
  bit the same as that chain, written out here as it was, at
  DeepSeek-V2-Lite's and MiniCPM3's widths, with ragged valid lengths
  around a tile of the kernel and a query position inside the valid
  length.
- **The route.** Only the absorbed attention of one query position over
  a bf16 cache, with autograd off, on CUDA takes the kernel; a prefill,
  an fp32 query or cache, a step that records autograd and a CPU step
  take the plain chain, and `MLA_DECODE_COUNTS` counts each. The CUDA
  condition is moved to the CPU here (`mla._KERNEL_DEVICE`), so the
  kernel's route runs end to end through `ops.mla_decode`, which takes
  the plain version on the CPU: the same bits as the chain, and the JAX
  package's absorbed decode within the bf16 tolerance of
  `tests/test_torch_mla.py` (5e-2).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.mla_decode import kernel, ops, ref  # noqa: E402
from repro_torch.models import lm, mla  # noqa: E402
from repro_torch.models import modules as nn  # noqa: E402

# (heads, latent width R, rope width Dr) of the two MLA configurations
WIDTHS = {"deepseek-v2-lite-16b": (16, 512, 64), "minicpm3-4b": (40, 256, 32)}
TILE = kernel.TILE
S_MAX = 3 * TILE + 5
# valid lengths: 1, a tile - 1, a tile, a tile + 1, S_max; and a row whose
# query sits inside its valid length (the causal mask, not the length)
VALID = (1, TILE - 1, TILE, TILE + 1, S_MAX, S_MAX)
Q_POS = (0, TILE - 2, TILE - 1, TILE, S_MAX - 1, TILE + 7)


def _chain(q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos, kv_valid, eps,
           scale):
    """The absorbed attention as the model ran it before the kernel
    (`mla_apply`'s mask, `_mla_attend_absorbed` and its `core`, `_scores`
    on the no-grad path), for q_pos [B, Sq]."""
    ckn = nn.rms_norm(c_kv, kv_norm, eps)
    B, S_max = c_kv.shape[0], c_kv.shape[1]
    kv_pos = torch.arange(S_max, dtype=torch.int32)[None].expand(B, S_max)
    kv_pos = torch.where(kv_pos < kv_valid[:, None], kv_pos, -1)
    s_nope = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckn.float())
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
    ok = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (kv_pos[:, None, :] >= 0)
    scores = s_nope.add_(s_rope).mul_(scale)
    scores = scores.masked_fill_(~ok[:, None], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(ckn.dtype)
    return torch.einsum("bhqk,bkr->bqhr", w, ckn)


def _inputs(arch, dtype, seed=0, norm_dtype=torch.float32):
    H, R, Dr = WIDTHS[arch]
    B = len(VALID)
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(dtype)

    kv_norm = (1 + 0.1 * torch.randn(R, generator=g)).to(norm_dtype)
    return (rnd(B, 1, H, R, s=2.0), rnd(B, 1, H, Dr), rnd(B, S_MAX, R),
            rnd(B, S_MAX, Dr), kv_norm,
            torch.tensor(Q_POS, dtype=torch.int32),
            torch.tensor(VALID, dtype=torch.int32))


@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_plain_version_is_the_chain_bit_for_bit(arch, dtype):
    q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos, kv_valid = _inputs(
        arch, dtype, seed=1)
    eps, scale = 1e-6, 0.0721
    got = ref.mla_decode_reference(q_lat, q_rope, c_kv, k_rope, kv_norm,
                                   q_pos, kv_valid, eps=eps, scale=scale)
    want = _chain(q_lat, q_rope, c_kv.clone(), k_rope, kv_norm,
                  q_pos[:, None], kv_valid, eps, scale)
    assert got.dtype == dtype and got.shape == q_lat.shape
    assert torch.equal(got, want)
    # the CPU dispatch takes the plain version
    assert torch.equal(ops.mla_decode(q_lat, q_rope, c_kv, k_rope, kv_norm,
                                      q_pos, kv_valid, eps=eps, scale=scale),
                       want)
    # a row attends to exactly its first min(valid, q_pos + 1) positions:
    # a change past them moves nothing
    c2 = c_kv.clone()
    for b, (v, q) in enumerate(zip(VALID, Q_POS)):
        c2[b, min(v, q + 1):] = 100.0
    assert torch.equal(ref.mla_decode_reference(
        q_lat, q_rope, c2, k_rope, kv_norm, q_pos, kv_valid, eps=eps,
        scale=scale), got)


def _route_case(case):
    """(q_lat, q_rope, c_kv, k_rope) for one route case, CPU tensors."""
    H, R, Dr = WIDTHS["deepseek-v2-lite-16b"]
    bf, f32 = torch.bfloat16, torch.float32
    Sq = 12 if case == "prefill" else 1
    qd = f32 if case == "fp32_query" else bf
    cd = f32 if case == "fp32_cache" else bf
    q_lat = torch.zeros(2, Sq, H, R, dtype=qd)
    if case == "records_grad":
        q_lat.requires_grad_(True)
    return (q_lat, torch.zeros(2, Sq, H, Dr, dtype=qd),
            torch.zeros(2, 40, R, dtype=cd), torch.zeros(2, 40, Dr, dtype=cd))


@pytest.mark.parametrize("case,device,kernel_route", [
    ("decode", "cpu", True),
    ("prefill", "cpu", False),
    ("fp32_query", "cpu", False),
    ("fp32_cache", "cpu", False),
    ("records_grad", "cpu", False),
    ("decode", "cuda", False),            # CPU tensors on the real rule
])
def test_route_predicate(case, device, kernel_route, monkeypatch):
    monkeypatch.setattr(mla, "_KERNEL_DEVICE", device)
    assert mla._kernel_route(*_route_case(case)) is kernel_route


def test_route_predicate_under_no_grad(monkeypatch):
    """A tensor that requires grad takes the kernel where autograd is
    off (serving under no_grad or inference_mode)."""
    monkeypatch.setattr(mla, "_KERNEL_DEVICE", "cpu")
    ts = _route_case("records_grad")
    with torch.no_grad():
        assert mla._kernel_route(*ts)
    with torch.inference_mode():
        assert mla._kernel_route(*(t.detach() for t in ts))


# ---------------------------------------------------------------------------
# through the model
# ---------------------------------------------------------------------------
def _cfgs(arch, dtype="bfloat16"):
    return (jconfigs.get_smoke_config(arch, use_pallas=True, dtype=dtype,
                                      mla_absorb=True),
            configs.get_smoke_config(arch, dtype=dtype, mla_absorb=True))


def _params(jc, seed):
    """One MLA layer's parameters, every leaf (kv_norm too) perturbed by
    seeded noise, and the port's copy (`tests/test_torch_mla.py`)."""
    jp = jmla.mla_init(jax.random.PRNGKey(seed), jc)
    rs = np.random.RandomState(seed + 50)
    jp = {k: jnp.asarray(np.asarray(v) + 0.05 * rs.standard_normal(v.shape)
                         .astype(np.float32)) for k, v in sorted(jp.items())}
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(seed, shape, dtype):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _pos(B, lo, hi):
    p = np.broadcast_to(np.arange(lo, hi, dtype=np.int32), (B, hi - lo))
    return jnp.asarray(p), torch.from_numpy(p.copy())


def _counts(before):
    return {k: v - before[k] for k, v in mla.MLA_DECODE_COUNTS.items()}


def _serve(tp, tc, tx, S, n, device, cache_dtype=torch.bfloat16,
           record=False):
    """A prefill of S positions, then n decode steps, through `mla_apply`
    with `_KERNEL_DEVICE` as given; the outputs, the counts, and the
    calls that reached `ops.mla_decode`."""
    m = tc.mla
    B = tx.shape[0]
    cache = mla.MLACache.init(B, S + n, m.kv_lora_rank, m.qk_rope_head_dim,
                              cache_dtype)
    calls, real = [], ops.mla_decode

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(mla, "_KERNEL_DEVICE", device)
    mp.setattr(mla.decode_ops, "mla_decode", spy)
    before, outs = dict(mla.MLA_DECODE_COUNTS), []
    try:
        ctx = torch.enable_grad() if record else torch.no_grad()
        with ctx:
            for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + n)]:
                _, tpos = _pos(B, lo, hi)
                y, cache = mla.mla_apply(tp, tc, tx[:, lo:hi], tpos,
                                         cache=cache, cache_pos=lo)
                outs.append(y.detach())
    finally:
        mp.undo()
    return outs, _counts(before), calls


@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_kernel_route_through_the_model(arch):
    """The decode steps of a bf16 model with bf16 caches take the
    kernel's route once a layer and step (the prefill the chain), and give
    the chain's bits; fp32 caches and a step that records autograd take
    the chain throughout."""
    jc, tc = _cfgs(arch)
    _, tp = _params(jc, 3)
    S, n = 12, 4
    _, tx = _x(4, (2, S + n, jc.d_model), "bfloat16")
    routed, c1, calls = _serve(tp, tc, tx, S, n, "cpu")
    assert c1 == {"kernel": n, "plain": 1}
    assert [tuple(s)[1] for s in calls] == [1] * n
    plain, c0, calls0 = _serve(tp, tc, tx, S, n, "cuda")
    assert c0 == {"kernel": 0, "plain": 1 + n} and not calls0
    for a, b in zip(routed, plain):
        assert torch.equal(a, b)
    _, c2, _ = _serve(tp, tc, tx, S, n, "cpu", cache_dtype=torch.float32)
    assert c2 == {"kernel": 0, "plain": 1 + n}
    tp_grad = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    _, c3, _ = _serve(tp_grad, tc, tx, S, n, "cpu", record=True)
    assert c3 == {"kernel": 0, "plain": 1 + n}


@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_kernel_route_matches_jax(arch):
    """The absorbed bf16 decode through the kernel's route against the JAX
    package's, as `tests/test_torch_mla.py` holds the chain: the outputs
    and the caches within 5e-2."""
    dtype = "bfloat16"
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(jc, 3)
    B, S, n = 2, 12, 4
    jx, tx = _x(4, (B, S + n, jc.d_model), dtype)
    m = jc.mla
    jcache = jmla.MLACache.init(B, S + n, m.kv_lora_rank,
                                m.qk_rope_head_dim, jnp.bfloat16)
    apply_j = jax.jit(lambda p, x, q, c, i: jmla.mla_apply(
        p, jc, x, q, cache=c, cache_pos=i), static_argnums=4)
    jys = []
    for lo, hi in [(0, S)] + [(t, t + 1) for t in range(S, S + n)]:
        jpos, _ = _pos(B, lo, hi)
        jy, jcache = apply_j(jp, jx[:, lo:hi], jpos, jcache, lo)
        jys.append(jy)
    tys, counts, _ = _serve(tp, tc, tx, S, n, "cpu")
    assert counts == {"kernel": n, "plain": 1}
    for ty, jy in zip(tys, jys):
        want = np.asarray(jnp.asarray(jy).astype(jnp.float32))
        rel = float(np.abs(ty.float().numpy() - want).max()
                    / (np.abs(want).max() + 1e-9))
        assert rel <= 5e-2


def test_counts_are_the_models():
    """`lm.MLA_DECODE_COUNTS` is the model's counter, beside
    `lm.STEP_GRAPH_COUNTS`."""
    assert lm.MLA_DECODE_COUNTS is mla.MLA_DECODE_COUNTS
    assert set(lm.MLA_DECODE_COUNTS) == {"kernel", "plain"}


# ---------------------------------------------------------------------------
# the wrapper's host side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S_max,H,R,Dr,want", [
    (64, 1324, 16, 512, 64, (2, 1)),      # the LM cell: 128 blocks
    (64, 1941, 16, 512, 64, (2, 1)),
    (4, 4128, 16, 512, 64, (8, 1)),       # a few rows: 8 splits a row
    (3, 40, 16, 512, 64, (2, 1)),         # at most a split a tile
    (2, 1032, 40, 256, 32, (8, 2)),       # MiniCPM3: two head groups
    (200, 702, 16, 512, 64, (1, 1)),      # more rows than SMs
    (5, 100, 64, 512, 64, (4, 4)),
])
def test_layout(B, S_max, H, R, Dr, want):
    assert kernel.layout(B, S_max, H, R, Dr, 132) == want


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos, kv_valid = _inputs(
        "deepseek-v2-lite-16b", torch.bfloat16)
    args = (q_lat, q_rope, c_kv, k_rope, kv_norm, q_pos, kv_valid)
    with pytest.raises(RuntimeError, match="requires grad"):
        kernel.mla_decode_fwd(q_lat.clone().requires_grad_(True),
                              *args[1:], eps=1e-6, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mla_decode_fwd(*args, eps=1e-6, scale=0.1)
    with pytest.raises(ValueError, match="widths"):
        kernel.mla_decode_fwd(q_lat[..., :64], *args[1:], eps=1e-6,
                              scale=0.1)
    with pytest.raises(ValueError, match="one query position"):
        kernel.mla_decode_fwd(q_lat.expand(-1, 2, -1, -1), *args[1:],
                              eps=1e-6, scale=0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.mla_decode(*(t.to("meta") for t in args), eps=1e-6, scale=0.1)
