"""Every registered config through the port's model path against the JAX
package's, on the CPU, at a small size (`get_smoke_config`: 2 layers,
d_model 64, 4 heads, vocab 512; MoE 4 experts top-2). The reference's
parameters are perturbed leaf by leaf with seeded noise before they are
carried over (`models/convert.py`), so that norm scales, zero-initialised
biases (Qwen2's `bq/bk/bv`, MusicGen's `b_up/b_down`) and the shared
experts are really exercised. The JAX side runs with `use_pallas=True`,
its Pallas kernels in interpret mode.

Held: `forward` logits and the MoE aux loss, `loss_fn` chunked and
unchunked, `prefill` and `decode_step` logits. Tolerances: fp32 1e-4
relative max-abs for logits, 1e-5 absolute for losses (XLA on the CPU
fuses multiply-adds and sums in another order); bf16 5e-2 relative, the
JAX package's own tolerance, for logits and losses.

MoE in bf16: the two frameworks round bf16 activations at different
places (XLA fuses ops and drops roundings between them), and a router
whose k-th and (k+1)-th logits lie within that noise picks another expert;
at capacity, the moved choice can also drop another token's. The
reference disagrees with itself that way (jit against op by op, 0.19 and
0.20 relative on these two models). So both sides' choices are recorded
in every MoE layer: each choice that differs must be a near tie in the
reference's own logits (within 2^-5 of the row's largest |logit|), and
the logits are held to 5e-2 at the positions no differing choice or drop
can reach: in the stack's last layer only its own position; in an
earlier one the later positions of its row too (causal attention), and
the row's caches. In fp32 the choices and drops are equal everywhere.
"""
import contextlib
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm, moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm, moe  # noqa: E402

from test_torch_moe import np_keep  # noqa: E402

ARCH_IDS = jconfigs.ARCH_IDS
REL = {"float32": 1e-4, "bfloat16": 5e-2}
LOSS = {"float32": 1e-5, "bfloat16": None}     # None: REL relative
NEAR_TIE = 2.0 ** -5
B, S = 2, 32


def _cfgs(arch, dtype):
    return (jconfigs.get_smoke_config(arch, use_pallas=True, dtype=dtype),
            configs.get_smoke_config(arch, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's parameters (fp32 at rest whatever the compute
    dtype), each leaf plus 0.05 x seeded noise, and the port's copy."""
    jc, tc = _cfgs(arch, "float32")
    jp = jax.jit(lambda k: jlm.lm_init(k, jc))(jax.random.PRNGKey(0))
    leaves, tree = jax.tree.flatten(jp)
    rs = np.random.RandomState(1)
    leaves = [np.asarray(a) + 0.05 * rs.standard_normal(a.shape)
              .astype(np.float32) for a in leaves]
    jp = jax.tree.unflatten(tree, [jnp.asarray(a) for a in leaves])
    return jp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            tc, "cpu")


def _inputs(cfg, seed=2):
    """Tokens [B, S] ([B, K, S]) and, for PaliGemma, prefix embeddings
    0.02 x normal, as tests/test_arch_smoke.py::_batch."""
    K = cfg.n_codebooks
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, (B, K, S) if K > 1 else (B, S))
    pe = None
    if cfg.n_prefix_embeds:
        pe = (0.02 * rs.standard_normal((B, cfg.n_prefix_embeds,
                                         cfg.d_model))).astype(np.float32)
    return toks, pe


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@contextlib.contextmanager
def _routes():
    """Record every MoE layer's router logits and choices on both sides,
    in call order: {"jax": [(logits, idx)], "port": [...]}. A function
    jitted inside records into the same lists on every later call."""
    rec = {"jax": [], "port": []}
    jfn, tfn = jmoe.router_topk, moe.router_topk

    def jwrap(logits, k):
        out = jfn(logits, k)
        jax.debug.callback(lambda lg, i: rec["jax"].append(
            (np.asarray(lg, np.float32), np.asarray(i))), logits, out[1],
            ordered=True)
        return out

    def twrap(logits, k):
        out = tfn(logits, k)
        rec["port"].append((logits.float().numpy(), out[1].numpy()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "router_topk", jwrap)
        mp.setattr(moe, "router_topk", twrap)
        yield rec
        jax.effects_barrier()


def _since(rec, n):
    """The records after the first n of each side."""
    return {side: rec[side][n[side]:] for side in rec}


def _reached(rec, cfg, S_):
    """([B, S_] positions, [B] rows' caches) that a differing choice or
    drop reaches, after checking that every differing choice is a near
    tie of the reference's logits. The MoE layers are the stack's last
    ones, so the last record of a call is its last layer."""
    assert len(rec["jax"]) == len(rec["port"]) > 0
    pos = np.zeros((B, S_), bool)
    rows = np.zeros(B, bool)
    for i, ((jl, ji), (_, ti)) in enumerate(zip(rec["jax"], rec["port"])):
        k = ji.shape[-1]
        cap = moe.capacity(cfg, B * S_ // ji.shape[0])
        jk = np_keep(ji.reshape(ji.shape[0], -1, k), cfg.moe.n_experts, cap)
        tk = np_keep(ti.reshape(ti.shape[0], -1, k), cfg.moe.n_experts, cap)
        ji, ti, jl = (a.reshape(B, S_, -1) for a in (ji, ti, jl))
        flip = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
        for b, s in zip(*np.nonzero(flip)):
            row = jl[b, s]
            moved = sorted(set(ti[b, s]) ^ set(ji[b, s]))
            gap = row[moved].max() - row[moved].min()
            assert gap <= NEAR_TIE * np.abs(row).max(), (b, s, gap)
        hit = flip | (jk.reshape(B, S_, k) != tk.reshape(B, S_, k)).any(-1)
        if i == len(rec["jax"]) - 1:
            pos |= hit
        else:
            pos |= np.cumsum(hit, axis=1) > 0
            rows |= hit.any(1)
    return pos, rows


def _hold_logits(got, want, dtype, reached=None):
    """got/want [B, S, V] or [B, K, S, V]; only the positions not
    `reached` ([B, S]) when given. Returns how many were held."""
    got, want = _np(got), _np(want)
    if reached is None:
        assert _rel(got, want) <= REL[dtype]
        return B * got.shape[-2]
    ok = ~reached
    g = np.moveaxis(got, -2, 1)[ok]        # [positions held, (K,) V]
    w = np.moveaxis(want, -2, 1)[ok]
    if g.size:
        assert np.abs(g - w).max() <= REL[dtype] * np.abs(want).max()
    return int(ok.sum())


def _hold_loss(got, want, dtype):
    lim = LOSS[dtype] if LOSS[dtype] is not None \
        else REL[dtype] * abs(float(want))
    assert abs(float(got) - float(want)) <= lim


# ---------------------------------------------------------------------------
# scoring: forward, aux and the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_loss_match_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(arch)
    toks, pe = _inputs(jc)
    track = jc.mlp_type == "moe"
    with _routes() as rec:
        want, _, jaux = jax.jit(lambda p, t, e: jlm.forward(
            p, jc, t, prefix_embeds=e))(jp, _j(toks), _j(pe))
        with torch.inference_mode():
            got, caches, taux = lm.forward(tp, tc, _t(toks),
                                           prefix_embeds=_t(pe))
    assert caches is None and got.dtype == getattr(torch, dtype)
    K = jc.n_codebooks
    assert got.shape == ((B, K, S, jc.vocab_padded) if K > 1
                         else (B, S, jc.vocab_padded))
    reached = None
    if track:
        if dtype == "bfloat16":
            reached, _ = _reached(rec, tc, S)
        if dtype == "float32":   # the same choices and drops everywhere
            for (_, ji), (_, ti) in zip(rec["jax"], rec["port"]):
                assert np.array_equal(ji, ti)
        _hold_loss(taux, jaux, dtype)
    else:
        assert taux == 0.0 and float(jaux) == 0.0
    held = _hold_logits(got, want, dtype, reached)
    assert held >= B * S // 2
    batch = {"tokens": toks, "labels": toks}
    if pe is not None:
        batch["prefix_embeds"] = pe
    for chunk in (16, 0):                 # S = 32: two chunks, and none
        jl, jm = jax.jit(lambda p, b: jlm.loss_fn(p, jc, b, loss_chunk=chunk))(
            jp, {k: _j(v) for k, v in batch.items()})
        with torch.inference_mode():
            tl, tm = lm.loss_fn(tp, tc, {k: _t(v) for k, v in batch.items()},
                                loss_chunk=chunk)
        for key in ("loss", "ce", "aux"):
            _hold_loss(tm[key], jm[key], dtype)
        assert float(tm["ntok"]) == float(jm["ntok"])


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    jc, tc = _cfgs(arch, "float32")
    jp, tp = _params(arch)
    assert lm.param_count(tp) == jlm.param_count(jp)
    assert lm.active_param_count(tc, tp) == jlm.active_param_count(jc, jp)
    assert lm.model_flops_per_token(tc, params=tp) == \
        jlm.model_flops_per_token(jc, params=jp)
    fresh = lm.lm_init(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = {n: tuple(t.shape) for n, t in fresh.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tp.named_parameters()}
    if tc.mlp_type == "moe":      # tests/test_arch_smoke.py's case
        assert lm.active_param_count(tc, fresh) < lm.param_count(fresh)


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py on the port (forward, and prefill/decode
# consistency; the port has no training step)
# ---------------------------------------------------------------------------
def _port_model(cfg, seed=0):
    return lm.lm_init(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_loss(arch):
    cfg = configs.get_smoke_config(arch)
    p = _port_model(cfg)
    toks, pe = _inputs(cfg, seed=0)
    batch = {"tokens": _t(toks), "labels": _t(toks)}
    if pe is not None:
        batch["prefix_embeds"] = _t(pe)
    with torch.inference_mode():
        loss, metrics = lm.loss_fn(p, cfg, batch)
    assert bool(torch.isfinite(loss)), arch
    assert 0 < float(loss) < 3 * math.log(cfg.vocab)
    assert float(metrics["ntok"]) == toks.size
