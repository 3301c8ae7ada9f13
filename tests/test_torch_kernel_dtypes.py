"""The three LM kernels on inputs wider than the models make: a value width
Dv other than the head width Dh (flash attention), and operands in mixed
dtypes (the RG-LRU and SSD scans).

The JAX package's Pallas kernels, run in interpret mode, pin the
reference's behaviour on each: flash returns [B, S, H, Dv] scaled by
1/sqrt(Dh); the scans cast every operand to fp32 on its own and return
the output in the first operand's dtype. The port's plain versions,
through `ops` on the CPU, are held to them. The CUDA wrappers pad
(`flash_attention.kernel.common_width`) or promote these inputs to fp32;
the tests below also hold that padding and promotion, in plain torch, to
the plain versions. `chip_smoke.py` phase 3 runs the same cases through
the kernels on the card.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import kernel as jfa  # noqa: E402
from repro.kernels.rg_lru import kernel as jrg  # noqa: E402
from repro.kernels.ssd_scan import ops as jssd_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel, ops as fa_ops, ref as fa_ref)
from repro_torch.kernels.rg_lru import ops as rg_ops, ref as rg_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402

# fp32 in both, summed in another order; a bf16 output rounds to 2^-8
# relative (tests/test_torch_lm_kernels.py, tests/test_torch_ssd.py)
TOL_FLASH = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_SSD = {"float32": 1e-4, "bfloat16": 3e-2}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arr, dt):
    """One numpy array as a JAX and a torch array of dtype `dt`."""
    return (jnp.asarray(arr).astype(dt),
            torch.from_numpy(arr).to(getattr(torch, dt)))


# B, S, H, K, Dh, Dv, window, softcap, dtype
FLASH_DV = [(1, 256, 4, 2, 64, 32, 0, 0.0, "float32"),
            (1, 256, 4, 1, 32, 64, 64, 0.0, "float32"),
            (2, 128, 4, 2, 64, 128, 0, 30.0, "float32"),
            (1, 256, 4, 2, 128, 64, 0, 0.0, "bfloat16")]


@pytest.mark.parametrize("case", FLASH_DV, ids=lambda c: "-".join(map(str, c)))
def test_flash_value_width_matches_pallas_interpret(case):
    B, S, H, K, Dh, Dv, W, cap, dt = case
    rng = np.random.RandomState(Dh + Dv)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((B, S, n, d)).astype(np.float32), dt)
        for n, d in ((H, Dh), (K, Dh), (K, Dv)))
    want = jfa.flash_attention_fwd(jq, jk, jv, causal=True, window=W,
                                   softcap=cap, block_q=128, block_k=128,
                                   interpret=True)
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, window=W,
                                 softcap=cap)
    assert tuple(want.shape) == (B, S, H, Dv)
    assert got.shape == (B, S, H, Dv) and got.dtype == tq.dtype
    assert np.abs(_f32(got) - _f32(want)).max() <= TOL_FLASH[dt]


@pytest.mark.parametrize("Dh,Dv", [(64, 32), (32, 64), (20, 20)])
def test_flash_common_width_pads_with_zero_columns(Dh, Dv):
    """The CUDA wrapper's padding: zero columns of q and k leave every
    score as it was (the kernel scales by 1/sqrt(Dh) of the unpadded
    width), zero columns of v give zero output columns."""
    rng = np.random.RandomState(Dh * Dv)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 96, n, d))
                                .astype(np.float32))
               for n, d in ((4, Dh), (2, Dh), (2, Dv)))
    qp, kp, vp = fa_kernel.common_width(q, k, v)
    D = max(Dh, Dv)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == D
    for t, p in ((q, qp), (k, kp), (v, vp)):
        assert torch.equal(p[..., :t.shape[-1]], t)
        assert not p[..., t.shape[-1]:].any()
    if Dh == Dv:
        assert qp is q and kp is k and vp is v
    # the plain version scales by the width it sees: undo the padded one
    scale = math.sqrt(D) / math.sqrt(Dh)
    got = fa_ref.mha_reference(qp * scale, kp, vp, causal=True, window=16)
    want = fa_ref.mha_reference(q, k, v, causal=True, window=16)
    assert not got[..., Dv:].any()
    assert np.abs(got[..., :Dv].numpy() - want.numpy()).max() <= 1e-5


@pytest.mark.parametrize("da,db", [("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_rg_lru_mixed_dtypes_match_pallas_interpret(da, db):
    shape = (2, 64, 256)
    rng = np.random.RandomState(7)
    ja, ta = _pair(rng.uniform(0.6, 0.999, size=shape).astype(np.float32),
                   da)
    jb, tb = _pair((rng.standard_normal(shape) * 0.1).astype(np.float32), db)
    want = jrg.rg_lru_fwd(ja, jb, chunk=16, block_c=128, interpret=True)
    got = rg_ops.rg_lru_scan(ta, tb)
    assert want.dtype == ja.dtype and got.dtype == ta.dtype
    # XLA may fuse a*h + b into an FMA (1e-5); a bf16 output rounds once
    tol = 8e-3 if da == "bfloat16" else 1e-5
    assert np.abs(_f32(got) - _f32(want)).max() <= tol
    # what the CUDA wrapper does: both to fp32, h rounded to a's dtype
    promoted = rg_ref.rg_lru_reference(ta.float(), tb.float()).to(ta.dtype)
    assert torch.equal(promoted, got)


@pytest.mark.parametrize("dx,db,dc", [("bfloat16", "float32", "float32"),
                                      ("float32", "bfloat16", "bfloat16"),
                                      ("bfloat16", "bfloat16", "float32")])
def test_ssd_mixed_dtypes_match_pallas_interpret(dx, db, dc):
    B, S, H, P, N, G, Q = 1, 64, 4, 16, 8, 2, 16
    rng = np.random.RandomState(11)

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    jx, tx = _pair(rn(B, S, H, P) * 0.5, dx)
    dt = np.log1p(np.exp(rn(B, S, H))) * 0.1
    A = -np.exp(rn(H))
    jB, tB = _pair(rn(B, S, G, N) * 0.5, db)
    jC, tC = _pair(rn(B, S, G, N) * 0.5, dc)
    jdt, tdt = _pair(dt.astype(np.float32), "float32")
    jA, tA = _pair(A.astype(np.float32), "float32")
    yw, hw = jssd_ops.ssd(jx, jdt, jA, jB, jC, chunk=Q, interpret=True)
    y, h = ssd_ops.ssd(tx, tdt, tA, tB, tC, chunk=Q)
    assert yw.dtype == jx.dtype and y.dtype == tx.dtype
    assert h.dtype == torch.float32
    assert np.abs(_f32(y) - _f32(yw)).max() <= TOL_SSD[dx]
    assert np.abs(h.numpy() - np.asarray(hw)).max() <= TOL_SSD["float32"]
    # the CUDA route: every operand to fp32 first, y rounded to x's dtype
    y32, h32 = ssd_ops.ssd_plain(tx.float(), tdt, tA, tB.float(), tC.float())
    assert torch.equal(y32.to(tx.dtype), y) and torch.equal(h32, h)
