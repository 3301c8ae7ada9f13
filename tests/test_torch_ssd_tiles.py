"""The arithmetic of the bf16 tensor-core SSD scan, emulated on the CPU.

`csrc/ssd_scan.cu` (`ssd_scan_wgmma_kernel`) runs only on a GPU. The
emulation below repeats its algorithm in plain torch: a chunk's rows and
the state padded to whole 16-row tiles, a warp's rows of a product (zeros
past Q and N), blocks of `TC_PS` state columns, C B^T on the
lower-triangular tiles only, the masked scores formed with exp(cum_i -
cum_j) taken only where j <= i (on the tiles below the diagonal as
exp(cum_i - cum_e) exp(cum_e - cum_j), e the last column of j's tile),
and every product on bf16 operands with fp32 sums:
B, C and x as they are, and each fp32 operand (the masked scores M, the
state h and w x) split into bf16 hi + lo and taken in two passes; the
row scale exp(cum_i) applied to C h in fp32 before M x is added. It is
held to the port's plain version and to the JAX package's kernel in
interpret mode, within the limits that `chip_smoke.py` holds the kernel
to on the card (y 3e-2, h_last 1e-4, over max(1, max |plain|)).

These tests check the design, written out a second time in Python; only
the tile constants are read from the CUDA source. The kernel's own
fragments, loads and masks are checked only on the card, by
`chip_smoke.py` phase 3 (which also runs three planted faults of the
kernel's source).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan import kernel as jkernel  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

SRC = (Path(ssd_kernel.__file__).resolve().parent / "csrc"
       / "ssd_scan.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


TC_Q = _const("TC_Q")            # rows of a chunk tile
TC_N = _const("TC_N")            # state rows
TC_PS = _const("TC_PS")          # state columns a block
TC_WARPS = _const("TC_WARPS")    # 16-row tiles of y, then the state
TC_BLOCKS_PER_SM = _const("TC_BLOCKS_PER_SM")
MMA = 16                         # a warp's rows, a product's depth step
TOL_Y, TOL_H = 3e-2, 1e-4        # chip_smoke.py's TOL_SSD


def split(v):
    """v = hi + lo, each bf16 (as floats)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def two_pass(a, b, *, split_a=True):
    """a @ b with `a` fp32 taken as bf16 hi + lo (or one bf16 pass) and
    `b` bf16-exact, summed in fp32."""
    if not split_a:
        return a.bfloat16().float() @ b
    hi, lo = split(a)
    return hi @ b + lo @ b


def emulate(x, dt, A, Bg, Cg, chunk, *, split_state=True, diagonal=True,
            zero_state_at=None):
    """The kernel's algorithm on bf16 x [B,S,H,P], fp32 dt [B,S,H] and A
    [H], bf16 Bg/Cg [B,S,G,N] -> (y bf16 [B,S,H,P], h_last fp32
    [B,H,N,P]). The keywords plant the faults of the mutation tests."""
    B, S, H, P = x.shape
    G, N = Bg.shape[2], Bg.shape[3]
    Q = chunk
    Qp, Np = -(-Q // MMA) * MMA, -(-N // MMA) * MMA
    assert Qp <= TC_Q and Np <= TC_N
    heads = torch.arange(H) // (H // G)
    i = torch.arange(Qp)[:, None]
    j = torch.arange(Qp)[None, :]
    tile_lower = (i // MMA) >= (j // MMA)      # the tiles C B^T computes
    same_tile = (i // MMA) == (j // MMA)
    keep = ((j <= i) if diagonal else (j < i)) & (i < Q)
    y = torch.zeros(B, S, H, P)
    h_out = torch.zeros(B, H, N, P)
    for p0 in range(0, P, TC_PS):               # one block per slice
        ps = min(TC_PS, P - p0)
        h = torch.zeros(B, H, Np, TC_PS)
        for c in range(S // Q):
            rows = slice(c * Q, (c + 1) * Q)
            Cc = torch.zeros(B, H, Qp, Np)
            Bc = torch.zeros(B, H, Qp, Np)
            xc = torch.zeros(B, H, Qp, TC_PS)
            d = torch.zeros(B, H, Qp)
            Cc[:, :, :Q, :N] = Cg[:, rows][:, :, heads].float().transpose(1, 2)
            Bc[:, :, :Q, :N] = Bg[:, rows][:, :, heads].float().transpose(1, 2)
            xc[..., :Q, :ps] = x[:, rows, :, p0:p0 + ps].float().transpose(1, 2)
            d[..., :Q] = dt[:, rows].transpose(1, 2)
            cum = torch.cumsum(d * A[None, :, None], -1)
            cend = cum[..., -1:]
            w = torch.where(torch.arange(Qp) < Q,
                            torch.exp(cend - cum) * d, 0.0)
            if c == zero_state_at:
                h = torch.zeros_like(h)
            # y = exp(cum_i) (C h) + M x
            yc = two_pass(h.transpose(-1, -2), Cc.transpose(-1, -2))
            yc = yc.transpose(-1, -2) * torch.exp(cum)[..., None]
            s = torch.where(tile_lower, Cc @ Bc.transpose(-1, -2), 0.0)
            # below the diagonal tiles exp(cum_i - cum_e) exp(cum_e -
            # cum_j), e the last column of j's tile; on them exp(cum_i -
            # cum_j) only where kept
            ce = cum[..., torch.arange(Qp) | (MMA - 1)]
            below = keep & ~same_tile
            fac = torch.exp(torch.where(below, cum[..., :, None]
                                        - ce[..., None, :], 0.0)) \
                * torch.exp(torch.where(below, ce[..., None, :]
                                        - cum[..., None, :], 0.0))
            diag = torch.exp(torch.where(keep & same_tile, cum[..., :, None]
                                         - cum[..., None, :], 0.0))
            m = torch.where(keep, s * torch.where(below, fac, diag)
                            * d[..., None, :], 0.0)
            yc = yc + two_pass(m, xc)
            y[:, rows, :, p0:p0 + ps] = yc[..., :Q, :ps].transpose(1, 2)
            # h = exp(cum_end) h + B^T (w x)
            wx = w[..., None] * xc
            upd = two_pass(wx.transpose(-1, -2), Bc, split_a=split_state)
            h = torch.exp(cend)[..., None] * h + upd.transpose(-1, -2)
        h_out[..., p0:p0 + ps] = h[:, :, :N, :ps]
    return y.bfloat16(), h_out


def _inputs(seed, B, S, H, P, N, G):
    """bf16 x, B, C and fp32 dt, A, drawn as tests/test_torch_ssd.py
    draws them."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(Bm).bfloat16(),
            torch.from_numpy(Cm).bfloat16())


def _err(got, want) -> float:
    """max abs error over max(1, max |want|), as chip_smoke.py."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got).astype(jnp.float32))
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# B, S, H, P, N, chunk, G: tests/test_torch_ssd.py's shapes (B and C per
# head, and per group), then the path's widths at two chunks
CASES = [
    (1, 32, 2, 8, 4, 16, 2),
    (2, 64, 3, 16, 8, 16, 3),
    (1, 128, 2, 16, 16, 32, 2),
    (2, 48, 4, 8, 8, 16, 1),
    (2, 48, 4, 8, 8, 16, 2),
    (1, 256, 2, 64, 128, 128, 1),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_matches_both_plain_versions(case):
    B, S, H, P, N, Q, G = case
    x, dt, A, Bg, Cg = _inputs(sum(case), B, S, H, P, N, G)
    y, h = emulate(x, dt, A, Bg, Cg, Q)
    yp, hp = ops.ssd_plain(x, dt, A, Bg, Cg)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (B, H, N, P)
    assert _err(y, yp) <= TOL_Y and _err(h, hp) <= TOL_H, case
    # the JAX kernel takes B and C per head
    rep = H // G
    jB = jnp.repeat(jnp.asarray(Bg.float().numpy()), rep, axis=2)
    jC = jnp.repeat(jnp.asarray(Cg.float().numpy()), rep, axis=2)
    yj, hj = jkernel.ssd_fwd(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(dt.numpy()), jnp.asarray(A.numpy()),
        jB, jC, chunk=Q, interpret=True)
    assert _err(y, yj) <= TOL_Y and _err(h, hj) <= TOL_H, case


# the mutation cases: each planted fault at the path's widths must fail
# the limit that catches it (as chip_smoke.py's planted faults of the
# kernel's source); the design itself passes both limits there
MUTANT = (1, 1024, 2, 64, 128, 128, 1)


@pytest.fixture(scope="module")
def mutant_inputs():
    B, S, H, P, N, Q, G = MUTANT
    args = _inputs(7, B, S, H, P, N, G)
    return args, ops.ssd_plain(*args)


@pytest.mark.parametrize("fault,which,limit", [
    (None, None, None),
    ({"split_state": False}, 1, TOL_H),
    ({"diagonal": False}, 0, TOL_Y),
    ({"zero_state_at": 3}, 0, TOL_Y),
], ids=["design", "state-in-one-pass", "diagonal-dropped",
        "chunk-3-state-zeroed"])
def test_planted_faults_fail_the_limits(mutant_inputs, fault, which, limit):
    args, (yp, hp) = mutant_inputs
    y, h = emulate(*args, MUTANT[5], **(fault or {}))
    errs = (_err(y, yp), _err(h, hp))
    if fault is None:
        assert errs[0] <= TOL_Y and errs[1] <= TOL_H, errs
    else:
        assert errs[which] > limit, (fault, errs)


def test_split_keeps_the_state_at_fp32_level(mutant_inputs):
    """The state in two passes is far inside the h_last limit, and one
    pass of every fp32 operand costs y several times its error."""
    args, (yp, hp) = mutant_inputs
    y, h = emulate(*args, MUTANT[5])
    y1, h1 = emulate(*args, MUTANT[5], split_state=False)
    assert _err(h, hp) < TOL_H / 10 < _err(h1, hp)


def test_tile_constants_fit_the_card():
    """Two warpgroups own a chunk's 64-row halves, one 16-row tile a warp,
    and a third the state; the block's shared memory (two stages of C and
    B bf16 and x's columns, two sets of x^T, w x^T hi and lo, two sets of
    h^T hi and lo, dt, two sets of four fp32 rows of cum, dt, w and the
    column factors and exp(cum_end), ten mbarriers, 1 KB to align the
    tiles to the 128-byte swizzle) fits the 227 KB a block may use, and
    TC_BLOCKS_PER_SM blocks (each with the 1 KB the runtime keeps) fit the
    SM's 228 KB; their threads, at the 168 registers that the launch bound
    leaves, fit the SM's 65,536."""
    assert TC_WARPS == 12 and 8 * MMA == TC_Q and TC_N <= 8 * MMA
    assert TC_Q == ssd_kernel.MAX_CHUNK and TC_N == ssd_kernel.MAX_STATE
    stage = 2 * TC_Q * TC_N * 2 + TC_Q * TC_PS * 2
    tile_t = TC_PS * TC_Q * 2
    smem = (2 * stage + 2 * tile_t + 2 * tile_t + 4 * tile_t + TC_Q * 4
            + 2 * (4 * TC_Q * 4 + 16) + 10 * 8 + 1024)
    assert smem <= 232_448
    assert TC_BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024
    assert TC_BLOCKS_PER_SM * 32 * TC_WARPS * 168 <= 65_536
