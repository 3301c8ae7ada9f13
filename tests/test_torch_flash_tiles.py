"""The arithmetic of the bf16 tensor-core flash kernel, emulated on the CPU.

`csrc/flash_attention.cu` (`flash_fwd_wgmma_kernel`) runs only on a GPU. The
emulation below repeats its algorithm in plain torch: the same block of
128 query rows over the same heads per block, the same 64-key tiles and
tile range, the element mask only on the tiles the kernel masks, scores in
log2 units with log2(e) / sqrt(Dh) folded into one multiply, exp2, the
`-inf` guard for rows that have seen only masked keys, P rounded to bf16
before P V, and the head width padded with zero columns. It is held to
the port's plain version and to the JAX package's, within the bf16
tolerance that `chip_smoke.py` holds the kernel to on the card.

These tests check the design, written out a second time in Python; only
the tile sizes are read from the CUDA source. The kernel's own tile loop
and edge rule are checked only on the card, by `chip_smoke.py` phase 3.
"""
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ref as jfar  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel, ref as fa_ref)

SRC = (Path(fa_kernel.__file__).resolve().parent / "csrc"
       / "flash_attention.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


M = _const("MMA_M")      # query rows a block
BK = _const("MMA_BK")    # keys a tile
LOG2E = 1.4426950408889634
TOL = 2e-2               # chip_smoke.py's TOL_FLASH["bfloat16"]


def heads_per_block(H: int, K: int) -> int:
    """Query heads of a KV group in a block of M rows: 2 for an even
    group (64 positions of two heads), else 1."""
    return 2 if (H // K) % 2 == 0 else 1


def padded_width(Dh: int) -> int:
    return next(d for d in (64, 128, 256) if Dh <= d)


def tile_range(q0, q_last, S, causal, window):
    """[t_lo, t_hi): the KV tiles that meet the rows q0 .. q_last."""
    kv_lo = max(0, q0 - window + 1) if window else 0
    kv_hi = q_last + 1 if causal else S
    return kv_lo // BK, (kv_hi + BK - 1) // BK


def is_edge(t, q0, q_last, S, causal, window):
    """Whether tile t runs the element mask."""
    k0 = t * BK
    return bool((causal and k0 + BK - 1 > q0)
                or (window and k0 <= q_last - window) or k0 + BK > S)


def band(qi, kj, S, causal, window):
    ok = kj < S
    if causal:
        ok = ok & (kj <= qi)
    if window:
        ok = ok & (kj > qi - window)
    return ok


def emulate(q, k, v, *, causal=True, window=0, softcap=0.0, hpb=None):
    """The kernel's algorithm on bf16 q [B,S,H,Dh], k/v [B,S,K,Dh]."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    hpb = heads_per_block(H, K) if hpb is None else hpb
    bq = M // hpb
    DP = padded_width(Dh)
    n_qt = -(-S // bq)
    n_kt = -(-S // BK)
    # zero columns to DP, zero rows to whole tiles (TMA's zero fill)
    qp = torch.zeros(B, n_qt * bq, H, DP)
    qp[:, :S, :, :Dh] = q.float()
    kp = torch.zeros(B, n_kt * BK, K, DP)
    vp = torch.zeros(B, n_kt * BK, K, DP)
    kp[:, :S, :, :Dh] = k.float()
    vp[:, :S, :, :Dh] = v.float()
    out = torch.zeros(B, S, H, Dh)
    inv_sqrt = 1.0 / math.sqrt(Dh)
    for b in range(B):
        for h0 in range(0, H, hpb):
            kh = h0 // G
            for qt in range(n_qt):
                q0 = qt * bq
                q_last = min(q0 + bq, S) - 1
                qi = torch.arange(q0, q0 + bq)[:, None]
                Q = qp[b, q0:q0 + bq, h0:h0 + hpb].transpose(0, 1)
                acc = torch.zeros(hpb, bq, DP)
                m = torch.full((hpb, bq, 1), -math.inf)
                l = torch.zeros(hpb, bq, 1)
                t_lo, t_hi = tile_range(q0, q_last, S, causal, window)
                for t in range(t_lo, t_hi):
                    k0 = t * BK
                    Kt = kp[b, k0:k0 + BK, kh]
                    Vt = vp[b, k0:k0 + BK, kh]
                    s = Q @ Kt.T
                    if softcap:
                        s = torch.tanh(s * inv_sqrt / softcap) * (softcap
                                                                  * LOG2E)
                    else:
                        s = s * (inv_sqrt * LOG2E)
                    if is_edge(t, q0, q_last, S, causal, window):
                        kj = torch.arange(k0, k0 + BK)[None, :]
                        s = s.masked_fill(~band(qi, kj, S, causal, window),
                                          -math.inf)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(s - m_use)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + p.bfloat16().float() @ Vt
                    m = m_new
                o = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
                n = q_last + 1 - q0
                out[b, q0:q_last + 1, h0:h0 + hpb] = (
                    o[:, :n, :Dh].transpose(0, 1))
    return out.to(q.dtype)


# B, S, H, K, Dh, window, softcap, causal: the new phase-3 edges of
# chip_smoke.py, scaled down
CASES = [
    (1, 300, 4, 1, 40, 0, 0.0, True),      # Dh 40, ragged S, MQA
    (2, 200, 4, 2, 20, 0, 0.0, True),      # Dh 20, GQA G 2
    (1, 77, 6, 3, 20, 16, 30.0, True),     # Dh 20, W 16, softcap
    (1, 333, 8, 1, 64, 100, 0.0, True),    # window across tiles
    (1, 260, 2, 2, 32, 16, 0.0, True),     # MHA, W 16 below a tile
    (1, 129, 4, 4, 128, 0, 50.0, True),    # one row past a block, softcap
    (2, 65, 4, 2, 256, 0, 0.0, True),      # Dh 256, S 65
    (1, 150, 2, 1, 32, 0, 0.0, False),     # no causal mask
    (1, 1, 2, 1, 16, 0, 0.0, True),        # S = 1
]


def _qkv(seed, B, S, H, K, D):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, K, K)]
    t = [torch.from_numpy(a).bfloat16() for a in arrs]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    return t, j


def _err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b).astype(jnp.float32))
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_matches_both_plain_versions(case):
    B, S, H, K, D, W, cap, causal = case
    (q, k, v), (jq, jk, jv) = _qkv(sum(case[:5]) + W, B, S, H, K, D)
    got = emulate(q, k, v, causal=causal, window=W, softcap=cap)
    want = fa_ref.mha_reference(q, k, v, causal=causal, window=W,
                                softcap=cap)
    jwant = jfar.mha_reference(jq, jk, jv, causal=causal, window=W,
                               softcap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= TOL, case
    assert _err(got, jwant) <= TOL, case


@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_emulated_kernel_at_each_heads_per_block(G):
    """Each group size, and so each heads per block the kernel picks (1
    for G 1 and 3, 2 for the even ones), gives the same function: tile
    ranges and edges are taken per block of positions."""
    (q, k, v), _ = _qkv(G, 1, 200, 2 * G, 2, 32)
    got = emulate(q, k, v, window=70)
    want = fa_ref.mha_reference(q, k, v, window=70)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("S,causal,window,bq", [
    (4096, True, 2048, 64), (4097, True, 2048, 128), (300, True, 16, 32),
    (333, True, 100, 16), (200, False, 0, 128), (150, False, 40, 64),
    (65, True, 0, 128)])
def test_tile_range_and_edges_are_exact(S, causal, window, bq):
    """Skipping the tiles outside [t_lo, t_hi) and the mask on the tiles
    that are not edges drops no in-band pair and keeps no masked one."""
    pos = torch.arange(S)
    for q0 in range(0, S, bq):
        q_last = min(q0 + bq, S) - 1
        qi = pos[q0:q_last + 1, None]
        t_lo, t_hi = tile_range(q0, q_last, S, causal, window)
        for t in range(-(-S // BK)):
            kj = torch.arange(t * BK, (t + 1) * BK)[None, :]
            ok = band(qi, kj, S, causal, window)
            if not t_lo <= t < t_hi:
                assert not bool(ok.any()), (q0, t)
            elif not is_edge(t, q0, q_last, S, causal, window):
                assert bool(ok.all()), (q0, t)


def test_masked_rows_take_the_guard():
    """A row whose first tiles are all masked (keys past S, or before the
    window) keeps m = -inf without a NaN: exp2(-inf - 0) = 0."""
    s = torch.full((1, 4, BK), -math.inf)
    m = torch.full((1, 4, 1), -math.inf)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
    assert bool((torch.exp2(m - m_use) == 0).all())
    assert bool((torch.exp2(s - m_use) == 0).all())


def test_tile_constants_fit_the_card():
    """Q and a ring of 2 K and 2 V slots at Dh 256, the 9 mbarriers and
    the 1 KB of alignment slack fit the 227 KB a block may use; the
    consumer warpgroups own 64 rows each, the 16-key steps of P V divide a
    tile."""
    assert M % 64 == 0 and BK % 16 == 0
    smem = 2 * (M + 4 * BK) * 256 + 9 * 8 + 1024
    assert smem <= 232_448
