"""The port's SSD scan and Mamba-2 SSD block against the JAX package's, on
the same inputs (numpy seeds) and the same parameters (`models/convert.py`),
on the CPU.

The plain scan (`kernels/ssd_scan/ref.py`) is held to the JAX Pallas
kernel in interpret mode and to the JAX sequential reference at the
shapes of `tests/test_kernels.py` (1e-4 absolute in fp32, 3e-2 relative
in bf16: its tolerances). The block's functions are held to
`repro.models.ssd` in fp32 within 1e-5 relative (the chunked and the
sequential forms sum in other orders). The CUDA kernel runs only on a
GPU; `chip_smoke.py` holds it to the plain version there.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ssd_scan import kernel as jkernel  # noqa: E402
from repro.kernels.ssd_scan import ops as jops, ref as jref  # noqa: E402
from repro.models import lm as jlm, ssd as jssd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel, ops, ref  # noqa: E402
from repro_torch.models import convert, ssd  # noqa: E402

ARCH = "mamba2-780m"
# the shapes of tests/test_kernels.py::test_ssd_vs_sequential_oracle:
# B, S, H, P, N, chunk
SHAPES = [(1, 32, 2, 8, 4, 16), (2, 64, 3, 16, 8, 16), (1, 128, 2, 16, 16, 32)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _inputs(seed, B, S, H, P, N, G):
    """x, dt, A, B, C as numpy, drawn as the reference's tests draw them."""
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(arrs, dtypes=None):
    dtypes = dtypes or ["float32"] * len(arrs)
    j = [jnp.asarray(a).astype(d) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(getattr(torch, d))
         for a, d in zip(arrs, dtypes)]
    return j, t


# ---------------------------------------------------------------------------
# the plain scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_ssd_plain_matches_pallas_interpret_and_jax_ref(shape):
    B, S, H, P, N, Q = shape
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(sum(shape), B, S, H, P, N, H))
    y, h = ref.ssd_reference(tx, tdt, tA, tB, tC)
    assert y.dtype == torch.float32 and h.shape == (B, H, N, P)
    yk, hk = jkernel.ssd_fwd(jx, jdt, jA, jB, jC, chunk=Q, interpret=True)
    yr, hr = jref.ssd_reference(jx, jdt, jA, jB, jC)
    for got, want in ((y, yk), (h, hk), (y, yr), (h, hr)):
        assert np.abs(_np(got) - _np(want)).max() < 1e-4


def test_ssd_plain_bf16_tolerance():
    """tests/test_kernels.py::test_ssd_bf16_tolerance: bf16 x, fp32 inside,
    bf16 y against the fp32 reference."""
    B, S, H, P, N, Q = 1, 64, 2, 16, 8, 16
    x, dt, A, Bm, Cm = _inputs(5, B, S, H, P, N, H)
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        [x, dt, A, Bm, Cm], ["bfloat16"] + ["float32"] * 4)
    y, _ = ref.ssd_reference(tx, tdt, tA, tB, tC)
    assert y.dtype == torch.bfloat16
    yk, _ = jkernel.ssd_fwd(jx, jdt, jA, jB, jC, chunk=Q, interpret=True)
    y32, _ = jref.ssd_reference(jx.astype(jnp.float32), jdt, jA, jB, jC)
    assert _rel(y, y32) < 3e-2 and _rel(y, yk) < 3e-2


@pytest.mark.parametrize("G", [1, 2])
def test_ops_ssd_expands_groups_as_jax(G):
    """`ops.ssd` with B and C per group against the JAX `ops.ssd` (which
    repeats them to heads and runs the Pallas kernel in interpret mode)."""
    B, S, H, P, N, Q = 2, 48, 4, 8, 8, 16
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(10 + G, B, S, H, P, N, G))
    y, h = ops.ssd(tx, tdt, tA, tB, tC, chunk=Q)
    yj, hj = jops.ssd(jx, jdt, jA, jB, jC, chunk=Q)
    assert np.abs(_np(y) - _np(yj)).max() < 1e-4
    assert np.abs(_np(h) - _np(hj)).max() < 1e-4


def test_ops_dispatch_by_device():
    """CPU tensors take the plain version and launch nothing; a chunk that
    does not divide S is a ValueError, as the reference asserts; another
    device is an error; the CUDA wrapper refuses CPU tensors rather than
    fall back."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _inputs(0, 1, 8, 2, 4, 4, 1))
    before = dict(ops.LAUNCHES)
    y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=4)
    want = ref.ssd_reference(x, dt, A, Bm.repeat(1, 1, 2, 1),
                             Cm.repeat(1, 1, 2, 1))
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert dict(ops.LAUNCHES) == before
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd(x, dt, A, Bm, Cm, chunk=3)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd(*(t.to("meta") for t in (x, dt, A, Bm, Cm)), chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_fwd(x, dt, A, Bm, Cm, chunk=4)


def test_library_path_is_keyed_by_source():
    path = kernel.LIBRARY.path()
    assert path.parent.name == "repro_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("ssd_scan-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in kernel.LIBRARY.flags
    assert kernel.LIBRARY.src.name == "ssd_scan.cu"


# ---------------------------------------------------------------------------
# the block's functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(with_h0):
    B, S, H, P, N, G, Q = 2, 48, 4, 8, 8, 2, 16
    arrs = list(_inputs(20, B, S, H, P, N, G))
    rng = np.random.RandomState(21)
    h0 = (rng.standard_normal((B, H, N, P)) * 0.5).astype(np.float32)
    (jx, jdt, jA, jB, jC, jh0), (tx, tdt, tA, tB, tC, th0) = _both(
        arrs + [h0])
    y, h = ssd.ssd_chunked(tx, tdt, tA, tB, tC, Q,
                           h0=th0 if with_h0 else None)
    yj, hj = jssd.ssd_chunked(jx, jdt, jA, jB, jC, Q,
                              h0=jh0 if with_h0 else None)
    assert h.dtype == torch.float32
    assert _rel(y, yj) <= 1e-5 and _rel(h, hj) <= 1e-5
    # the chunked form is the sequential recurrence
    ys, hs = ops.ssd(tx, tdt, tA, tB, tC, chunk=Q)
    if not with_h0:
        assert _rel(y, ys) <= 1e-5 and _rel(h, hs) <= 1e-5


def test_ssd_step_matches_jax():
    B, H, P, N, G = 2, 4, 8, 8, 2
    rng = np.random.RandomState(22)
    arrs = [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((B, H, P), (B, G, N), (B, G, N), (B, H, N, P))]
    dt = (np.abs(rng.standard_normal((B, H))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    (jx, jB, jC, jh, jdt, jA), (tx, tB, tC, th, tdt, tA) = _both(
        arrs + [dt, A])
    y, h = ssd.ssd_step(tx, tdt, tA, tB, tC, th)
    yj, hj = jssd.ssd_step(jx, jdt, jA, jB, jC, jh)
    assert _rel(y, yj) <= 1e-6 and _rel(h, hj) <= 1e-6


def _ssd_cfgs(n_groups=1, dtype="float32", **kw):
    kw = dict(n_layers=2, dtype=dtype, **kw)
    jc = jconfigs.scaled_down(jconfigs.get_config(ARCH), use_pallas=True,
                              **kw)
    tc = configs.scaled_down(configs.get_config(ARCH), **kw)
    if n_groups != 1:
        jc = dataclasses.replace(jc, ssd=dataclasses.replace(
            jc.ssd, n_groups=n_groups))
        tc = dataclasses.replace(tc, ssd=dataclasses.replace(
            tc.ssd, n_groups=n_groups))
    return jc, tc


@pytest.mark.parametrize("n_groups", [1, 2])
def test_ssd_apply_stateless_prefill_and_decode(n_groups):
    """One SSD layer on the reference's parameters: stateless (the scan
    kernel in interpret mode against the port's plain scan), a prefill in
    two chunks carrying state (the plain chunked form with h0 on both
    sides), then one-token decode steps."""
    jc, tc = _ssd_cfgs(n_groups)
    jp = jax.jit(lambda key: jlm.lm_init(key, jc))(jax.random.PRNGKey(3))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                      "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0]["attn"])
    tl = tp["stack"]["groups"][0][0]["attn"]
    assert set(tl._parameters) | set(tl._modules) == set(jl)
    B, S = 2, 40
    rng = np.random.RandomState(23)
    xa = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xa), torch.from_numpy(xa)
    apply_j = jax.jit(lambda x, s: jssd.ssd_apply(jl, jc, x, state=s))
    with torch.inference_mode():
        jy, _ = apply_j(jx, None)
        ty, tstate = ssd.ssd_apply(tl, tc, tx)
        assert tstate is None and _rel(ty, jy) <= 1e-5
        sc = jc.ssd
        _, nh = jssd.ssd_dims(jc)
        args = (B, nh, sc.d_state, sc.head_dim, sc.conv_width, sc.n_groups)
        js, ts = jssd.SSDState.init(*args), ssd.SSDState.init(*args)
        for lo, hi in [(0, 24), (24, 36)] + [(t, t + 1) for t in range(36, S)]:
            jy, js = apply_j(jx[:, lo:hi], js)
            ty, ts = ssd.ssd_apply(tl, tc, tx[:, lo:hi], state=ts)
            assert _rel(ty, jy) <= 1e-5, (lo, hi)
            for a, b in zip(ts, js):
                assert a.dtype == torch.float32 and _rel(a, b) <= 1e-5
