"""The port's flash attention and RG-LRU plain versions against the JAX
package's Pallas kernels in interpret mode, and the ops' dispatch by
device on the CPU.

The CUDA kernels run only on a GPU; `chip_smoke.py` holds them to these
plain versions there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import kernel as jfa, ref as jfar  # noqa: E402
from repro.kernels.rg_lru import kernel as jrg, ref as jrgr  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel, ops as fa_ops, ref as fa_ref)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rg_lru import (  # noqa: E402
    kernel as rg_kernel, ops as rg_ops, ref as rg_ref)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402

# the shapes of tests/test_kernels.py::FLASH_CASES
FLASH_CASES = [
    # B, S, H, K, D, window, softcap, dtype
    (1, 256, 4, 4, 64, 0, 0.0, "float32"),     # MHA
    (2, 256, 8, 2, 64, 0, 0.0, "float32"),     # GQA
    (1, 256, 4, 1, 128, 0, 0.0, "float32"),    # MQA, d128
    (1, 512, 4, 2, 64, 128, 0.0, "float32"),   # sliding window
    (1, 256, 4, 4, 64, 0, 30.0, "float32"),    # softcap
    (2, 256, 8, 2, 64, 0, 0.0, "bfloat16"),    # bf16
    (1, 384, 6, 3, 32, 0, 0.0, "float32"),     # non-128 block tail (S=384)
]
# the acceptance tolerances: fp32 arithmetic in both, summed in another
# order; bf16 output rounds to 2^-8 relative
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _qkv(seed, B, S, H, K, D, dt):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, K, K)]
    j = [jnp.asarray(a).astype(dt) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dt)) for a in arrs]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_plain_matches_pallas_interpret(case):
    B, S, H, K, D, W, cap, dt = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(sum(case[:5]), B, S, H, K, D, dt)
    want = jfa.flash_attention_fwd(jq, jk, jv, causal=True, window=W,
                                   softcap=cap, block_q=128, block_k=128,
                                   interpret=True)
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, window=W,
                                 softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= TOL[dt], (case, err)


@pytest.mark.parametrize("S,W", [(100, 0), (100, 16), (1, 0)])
def test_flash_plain_ragged_length_matches_jax_ref(S, W):
    """Lengths that are no multiple of a block (the CUDA kernel masks its
    own edge): the plain version against the JAX plain version."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(S + W, 1, S, 4, 2, 32, "float32")
    want = jfar.mha_reference(jq, jk, jv, causal=True, window=W)
    got = fa_ref.mha_reference(tq, tk, tv, causal=True, window=W)
    assert np.abs(_f32(got) - _f32(want)).max() <= 1e-5


@pytest.mark.parametrize("shape", [(1, 32, 128), (2, 64, 256), (1, 96, 384)])
def test_rg_lru_plain_matches_pallas_interpret(shape):
    """Shapes of tests/test_kernels.py::test_rg_lru_vs_oracle. XLA may fuse
    a*h + b into an FMA where torch rounds twice: 1e-5 absolute."""
    B, S, C = shape
    rng = np.random.RandomState(S + C)
    a = rng.uniform(0.6, 0.999, size=shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    want = jrg.rg_lru_fwd(jnp.asarray(a), jnp.asarray(b), chunk=16,
                          block_c=128, interpret=True)
    got = rg_ops.rg_lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_rg_lru_plain_bf16_and_odd_width():
    """bf16 in, bf16 out, fp32 inside, at an odd channel count."""
    shape = (2, 40, 77)
    rng = np.random.RandomState(3)
    a = rng.uniform(0.6, 0.999, size=shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = jrgr.rg_lru_reference(ja, jb)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    got = rg_ref.rg_lru_reference(ta, tb)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative of |h| < 1)
    assert np.abs(_f32(got) - _f32(want)).max() <= 8e-3


def test_ops_dispatch_by_device():
    """CPU tensors take the plain versions and launch nothing; a tensor
    on another device is an error; the CUDA wrappers refuse CPU tensors
    rather than fall back."""
    (_, _, _), (q, k, v) = _qkv(0, 1, 8, 2, 1, 16, "float32")
    a = torch.rand(1, 8, 5)
    b = torch.rand(1, 8, 5)
    before = (dict(fa_ops.LAUNCHES), dict(rg_ops.LAUNCHES))
    assert torch.equal(fa_ops.flash_attention(q, k, v, window=4),
                       fa_ref.mha_reference(q, k, v, window=4))
    assert torch.equal(rg_ops.rg_lru_scan(a, b),
                       rg_ref.rg_lru_reference(a, b))
    assert (dict(fa_ops.LAUNCHES), dict(rg_ops.LAUNCHES)) == before
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rg_ops.rg_lru_scan(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        rg_kernel.rg_lru_fwd(a, b)


@pytest.mark.parametrize("lib,name", [(fa_kernel.LIBRARY, "flash_attention"),
                                      (rg_kernel.LIBRARY, "rg_lru"),
                                      (ssd_kernel.LIBRARY, "ssd_scan"),
                                      ("tmp", "toy")])
def test_library_path_is_keyed_by_source(lib, name, tmp_path):
    if lib == "tmp":
        # a library over a csrc/ of its own: an edit to its header, a new
        # file beside it or other flags give a new path; the same files
        # and flags the same path
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "toy.cu").write_text('#include "toy.cuh"\n')
        (csrc / "toy.cuh").write_text("#define N 1\n")
        lib = _build.Library(name, csrc / "toy.cu", _build.BASE_FLAGS,
                             lambda cdll: None)
        first = lib.path()
        assert _build.Library(name, csrc / "toy.cu", _build.BASE_FLAGS,
                              lambda cdll: None).path() == first
        (csrc / "toy.cuh").write_text("#define N 2\n")
        second = lib.path()
        assert second != first
        (csrc / "extra.cuh").write_text("\n")
        third = lib.path()
        assert third not in (first, second)
        flags = _build.BASE_FLAGS + ("-Xptxas", "-v")
        assert _build.Library(name, csrc / "toy.cu", flags,
                              lambda cdll: None).path() != third
        assert lib.ptxas_lines() == []   # never built
    path = lib.path()
    assert path.parent.name == "repro_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in lib.flags


def test_library_path_is_keyed_by_shared_headers(tmp_path):
    """An edit to a header of a shared include directory gives every
    library that includes it a new path, as an edit to its own source
    does; flash attention and the SSD scan both read `kernels/include/`
    (`ptx.cuh`)."""
    csrc, inc = tmp_path / "csrc", tmp_path / "include"
    csrc.mkdir()
    inc.mkdir()
    (inc / "shared.cuh").write_text("#define N 1\n")
    libs = []
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text('#include "shared.cuh"\n')
        libs.append(_build.Library(name, csrc / f"{name}.cu",
                                   _build.BASE_FLAGS, lambda cdll: None,
                                   include_dirs=(inc,)))
    first = [lib.path() for lib in libs]
    assert _build.Library("one", csrc / "one.cu", _build.BASE_FLAGS,
                          lambda cdll: None).path() != first[0]
    (inc / "shared.cuh").write_text("#define N 2\n")
    second = [lib.path() for lib in libs]
    assert all(a != b for a, b in zip(first, second))
    (inc / "shared.cuh").write_text("#define N 1\n")
    assert [lib.path() for lib in libs] == first
    for lib in (fa_kernel.LIBRARY, ssd_kernel.LIBRARY):
        assert lib.include_dirs == (_build.INCLUDE_DIR,)
        assert (_build.INCLUDE_DIR / "ptx.cuh").is_file()
        assert not (lib.src.parent / "ptx.cuh").exists()
