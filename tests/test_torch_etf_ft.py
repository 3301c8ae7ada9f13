"""The port's decision kernels (plain versions on the CPU) against the JAX
package's `ref.py` and its Pallas kernels in interpret mode, bit for bit.

The CUDA kernels themselves run only on a GPU; `chip_smoke.py` holds
them to these plain versions there.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.etf_ft import kernel as jkernel, ref as jref  # noqa: E402
from repro_torch.kernels.etf_ft import kernel, ops, ref  # noqa: E402

P, C = 19, 6


def _masked_case(seed, s, r, ties=False):
    """The structure of `test_kernels._masked_case`, drawn with numpy."""
    rng = np.random.RandomState(seed)
    avail = (rng.uniform(size=(s, r, P)) * 10).astype(np.float32)
    free = (rng.uniform(size=(s, P)) * 10).astype(np.float32)
    ex = np.where(rng.uniform(size=(s, r, P)) < 0.3, np.inf,
                  rng.uniform(size=(s, r, P)) * 5).astype(np.float32)
    if ties:
        # quantize hard so many (slot, pe) pairs tie for the minimum
        avail = (np.round(avail / 5) * 5).astype(np.float32)
        free = (np.round(free / 5) * 5).astype(np.float32)
        ex = np.round(ex).astype(np.float32)
    now = (rng.uniform(size=s) * 3).astype(np.float32)
    slot_ok = rng.uniform(size=(s, r)) < 0.7
    alive = rng.uniform(size=(s, P)) < 0.8
    return avail, free, ex, now, slot_ok, alive


def _push_case(seed, s, k, mp, pv=None):
    rng = np.random.RandomState(seed)
    pfin = (rng.uniform(size=(s, k, mp)) * 100).astype(np.float32)
    cost = (rng.uniform(size=(s, k, mp)) * 10).astype(np.float32)
    pcl = rng.randint(0, C, size=(s, k, mp)).astype(np.int32)
    if pv is None:
        pv = rng.uniform(size=(s, k, mp)) < 0.6
    pecl = rng.randint(0, C, size=P).astype(np.int32)
    bases = (rng.uniform(size=(s, k)) * 50).astype(np.float32)
    return pfin, cost, pcl, pv, pecl, bases


def _t(case):
    return tuple(torch.as_tensor(x) for x in case)


def _j(case):
    return tuple(jnp.asarray(x) for x in case)


def _assert_same(got, want, tag=""):
    for a, b in zip(got, want):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.tobytes() == b.astype(a.dtype).tobytes(), tag
        assert a.shape == b.shape, tag


MASKED = [(seed, s, r, ties) for seed, (s, r) in enumerate(
    [(1, 2), (1, 16), (3, 7), (6, 24), (4, 16), (2, 5)])
    for ties in (False, True)]


@pytest.mark.parametrize("seed,s,r,ties", MASKED)
def test_masked_search_matches_jax_ref(seed, s, r, ties):
    case = _masked_case(seed, s, r, ties)
    for alive in (case[5], None):
        want = jref.etf_ft_masked_reference(
            *_j(case[:5]), None if alive is None else jnp.asarray(alive))
        got = ref.etf_ft_masked_reference(
            *_t(case[:5]), None if alive is None else torch.as_tensor(alive))
        _assert_same(got, want, (seed, s, r, ties, alive is None))
        assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool


def test_masked_search_all_masked_lane():
    """Everything masked -> slot 0 / pe 0, feasible False."""
    s, r = 2, 4
    avail = torch.ones((s, r, P))
    free = torch.zeros((s, P))
    ex = torch.ones((s, r, P))
    now = torch.zeros(s)
    slot_ok = torch.zeros((s, r), dtype=torch.bool)
    alive = torch.ones((s, P), dtype=torch.bool)
    _, sl, pe, ok = ref.etf_ft_masked_reference(avail, free, ex, now,
                                                slot_ok, alive)
    assert not sl.any() and not pe.any() and not ok.any()
    want = jref.etf_ft_masked_reference(
        *[jnp.asarray(x.numpy()) for x in (avail, free, ex, now, slot_ok,
                                           alive)])
    _assert_same(ref.etf_ft_masked_reference(avail, free, ex, now, slot_ok,
                                             alive), want)


def test_masked_search_special_values():
    """+-inf and NaN cells never win, as in the reference."""
    case = list(_masked_case(11, 3, 8))
    rng = np.random.RandomState(0)
    for arr, val, n in ((case[0], np.inf, 6), (case[0], -np.inf, 6),
                        (case[2], -np.inf, 4), (case[0], np.nan, 4),
                        (case[1], np.nan, 2)):
        arr.reshape(-1)[rng.randint(arr.size, size=n)] = val
    case[4][0] = False
    _assert_same(ref.etf_ft_masked_reference(*_t(case)),
                 jref.etf_ft_masked_reference(*_j(case)))


@pytest.mark.parametrize("seed,b,r", [(0, 1, 2), (1, 4, 16), (2, 8, 32),
                                      (3, 3, 7)])
def test_unmasked_search_matches_jax_ref(seed, b, r):
    avail, free, ex, _, _, _ = _masked_case(seed, b, r)
    now = np.zeros(b, np.float32)
    case = (avail, free, ex, now)
    _assert_same(ref.etf_ft_reference(*_t(case)),
                 jref.etf_ft_reference(*_j(case)))


@pytest.mark.parametrize("seed,s,k,mp", [(0, 1, 1, 1), (1, 2, 4, 4),
                                         (2, 4, 8, 6), (3, 3, 5, 2)])
def test_push_rows_matches_jax_ref(seed, s, k, mp):
    case = _push_case(seed, s, k, mp)
    _assert_same([ref.push_rows_reference(*_t(case), C)],
                 [jref.push_rows_reference(*_j(case), C)])


def test_push_rows_every_validity_pattern():
    mp = 4
    pats = (np.arange(2 ** mp)[:, None] >> np.arange(mp)) & 1 > 0  # [16, 4]
    pv = np.broadcast_to(pats[None], (3, 16, mp)).copy()
    case = _push_case(5, 3, 16, mp, pv=pv)
    got = ref.push_rows_reference(*_t(case), C)
    _assert_same([got], [jref.push_rows_reference(*_j(case), C)])
    # a row with no valid predecessor is its base
    np.testing.assert_array_equal(got[:, 0, :].numpy(),
                                  np.broadcast_to(case[5][:, :1], (3, P)))


@pytest.mark.parametrize("seed,s,r,ties", [(0, 2, 8, False),
                                           (1, 3, 16, True)])
def test_masked_search_matches_pallas_interpret(seed, s, r, ties):
    case = _masked_case(seed, s, r, ties)
    want = jkernel.etf_ft_search_masked(*_j(case), interpret=True)
    _assert_same(ref.etf_ft_masked_reference(*_t(case)), want)


def test_unmasked_search_matches_pallas_interpret():
    avail, free, ex, now, _, _ = _masked_case(4, 3, 8)
    case = (avail, free, ex, np.zeros(3, np.float32))
    want = jkernel.etf_ft_search(*_j(case), interpret=True)
    _assert_same(ref.etf_ft_reference(*_t(case)), want)


@pytest.mark.parametrize("seed,s,k,mp", [(0, 2, 4, 4), (1, 1, 3, 2)])
def test_push_rows_matches_pallas_interpret(seed, s, k, mp):
    case = _push_case(seed, s, k, mp)
    want = jkernel.push_rows(*_j(case), interpret=True)
    _assert_same([ref.push_rows_reference(*_t(case), C)], [want])


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    before = dict(ops.LAUNCHES)
    case = _t(_masked_case(0, 3, 16))
    slot, pe, ok = ops.etf_decide(*case)
    _, s2, p2, ok2 = ref.etf_ft_masked_reference(*case)
    assert torch.equal(slot, s2) and torch.equal(pe, p2)
    assert torch.equal(ok, ok2)
    ops.push_rows(*_t(_push_case(0, 2, 4, 4)), C)
    ops.etf_ft(*case[:4])
    assert ops.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch on the GPU or raise; they never fall back."""
    case = _t(_masked_case(0, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.etf_ft_search_masked(*case)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.etf_ft_search(*case[:4])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.push_rows(*_t(_push_case(0, 2, 4, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.etf_decide(*[x.to("meta") for x in case])


def test_kernel_without_cuda_raises():
    """Asking for the kernels where there is no CUDA toolkit or GPU is an
    error, not a quiet switch to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the error path needs none")
    import shutil
    from pathlib import Path
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(ValueError):
            kernel.etf_ft_search_masked(*_t(_masked_case(0, 1, 2)))
    elif not kernel.library_path().exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            kernel.build()


def test_library_path_is_keyed_by_source():
    path = kernel.library_path()
    assert path.parent.name == "repro_torch"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("etf_ft-") and path.suffix == ".so"
