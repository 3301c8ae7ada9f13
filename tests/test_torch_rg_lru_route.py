"""The RG-LRU scan's routes, on the CPU: the carried-state branch of the
port's `rglru_apply` (the carry folded into step 0, then the zero-state
scan of `kernels/rg_lru`) against the sequential recurrence from h0, bit
for bit, and against the JAX package's associative `_scan`; and the
wrapper's choice between the TMA ring and the generic kernel, pinned.

The CUDA kernels run only on a GPU; `chip_smoke.py` holds both routes to
the plain version there.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as rg_kernel  # noqa: E402
from repro_torch.kernels.rg_lru import ops as rg_ops  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

# (B, S, C): a two-step chunk (one step takes the decode branch), ragged
# lengths and widths
SHAPES = [(1, 2, 8), (2, 37, 8), (3, 64, 33), (2, 129, 64)]


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def _branch(monkeypatch, B, S, C, h0_dtype, seed):
    """Run the carried-state branch of `rglru_apply` on one layer of width
    C, recording the gates' (a, bx) before the fold and the scan's h.
    Returns (a, bx, h0, h, new_state)."""
    cfg = configs.scaled_down(configs.get_config("recurrentgemma-9b"),
                              n_layers=3, window=8, dtype="float32")
    cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(cfg.rglru,
                                                             d_rnn=C))
    p = rglru.rglru_init(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32))
    conv = torch.from_numpy(rng.standard_normal(
        (B, cfg.rglru.conv_width - 1, C)).astype(np.float32))
    state = rglru.RGLRUState(h0.to(h0_dtype), conv)
    seen = {}
    gates, scan = rglru._gates, rg_ops.rg_lru_scan

    def spy_gates(*args):
        a, bx = gates(*args)
        seen["a"], seen["bx"] = a.clone(), bx.clone()
        return a, bx

    def spy_scan(a, b):
        seen["h"] = scan(a, b)
        return seen["h"]

    monkeypatch.setattr(rglru, "_gates", spy_gates)
    monkeypatch.setattr(rg_ops, "rg_lru_scan", spy_scan)
    _, new_state = rglru.rglru_apply(p, cfg, x, state=state)
    return seen["a"], seen["bx"], state.h, seen["h"], new_state


@pytest.mark.parametrize("h0_dtype", [torch.float32, torch.bfloat16],
                         ids=["h0_f32", "h0_bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_carried_state_branch_equals_sequential_recurrence(monkeypatch,
                                                           shape, h0_dtype):
    """h_t = a_t h_{t-1} + bx_t from h_{-1} = h0, two rounded torch
    operations a step: the fold then the scan from zero give it bit for
    bit (fmul(a_0, 0) + bx_0' is bx_0')."""
    B, S, C = shape
    a, bx, h0, h, new_state = _branch(monkeypatch, B, S, C, h0_dtype,
                                      sum(shape))
    assert h.dtype == torch.float32 and h.shape == (B, S, C)
    want, ht = [], h0.float()
    for t in range(S):
        ht = a[:, t] * ht
        ht = ht + bx[:, t]
        want.append(ht)
    assert torch.equal(_bits(h), _bits(torch.stack(want, 1)))
    assert new_state.h.dtype == h0_dtype
    assert torch.equal(_bits(new_state.h), _bits(want[-1].to(h0_dtype)))


@pytest.mark.parametrize("shape", SHAPES[1:],
                         ids=lambda s: "x".join(map(str, s)))
def test_carried_state_branch_matches_jax_scan(monkeypatch, shape):
    """The same branch against the reference's `_scan(a, bx, h0)` (an
    associative scan; XLA rounds in another order): 1e-6 relative."""
    B, S, C = shape
    a, bx, h0, h, _ = _branch(monkeypatch, B, S, C, torch.float32, 7)
    want = np.asarray(jrglru._scan(jnp.asarray(a.numpy()),
                                   jnp.asarray(bx.numpy()),
                                   h0=jnp.asarray(h0.numpy())))
    err = np.abs(h.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-6, err


F32, BF16 = torch.float32, torch.bfloat16
ROUTES = [
    # B, C, dtype, data pointers, route
    (1, 4096, F32, (0, 1 << 20), "rg_lru"),        # RG-9B forward
    (4, 4096, F32, (0, 1 << 20), "rg_lru"),        # RG-9B prefill
    (3, 1000, F32, (16, 48), "rg_lru"),            # C % 4 == 0, tail
    (3, 999, F32, (0, 0), "rg_lru_generic"),       # C % 4 != 0
    (1, 33, F32, (0, 0), "rg_lru_generic"),
    (1, 1002, F32, (0, 0), "rg_lru_generic"),      # C % 4 == 2
    (2, 512, BF16, (0, 0), "rg_lru"),
    (2, 520, BF16, (0, 0), "rg_lru"),              # C % 8 == 0, tail
    (2, 1004, BF16, (0, 0), "rg_lru_generic"),     # C % 8 == 4
    (1, 4096, F32, (4, 0), "rg_lru_generic"),      # a one element in
    (1, 4096, F32, (0, 8), "rg_lru_generic"),      # b two elements in
    (1, 4096, BF16, (2, 2), "rg_lru_generic"),     # one bf16 element in
    (1, 4096, BF16, (32, 16), "rg_lru"),           # 16-byte offsets
    (70000, 4096, F32, (0, 0), "rg_lru"),          # the ring's grid is flat
    (65535, 4096, F32, (4, 4), "rg_lru_generic"),  # the generic grid's limit
]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in (c[0], c[1], c[2], *c[3])))
def test_route_choice(case):
    B, C, dt, ptrs, want = case
    assert rg_kernel.route(B, C, dt, *ptrs) == want


def test_route_refuses_what_no_kernel_takes():
    """Unaligned inputs beyond the generic grid's 65535 batch rows."""
    with pytest.raises(ValueError, match="65535"):
        rg_kernel.route(65536, 4096, F32, 4, 0)
    with pytest.raises(ValueError, match="65535"):
        rg_kernel.route(70000, 999, F32, 0, 0)


@pytest.mark.parametrize("offset,want", [(0, "rg_lru"), (1, "rg_lru_generic"),
                                         (2, "rg_lru_generic"),
                                         (4, "rg_lru")])
def test_route_of_offset_views(offset, want):
    """A view `offset` fp32 elements into a 64-byte aligned storage, as the
    wrapper sees it (`data_ptr`)."""
    B, S, C = 1, 5, 64
    store = torch.empty(B * S * C + 64)
    skip = (-store.data_ptr() // 4) % 16   # to the next 64-byte boundary
    a = store[skip + offset:skip + offset + B * S * C].view(B, S, C)
    b = torch.empty(B, S, C)
    assert a.is_contiguous() and b.data_ptr() % 16 == 0
    assert rg_kernel.route(B, C, a.dtype, a.data_ptr(), b.data_ptr()) == want


def test_launch_counts_name_both_routes():
    rg_kernel.LAUNCHES["rg_lru_generic"] += 3
    rg_kernel.reset_launches()
    assert rg_ops.LAUNCHES == {"rg_lru": 0, "rg_lru_generic": 0}
