"""What the captured DAS super-step rests on, checked on the CPU at
`tests/test_differential.py` size.

- **No host sync.** On a GPU the simulator records a block of super-steps
  in one CUDA graph (`core/simulator.py`), which is possible only if the
  block never waits for the device: no `.item()`, no `bool(tensor)`, no
  op whose output shape depends on the data. A block of each mode runs
  here under a dispatch mode that raises on those.
- **The fused push rows.** `ref.avail_rows_reference`, the plain version
  of the `avail_rows` kernel, gathers its inputs from the simulator's
  state itself. It is held bit for bit to the JAX package's `push_rows`
  (its `ref.py` and its Pallas kernel in interpret mode) fed by the same
  gathers done in numpy.
- **The search kernel's cell walk.** `etf_search_fixed` in
  `csrc/etf_ft.cu` walks a scenario's cells lane by lane (32 lanes, each
  taking float4 l, l + 32, l + 64, each float4's four cells in order,
  keeping its first minimum), then reduces the lanes by shuffles that keep
  the smaller value and, on a tie, the smaller index. That order is
  written out below in plain torch and held to `ref._first_min` on inputs
  full of ties; mutations of the tie-break must be caught. Only the
  kernel's fixed [R, P] is read from the CUDA source; the kernel itself
  is held to the plain version on the card, by `chip_smoke.py` phase 3.
"""
import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.kernels.etf_ft import kernel as jkernel, ref as jref  # noqa: E402
from repro_torch.core import convert, soc, simulator as sim, workloads  # noqa: E402
from repro_torch.kernels.etf_ft import kernel, ref  # noqa: E402

SRC = (Path(kernel.__file__).resolve().parent / "csrc"
       / "etf_ft.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


R_PATH, P_PATH = _const("kPathR"), _const("kPathP")
LANES, VEC = 32, 4      # a warp; a float4
BIG = np.float32(3.4e38)


# ---------------------------------------------------------------------------
# no host sync in a block of super-steps
# ---------------------------------------------------------------------------
class _NoHostSync(TorchDispatchMode):
    """Raise on an op that makes the host wait for the device: reading a
    scalar out, or an output whose shape depends on the data."""

    BANNED = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
              "masked_select", "unique", "_unique", "_unique2",
              "unique_dim", "unique_consecutive"}

    MASK_INDEXED = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        # indexing by a bool mask takes the mask's nonzero inside the op
        masked = name in self.MASK_INDEXED and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in args[1] if i is not None)
        if name in self.BANNED or masked:
            raise AssertionError(f"host sync in the super-step: aten.{name}")
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _stacked():
    cells = [(m, r) for m in (0, 1, 4, 5) for r in (0, 9, 13)]
    return workloads.default_suite(n_instances=10).build_many(cells)


def _engine(mode):
    params = sim.make_params(device="cpu")
    wl = sim._engine_workload(_stacked(), torch.device("cpu"))
    ctx = sim._make_ctx(params, wl)
    rng = np.random.RandomState(mode)
    # a tree that splits on the rate, so DAS takes both schedulers
    tree = convert.dtree_from_numpy(
        np.array([sim.FEAT_RATE, 0, 0], np.int32),
        np.array([float(rng.uniform(100, 900)), 1e9, -1e9], np.float32),
        np.array([0, 0, 1, 1], np.int32), device="cpu")
    tree = sim.DTree(*[x.expand(ctx.S, *x.shape) for x in tree])
    thr = torch.full((ctx.S,), 900.0)
    max_iters = 3 * ctx.T + ctx.I + 64
    s = sim._init_state(ctx, wl)
    it = torch.zeros(ctx.S, dtype=torch.int64)

    def block(st, i):
        return sim._block(ctx, mode, params, st, wl, tree, thr, i, max_iters)

    return block, s, it, wl, max_iters


@pytest.mark.parametrize("mode", list(sim.MODE_NAMES),
                         ids=lambda m: sim.MODE_NAMES[m])
def test_a_block_of_super_steps_has_no_host_sync(mode):
    block, s, it, wl, max_iters = _engine(mode)
    s, it = block(s, it)     # the warm-up block: every phase has work next
    assert bool(sim._running(wl, s, it, max_iters).any())
    with _NoHostSync():
        s2, it2 = block(s, it)
        sim._running(wl, s2, it2, max_iters)
    assert bool((it2 > it).any())     # the block retired events
    assert int(s2.d_ptr.sum()) > int(s.d_ptr.sum())


def test_the_dispatch_mode_catches_a_sync():
    with pytest.raises(AssertionError, match="host sync"):
        with _NoHostSync():
            bool(torch.ones(3).any())
    with pytest.raises(AssertionError, match="host sync"):
        with _NoHostSync():
            torch.arange(4)[torch.arange(4) > 1]


def test_eager_entry_point_matches_simulate_batch_on_the_cpu():
    """On the CPU both entry points run the eager loop: the same result."""
    params = sim.make_params(device="cpu")
    tree = sim.always_fast_tree("cpu")
    tree = sim.DTree(*[x.expand(12, *x.shape) for x in tree])
    thr = torch.full((12,), 900.0)
    tel = []
    a = sim.simulate_batch(sim.MODE_ETF, params, _stacked(), tree, thr, tel)
    b = sim._simulate_eager(sim.MODE_ETF, params, _stacked(), tree, thr)
    assert tel[0]["steps"] % sim.POLL_EVERY == 0
    for f in sim.SimResult._fields:
        assert getattr(a, f).numpy().tobytes() == \
            getattr(b, f).numpy().tobytes(), f


# ---------------------------------------------------------------------------
# the fused push rows against JAX's push_rows on numpy gathers
# ---------------------------------------------------------------------------
def _rows_case(seed, S, T, K, MP, special=False):
    """Simulator-layout inputs: every prefix length 0..MP of valid
    predecessors, -1 pads, unscheduled predecessors, and with `special`
    NaN finish times and inf sizes (inf x 0 = NaN costs)."""
    rng = np.random.RandomState(seed)
    cfg = soc.default_soc()
    P = len(cfg.pe_cluster)
    tasks = rng.randint(0, T, size=(S, K)).astype(np.int64)
    preds = rng.randint(-1, T, size=(S, T, MP)).astype(np.int64)
    n_preds = (np.arange(S * T) % (MP + 1)).reshape(S, T).astype(np.int64)
    finish = (rng.uniform(size=S * T + 1) * 1000).astype(np.float32)
    pe_of = rng.randint(-1, P, size=S * T + 1).astype(np.int64)
    finish[pe_of < 0] = np.inf
    out_kb = (rng.uniform(size=(S, T)) * 64).astype(np.float32)
    if special:
        finish[rng.randint(finish.size, size=S * T // 4)] = np.nan
        finish[rng.randint(finish.size, size=S * T // 8)] = -np.inf
        out_kb.reshape(-1)[rng.randint(out_kb.size, size=S * T // 4)] = np.inf
    bases = (rng.uniform(size=(S, K)) * 500).astype(np.float32)
    return (tasks, finish, pe_of, preds, n_preds, out_kb,
            np.float32(cfg.us_per_kb), np.asarray(cfg.pe_cluster, np.int32),
            bases)


def _numpy_gathers(case):
    """The push_rows inputs of `case`, gathered in numpy."""
    tasks, finish, pe_of, preds, n_preds, out_kb, upk, pecl, bases = case
    S, K = tasks.shape
    T, MP = preds.shape[1:]
    lane = np.arange(S)[:, None]
    pr = preds[lane, tasks]                               # [S, K, MP]
    pv = np.arange(MP) < n_preds[lane, tasks][..., None]
    pidx = np.maximum(pr, 0)
    l3 = lane[..., None]
    pfin = np.where(pv, finish[:-1].reshape(S, T)[l3, pidx],
                    np.float32(-np.inf)).astype(np.float32)
    pkb = np.where(pv, out_kb[l3, pidx], np.float32(0)).astype(np.float32)
    pcl = pecl[np.maximum(pe_of[:-1].reshape(S, T)[l3, pidx], 0)]
    return pfin, pkb * upk, pcl.astype(np.int32), pv, pecl, bases


def _same_bits(a, b):
    """Bit equality with NaN anywhere equal to NaN (its payload aside)."""
    a, b = np.asarray(a), np.asarray(b, dtype=np.asarray(a).dtype)
    assert a.shape == b.shape
    na, nb = np.isnan(a), np.isnan(b)
    assert np.array_equal(na, nb)
    assert np.where(na, 0, a).tobytes() == np.where(nb, 0, b).tobytes()


@pytest.mark.parametrize("seed,S,T,K,MP,special", [
    (0, 1, 6, 1, 1, False), (1, 3, 20, 4, 4, False), (2, 5, 30, 4, 4, True),
    (3, 2, 12, 3, 2, True), (4, 7, 40, 4, 6, True)])
def test_avail_rows_reference_matches_jax_push_rows(seed, S, T, K, MP,
                                                   special):
    case = _rows_case(seed, S, T, K, MP, special)
    got = ref.avail_rows_reference(*[torch.as_tensor(x) for x in case])
    assert got.dtype == torch.float32 and got.shape == (S, K, 19)
    gathered = _numpy_gathers(case)
    C = soc.default_soc().cluster_pe_mask.shape[0]
    want = jref.push_rows_reference(*[jnp.asarray(x) for x in gathered], C)
    _same_bits(got.numpy(), want)
    want_k = jkernel.push_rows(*[jnp.asarray(x) for x in gathered],
                               interpret=True)
    _same_bits(got.numpy(), want_k)
    if special:
        assert np.isnan(got.numpy()).any()


def test_avail_rows_every_validity_pattern_and_its_base():
    """n_preds 0..MP: a task with no valid predecessor gets its base; the
    indices are int64 as the simulator holds them."""
    case = _rows_case(5, 2, 10, 5, 4)
    tasks = np.arange(10, dtype=np.int64).reshape(2, 5)    # n_preds 0..4
    case = (tasks,) + case[1:]
    t = [torch.as_tensor(x) for x in case]
    assert t[0].dtype == t[2].dtype == t[3].dtype == t[4].dtype == torch.int64
    got = ref.avail_rows_reference(*t)
    gathered = _numpy_gathers(case)
    C = soc.default_soc().cluster_pe_mask.shape[0]
    _same_bits(got.numpy(), jref.push_rows_reference(
        *[jnp.asarray(x) for x in gathered], C))
    none = case[4][np.arange(2)[:, None], tasks] == 0
    np.testing.assert_array_equal(
        got.numpy()[none], np.broadcast_to(case[8][none][:, None],
                                           (int(none.sum()), 19)))


def test_avail_rows_routes_by_device():
    """CPU tensors take the plain version and count no launch; the CUDA
    wrapper refuses them rather than fall back."""
    from repro_torch.kernels.etf_ft import ops
    case = [torch.as_tensor(x) for x in _rows_case(6, 3, 20, 4, 4)]
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.avail_rows(*case), ref.avail_rows_reference(*case))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.avail_rows(*case)


def test_simulator_rows_go_through_avail_rows():
    """The simulator's push rows are `avail_rows` of its state."""
    params = sim.make_params(device="cpu")
    wl = sim._engine_workload(_stacked(), torch.device("cpu"))
    ctx = sim._make_ctx(params, wl)
    s = sim._init_state(ctx, wl)
    rng = np.random.RandomState(0)
    sim._lanes(s.finish, ctx.S).copy_(torch.as_tensor(
        rng.uniform(size=(ctx.S, ctx.T)).astype(np.float32) * 100))
    sim._lanes(s.pe_of, ctx.S).copy_(torch.as_tensor(
        rng.randint(-1, 19, size=(ctx.S, ctx.T))))
    tasks = torch.as_tensor(rng.randint(0, ctx.T, size=(ctx.S, 4)))
    bases = torch.as_tensor(rng.uniform(size=(ctx.S, 4)).astype(np.float32))
    got = sim._avail_rows(params, wl, s, tasks, bases)
    want = ref.avail_rows_reference(
        tasks, s.finish, s.pe_of, wl.preds, wl.n_preds, wl.out_kb,
        params.us_per_kb, params.pe_cluster, bases)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the fixed search kernel's cell walk and reduction order
# ---------------------------------------------------------------------------
def test_fixed_kernel_is_the_paths_shape():
    assert (R_PATH, P_PATH) == (sim.R_MAX, soc.N_PES)
    assert R_PATH * P_PATH % VEC == 0      # whole float4 a scenario
    assert R_PATH <= LANES and P_PATH <= LANES    # one ballot a mask


def _masked_values(avail, free, exec_t, now, slot_ok, pe_alive):
    """[S, R*P]: each cell's finish time, BIG where masked or not finite,
    as the kernel computes it before the walk."""
    ft = torch.maximum(torch.maximum(avail, free[:, None, :]),
                       now[:, None, None]) + exec_t
    ok = slot_ok[:, :, None] & torch.isfinite(ft)
    if pe_alive is not None:
        ok = ok & pe_alive[:, None, :]
    return torch.where(ok, ft, torch.tensor(BIG)).flatten(1)


def cell_walk(v, lane_le=False, tie="smaller"):
    """The kernel's order over v [S, R*P] -> (value, flat index). Lanes
    keep their first minimum (`lane_le` keeps the last, a mutation); the
    shuffle-down reduction breaks ties to the smaller index (`tie`:
    "larger" or "none" are mutations)."""
    S, RP = v.shape
    V = RP // VEC
    K = -(-V // LANES)
    lane = torch.arange(LANES)
    best = torch.full((S, LANES), float("inf"))
    bidx = torch.full((S, LANES), 2 ** 31 - 1, dtype=torch.int64)
    for k in range(K):
        j = lane + LANES * k
        for q in range(VEC):
            c = VEC * j + q
            val = v[:, c.clamp_max(RP - 1)]
            better = (val <= best) if lane_le else (val < best)
            upd = (j < V) & better
            best = torch.where(upd, val, best)
            bidx = torch.where(upd, c, bidx)
    for off in (16, 8, 4, 2, 1):
        src = (lane + off).clamp_max(LANES - 1)
        has = lane + off < LANES          # __shfl_down_sync keeps its own
        ov = torch.where(has, best[:, src], best)
        oi = torch.where(has, bidx[:, src], bidx)
        if tie == "smaller":
            take = (ov < best) | ((ov == best) & (oi < bidx))
        elif tie == "larger":
            take = (ov < best) | ((ov == best) & (oi > bidx))
        else:
            take = ov < best
        best = torch.where(take, ov, best)
        bidx = torch.where(take, oi, bidx)
    return best[:, 0], bidx[:, 0]


def _tie_case(seed, S, special=False):
    """Masked-search inputs at the path's shape, quantised so that many
    cells tie for the minimum."""
    rng = np.random.RandomState(seed)
    R, P = R_PATH, P_PATH
    avail = np.round(rng.uniform(size=(S, R, P)) * 2) * 5
    free = np.round(rng.uniform(size=(S, P)) * 2) * 5
    ex = np.where(rng.uniform(size=(S, R, P)) < 0.3, np.inf,
                  np.round(rng.uniform(size=(S, R, P)) * 2))
    now = rng.uniform(size=S) * 3
    slot_ok = rng.uniform(size=(S, R)) < 0.7
    alive = rng.uniform(size=(S, P)) < 0.8
    if special:
        slot_ok[0] = False
        avail.reshape(-1)[rng.randint(avail.size, size=8)] = np.nan
        ex.reshape(-1)[rng.randint(ex.size, size=8)] = -np.inf
    return tuple(torch.as_tensor(x) for x in (
        avail.astype(np.float32), free.astype(np.float32),
        ex.astype(np.float32), now.astype(np.float32), slot_ok, alive))


@pytest.mark.parametrize("seed,special", [(0, False), (1, True), (2, False)])
@pytest.mark.parametrize("alive", [True, False])
def test_cell_walk_keeps_the_first_global_minimum(seed, special, alive):
    case = _tie_case(seed, 64, special)
    pe_alive = case[5] if alive else None
    v = _masked_values(*case[:5], pe_alive)
    val, idx = cell_walk(v)
    want_val, want_idx = ref._first_min(v)
    assert torch.equal(idx, want_idx)
    assert val.numpy().tobytes() == want_val.numpy().tobytes()
    ft_min, sl, pe, ok = ref.etf_ft_masked_reference(*case[:5], pe_alive)
    assert torch.equal((idx // P_PATH).int(), sl)
    assert torch.equal((idx % P_PATH).int(), pe)
    assert torch.equal(val < float(BIG), ok)


@pytest.mark.parametrize("mutation", [{"lane_le": True}, {"tie": "larger"},
                                      {"tie": "none"}],
                         ids=["lane keeps last", "tie to larger", "no tie"])
def test_cell_walk_mutations_are_caught(mutation):
    """Each way of breaking the tie-break differs from the first global
    minimum on inputs full of ties."""
    case = _tie_case(3, 256)
    v = _masked_values(*case[:5], case[5])
    _, want_idx = ref._first_min(v)
    _, idx = cell_walk(v, **mutation)
    assert not torch.equal(idx, want_idx)
