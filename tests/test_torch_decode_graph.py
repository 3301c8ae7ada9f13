"""The decode step's kept CUDA graphs (`models/lm.py::_graph_step`) and
what they rest on, on the CPU at DeepSeek-V2-Lite's smoke size (a dense
layer and two MoE layers, MLA), with two cases on the card.

- **The device position.** A captured step reads its position from an
  int64 tensor [1] on the device; it must write the same cache rows and
  give the same logits, bit for bit, as the step at the host int.
- **No host sync.** A capture fails on any op that makes the host wait
  for the device: the step runs here under a dispatch mode that raises
  on those, with `torch.bincount` among them (it reads its input's
  maximum on a GPU); the MoE counts experts by a scatter-add instead.
- **The rule.** Only a step that can be captured takes the graph: the
  others run eagerly and the counter says so.
- **The kept graphs.** With `graph_standin.FakeGraph` in place of a CUDA
  graph (holding, as a graph does, no tensor made before the capture)
  the whole path runs here: a capture for each set of caches, replays,
  the entries going with their caches or their weights, a capture with
  no room. Held to the eager step bit for bit.
"""
import contextlib
import functools
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from graph_standin import RECORDING, FakeGraph, fake_capture  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bench import lm_serve  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
STEPS = 16


def _cfg(dtype="bfloat16", absorb=True, arch=ARCH):
    return lm_serve.serving_config(configs.get_smoke_config(
        arch, n_layers=3, dtype=dtype, mla_absorb=absorb))


def _model(cfg, seed, device="cpu"):
    return lm.lm_init(cfg, torch.Generator(device=device).manual_seed(seed),
                      device=device)


def _prefilled(p, cfg, B, P, max_len, seed, device="cpu"):
    """Tokens [B, max_len] drawn from `seed`, and caches of `max_len`
    positions holding the prefill of the first P."""
    g = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, max_len), generator=g,
                         device=device)
    caches = lm.init_caches(cfg, B, max_len, dtype=lm.compute_dtype(cfg),
                            device=device)
    _, caches = lm.prefill(p, cfg, toks[:, :P], caches)
    return toks, caches


def _copy(caches):
    return pytree.tree_map(torch.clone, caches)


def _same(a, b) -> bool:
    return all(torch.equal(x, y)
               for c, d in zip(lm._layer_caches(a), lm._layer_caches(b))
               for x, y in zip(c, d))


def _counts(before: dict) -> dict:
    return {k: v - before[k] for k, v in lm.STEP_GRAPH_COUNTS.items()}


@pytest.fixture(autouse=True)
def _no_kept_graphs():
    """No kept graph before or after; one thread (the smoke model's small
    products run many times slower on several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    lm.clear_step_graphs()
    yield
    lm.clear_step_graphs()
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the step at a device position
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expanded", "absorbed"])
def test_a_device_position_steps_as_the_int(absorb, dtype):
    """Six steps from the same prefill, B = 3: the same logits and the
    same caches, every row, at each position."""
    cfg = _cfg(dtype, absorb)
    p = _model(cfg, 0)
    with torch.inference_mode():
        toks, a = _prefilled(p, cfg, 3, 5, 12, 1)
        b = _copy(a)
        for pos in range(5, 11):
            la, a = lm._step(p, cfg, toks[:, pos], pos, a)
            lb, b = lm._step(p, cfg, toks[:, pos], torch.tensor([pos]), b)
            assert torch.equal(la, lb), pos
            assert _same(a, b), pos


# ---------------------------------------------------------------------------
# the expert count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,E", [((1, 7, 2), 4), ((2, 16, 6), 64),
                                     ((3, 5, 1), 8)])
def test_expert_counts_are_bincounts(shape, E):
    """`moe.expert_counts` gives `torch.bincount`'s integers, experts no
    choice picked included, and the router's aux loss is the one that
    `bincount` gives."""
    g = torch.Generator().manual_seed(sum(shape) + E)
    idx = torch.randint(0, E // 2, shape, generator=g)   # upper half unused
    got = moe.expert_counts(idx, E)
    want = torch.bincount(idx.reshape(-1), minlength=E)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert not got[E // 2:].any()
    logits = torch.randn(*shape[:-1], E, generator=g)
    _, idx, aux = moe.router_topk(logits, shape[-1])
    me = torch.softmax(logits.float(), -1).reshape(-1, E).mean(0)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.numel()
    assert torch.equal(aux, E * torch.sum(me * ce))


# ---------------------------------------------------------------------------
# no host sync
# ---------------------------------------------------------------------------
class _NoHostSync(TorchDispatchMode):
    """Raise on an op that makes the host wait for the device: reading a
    scalar out, an output whose shape depends on the data, or a count
    that reads its input's maximum."""

    BANNED = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
              "masked_select", "unique", "_unique", "_unique2",
              "unique_dim", "unique_consecutive", "bincount",
              "repeat_interleave"}

    MASK_INDEXED = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        masked = name in self.MASK_INDEXED and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in args[1] if i is not None)
        if name in self.BANNED or masked:
            raise AssertionError(f"host sync in the decode step: aten.{name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expanded", "absorbed"])
def test_the_decode_step_reads_nothing_on_the_host(absorb):
    """The step at a device position runs under `_NoHostSync`; the count
    it replaced would not."""
    cfg = _cfg("bfloat16", absorb)
    p = _model(cfg, 0)
    with torch.inference_mode():
        toks, caches = _prefilled(p, cfg, 3, 5, 8, 1)
        with _NoHostSync():
            lm._step(p, cfg, toks[:, 5], torch.tensor([5]), caches)
            with pytest.raises(AssertionError, match="bincount"):
                torch.bincount(toks[:, 0], minlength=4)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
# case: (arch, how the step is called, the reason, whether the device is
# taken as capturable, so that the rule alone decides)
EAGER = {
    "recurrentgemma": ("recurrentgemma-9b", {}, "layers", True),
    "mamba2": ("mamba2-780m", {}, "layers", True),
    "autograd": (ARCH, {"grad": True}, "autograd", True),
    "kv_valid": (ARCH, {"kv_valid": True}, "kv_valid", True),
    "positions": (ARCH, {"positions": True}, "positions", True),
    "cpu": (ARCH, {}, "device", False),
}


@pytest.mark.parametrize("case", list(EAGER))
def test_a_step_that_cannot_be_captured_runs_eagerly(case, monkeypatch):
    """Each case runs the eager step and counts it, keeps nothing, and
    gives the eager logits."""
    arch, how, reason, capturable = EAGER[case]
    if capturable:
        monkeypatch.setattr(lm, "_capturable", lambda dev: True)
    cfg = _cfg("float32", arch=arch)
    p = _model(cfg, 0)
    B, P = 2, 4
    mode = torch.enable_grad() if how.get("grad") else torch.no_grad()
    with mode:
        toks, caches = _prefilled(p, cfg, B, P, 8, 1)
        kw = {}
        if how.get("kv_valid"):
            kw["kv_valid"] = torch.full((B,), P + 1, dtype=torch.int32)
        if how.get("positions"):
            kw["positions"] = torch.full((B, 1), P, dtype=torch.int32)
        assert lm._eager_reason(p, toks[:, P], lm._layer_caches(caches),
                                kw.get("kv_valid"),
                                kw.get("positions")) == reason
        want, _ = lm._step(p, cfg, toks[:, P], P, _copy(caches), **kw)
        before = dict(lm.STEP_GRAPH_COUNTS)
        got, _ = lm.decode_step(p, cfg, toks[:, P], P, caches, **kw)
    assert _counts(before) == {"captures": 0, "replays": 0,
                               "eager_steps": 1}
    assert not lm._STEP_GRAPHS
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kept graphs, with a stand-in graph on the CPU
# ---------------------------------------------------------------------------
class _Stream:
    def __init__(self, *a, **kw):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def standin(monkeypatch):
    """`FakeGraph` for CUDA graphs, streams that do nothing, and the CPU
    taken as capturable."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        functools.partial(fake_capture, weak=True))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(lm, "_capturable", lambda dev: True)
    monkeypatch.setattr(lm, "_SIDE", {})


def _replays_as_eager(cfg, device):
    """Two cache lengths, two batches each, STEPS steps a batch, then a
    second set of weights, one batch a length: every step's logits and
    caches bit-equal to the eager step at the host int, the caller's
    caches written in place and returned, each step's logits its own, one
    graph kept while a batch's caches live and none once they are gone.
    Returns the counts."""
    before = dict(lm.STEP_GRAPH_COUNTS)
    with torch.inference_mode():
        for w, batches in ((0, 2), (1, 1)):
            p = _model(cfg, w, device)
            for P in (5, 9):
                for b in range(batches):
                    toks, caches = _prefilled(p, cfg, 3, P, P + STEPS,
                                              10 * w + P + b, device)
                    ref = _copy(caches)
                    prev = None
                    for i in range(STEPS):
                        got, out = lm.decode_step(p, cfg, toks[:, P + i],
                                                  P + i, caches)
                        want, ref = lm._step(p, cfg, toks[:, P + i], P + i,
                                             ref)
                        assert torch.equal(got, want), (w, P, b, i)
                        assert out is caches and _same(caches, ref), (
                            w, P, b, i)
                        if prev is not None:
                            assert torch.equal(prev[0], prev[1])
                        prev = (got, got.clone())
                    assert len(lm._STEP_GRAPHS) == 1
                    del caches, out
                    assert not lm._STEP_GRAPHS
            del p
    return _counts(before)


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expanded", "absorbed"])
def test_kept_graphs_replay_as_the_eager_step(absorb, standin):
    """One capture a batch, one replay a step."""
    counts = _replays_as_eager(_cfg("bfloat16", absorb), "cpu")
    assert counts == {"captures": 6, "replays": 6 * STEPS, "eager_steps": 0}


def test_live_caches_keep_a_graph_each(standin):
    """Three batches stepped in turn, two of one length: one capture each,
    then replays alone, each over its own caches."""
    cfg = _cfg("float32")
    p = _model(cfg, 0)
    before = dict(lm.STEP_GRAPH_COUNTS)
    with torch.inference_mode():
        batches = [_prefilled(p, cfg, 2, 3, L, n)
                   for n, L in enumerate((8, 8, 10))]
        refs = [_copy(c) for _, c in batches]
        for i in range(3):
            for (toks, caches), j in zip(batches, range(3)):
                got, _ = lm.decode_step(p, cfg, toks[:, 3 + i], 3 + i, caches)
                want, refs[j] = lm._step(p, cfg, toks[:, 3 + i], 3 + i,
                                         refs[j])
                assert torch.equal(got, want) and _same(caches, refs[j])
    assert len(lm._STEP_GRAPHS) == 3
    assert _counts(before) == {"captures": 3, "replays": 9, "eager_steps": 0}


def test_dropped_caches_take_their_graph_with_them(standin):
    """A graph holds the caches weakly and copies none: with the caller's
    caches gone, the entry and its graph go and the caches' memory is
    freed."""
    cfg = _cfg("float32")
    p = _model(cfg, 0)
    with torch.inference_mode():
        toks, caches = _prefilled(p, cfg, 2, 3, 8, 0)
        lm.decode_step(p, cfg, toks[:, 3], 3, caches)
        lm.decode_step(p, cfg, toks[:, 4], 4, caches)
    e, = lm._STEP_GRAPHS.values()
    graph, buf = weakref.ref(e.graph), weakref.ref(caches["prologue"][0][0])
    del e
    del caches
    assert not lm._STEP_GRAPHS and graph() is None and buf() is None


def test_dropped_weights_take_their_graphs_with_them(standin):
    """A graph holds its weights weakly: with them gone, the entry and its
    graph are freed; the caches stay the caller's."""
    cfg = _cfg("float32")
    p = _model(cfg, 0)
    with torch.inference_mode():
        toks, caches = _prefilled(p, cfg, 2, 3, 8, 0)
        _, caches = lm.decode_step(p, cfg, toks[:, 3], 3, caches)
    e, = lm._STEP_GRAPHS.values()
    graph, buf = weakref.ref(e.graph), weakref.ref(caches["prologue"][0][0])
    del e
    assert graph() is not None
    del p
    gc.collect()
    assert not lm._STEP_GRAPHS and graph() is None
    assert buf() is not None
    del caches
    assert buf() is None


def test_a_capture_without_room_steps_eagerly(standin, monkeypatch):
    """Where the graph's pool has no room for the step's transients, the
    capture gives up and these caches step eagerly from then on, without
    trying again; other caches capture."""
    cfg = _cfg("float32")
    p = _model(cfg, 0)
    real = lm._step
    full = [True]

    def step(*a, **kw):
        if RECORDING and full[0]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a, **kw)

    monkeypatch.setattr(lm, "_step", step)
    before = dict(lm.STEP_GRAPH_COUNTS)
    with torch.inference_mode():
        toks, caches = _prefilled(p, cfg, 2, 3, 8, 0)
        ref = _copy(caches)
        for i in range(3):
            got, out = lm.decode_step(p, cfg, toks[:, 3 + i], 3 + i, caches)
            want, ref = real(p, cfg, toks[:, 3 + i], 3 + i, ref)
            assert torch.equal(got, want) and _same(out, ref)
            full[0] = False
        assert _counts(before) == {"captures": 0, "replays": 0,
                                   "eager_steps": 3}
        _, other = _prefilled(p, cfg, 2, 3, 8, 1)
        lm.decode_step(p, cfg, toks[:, 3], 3, other)
    assert _counts(before) == {"captures": 1, "replays": 1, "eager_steps": 3}


def test_a_failed_capture_keeps_nothing(standin, monkeypatch):
    """A capture that raises drops its entry; the next call captures."""
    cfg = _cfg("float32")
    p = _model(cfg, 0)
    real = lm._step

    def failing(*a, **kw):
        if RECORDING:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return real(*a, **kw)

    before = dict(lm.STEP_GRAPH_COUNTS)
    with torch.inference_mode():
        toks, caches = _prefilled(p, cfg, 2, 3, 8, 0)
        monkeypatch.setattr(lm, "_step", failing)
        with pytest.raises(RuntimeError, match="capturing"):
            lm.decode_step(p, cfg, toks[:, 3], 3, caches)
        assert not lm._STEP_GRAPHS
        monkeypatch.setattr(lm, "_step", real)
        got, _ = lm.decode_step(p, cfg, toks[:, 3], 3, caches)
        want, _ = lm._step(p, cfg, toks[:, 3], 3, _copy(caches))
    assert torch.equal(got, want)
    assert _counts(before)["captures"] == 1 and len(lm._STEP_GRAPHS) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    """Skip where there is no GPU; decided when the test runs, never
    while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.card
@pytest.mark.parametrize("absorb", [False, True],
                         ids=["expanded", "absorbed"])
def test_kept_graphs_replay_as_the_eager_step_on_the_card(absorb, card):
    """CUDA graphs replay the eager step's kernels bit for bit."""
    counts = _replays_as_eager(_cfg("bfloat16", absorb), "cuda")
    assert counts == {"captures": 6, "replays": 6 * STEPS, "eager_steps": 0}


@pytest.mark.card
def test_dropped_weights_release_their_graphs_on_the_card(card):
    """With the weights and the returned caches dropped, the device gets
    back at least the weights' and the caches' bytes."""
    cfg = _cfg("bfloat16")
    with torch.inference_mode():
        p = _model(cfg, 0, "cuda")
        toks, caches = _prefilled(p, cfg, 4, 5, 64, 0, "cuda")
        _, caches = lm.decode_step(p, cfg, toks[:, 5], 5, caches)
        del toks
    nbytes = sum(t.numel() * t.element_size() for t in p.parameters())
    nbytes += sum(t.numel() * t.element_size()
                  for c in lm._layer_caches(caches) for t in c)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del p, caches
    gc.collect()
    assert not lm._STEP_GRAPHS
    assert held - torch.cuda.memory_allocated() >= nbytes
