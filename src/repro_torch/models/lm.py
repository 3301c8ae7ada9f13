"""Language-model wrapper of the port: embeddings, the block stack, the
heads, the LM loss, and the scoring and serving entry points, on the JAX
package's `models/lm.py`.

Batch conventions, as in the reference:
    tokens  [B, S], or [B, K, S] for K codebook streams (MusicGen)
    labels  same shape, -100 = ignore
    prefix_embeds [B, P, D] optional (PaliGemma's patch embeddings, a
        stub frontend), put before the token embeddings; the prefix
        positions attend to each other both ways when cfg.prefix_lm.

scoring:
    forward(p, cfg, tokens, caches=None) -> (logits, None, aux)
    loss_fn(p, cfg, batch) -> (loss, metrics)
serving:
    init_caches(cfg, batch, max_len) -> caches
    prefill(p, cfg, tokens, caches) -> (last_logits, caches)
    decode_step(p, cfg, token, pos, caches) -> (logits, caches), on CUDA
        a CUDA graph kept for the weights and caches where the step
        allows one

Parameters live in an `LM` module whose parameter names are the
reference's dict keys; the functions on tensors are plain functions, as
in the reference. `loss_fn` scores: the port has no gradient step.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.device import resolve
from repro_torch.models import mla, transformer
from repro_torch.models import modules as nn
from repro_torch.parallel import sharding as shd

IGNORE = -100


class LM(nn.Params):
    """All parameters of one model: `embed` [V, D] ([K, V, D] for K
    codebooks), `stack` ("prologue": a list of layers, "groups": per
    pattern slot a list of layers, one per group), `final_norm` [D] and,
    when untied, `head` [D, V] ([K, D, V])."""


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def embed_init(generator: torch.Generator, cfg) -> torch.Tensor:
    K, V = cfg.n_codebooks, cfg.vocab_padded
    shape = (K, V, cfg.d_model) if K > 1 else (V, cfg.d_model)
    return nn.truncated_normal(generator, shape, 0.02)


def head_init(generator: torch.Generator, cfg) -> torch.Tensor:
    K, V = cfg.n_codebooks, cfg.vocab_padded
    shape = (K, cfg.d_model, V) if K > 1 else (cfg.d_model, V)
    return nn.truncated_normal(generator, shape, 0.02)


def lm_init(cfg, generator: torch.Generator, device="cuda") -> LM:
    """Random parameters drawn from `generator`, which must live on
    `device` (the GPU unless the caller asks for the CPU): the embedding,
    the stack in `transformer.init_order`, then the untied head."""
    cfg.validate()
    dev = resolve(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: draw them on the same device")
    p: Dict[str, Any] = {
        "embed": embed_init(generator, cfg),
        "stack": transformer.stack_init(generator, cfg),
        "final_norm": torch.ones(cfg.d_model, device=generator.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = head_init(generator, cfg)
    return LM(p)


def _scale(cfg, dt):
    """cfg.embed_scale rounded to the compute dtype, as jnp.asarray does."""
    return float(torch.tensor(cfg.embed_scale, dtype=dt))


def _lookup(table, tokens):
    """Rows `tokens` of `table`. Under a sharding policy each rank looks
    its tokens up in the whole table, gathered (DTensor's rules for a
    lookup in a split vocabulary, and for the indexing's backward, do not
    hold on every torch version); the table's gradient comes back as a
    partial sum over the batch's axes."""
    if not shd.is_dtensor(table):
        return table[tokens]
    rows = shd.spec_of(tokens)
    return shd.local_call(lambda t, i: t[i], (table, tokens),
                          ((None,) * table.ndim, rows), (rows + (None,),))


def _embed(p, cfg, tokens):
    """Gather, then cast: the same values as the reference's cast of the
    whole table before the gather, without the table-sized copy. K
    codebooks' embeddings are summed in order in the compute dtype."""
    dt = compute_dtype(cfg)
    if cfg.n_codebooks > 1:           # tokens [B, K, S]
        x = _lookup(p["embed"][0], tokens[:, 0]).to(dt)
        for k in range(1, cfg.n_codebooks):
            x = x + _lookup(p["embed"][k], tokens[:, k]).to(dt)
    else:
        x = _lookup(p["embed"], tokens).to(dt)
    if cfg.embed_scale:
        x = x * _scale(cfg, dt)
    return x


def _head(p, cfg, x):
    """x [B, S, D] -> logits [B, S, V] ([B, K, S, V] for K codebooks)."""
    if cfg.n_codebooks > 1 and shd.is_dtensor(x):
        # one product a codebook (DTensor cannot flatten the codebook
        # and vocab dims of a stack whose vocab is split)
        w = p["embed"] if cfg.tie_embeddings else p["head"]
        logits = torch.stack(
            [nn.linear(x, (w[k].T if cfg.tie_embeddings else w[k])
                       .to(x.dtype)) for k in range(cfg.n_codebooks)], 1)
    elif cfg.tie_embeddings:
        if cfg.n_codebooks > 1:
            logits = torch.einsum("bsd,kvd->bksv", x,
                                  p["embed"].to(x.dtype))
        else:
            logits = nn.linear(x, p["embed"].to(x.dtype).T)
    elif cfg.n_codebooks > 1:
        logits = torch.einsum("bsd,kdv->bksv", x, p["head"].to(x.dtype))
    else:
        logits = nn.linear(x, p["head"])
    if cfg.vocab_padded != cfg.vocab:   # mask padding rows
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits + torch.where(pad, -1e9, 0.0).to(logits.dtype)
    return logits


def forward(p, cfg, tokens, prefix_embeds=None, positions=None,
            caches=None, cache_pos=None, kv_valid=None,
            head_mode: str = "all"):
    """Full forward over tokens [B, S] ([B, K, S]). head_mode: "all" |
    "last" (only the final position's logits, as prefill) | "none" (the
    final hidden states). The prefix positions are dropped before the
    head. `cache_pos` is the cache offset of the first token: a host int,
    or, on a stack of MLA blocks alone, an int64 tensor [1] read on the
    device (a captured decode step's position), which writes the same
    values. Returns (logits_or_hidden, new_caches, aux_loss)."""
    x = _embed(p, cfg, tokens)
    B = x.shape[0]
    n_pre = 0
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype)
        if cfg.embed_scale:
            pe = pe * _scale(cfg, x.dtype)
        x = torch.cat([pe, x], dim=1)
        n_pre = prefix_embeds.shape[1]
    S = x.shape[1]
    if cache_pos is not None and not (torch.is_tensor(cache_pos)
                                      and cache_pos.ndim == 1):
        cache_pos = int(cache_pos)      # a 0-d tensor is read on the host
    if positions is None:
        base = 0 if cache_pos is None else cache_pos
        positions = (base + torch.arange(S, dtype=torch.int32,
                                         device=x.device)
                     ).to(torch.int32)[None].expand(B, S)
    prefix_len = None
    if cfg.prefix_lm and n_pre:
        prefix_len = torch.full((B,), n_pre, dtype=torch.int32,
                                device=x.device)
    x = shd.constrain(x, ("batch", "seq", None))
    x, new_caches, aux = transformer.stack_apply(
        p["stack"], cfg, x, positions, prefix_len=prefix_len, caches=caches,
        cache_pos=cache_pos, kv_valid=kv_valid)
    # the head and the loss read whole sequences (sequence parallelism
    # split them over "model"; a no-op otherwise)
    x = shd.constrain(nn.rms_norm(x, p["final_norm"], cfg.norm_eps),
                      ("batch", None, None))
    if n_pre:
        x = x[:, n_pre:]
    if head_mode == "none":
        return x, new_caches, aux
    if head_mode == "last":
        x = x[:, -1:]
    return _head(p, cfg, x), new_caches, aux


# ---------------------------------------------------------------------------
# the LM loss
# ---------------------------------------------------------------------------
def _ce_from_logits(cfg, logits, labels):
    """(sum of the token cross entropies in fp32, count of labelled
    tokens) over logits [..., V] and labels [...]."""
    logits = logits.float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    mask = labels != IGNORE
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    if shd.is_dtensor(logits):
        # a DTensor, its vocab dim maybe sharded: pick the gold logit by a
        # comparison with the vocab index, which shards as the logits do
        # and sums exactly (one value and zeros) where `gather` would
        # need the whole row
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == safe[..., None], logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def loss_fn(p, cfg, batch, loss_chunk: int = 1024
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy (+ MoE aux loss) of batch["tokens"]
    against batch["labels"] (and batch["prefix_embeds"], optional).

    Where S > loss_chunk and is a multiple of it, the head and the CE run
    in chunks of `loss_chunk` positions, summed in order in fp32, so the
    full [B, S, V] fp32 logits are never materialised."""
    labels = batch["labels"]
    hidden, _, aux = forward(p, cfg, batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"),
                             head_mode="none")
    S = hidden.shape[1]
    if loss_chunk and S > loss_chunk and S % loss_chunk == 0:
        nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        n_sum = torch.zeros((), dtype=torch.int64, device=hidden.device)
        for lo in range(0, S, loss_chunk):
            logits = _head(p, cfg, hidden[:, lo:lo + loss_chunk])
            nll, n = _ce_from_logits(cfg, logits,
                                     labels[..., lo:lo + loss_chunk])
            nll_sum, n_sum = nll_sum + nll, n_sum + n
            del logits
    else:
        nll_sum, n_sum = _ce_from_logits(cfg, _head(p, cfg, hidden), labels)
    denom = torch.clamp(n_sum, min=1).float()
    ce = nll_sum / denom
    total = ce + aux
    return total, {"loss": total, "ce": ce,
                   "aux": torch.as_tensor(aux, dtype=torch.float32,
                                          device=hidden.device),
                   "ntok": denom}


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------
def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cuda"):
    return transformer.stack_cache_init(cfg, batch, max_len, dtype,
                                        resolve(device))


def _at(logits, i: int):
    """Position i of [B, S, V] or [B, K, S, V] logits."""
    return logits[:, i] if logits.ndim == 3 else logits[:, :, i]


def prefill(p, cfg, tokens, caches, prefix_embeds=None, kv_valid=None):
    """Prefill from position 0 (the prefix first, when given). Returns
    (last_logits [B, V] or [B, K, V], caches)."""
    logits, caches, _ = forward(p, cfg, tokens, prefix_embeds=prefix_embeds,
                                caches=caches, cache_pos=0,
                                kv_valid=kv_valid, head_mode="last")
    return _at(logits, 0), caches


def decode_step(p, cfg, token, pos: int, caches, kv_valid=None,
                positions=None):
    """One decode step. token [B] (or [B, K]); pos is the cache offset of
    the token. Returns (logits [B, V] or [B, K, V], caches).

    Where the step can be captured (`_eager_reason` finds nothing), it
    runs as a CUDA graph recorded over `caches` at their first step and
    replayed at each later step on them (`_graph_step`), kept while the
    weights and the caches live. Either way the step writes `caches` in
    place and returns them, and the logits are a fresh tensor."""
    layers = _layer_caches(caches)
    if _eager_reason(p, token, layers, kv_valid, positions) is None:
        return _graph_step(p, cfg, token, int(pos), caches, layers)
    STEP_GRAPH_COUNTS["eager_steps"] += 1
    return _step(p, cfg, token, pos, caches, kv_valid, positions)


def _step(p, cfg, token, pos, caches, kv_valid=None, positions=None):
    logits, caches, _ = forward(p, cfg, token[..., None], caches=caches,
                                cache_pos=pos, kv_valid=kv_valid,
                                positions=positions)
    return _at(logits, 0), caches


# ---------------------------------------------------------------------------
# kept decode graphs
# ---------------------------------------------------------------------------
# A decode step launches thousands of small kernels, one after another
# from the host. Recorded once in a CUDA graph over the caller's caches,
# it replays in one launch at every later step on them. A graph is kept
# while its weights and its caches live: it holds them by weak
# references, which drop it with either, so it holds no memory of a dead
# model or of a finished batch (nor a copy of any cache), and never
# replays over freed buffers. New caches, such as the next batch's, are
# captured anew. A device's captures share one memory pool for their
# transients, since they replay one at a time. `STEP_GRAPH_COUNTS`
# counts, for the process, what the calls did.
STEP_GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager_steps": 0}
# the absorbed MLA attention's calls by route ("kernel": the MLA decode
# kernel, "plain": the tensor chain), as a step runs or is recorded
MLA_DECODE_COUNTS = mla.MLA_DECODE_COUNTS
_STEP_GRAPHS: Dict[tuple, "_StepGraph"] = {}
_SIDE: Dict[torch.device, tuple] = {}    # a device's side stream and pool
_WARM: set = set()          # the step shapes run once before a capture
_SERIAL = itertools.count()


class _StepGraph:
    """A kept decode step: its graph (None until captured, and for
    caches whose capture found no room: those step eagerly), its static
    inputs (the token, and the position as an int64 [1]), its output
    logits, and the weak references that drop it."""

    __slots__ = ("graph", "eager", "token", "pos", "logits", "refs")


def clear_step_graphs() -> None:
    """Drop every kept decode step."""
    _STEP_GRAPHS.clear()


def _layer_caches(caches) -> list:
    """Each layer's cache in the order `stack_apply` runs them; [] for
    no caches."""
    if not isinstance(caches, dict):
        return []
    return [*caches["prologue"], *(c for slot in caches["groups"]
                                   for c in slot)]


def _eager_reason(p, token, layers, kv_valid, positions) -> Optional[str]:
    """Why a decode step must run eagerly, or None where a kept graph can
    run it: a graph replays the same kernels on the same buffers, so
    nothing in the step may be read on the host or vary but the token and
    the position it copies in."""
    if positions is not None:
        return "positions"          # the caller's own, any shape
    if kv_valid is not None:
        return "kv_valid"
    if torch.is_grad_enabled():
        return "autograd"
    if not isinstance(p, torch.nn.Module):
        return "weights"            # a graph holds them weakly
    if shd.active_mesh() is not None:
        return "mesh"
    # an MLA cache is written at the position alone; a window's ring
    # buffer and the recurrent states are written at host positions or
    # by the port's kernels
    if not layers or not all(isinstance(c, mla.MLACache)
                             and not shd.is_dtensor(c.c_kv)
                             for c in layers):
        return "layers"
    dev = token.device
    if any(t.device != dev for c in layers for t in c) \
            or not _capturable(dev):
        return "device"
    return None


def _capturable(dev: torch.device) -> bool:
    """Whether a CUDA graph can record on `dev` now."""
    return dev.type == "cuda" and not torch.cuda.is_current_stream_capturing()


def _shape(cfg, token, layers) -> tuple:
    """The shape of a step: device, configuration, token shape, each
    layer's cache shapes and dtypes, and inference mode (a buffer made
    under it cannot be written outside it)."""
    return (token.device, cfg, tuple(token.shape),
            tuple((c.c_kv.shape, c.c_kv.dtype, c.k_rope.shape,
                   c.k_rope.dtype) for c in layers),
            torch.is_inference_mode_enabled())


def _graph_step(p, cfg, token, pos: int, caches, layers):
    """`decode_step` through the graph kept for these weights and these
    caches (captured on their first call): fills the token and the
    position and replays, writing the caches in place."""
    key = (id(p), *(id(t) for c in layers for t in c),
           *_shape(cfg, token, layers))
    e = _STEP_GRAPHS.get(key)
    if e is None:
        e = _new_entry(key, p, token, layers)
    if e.eager:
        STEP_GRAPH_COUNTS["eager_steps"] += 1
        return _step(p, cfg, token, pos, caches)
    e.token.copy_(token)
    e.pos.fill_(pos)
    if e.graph is None and not _capture(key, e, p, cfg, caches, layers):
        STEP_GRAPH_COUNTS["eager_steps"] += 1
        return _step(p, cfg, token, pos, caches)
    e.graph.replay()
    STEP_GRAPH_COUNTS["replays"] += 1
    return e.logits.clone(), caches


def _new_entry(key, p, token, layers) -> _StepGraph:
    """An entry for `key`, dropped when its weights or any of its cache
    buffers go (the ids in `key` are then free for other objects)."""
    e = _StepGraph()
    e.graph = e.logits = None
    e.eager = False
    e.token = token.clone()
    e.pos = torch.zeros(1, dtype=torch.int64, device=token.device)
    n = next(_SERIAL)

    def drop(_, k=key, n=n):
        kept = _STEP_GRAPHS.get(k)
        if kept is not None and kept.refs[0] == n:
            del _STEP_GRAPHS[k]

    e.refs = [n, weakref.ref(p, drop),
              *(weakref.ref(t, drop) for c in layers for t in c)]
    _STEP_GRAPHS[key] = e
    return e


def _capture(key, e: _StepGraph, p, cfg, caches, layers) -> bool:
    """Record the step over `caches` into `e.graph` on a side stream, its
    transients in the device's pool; a shape's first capture runs the step
    once eagerly before (what initialises itself on a first call does so
    outside the capture; it writes the row that the replay then writes
    again, with the same values). Where the pool finds no room for the
    transients, the entry is marked to step eagerly and False returned.
    Any other failure drops the entry and raises."""
    dev = e.token.device
    if dev not in _SIDE:
        _SIDE[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
    (side, pool), here = _SIDE[dev], torch.cuda.current_stream(dev)
    shape = _shape(cfg, e.token, layers)
    side.wait_stream(here)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            if shape not in _WARM:
                _step(p, cfg, e.token, e.pos, caches)
                _WARM.add(shape)
        with torch.cuda.graph(g, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            e.logits, _ = _step(p, cfg, e.token, e.pos, caches)
    except torch.cuda.OutOfMemoryError:
        here.wait_stream(side)
        e.eager, e.logits = True, None
        return False
    except BaseException:
        _STEP_GRAPHS.pop(key, None)
        raise
    here.wait_stream(side)
    e.graph = g
    STEP_GRAPH_COUNTS["captures"] += 1
    return True


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------
def param_count(p) -> int:
    return sum(t.numel() for t in p.parameters())


def active_param_count(cfg, params) -> int:
    """Active (per-token) parameter count: embeddings + non-expert weights
    + top_k/E of the routed experts' weights + shared experts. A routed
    expert leaf is found as in the reference: named w_gate, w_up or w_down
    under an "mlp" and not under "shared", with the expert count in its
    leading dims."""
    total = param_count(params)
    if cfg.mlp_type != "moe":
        return total
    E = cfg.moe.n_experts
    e_total = 0
    for name, leaf in params.named_parameters():
        keys = name.split(".")
        if (keys[-1] in ("w_gate", "w_up", "w_down") and "mlp" in keys
                and "shared" not in keys and leaf.ndim >= 3
                and E in tuple(leaf.shape[:-2])):
            e_total += leaf.numel()
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - e_total * (1.0 - frac))


def model_flops_per_token(cfg, n_params: Optional[int] = None,
                          params=None) -> float:
    """6*N per token for training (forward and backward); N = active
    params."""
    if n_params is None:
        if params is None:
            raise ValueError("need params")
        n_params = active_param_count(cfg, params)
    return 6.0 * n_params
