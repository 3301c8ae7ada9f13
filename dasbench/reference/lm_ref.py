"""The plain reference of the language-model lane: DeepSeek-V2's forward
pass (arXiv:2405.04434 §2; the published `config.json` keys) in plain
torch, float32, with no cache, no batching and no kernel of any library
beyond torch's own operations.

It reads the keys a configuration runs the model with (its published
keys, with its `variant` over them: `lm_lane.model`) and nothing of the
program. Weights are the benchmark's, made here from the seed
(`draw_weights`) under this module's own names and layouts (`specs`), and
handed to the program and to `forward` alike; `forward` casts one layer
at a time to float32, so that it fits beside the bfloat16 model.

The block, per token x (pre-norm residual, RMSNorm with the file's
`rms_norm_eps` and a learned scale):

  attention (MLA)  q = x W_q, split per head into q_nope [dn] and
                   q_rope [dr];
                   c = norm(x W_kv_a) [kv_lora_rank]; k_nope = c W_k_b,
                   v = c W_v_b per head; k_rope = x W_k_rope [dr], one for
                   all heads; RoPE on q_rope and k_rope; scores
                   (q_nope.k_nope + q_rope.k_rope) / sqrt(dn + dr), causal;
                   out = softmax(scores) v, then W_o
  MLP              the first `first_k_dense_replace` layers a SwiGLU of
                   `intermediate_size`; the others a MoE: router softmax
                   over `n_routed_experts`, the top `num_experts_per_tok`
                   (weights renormalised when `norm_topk_prob`, times
                   `routed_scaling_factor`), each a SwiGLU of
                   `moe_intermediate_size`, plus `n_shared_experts` shared
                   experts as one SwiGLU of their summed width
  head             final RMSNorm, then W_head (untied)

Departures from the published description, each a key that a
configuration's `variant` sets where the published value differs:

  * `rope_scaling` must be null: plain RoPE at `rope_theta` (DeepSeek-
    V2-Lite has YaRN, factor 40, and its attention scale mscale^2); the
    rotation pairs dimension i with i + dr/2 (the published checkpoint
    stores q_rope and k_rope interleaved and permutes them first: with
    drawn weights the two layouts are one model);
  * `norm_topk_prob` and `routed_scaling_factor` as the file gives them;
    softmax scoring, greedy top-k in one group only (`scoring_func`,
    `topk_method`, `n_group` are checked);
  * no capacity: every routed choice is computed (the published inference
    drops none).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# the controls and planted faults `forward` can compute in the program's
# place: every product of a weight with both operands rounded through
# float8_e4m3fn (the precision below the configuration's bfloat16); the
# shared experts left out; the RoPE part of the keys left out
VARIANTS = ("fp8", "no_shared", "no_rope_k")
FP8_MAX = 448.0              # the largest finite float8_e4m3fn
NORM_STD = 0.1               # a norm scale is drawn as 1 + NORM_STD * N(0, 1)


def check_config(c: dict) -> None:
    """Refuse a configuration whose published keys this reference does
    not compute."""
    need = {"rope_scaling": None, "q_lora_rank": None,
            "scoring_func": "softmax",
            "topk_method": "greedy", "n_group": 1, "topk_group": 1,
            "hidden_act": "silu", "attention_bias": False,
            "tie_word_embeddings": False, "moe_layer_freq": 1}
    bad = {k: c.get(k) for k, v in need.items() if c.get(k, v) != v}
    if bad:
        raise ValueError(f"the reference does not compute {bad}")


def specs(c: dict) -> List[Tuple[str, tuple, Optional[float]]]:
    """Every weight: (name, shape, std); std None is a norm's scale. A
    product's weight keeps the [d_in, d_out] layout and the std
    1/sqrt(d_in), so that the router's and the head's logits have about
    unit spread at any width; the embedding's is 0.02."""
    check_config(c)
    D, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    R = c["kv_lora_rank"]
    E, F_, S = (c["n_routed_experts"], c["moe_intermediate_size"],
                c["n_shared_experts"] or 0)

    def dense(n, d_in, d_out):
        return (n, (d_in, d_out), 1.0 / math.sqrt(d_in))

    out = [("embed", (V, D), 0.02)]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (D,), None),
                dense(p + "q", D, H * (dn + dr)), dense(p + "kv_a", D, R),
                dense(p + "k_rope", D, dr),
                (p + "kv_norm", (R,), None), dense(p + "k_b", R, H * dn),
                dense(p + "v_b", R, H * dv), dense(p + "o", H * dv, D),
                (p + "mlp_norm", (D,), None)]
        if i < c["first_k_dense_replace"]:
            Fd = c["intermediate_size"]
            out += [dense(p + "mlp.gate", D, Fd), dense(p + "mlp.up", D, Fd),
                    dense(p + "mlp.down", Fd, D)]
            continue
        out += [dense(p + "router", D, E),
                (p + "experts.gate", (E, D, F_), 1.0 / math.sqrt(D)),
                (p + "experts.up", (E, D, F_), 1.0 / math.sqrt(D)),
                (p + "experts.down", (E, F_, D), 1.0 / math.sqrt(F_))]
        if S:
            out += [dense(p + "shared.gate", D, S * F_),
                    dense(p + "shared.up", D, S * F_),
                    dense(p + "shared.down", S * F_, D)]
    return out + [("norm", (D,), None), dense("head", D, V)]


def draw_weights(c: dict, seed: int, device, dtype=torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """The model's weights from `seed`, on `device`, in `dtype`: one draw
    a kind of weight, every layer's at once (a normal with the weight's
    std; a norm's scale 1 + NORM_STD times a normal), each layer's weight
    a view of it."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    groups: Dict[tuple, List[str]] = {}
    for name, shape, std in specs(c):
        key = (re.sub(r"^layers\.\d+\.", "", name), shape, std)
        groups.setdefault(key, []).append(name)
    out = {}
    for (_, shape, std), names in groups.items():
        t = torch.empty((len(names), *shape), dtype=dtype, device=device)
        if std is None:
            t.normal_(1.0, NORM_STD, generator=gen)
        else:
            t.normal_(0.0, std, generator=gen)
        out.update(zip(names, t.unbind(0)))
    return out


def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """t rounded through float8_e4m3fn, scaled so that its largest
    magnitude over `dims` maps to the format's largest value."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """x [L, ..., dr], pairs i and i + dr/2; angles in float64."""
    dr = x.shape[-1]
    inv = theta ** (-torch.arange(0, dr, 2, dtype=torch.float64,
                                  device=x.device) / dr)
    ang = pos.double()[:, None] * inv[None]               # [L, dr/2]
    shape = (ang.shape[0],) + (1,) * (x.ndim - 2) + (ang.shape[1],)
    cos = torch.cos(ang).float().reshape(shape)
    sin = torch.sin(ang).float().reshape(shape)
    x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class _Layer:
    """One layer's weights in float32 (rounded through fp8 under that
    variant), and the products that read them."""

    def __init__(self, weights, prefix: str, variant: Optional[str]):
        self.fp8 = variant == "fp8"
        self.w = {}
        for k, v in weights.items():
            if not k.startswith(prefix):
                continue
            v = v.float()
            if self.fp8 and v.ndim >= 2:
                v = _fp8(v, -2)     # a scale a column (a product's output)
            self.w[k[len(prefix):]] = v

    def lin(self, x, name):
        if self.fp8:
            x = _fp8(x, -1)         # a scale a row (a token)
        return x @ self.w[name]

    def swiglu(self, x, g, u, d):
        if self.fp8:
            x = _fp8(x, -1)
            h = F.silu(x @ g) * (x @ u)
            return _fp8(h, -1) @ d
        return (F.silu(x @ g) * (x @ u)) @ d


def _attention(c, L: _Layer, x, variant):
    H = c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    eps = c["rms_norm_eps"]
    n = x.shape[0]
    pos = torch.arange(n, device=x.device)
    q = L.lin(x, "q").view(n, H, dn + dr)
    q_nope, q_rope = q[..., :dn], _rope(q[..., dn:], pos, c["rope_theta"])
    ckv = _rms(L.lin(x, "kv_a"), L.w["kv_norm"], eps)
    k_nope = L.lin(ckv, "k_b").view(n, H, dn)
    v = L.lin(ckv, "v_b").view(n, H, dv)
    k_rope = _rope(L.lin(x, "k_rope"), pos, c["rope_theta"])   # [n, dr]
    s = torch.einsum("qhd,khd->hqk", q_nope, k_nope)
    if variant != "no_rope_k":
        s = s + torch.einsum("qhd,kd->hqk", q_rope, k_rope)
    s = s / math.sqrt(dn + dr)
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool,
                                 device=x.device).triu(1), float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return L.lin(o.reshape(n, H * dv), "o")


def _moe(c, L: _Layer, x, variant):
    k = c["num_experts_per_tok"]
    probs = torch.softmax(L.lin(x, "router"), -1)
    w, idx = torch.topk(probs, k, dim=-1)
    if c["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    w = w * c["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in idx.unique().tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        h = L.swiglu(x[tok], L.w["experts.gate"][e], L.w["experts.up"][e],
                     L.w["experts.down"][e])
        y.index_add_(0, tok, h * w[tok, slot, None])
    if c["n_shared_experts"] and variant != "no_shared":
        y = y + L.swiglu(x, L.w["shared.gate"], L.w["shared.up"],
                         L.w["shared.down"])
    return y


@torch.no_grad()
def forward(c: dict, weights: Dict[str, torch.Tensor],
            seqs: Sequence[torch.Tensor], keep: Sequence[torch.Tensor],
            variant: Optional[str] = None) -> List[torch.Tensor]:
    """Each token sequence's float32 logits [len(keep[j]), vocab] at the
    positions `keep[j]`, by a full causal forward over the sequence
    alone. `variant` (one of `VARIANTS`) computes a control or a planted
    fault instead."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(variant)
    check_config(c)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        eps = c["rms_norm_eps"]
        xs = [weights["embed"][s].float() for s in seqs]
        for i in range(c["num_hidden_layers"]):
            L = _Layer(weights, f"layers.{i}.", variant)
            dense = i < c["first_k_dense_replace"]
            for j, x in enumerate(xs):
                x = x + _attention(c, L, _rms(x, L.w["attn_norm"], eps),
                                   variant)
                h = _rms(x, L.w["mlp_norm"], eps)
                if dense:
                    h = L.swiglu(h, L.w["mlp.gate"], L.w["mlp.up"],
                                 L.w["mlp.down"])
                else:
                    h = _moe(c, L, h, variant)
                xs[j] = x + h
            del L
        top = _Layer({"head": weights["head"]}, "", variant)
        norm = weights["norm"].float()
        return [top.lin(_rms(x[p], norm, eps), "head")
                for x, p in zip(xs, keep)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
