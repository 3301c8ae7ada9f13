"""The port's serving path and the LM details of the JAX package's
tests, on the CPU: `prefill` and `decode_step` of every registered config
against the JAX package's (small size, perturbed parameters, as
`tests/test_torch_arch.py`, whose helpers and tolerances this file
shares), the prefill/decode consistency case of
`tests/test_arch_smoke.py`, and the cases of `tests/test_lm_details.py`
but training.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402

from test_torch_arch import (  # noqa: E402
    ARCH_IDS, B, REL, S, _cfgs, _inputs, _j, _np, _params, _port_model,
    _reached, _rel, _routes, _since, _t)


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """A prefill of S - 3 tokens (after the prefix), then 3 decode steps,
    caches in the compute dtype."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(arch)
    toks, pe = _inputs(jc, seed=3)
    P, n = S - 3, 3
    npre = jc.n_prefix_embeds
    jcaches = jlm.init_caches(jc, B, S + npre, dtype=getattr(jnp, dtype))
    tcaches = lm.init_caches(tc, B, S + npre, dtype=getattr(torch, dtype),
                             device="cpu")
    prefill = jax.jit(lambda p, t, c, e: jlm.prefill(p, jc, t, c,
                                                     prefix_embeds=e))
    decode = jax.jit(lambda p, t, i, c: jlm.decode_step(p, jc, t, i, c))
    bf16_moe = jc.mlp_type == "moe" and dtype == "bfloat16"
    dirty = np.zeros(B, bool)      # rows whose caches a differing route
    #                                has reached
    steps = [(toks[..., :P], None)] + [(toks[..., P + i], P + i + npre)
                                       for i in range(n)]
    compared = 0
    with _routes() as rec:
        for t, pos in steps:
            seen = {side: len(rec[side]) for side in rec}
            if pos is None:
                jl, jcaches = prefill(jp, _j(t), jcaches, _j(pe))
            else:
                jl, jcaches = decode(jp, _j(t), pos, jcaches)
            with torch.inference_mode():
                if pos is None:
                    tl, tcaches = lm.prefill(tp, tc, _t(t), tcaches,
                                             prefix_embeds=_t(pe))
                else:
                    tl, tcaches = lm.decode_step(tp, tc, _t(t), pos, tcaches)
            jax.effects_barrier()
            new = _since(rec, seen)
            held = ~dirty
            if bf16_moe:
                at, rows = _reached(new, tc, P if pos is None else 1)
                held &= ~at[:, -1]
                dirty |= rows
            else:
                for (_, ji), (_, ti) in zip(new["jax"], new["port"]):
                    assert np.array_equal(ji, ti)
                assert len(new["jax"]) == len(new["port"])
            K = jc.n_codebooks
            assert tl.shape == ((B, K, jc.vocab_padded) if K > 1
                                else (B, jc.vocab_padded))
            g, w = _np(tl), _np(jl)
            for b in np.flatnonzero(held):
                assert np.abs(g[b] - w[b]).max() \
                    <= REL[dtype] * np.abs(w).max()
                compared += 1
    assert compared >= (len(steps) * B) // 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_consistency(arch):
    cfg = configs.get_smoke_config(arch)
    if cfg.window:
        cfg = configs.scaled_down(configs.get_config(arch), window=8)
    if cfg.moe is not None:   # avoid capacity-drop divergence in the check
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    p = _port_model(cfg)
    toks, pe = _inputs(cfg, seed=1)
    toks, pe = _t(toks), _t(pe)
    npre = cfg.n_prefix_embeds
    with torch.inference_mode():
        full, _, _ = lm.forward(p, cfg, toks, prefix_embeds=pe)
        ref = full[:, -1] if cfg.n_codebooks == 1 else full[:, :, -1]
        caches = lm.init_caches(cfg, B, S + npre, dtype=torch.float32,
                                device="cpu")
        _, caches = lm.prefill(p, cfg, toks[..., :-1], caches,
                               prefix_embeds=pe)
        pos = S - 1 + npre
        positions = (torch.full((B, 1), pos, dtype=torch.int32) if npre
                     else None)
        logits, _ = lm.decode_step(p, cfg, toks[..., -1], pos, caches,
                                   positions=positions)
    rel = float((logits.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    assert rel < 5e-2, f"{arch}: decode mismatch rel={rel}"


# ---------------------------------------------------------------------------
# tests/test_lm_details.py on the port (all but training; the MLA and MoE
# cases are in tests/test_torch_mla.py and tests/test_torch_moe.py)
# ---------------------------------------------------------------------------
def test_chunked_ce_matches_unchunked():
    cfg = configs.get_smoke_config("yi-34b", d_model=64, vocab=128)
    p = _port_model(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 64)))
    batch = {"tokens": toks, "labels": toks}
    with torch.inference_mode():
        l1, _ = lm.loss_fn(p, cfg, batch, loss_chunk=16)
        l2, _ = lm.loss_fn(p, cfg, batch, loss_chunk=0)
    assert abs(float(l1) - float(l2)) < 1e-3


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_banded_sdpa(softcap):
    """Equal to the masked local attention, and to the reference's
    `banded_sdpa` on the same inputs."""
    Bq, Sq, H, K, D, W = 2, 96, 4, 2, 16, 32
    rs = np.random.RandomState(1)
    q, k, v = (rs.standard_normal((Bq, Sq, n, D)).astype(np.float32)
               for n in (H, K, K))
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32)[None], (Bq, Sq))
    tq, tk, tv, tpos = (torch.from_numpy(np.array(a)) for a in (q, k, v, pos))
    bias = attention._mask_bias(tpos, tpos, W, None)
    ref = attention.sdpa(tq, tk, tv, bias, softcap)
    out = attention.banded_sdpa(tq, tk, tv, tpos, W, softcap)
    assert float((ref - out).abs().max()) < 1e-5
    want = jattn.banded_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), W, softcap)
    assert _rel(out, want) <= 1e-5


def test_banded_route_on_the_cpu(monkeypatch):
    """A fresh windowed sequence of a multiple of at least two windows
    takes `banded_sdpa` on the CPU, as the reference's plain dispatch
    does; a shorter one the flash kernel's plain version."""
    cfg = configs.scaled_down(configs.get_config("recurrentgemma-9b"),
                              window=8)
    calls = []
    real = attention.banded_sdpa
    monkeypatch.setattr(attention, "banded_sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rs = np.random.RandomState(2)
    for Sq, banded in ((32, True), (12, False), (8, False)):
        q, k, v = (torch.from_numpy(rs.standard_normal(
            (1, Sq, n, 16)).astype(np.float32)) for n in (4, 1, 1))
        pos = torch.arange(Sq, dtype=torch.int32)[None]
        calls.clear()
        out = attention._sdpa_dispatch(cfg, q, k, v, pos, 8, None)
        assert bool(calls) == banded, Sq
        bias = attention._mask_bias(pos, pos, 8, None)
        assert float((out - attention.sdpa(q, k, v, bias)).abs().max()) < 1e-5


def test_window_ring_cache_matches_full_cache():
    cfg = configs.scaled_down(configs.get_config("recurrentgemma-9b"),
                              window=8)
    p = _port_model(cfg)
    Bq, Sq = 1, 24
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab, (Bq, Sq + 4)))
    with torch.inference_mode():
        full, _, _ = lm.forward(p, cfg, toks)
        caches = lm.init_caches(cfg, Bq, Sq + 4, dtype=torch.float32,
                                device="cpu")
        _, caches = lm.prefill(p, cfg, toks[:, :Sq], caches)
        for i in range(4):
            logits, caches = lm.decode_step(p, cfg, toks[:, Sq + i], Sq + i,
                                            caches)
    rel = float((logits.float() - full[:, -1].float()).abs().max()
                / full[:, -1].float().abs().max())
    assert rel < 5e-2, rel


def test_vocab_padding_masked_in_head():
    cfg = configs.get_smoke_config("mamba2-780m", vocab=100)
    assert cfg.vocab_padded == 112
    p = _port_model(cfg)
    toks = torch.from_numpy(np.random.RandomState(5).randint(0, 100, (1, 16)))
    with torch.inference_mode():
        logits, _, _ = lm.forward(p, cfg, toks)
    assert logits.shape[-1] == 112
    assert float(logits[..., 100:].max()) < -1e8


def test_head_mode_last_matches_full():
    cfg = configs.get_smoke_config("phi3-mini-3.8b", d_model=64, vocab=128)
    p = _port_model(cfg)
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 128, (2, 16)))
    with torch.inference_mode():
        all_logits, _, _ = lm.forward(p, cfg, toks, head_mode="all")
        last, _, _ = lm.forward(p, cfg, toks, head_mode="last")
    np.testing.assert_allclose(last[:, 0].float().numpy(),
                               all_logits[:, -1].float().numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the serving bench at a small size
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "musicgen-medium",
                                  "paligemma-3b"])
def test_lm_serve_small_on_cpu(arch):
    """`bench/lm_serve.run` on the CPU: MLA + MoE decoded expanded and
    absorbed at the no-drop capacity, four codebooks decoded greedily
    each, and a prefix before every sequence; served logits against
    scoring."""
    from repro_torch.bench import lm_serve
    cfg = configs.get_smoke_config(arch, n_layers=3, dtype="float32")
    out = lm_serve.run("cpu", cfg=cfg, score_len=32, batch=2, prompt_len=16,
                       decode_steps=3)
    assert out["forward_finite"] and out["serve_finite"]
    checks = [out["check"]] + ([out["absorbed"]["check"]]
                               if "absorbed" in out else [])
    assert len(checks) == (2 if cfg.attn_impl == "mla" else 1)
    for chk in checks:
        assert chk["positions"] == 2 * cfg.n_codebooks * 4
        assert chk["rel_max_abs"] <= REL["float32"]
    assert 0 < out["loss"] < 3 * np.log(cfg.vocab)
    assert (out["aux"] > 0) == (cfg.moe is not None)
    assert out["forward_launches"] == {"flash_attention": 0, "rg_lru": 0,
                                       "rg_lru_generic": 0, "ssd_scan": 0}
    if cfg.moe is not None:
        assert out["serve_capacity_factor"] == 2.0   # 4 experts, top 2
    tokens, served = out["kept"]["expanded"]
    assert tokens.shape[-1] == 16 + 3 and served.shape[-2] == 4


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-72b",
                                  "musicgen-medium"])
def test_bf16_at_rest_is_bit_equal(arch):
    """`lm_serve.build` with bf16 at rest draws what `lm.lm_init` draws,
    each tensor cast as drawn: the same bf16 logits bit for bit."""
    from repro_torch.bench import lm_serve
    cfg = configs.get_smoke_config(arch, n_layers=3)
    p32 = lm_serve.build(cfg, 3, "cpu")
    p16 = lm_serve.build(cfg, 3, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in p16.parameters())
    assert [n for n, _ in p16.named_parameters()] == \
        [n for n, _ in p32.named_parameters()]
    toks, _ = _inputs(cfg, seed=4)
    with torch.inference_mode():
        a, _, _ = lm.forward(p32, cfg, _t(toks))
        b, _, _ = lm.forward(p16, cfg, _t(toks))
    assert torch.equal(a, b)
