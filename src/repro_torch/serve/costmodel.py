"""Roofline cost model for serving: per-replica prefill/decode step times
and energy, derived from the arch config and the H100 constants of
`launch/mesh.py`. The ETF dispatcher's finish-time estimates and the
simulated executor clock both come from here.

The port of `repro/serve/costmodel.py` (numpy-free arithmetic, the same
float64 expressions). Only the replica's default constants differ: an
H100 card, its 700 W power limit busy and its measured idle draw.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch import mesh as meshlib

# a card's draw, busy and idle: the power limit by `nvidia-smi`, and
# `power.draw` of the idle card (a CUDA context open, 5 s after its last
# work) as `chip_smoke.py` phase 5d reads it: 120.45-120.48 W on an
# NVIDIA H100 80GB HBM3 with its power limit at 700.00 W (another
# machine of the same kind read 131.29-131.38 W)
BUSY_W = 700.0
IDLE_W = 120.46


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """A serving replica = a device group running one model instance."""
    name: str
    n_chips: int = 8
    peak_flops: float = meshlib.PEAK_FLOPS_BF16
    hbm_bw: float = meshlib.HBM_BW
    power_w: float = BUSY_W         # per card, busy
    idle_w: float = IDLE_W
    efficiency: float = 0.5         # fraction-of-roofline actually achieved


@dataclasses.dataclass(frozen=True)
class ModelCost:
    """Active params + per-token KV bytes determine the roofline terms."""
    n_active_params: float
    kv_bytes_per_token: float       # across all layers
    param_bytes: float

    @staticmethod
    def from_config(cfg) -> "ModelCost":
        # rough active-param count (exact one comes from lm.param_count)
        d, L, f, v = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab
        if cfg.mlp_type == "moe":
            mc = cfg.moe
            f_eff = mc.d_expert * (mc.top_k + mc.n_shared)
        elif cfg.mlp_type == "none":
            f_eff = 2 * d * cfg.ssd.expand if cfg.ssd else 2 * d
        else:
            f_eff = f
        per_layer = 4 * d * d + 3 * d * f_eff
        n = L * per_layer + 2 * v * d
        if cfg.attn_impl == "mla":
            kv = L * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
        elif cfg.ssd is not None:
            kv = 0.0
        else:
            kv = L * cfg.n_kv_heads * cfg.d_head * 2 * 2
        return ModelCost(n_active_params=float(n),
                         kv_bytes_per_token=float(kv),
                         param_bytes=float(n) * 2)


def prefill_seconds(mc: ModelCost, rs: ReplicaSpec, n_tokens: int) -> float:
    flops = 2.0 * mc.n_active_params * n_tokens
    t_compute = flops / (rs.n_chips * rs.peak_flops * rs.efficiency)
    t_mem = mc.param_bytes / (rs.n_chips * rs.hbm_bw)
    return max(t_compute, t_mem)


def decode_step_seconds(mc: ModelCost, rs: ReplicaSpec, batch: int,
                        mean_ctx: float) -> float:
    flops = 2.0 * mc.n_active_params * batch
    t_compute = flops / (rs.n_chips * rs.peak_flops * rs.efficiency)
    bytes_moved = (mc.param_bytes
                   + batch * mean_ctx * mc.kv_bytes_per_token)
    t_mem = bytes_moved / (rs.n_chips * rs.hbm_bw)
    return max(t_compute, t_mem)


def step_energy_j(rs: ReplicaSpec, seconds: float, busy: bool) -> float:
    w = rs.power_w if busy else rs.idle_w
    return rs.n_chips * w * seconds
