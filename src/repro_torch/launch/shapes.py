"""The assigned input-shape suite and per-(arch x shape) applicability, a
copy of the JAX package's `launch/shapes.py`."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
SHAPE_NAMES: Tuple[str, ...] = tuple(SHAPES)


def applicable(cfg, shape: str) -> Optional[str]:
    """None if the cell runs; else a skip reason."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("full-attention decode at 524k context is quadratic-in-"
                "aggregate and exceeds HBM; run only for SSM/hybrid archs")
    return None


def cells(arch_cfgs) -> List[Tuple[str, str]]:
    out = []
    for arch, cfg in arch_cfgs.items():
        for s in SHAPE_NAMES:
            if applicable(cfg, s) is None:
                out.append((arch, s))
    return out
