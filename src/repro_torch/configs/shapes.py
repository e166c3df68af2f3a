"""Assigned input shapes (public-pool assignment for this paper).

A copy of the JAX package's ``configs/shapes.py``: the config zoo's four
shapes, which the kernel lint (``analysis.kernel_checks``) and the
dry-run (``launch.dryrun``) evaluate.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, phase="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, phase="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, phase="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, phase="decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def list_shapes() -> List[str]:
    return list(SHAPES)
