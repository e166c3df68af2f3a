"""Architecture configs of the port: the dense decoders, the MoE family,
the SSM/hybrid family, the VLM and the encoder-decoder.

Each module is a copy of its namesake in the JAX package's ``configs``,
so :func:`list_archs` names the same zoo.
"""
from __future__ import annotations

import importlib

_MODULES = [
    "yi_9b",
    "qwen2_5_7b",
    "stablelm_12b",
    "codeqwen1_5_7b",
    "granite_moe_3b_a800m",
    "llama4_scout_17b_a16e",
    "mamba2_370m",
    "zamba2_2p7b",
    "mistral_large_123b",
    "llama_3_2_vision_90b",
    "whisper_large_v3",
]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from repro_torch.configs.base import (  # noqa: E402,F401
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
)
from repro_torch.configs.shapes import SHAPES, get_shape, list_shapes  # noqa: E402,F401
