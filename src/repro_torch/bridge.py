"""Carry a param tree between nested dicts of numpy arrays and of tensors.

A JAX param pytree taken to numpy (``jax.tree.map(np.asarray, params)``)
becomes the port's dict of tensors with the same keys, nesting, shapes
and einsum layouts (``wq`` (d, H, hd), ``wo`` (H, hd, d), a leading layer
axis on ``layers``), and back; an AdamW state the same way, so both
packages can start from the same moments.  Leaves that JAX keeps in f32
whatever the model's type (:data:`F32_LEAVES`) stay f32 under a cast.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.treeutil import tree_map
from repro_torch.train.optimizer import AdamWState


def _to_tensor(a: Any, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch may not share read-only memory
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


# param names that JAX initializes in f32 whatever the model's type: the
# MoE router (``models/moe.py`` ``init_moe``) and the Mamba2 decay and
# skip parameters (``models/ssm.py`` ``init_mamba2``)
F32_LEAVES = frozenset({"router", "dt_bias", "A_log", "D"})


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """numpy leaves -> tensors on ``device`` (the card by default), cast to
    ``dtype`` when given, except the :data:`F32_LEAVES`, which stay f32."""
    device = resolve_device(device)

    def leaf(key: str, a: Any) -> torch.Tensor:
        f32 = dtype is not None and key in F32_LEAVES
        return _to_tensor(a, device, torch.float32 if f32 else dtype)

    def rec(node: Dict[str, Any]) -> Dict[str, Any]:
        return {k: rec(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return rec(tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Tensor leaves -> numpy arrays on the host; bf16 leaves come back as
    float32 (numpy has no bfloat16 of its own)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def opt_state_from_numpy(state: Any, device: DeviceLike = None
                         ) -> AdamWState:
    """An AdamW state with numpy leaves (``jax.tree.map(np.asarray,
    state)`` of the JAX ``AdamWState``) -> the port's, moments in f32."""
    return AdamWState(step=int(np.asarray(state.step)),
                      mu=params_from_numpy(state.mu, device, torch.float32),
                      nu=params_from_numpy(state.nu, device, torch.float32))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's AdamW state with numpy leaves and an int32 step."""
    return AdamWState(step=np.int32(state.step),
                      mu=params_to_numpy(state.mu),
                      nu=params_to_numpy(state.nu))
