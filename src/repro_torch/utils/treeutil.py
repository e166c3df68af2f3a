"""Small utilities over param trees: nested dicts of tensors.

Counterpart of the JAX package's ``utils/treeutil.py``, the part the
optimizer and trainer use: ``global_norm``, with ``tree_map``,
``tree_leaves`` and ``tree_unflatten`` standing in for ``jax.tree_util``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def tree_map(fn: Callable[..., Any], tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over matching leaves of dicts with the same keys."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree: Dict) -> List[Any]:
    """The leaves in key order, depth first."""
    out: List[Any] = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like: Dict, leaves: List[Any]) -> Dict:
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))
