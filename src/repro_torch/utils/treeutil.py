"""Small utilities over param trees: nested dicts of tensors.

Counterpart of the JAX package's ``utils/treeutil.py``, the part the
optimizer and trainer use: ``global_norm``, with ``tree_map``,
``tree_leaves`` and ``tree_unflatten`` standing in for ``jax.tree_util``
on dicts.  The runtime's state and messages hold more than dicts (an
AdamW state is a NamedTuple; a payload may be a list or a tuple), so
``pytree_map``, ``pytree_flatten`` and ``pytree_unflatten`` walk every
container ``jax.tree_util`` walks: dicts, lists, tuples and NamedTuples,
with None an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

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


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def pytree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over every leaf, the containers rebuilt around the results.
    A leaf is anything but a dict, list, tuple, NamedTuple or None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: pytree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(pytree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(pytree_map(fn, v) for v in tree)
    return fn(tree)


_LEAF = object()


def pytree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in walk order, treedef); ``pytree_unflatten`` inverts it."""
    leaves: List[Any] = []

    def take(x):
        leaves.append(x)
        return _LEAF

    return leaves, pytree_map(take, tree)


def pytree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """The tree ``treedef`` describes, holding ``leaves`` in order."""
    it = iter(leaves)
    return pytree_map(lambda _: next(it), treedef)


def pytree_leaves(tree: Any) -> List[Any]:
    return pytree_flatten(tree)[0]
