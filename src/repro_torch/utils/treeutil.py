"""Small utilities over param trees: nested dicts of tensors.

Counterpart of the JAX package's ``utils/treeutil.py``, the part the
optimizer, trainer, checkpoints and sharding rules use: ``global_norm``,
``tree_paths`` and ``map_with_path``, with ``tree_map``,
``tree_leaves`` and ``tree_unflatten`` standing in for ``jax.tree_util``
on dicts.  The runtime's state and messages hold more than dicts (an
AdamW state is a NamedTuple; a payload may be a list or a tuple), so
``pytree_map``, ``pytree_flatten`` and ``pytree_unflatten`` walk every
container ``jax.tree_util`` walks: dicts, lists, tuples and NamedTuples,
with None an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

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


def global_norm(tree, *, counted: Optional[List[bool]] = None,
                reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor).

    Over a tree of shards (``train.parallel``), ``counted`` (a bool a
    leaf, in :func:`tree_leaves` order) keeps the leaves this rank
    counts, so that each shard and each replicated leaf is counted once
    over the ranks, and ``reduce`` sums the local sum over them."""
    leaves = tree_leaves(tree)
    if counted is not None:
        leaves = [x for x, c in zip(leaves, counted) if c]
    total = sum(x.float().square().sum() for x in leaves)
    if not isinstance(total, torch.Tensor):  # no leaf counted here
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(tree)[0].device)
    if reduce is not None:
        total = reduce(total)
    return torch.sqrt(total)


def tree_paths(tree) -> Dict[str, Any]:
    """Flatten a pytree into {'/a/b/c': leaf} using dict keys."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}", v)
        elif hasattr(node, "_fields"):  # NamedTuple
            for f in node._fields:
                rec(f"{prefix}/{f}", getattr(node, f))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    rec("", tree)
    return flat


def map_with_path(fn: Callable[[str, Any], Any], tree):
    """tree_map that passes the '/a/b' path string to fn (dicts, lists,
    tuples and NamedTuples, whose field names make the path)."""
    return _map_with_path_rec(fn, tree, "")


def _map_with_path_rec(fn, node, prefix):
    if isinstance(node, dict):
        return {k: _map_with_path_rec(fn, v, f"{prefix}/{k}")
                for k, v in node.items()}
    if hasattr(node, "_fields"):  # NamedTuple — use field names in paths
        vals = {f: _map_with_path_rec(fn, getattr(node, f), f"{prefix}/{f}")
                for f in node._fields}
        return type(node)(**vals)
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_path_rec(fn, v, f"{prefix}/{i}")
                          for i, v in enumerate(node))
    return fn(prefix, node)


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


def to_device(tree: Any, device: torch.device,
              memo: Optional[Dict[int, torch.Tensor]] = None) -> Any:
    """``tree`` with every tensor leaf on ``device`` (a leaf already there
    is kept).  ``memo`` maps the id of a tensor already moved to its
    copy: a tensor that two trees share is copied once and stays shared,
    so a move never holds two copies of it."""
    memo = {} if memo is None else memo

    def move(x):
        if not isinstance(x, torch.Tensor):
            return x
        out = memo.get(id(x))
        if out is None:
            out = memo[id(x)] = x.to(device)
        return out

    return pytree_map(move, tree)
