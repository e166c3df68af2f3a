"""Advantage estimators on numpy arrays, host-side (they sit between the
workers, not inside the steps).

A copy of the GRPO part of the JAX package's ``rl/advantage.py``; the
rest (GAE, REINFORCE++, staleness weights) comes with the runtime glue.
"""
from __future__ import annotations

import numpy as np


def grpo_advantages(rewards: np.ndarray, group_size: int,
                    eps: float = 1e-6) -> np.ndarray:
    """Group-relative advantages (GRPO): responses to the same query form a
    group; advantage = (r - mean_group) / std_group, broadcast per token by
    the caller.  rewards: (B,) with B = n_queries * group_size, grouped
    consecutively."""
    B = rewards.shape[0]
    assert B % group_size == 0, (B, group_size)
    g = rewards.reshape(B // group_size, group_size)
    mean = g.mean(axis=1, keepdims=True)
    std = g.std(axis=1, keepdims=True)
    adv = (g - mean) / (std + eps)
    return adv.reshape(B)


def broadcast_to_tokens(adv_seq: np.ndarray, loss_mask: np.ndarray
                        ) -> np.ndarray:
    """Per-sequence advantage -> per-token (B, S) masked broadcast."""
    return adv_seq[:, None].astype(np.float32) * loss_mask.astype(np.float32)
