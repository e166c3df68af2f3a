"""Advantage estimators: GRPO group normalization, GAE, REINFORCE++.

All operate on numpy arrays host-side (they sit between workers in the
workflow, not inside the jitted steps).

A copy of the JAX package's ``rl/advantage.py``; only its imports
differ.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def reinforce_pp_advantages(rewards: np.ndarray,
                            baseline_momentum: float = 0.9,
                            state: Optional[float] = None
                            ) -> Tuple[np.ndarray, float]:
    """REINFORCE++ style: global moving-average baseline + batch whitening."""
    b = rewards.mean() if state is None else (
        baseline_momentum * state + (1 - baseline_momentum) * rewards.mean())
    adv = rewards - b
    std = adv.std() + 1e-6
    return adv / std, float(b)


def gae_advantages(rewards: np.ndarray, values: np.ndarray,
                   dones: Optional[np.ndarray] = None, gamma: float = 0.99,
                   lam: float = 0.95, *,
                   terminated: Optional[np.ndarray] = None,
                   truncated: Optional[np.ndarray] = None,
                   terminal_values: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over (T, B) step-major rollouts.

    values: (T+1, B) — bootstrap value appended.
    Returns (advantages (T, B), returns (T, B)).

    Episode ends come in two kinds and they bootstrap differently:

      * ``terminated`` — the MDP truly ended (goal reached, failure
        state): the future value is genuinely zero, so the TD target
        drops the ``gamma * V(s')`` bootstrap;
      * ``truncated`` — the episode was CUT (e.g. an env's ``max_steps``
        horizon): the state had remaining value, so the target keeps the
        bootstrap.  Pass ``terminal_values`` (T, B) holding
        ``V(terminal_obs)`` — the value of the episode's true final
        observation (``info["terminal_obs"]`` from the env) — because
        ``values[t+1]`` at a truncation boundary scores the *post-reset*
        observation of the next episode, not the state that was cut.

    Both kinds reset the advantage carry (no credit flows across
    episode boundaries).  Legacy positional ``dones`` treats every end
    as terminated — the timeout-as-terminal bias this signature exists
    to remove."""
    if terminated is None:
        terminated = dones if dones is not None else np.zeros_like(rewards)
    if truncated is None:
        truncated = np.zeros_like(terminated)
    T, B = rewards.shape
    adv = np.zeros((T, B), np.float32)
    last = np.zeros((B,), np.float32)
    for t in reversed(range(T)):
        v_next = values[t + 1]
        if terminal_values is not None:
            v_next = np.where(truncated[t] > 0, terminal_values[t], v_next)
        notterm = 1.0 - terminated[t]
        ends = np.clip(terminated[t] + truncated[t], 0.0, 1.0)
        delta = rewards[t] + gamma * v_next * notterm - values[t]
        last = delta + gamma * lam * (1.0 - ends) * last
        adv[t] = last
    returns = adv + values[:-1]
    return adv, returns


def broadcast_to_tokens(adv_seq: np.ndarray, loss_mask: np.ndarray
                        ) -> np.ndarray:
    """Per-sequence advantage -> per-token (B, S) masked broadcast."""
    return adv_seq[:, None].astype(np.float32) * loss_mask.astype(np.float32)


def staleness_importance_weights(behavior_logprobs: np.ndarray,
                                 target_logprobs: np.ndarray,
                                 loss_mask: np.ndarray,
                                 *, staleness: int,
                                 clip_ratio: float = 2.0) -> np.ndarray:
    """Per-token truncation dampers realizing truncated importance
    sampling for off-policy (stale) samples.

    A rollout generated under parameters ``v`` but trained at ``v + s``
    (``s`` = staleness, bounded by the AsyncQueue's K) needs the
    truncated-IS weight ``min(exp(Δ), clip_ratio)`` where
    ``Δ = logπ_target − logπ_behavior``.  The behavior-referenced PPO
    ratio in the loss ALREADY equals ``exp(Δ)`` at the start of the
    update, so multiplying advantages by the full ratio would count the
    off-policy gap twice.  This returns only the *truncation factor*

        w = min(1, clip_ratio · exp(−Δ))

    so that (loss ratio at train start) × w = min(exp(Δ), clip_ratio) —
    the RollArt/AReaL-style truncated importance weight, applied exactly
    once.  Pass the SAME behavior logprobs the loss references
    (``old_logprobs``) so the two factors cancel token-for-token.

    ``staleness == 0`` means behavior and target policy are the SAME
    parameters, so the method returns exactly 1.0 everywhere — async depth
    K = 0 reduces bit-for-bit to synchronous on-policy GRPO.

    Shapes: all (B, S); returns (B, S) float32 with 1.0 off-mask.
    """
    if staleness <= 0:
        return np.ones_like(loss_mask, dtype=np.float32)
    delta = np.clip(target_logprobs - behavior_logprobs, -20.0, 20.0)
    w = np.minimum(1.0, clip_ratio * np.exp(-delta)).astype(np.float32)
    mask = loss_mask.astype(bool)
    return np.where(mask, w, np.float32(1.0))


def whiten(x: np.ndarray, mask: Optional[np.ndarray] = None,
           eps: float = 1e-6) -> np.ndarray:
    if mask is None:
        return (x - x.mean()) / (x.std() + eps)
    m = mask.astype(bool)
    mu, sd = x[m].mean(), x[m].std()
    out = np.where(m, (x - mu) / (sd + eps), 0.0)
    return out.astype(np.float32)
