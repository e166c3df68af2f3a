"""Rule-based reward (paper §5.1): +5 if the boxed/numeric answer is
correct else -5; applied to the synthetic math tasks of repro_torch.train.data.

A copy of the JAX package's ``rl/reward.py``; only its imports
differ.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.train.data import EOS, decode_digits

CORRECT, WRONG = 5.0, -5.0


def math_reward(response_tokens: np.ndarray, answers: np.ndarray,
                prompt_len: int) -> np.ndarray:
    """response_tokens: (B, S_total) prompt+generated; answers: (B,)."""
    B = response_tokens.shape[0]
    out = np.full((B,), WRONG, np.float32)
    for i in range(B):
        resp = list(response_tokens[i, prompt_len:])
        if EOS in resp:
            resp = resp[: resp.index(EOS)]
        if decode_digits(resp) == int(answers[i]):
            out[i] = CORRECT
    return out


def format_bonus(response_tokens: np.ndarray, prompt_len: int,
                 bonus: float = 0.5) -> np.ndarray:
    """Small shaping bonus for terminating with EOS (optional)."""
    B = response_tokens.shape[0]
    out = np.zeros((B,), np.float32)
    for i in range(B):
        if EOS in list(response_tokens[i, prompt_len:]):
            out[i] = bonus
    return out
