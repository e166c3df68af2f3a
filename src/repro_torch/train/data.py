"""Data pipeline: synthetic tokenized math-style prompts + batching.

The paper trains on AReaL-boba math data; offline we generate a synthetic
arithmetic-reasoning dataset with a *verifiable* answer so the rule-based
reward (±5, §5.1) is exact.  Token space: 0..9 digits, ops, and control
tokens.  This gives the end-to-end example a real learnable signal.

A copy of the JAX package's ``train/data.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

# token vocabulary
PAD, BOS, EOS, EQ, PLUS, TIMES, ANS = 0, 1, 2, 3, 4, 5, 6
DIGIT0 = 7  # digits 0..9 -> tokens 7..16
VOCAB = 17


def encode_digits(n: int) -> List[int]:
    return [DIGIT0 + int(c) for c in str(n)]


def decode_digits(toks) -> int:
    ds = [t - DIGIT0 for t in toks if DIGIT0 <= t < DIGIT0 + 10]
    if not ds:
        return -1
    return int("".join(str(d) for d in ds))


@dataclasses.dataclass
class MathTask:
    prompt: List[int]
    answer: int


def sample_task(rng: np.random.Generator, max_operand: int = 9,
                add_only: bool = False) -> MathTask:
    a = int(rng.integers(0, max_operand + 1))
    b = int(rng.integers(0, max_operand + 1))
    op = 0 if add_only else int(rng.integers(0, 2))
    prompt = [BOS] + encode_digits(a) + [PLUS if op == 0 else TIMES] \
        + encode_digits(b) + [EQ]
    ans = a + b if op == 0 else a * b
    return MathTask(prompt=prompt, answer=ans)


class PromptDataset:
    """Infinite sampler of padded prompt batches."""

    def __init__(self, batch_size: int, prompt_len: int = 8,
                 max_operand: int = 9, seed: int = 0,
                 add_only: bool = False):
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.max_operand = max_operand
        self.add_only = add_only
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = np.full((self.batch_size, self.prompt_len), PAD, np.int32)
        answers = np.zeros((self.batch_size,), np.int32)
        lens = np.zeros((self.batch_size,), np.int32)
        for i in range(self.batch_size):
            t = sample_task(self.rng, self.max_operand,
                            self.add_only)
            L = min(len(t.prompt), self.prompt_len)
            # left-pad so prompts end at the same position
            toks[i, self.prompt_len - L:] = t.prompt[:L]
            answers[i] = t.answer
            lens[i] = L
        return {"prompt_tokens": toks, "answers": answers,
                "prompt_lens": lens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
