"""Vectorized synthetic embodied environment (the CPU "simulator" worker).

Mirrors the computational profile the paper measures (Fig. 3): step time
nearly flat in the number of environments (plus an optional per-env
component for GPU-parallel ManiSkill-like sims), memory linear,
CPU-bound.  The task is a 2-D "reach the target" control problem: the
policy emits one of 9 discrete actions (8 directions + stay) per step;
reward is progress toward the goal; an episode succeeds when within eps
of the goal.

This gives embodied RL examples a *real* closed loop (obs -> action ->
sim -> reward) with a learnable optimal policy.

Semantics:

* Episode ends split into ``terminated`` (the goal was reached — the MDP
  truly ended) and ``truncated`` (the ``max_steps`` horizon ran out — the
  episode was cut, not finished).  GAE must bootstrap through truncation
  but not through termination (``rl.advantage.gae_advantages``).
* ``step`` auto-resets finished envs and returns the POST-reset
  observation — the one the next action must be computed from.  The true
  final observation of the finished episode is exposed as
  ``info["terminal_obs"]`` (the value target for truncated episodes).
* Randomness is per-env (one generator per environment), so stepping an
  arbitrary subset (``env_ids``) consumes exactly the same random stream
  per env as stepping the full batch — chunked (hybrid-pipelined) and
  full-batch (collocated) cycle execution produce identical trajectories.

A copy of the JAX package's ``rl/env.py`` (numpy only): the port imports
nothing of that package, and ``tests/test_torch_embodied.py`` holds the
two modules' code equal, docstrings aside.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

_DIRS = np.array(
    [[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1],
     [1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
_DIRS[1:] /= np.linalg.norm(_DIRS[1:], axis=1, keepdims=True)

NUM_ACTIONS = 9
OBS_DIM = 4  # (dx, dy, dist, step_frac)


@dataclass
class EnvConfig:
    num_envs: int = 64
    arena: float = 10.0
    speed: float = 0.7
    eps: float = 0.5
    max_steps: int = 32
    # artificial per-step latency to mimic physics+render cost (Fig. 3b);
    # 0 disables (tests).  `step_latency` is flat per step call (the
    # LIBERO-like CPU-sim regime: chunking envs does not make a step
    # cheaper); `latency_per_env` scales with the number of envs stepped
    # (the ManiSkill-like GPU-parallel regime: a chunk costs its share).
    step_latency: float = 0.0
    latency_per_env: float = 0.0


class VecReachEnv:
    def __init__(self, cfg: EnvConfig, seed: int = 0):
        self.cfg = cfg
        # one generator per env: subset stepping stays bit-identical to
        # full-batch stepping (resets draw only from the reset env's
        # stream, never shifting its neighbours')
        self.rngs = [np.random.default_rng((seed, i))
                     for i in range(cfg.num_envs)]
        self.pos = np.zeros((cfg.num_envs, 2), np.float32)
        self.goal = np.zeros((cfg.num_envs, 2), np.float32)
        self.steps = np.zeros((cfg.num_envs,), np.int32)
        self.reset()

    def reset(self, env_ids: Optional[np.ndarray] = None) -> np.ndarray:
        ids = np.arange(self.cfg.num_envs) if env_ids is None else env_ids
        for i in ids:
            draw = self.rngs[int(i)].uniform(
                -self.cfg.arena, self.cfg.arena, (2, 2)).astype(np.float32)
            self.pos[i] = draw[0]
            self.goal[i] = draw[1]
        self.steps[ids] = 0
        return self.observe(env_ids)

    def observe(self, env_ids: Optional[np.ndarray] = None) -> np.ndarray:
        ids = slice(None) if env_ids is None else env_ids
        d = self.goal[ids] - self.pos[ids]
        dist = np.linalg.norm(d, axis=1, keepdims=True)
        frac = (self.steps[ids] / self.cfg.max_steps)[:, None]
        return np.concatenate(
            [d / self.cfg.arena, dist / self.cfg.arena, frac], axis=1
        ).astype(np.float32)

    def step(self, actions: np.ndarray,
             env_ids: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
        ids = np.arange(self.cfg.num_envs) if env_ids is None else \
            np.asarray(env_ids)
        if self.cfg.step_latency or self.cfg.latency_per_env:
            time.sleep(self.cfg.step_latency
                       + self.cfg.latency_per_env * len(ids))
        old_dist = np.linalg.norm(self.goal[ids] - self.pos[ids], axis=1)
        self.pos[ids] += _DIRS[actions] * self.cfg.speed
        self.steps[ids] += 1
        new_dist = np.linalg.norm(self.goal[ids] - self.pos[ids], axis=1)
        progress = old_dist - new_dist
        success = new_dist < self.cfg.eps
        terminated = success
        truncated = (self.steps[ids] >= self.cfg.max_steps) & ~terminated
        done = terminated | truncated
        reward = progress.astype(np.float32) + 10.0 * success.astype(np.float32)
        # the finished episode's TRUE final observation — captured before
        # the auto-reset below replaces it
        terminal_obs = self.observe(ids)
        if done.any():
            self.reset(ids[np.nonzero(done)[0]])
        # post-reset obs: what the next action (and the GAE bootstrap
        # value at episode starts) must be computed from
        obs = self.observe(ids)
        info = {"success": success.copy(),
                "terminated": terminated.copy(),
                "truncated": truncated.copy(),
                "terminal_obs": terminal_obs}
        return obs, reward, done.astype(np.float32), info
