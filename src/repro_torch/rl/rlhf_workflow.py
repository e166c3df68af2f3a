"""Full PPO/RLHF workflow (paper Fig. 1 top-right): four models in the loop.

  actor      — trainable policy (clipped PPO with per-token values)
  critic     — trainable value model (separate backbone + value head)
  reference  — frozen copy of the initial actor (KL anchor)
  reward     — scalar scorer (rule-based here, per §5.1; a learned RM
               plugs into the same worker slot)

plus the rollout and inference workers shared with GRPO.  The workflow
graph has 6 nodes with a diamond (rollout feeds reference/critic/reward
in parallel, all meeting at the actor update) — the richest scheduling
graph in the repo, and the reason RLHF is the paper's motivating example
for flexible orchestration.  The runner goes through the shared
:class:`~repro_torch.rl.runner.WorkflowRunner`, so the diamond exercises
the same binding-placement profile → plan → execute path as GRPO.

Counterpart of the JAX package's ``rl/rlhf_workflow.py``.  Every worker
runs on one device (the card unless ``device="cpu"``).  The actor's and
the critic's AdamW update their params in place, so the reference holds
a CLONE of the initial actor in storage of its own: a reference to the
actor's tensors would follow its updates, and the KL term would read 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import Cluster, FlowGraph, SchedulerConfig
from repro_torch.core.worker import Worker
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import forward, init_model
from repro_torch.models.layers import dense_init
from repro_torch.rl.advantage import gae_advantages, whiten
from repro_torch.rl.reward import math_reward
from repro_torch.rl.runner import WorkflowRunner
from repro_torch.rl.workers import ActorWorker, InferenceWorker, RolloutWorker
from repro_torch.train.data import PromptDataset
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_adamw
from repro_torch.train.trainer import TrainHParams, make_prefill_step
from repro_torch.utils.treeutil import (
    pytree_map,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


# ---------------------------------------------------------------------------
# Critic: backbone + value head
# ---------------------------------------------------------------------------
def init_critic(gen: Optional[torch.Generator], cfg: ModelConfig,
                dtype=torch.float32, device: DeviceLike = None):
    """The backbone from ``init_model`` and an f32 (d_model, 1) value
    head, both drawn from ``gen`` in that order."""
    device = resolve_device(device)
    return {
        "backbone": init_model(gen, cfg, dtype, device),
        "vhead": dense_init(gen, (cfg.d_model, 1), torch.float32, device),
    }


def critic_values(params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Per-token value estimates (B, S), f32."""
    _, _, hidden = forward(params["backbone"], cfg, tokens,
                           return_hidden=True)
    v = hidden.float() @ params["vhead"]
    return v[..., 0]


def _tokens(chunk, device) -> torch.Tensor:
    return torch.tensor(np.asarray(chunk["tokens"]), dtype=torch.long,
                        device=device)


class CriticWorker(Worker):
    """The value model: ``values`` scores a rollout, ``train_value`` takes
    one AdamW step (lr 1e-3, clip 1.0) on the masked squared error to the
    returns.  Params from :func:`init_critic` with a generator seeded
    ``seed``, unless ``params`` hands them in; updated in place."""

    def __init__(self, name: str, *, cfg: ModelConfig, lr: float = 1e-3,
                 seed: int = 1, devices=(), process_index: int = 0,
                 device: DeviceLike = None, params: Optional[Any] = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_critic(gen, cfg, torch.float32, self.device)
        self.register_state("params", params)
        self.register_state("opt", init_adamw(params))
        self.opt_cfg = AdamWConfig(lr=lr, clip_norm=1.0)

    def values(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(chunk)
        with torch.no_grad():
            out["values"] = critic_values(
                self.get_state("params"), self.cfg,
                _tokens(chunk, self.device)).cpu().numpy()
        return out

    def train_value(self, chunk: Dict[str, np.ndarray]) -> Dict[str, Any]:
        params, opt = self.get_state("params"), self.get_state("opt")
        dev = self.device
        tokens = _tokens(chunk, dev)
        returns, mask = (torch.tensor(np.asarray(chunk[k]),
                                      dtype=torch.float32, device=dev)
                         for k in ("returns", "loss_mask"))
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            v = critic_values(live, self.cfg, tokens)
            err = torch.square(v - returns) * mask
            loss = err.sum() / torch.clamp(mask.sum(), min=1.0)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt, _ = adamw_update(self.opt_cfg, params,
                                      tree_unflatten(params, grads), opt)
        self.set_state("params", params)
        self.set_state("opt", opt)
        out = dict(chunk)
        out["value_loss"] = float(loss.detach())
        return out


class ReferenceWorker(Worker):
    """Frozen initial policy — supplies ref logprobs for the KL penalty.
    It keeps a clone of ``params`` (see the module docstring)."""

    def __init__(self, name: str, *, cfg: ModelConfig, params,
                 devices=(), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        with torch.no_grad():
            self.register_state("params", pytree_map(
                lambda x: x.detach().clone()
                if isinstance(x, torch.Tensor) else x, params))
        # forward, token logprobs, entry 0 padded: the recompute's step
        self._lp = make_prefill_step(cfg)

    def ref_logprobs(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(chunk)
        out["ref_logprobs"] = self._lp(
            self.get_state("params"),
            {"tokens": _tokens(chunk, self.device)}).cpu().numpy()
        return out


class PPOActorWorker(ActorWorker):
    """Trainable actor with the clipped PPO loss + KL-to-reference:
    ``ActorWorker``'s step, which passes the chunk's ``ref_logprobs`` to
    ``policy_loss`` (JAX's PPO actor has a step of its own doing the
    same)."""


# ---------------------------------------------------------------------------
# PPO reward + advantage worker (the GRPO RewardWorker's PPO analogue)
# ---------------------------------------------------------------------------
class PPORewardWorker(Worker):
    """Rule-based reward + per-token GAE over the critic's values (host
    numpy).

    Consumes ``values`` (from the critic) alongside the rollout tokens,
    places the scalar reward on the last valid token, and runs GAE +
    whitening — so advantage estimation is a schedulable workflow node
    rather than inline runner code."""

    def __init__(self, name: str, *, prompt_len: int, gamma: float = 1.0,
                 lam: float = 0.95, devices=(), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.prompt_len = prompt_len
        self.gamma = gamma
        self.lam = lam

    def score(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        toks = chunk["tokens"]
        B, S = toks.shape
        rewards = math_reward(toks, chunk["answers"], self.prompt_len)
        mask = np.zeros((B, S), np.float32)
        mask[:, self.prompt_len:] = toks[:, self.prompt_len:] != 0

        # --- per-token GAE: reward lands on the last valid token ---
        values = chunk["values"] * mask  # (B, S)
        last_idx = np.maximum(mask.cumsum(1).argmax(1), self.prompt_len)
        r_tok = np.zeros((B, S), np.float32)
        r_tok[np.arange(B), last_idx] = rewards
        # treat the response as a short episode over time axis S
        adv, ret = gae_advantages(
            r_tok.T,
            np.concatenate([values.T, np.zeros((1, B), np.float32)]),
            np.zeros((S, B), np.float32), gamma=self.gamma, lam=self.lam)
        adv = whiten(adv.T, mask)
        out = dict(chunk)
        out["rewards"] = rewards
        out["advantages"] = adv * mask
        out["returns"] = ret.T * mask
        out["loss_mask"] = mask
        return out


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------
@dataclass
class PPOConfig:
    batch_size: int = 32
    prompt_len: int = 8
    max_new_tokens: int = 4
    temperature: float = 1.0
    iterations: int = 20
    kl_coef: float = 0.02
    gamma: float = 1.0
    lam: float = 0.95
    mode: str = "auto"
    seed: int = 0
    profile_batches: tuple = (8, 32)


@dataclass
class PPOIterStats:
    iteration: int
    wall_time: float
    mean_reward: float
    accuracy: float
    value_loss: float
    metrics: Dict[str, float] = field(default_factory=dict)


def rlhf_graph() -> FlowGraph:
    """The 6-node RLHF diamond (module-level so tooling — flowlint,
    benchmarks — can build it without constructing a runner);
    critic_v → reward encodes the data dependency of GAE on values."""
    g = FlowGraph()
    for w in ("rollout", "inference", "reference", "critic_v", "reward",
              "actor"):
        g.add_worker(w)
    g.add_edge("rollout", "inference")
    g.add_edge("rollout", "reference")
    g.add_edge("rollout", "critic_v")
    g.add_edge("rollout", "reward")
    g.add_edge("critic_v", "reward")
    g.add_edge("inference", "actor")
    g.add_edge("reference", "actor")
    g.add_edge("critic_v", "actor")
    g.add_edge("reward", "actor")
    return g


class RLHFRunner(WorkflowRunner):
    """actor+critic+reference+reward PPO over the M2Flow runtime.

    Declares the 6-node diamond to the shared WorkflowRunner; profiling,
    planning, binding placement, managed context switches and measured
    weight sync are all inherited.  The critic's value update rides in
    ``post_execute`` (it trains on the coalesced full batch the actor
    just consumed).

    ``device``: where every worker runs (the card by default).
    ``params`` / ``critic_params``: the actor's and the critic's initial
    params, in place of ``init_model`` with ``ppo.seed`` and
    ``init_critic`` with ``ppo.seed + 1`` (tests bridge the JAX
    runner's)."""

    weight_sync_workers = ("rollout", "inference")

    def __init__(self, cfg: ModelConfig, ppo: PPOConfig,
                 hp: Optional[TrainHParams] = None,
                 cluster: Optional[Cluster] = None,
                 device: DeviceLike = None,
                 params: Optional[Any] = None,
                 critic_params: Optional[Any] = None, **kw):
        self.device = resolve_device(device)
        self._init_params = params
        self._init_critic = critic_params
        self.cfg = cfg
        self.ppo = ppo
        self.hp = hp or TrainHParams(
            optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0),
            kl_coef=ppo.kl_coef, entropy_coef=0.02)
        self.data = self._build_data()
        super().__init__(iterations=ppo.iterations,
                         batch_size=ppo.batch_size, mode=ppo.mode,
                         profile_batches=ppo.profile_batches,
                         cluster=cluster, **kw)

    def _build_data(self) -> PromptDataset:
        data = PromptDataset(self.ppo.batch_size,
                             prompt_len=self.ppo.prompt_len,
                             seed=self.ppo.seed, add_only=True)
        data.max_operand = 3
        return data

    def reset_stream(self) -> None:
        # recovery determinism: replay the fresh runner's prompt sequence
        self.data = self._build_data()

    # ------------------------------------------------------------------
    # declarative surface
    # ------------------------------------------------------------------
    def build_workers(self) -> Dict[str, Any]:
        cfg, ppo, dev = self.cfg, self.ppo, self.device
        self.actor = PPOActorWorker(
            "actor/0", cfg=cfg, hp=self.hp, seed=ppo.seed,
            devices=self.cluster.allocate("actor", 2), device=dev,
            params=self._init_params)
        self.rollout = RolloutWorker(
            "rollout/0", cfg=cfg, max_new_tokens=ppo.max_new_tokens,
            temperature=ppo.temperature, seed=ppo.seed,
            devices=self.cluster.allocate("rollout", 2), device=dev)
        self.inference = InferenceWorker(
            "inference/0", cfg=cfg,
            devices=self.cluster.allocate("inference", 1), device=dev)
        self.reference = ReferenceWorker(
            "reference/0", cfg=cfg, params=self.actor.params(),
            devices=self.cluster.allocate("reference", 1), device=dev)
        self.critic = CriticWorker(
            "critic/0", cfg=cfg, seed=ppo.seed + 1,
            devices=self.cluster.allocate("critic_v", 2), device=dev,
            params=self._init_critic)
        # the workers own them now: references kept here would stop
        # their offloads from freeing the card
        self._init_params = self._init_critic = None
        self.reward = PPORewardWorker(
            "reward/0", prompt_len=ppo.prompt_len, gamma=ppo.gamma,
            lam=ppo.lam, device=dev)
        return {"rollout": self.rollout, "inference": self.inference,
                "reference": self.reference, "critic_v": self.critic,
                "reward": self.reward, "actor": self.actor}

    def build_task_fns(self) -> Dict[str, Any]:
        return {
            "rollout": lambda w, c: w.generate(c),
            "inference": lambda w, c: w.compute_logprobs(c),
            "reference": lambda w, c: w.ref_logprobs(c),
            "critic_v": lambda w, c: w.values(c),
            "reward": lambda w, c: w.score(c),
            "actor": lambda w, c: w.train(c),
        }

    def build_graph(self) -> FlowGraph:
        return rlhf_graph()

    def make_batch(self) -> Dict[str, np.ndarray]:
        return dict(self.data.next_batch())

    def scheduler_config(self) -> SchedulerConfig:
        # chunk_multiple = full batch: GAE whitening and the value target
        # are batch-global statistics, so pipeline chunks must never
        # split an update batch
        return SchedulerConfig(
            total_batch=self.ppo.batch_size,
            granularity_divisors=(1, 2, 4),
            device_quantum=1,
            chunk_multiple=self.ppo.batch_size,
        )

    # ------------------------------------------------------------------
    def post_execute(self, out):
        # the critic's value update rides with the training stage
        return self.critic.train_value(out)

    def _record_stats(self, it: int, wall: float, out) -> PPOIterStats:
        rewards = out.get("rewards", np.zeros(1))
        st = PPOIterStats(
            iteration=it, wall_time=wall,
            mean_reward=float(rewards.mean()),
            accuracy=float((rewards > 0).mean()),
            value_loss=out.get("value_loss", float("nan")),
            metrics=out.get("metrics", {}))
        self.stats.append(st)
        return st

    def log_iteration(self, st: PPOIterStats) -> None:
        if st.iteration % 5 == 0 or st.iteration == self.ppo.iterations - 1:
            print(f"ppo iter {st.iteration:3d} wall={st.wall_time:5.2f}s "
                  f"reward={st.mean_reward:+6.2f} acc={st.accuracy:4.2f} "
                  f"vloss={st.value_loss:7.3f} "
                  f"kl={st.metrics.get('kl_ref', 0.0):+.4f}")
