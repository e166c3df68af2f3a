"""End-to-end GRPO workflow runner on the M2Flow runtime (Fig. 5b).

The *logical* workflow is the plain imperative loop of the paper:

    for batch in data:
        update_rollout_weights()
        rollout.generate(data_ch -> rollout_ch)
        inference.compute_logprobs(rollout_ch -> scored_ch)
        reward.score(...)
        actor.train(scored_ch).wait()

M2Flow then decides where/when each worker actually runs: the shared
:class:`~repro_torch.rl.runner.WorkflowRunner` base executes one *profiling
iteration* (timing each worker at two granularities), asks the Scheduler
for a plan (or a forced collocated/disaggregated mode), and runs the
remaining iterations through the Execution Flow Manager under that plan
— which is *binding*: ``Controller.execute`` rebinds every worker's
device slice to the plan's placement, Temporal cuts go through the
managed ContextSwitcher, and weight sync is a measured copy into the
generation side's own tensors.  No change to the workflow code.

Counterpart of the JAX package's ``rl/grpo_workflow.py``.  The runner's
workers live on one device (the card unless ``device="cpu"``), every
stage on its default stream: chunks cross threads as host numpy, so the
stream's order is the program's.  The trainer updates its params in
place, so the async horizon publishes a snapshot (a clone) of them with
each version, never the live tensors.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import Cluster, FlowGraph, SchedulerConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.rl.runner import WorkflowRunner
from repro_torch.rl.workers import (
    ActorWorker,
    InferenceWorker,
    RewardWorker,
    RolloutWorker,
)
from repro_torch.train.data import PromptDataset
from repro_torch.train.trainer import TrainHParams
from repro_torch.utils.treeutil import pytree_map

WORKFLOW_ORDER = ("rollout", "inference", "reward", "actor")


def grpo_graph() -> FlowGraph:
    """The GRPO chain graph (module-level so tooling — flowlint,
    benchmarks — can build it without constructing a runner)."""
    graph = FlowGraph()
    prev = None
    for name in WORKFLOW_ORDER:
        graph.add_worker(name)
        if prev is not None:
            graph.add_edge(prev, name, channel=f"{prev}->{name}")
        prev = name
    return graph


@dataclass
class GRPOConfig:
    batch_size: int = 32
    group_size: int = 4
    prompt_len: int = 8
    max_new_tokens: int = 8
    temperature: float = 1.0
    iterations: int = 10
    mode: str = "auto"  # auto | collocated | disaggregated
    seed: int = 0
    profile_batches: tuple = (8, 32)
    # Bounded-staleness off-policy asynchrony: rollouts for iteration i may
    # be generated with parameters up to `async_depth` (K) versions stale
    # while training runs concurrently; samples are importance-corrected
    # per token (rl.advantage.staleness_importance_weights).  K = 0 is
    # fully synchronous on-policy execution.  K >= 1 supersedes `mode`
    # (the async horizon plan replaces the per-iteration plan).
    async_depth: int = 0
    # truncation bound for the per-token importance ratios
    staleness_clip: float = 2.0
    # apply the correction (disable to get raw clipped-PPO staleness
    # handling, the pre-correction behaviour)
    staleness_correction: bool = True
    # legacy alias (AReaL-style 1-step asynchrony): maps to async_depth=1
    async_offpolicy: bool = False

    def __post_init__(self):
        if self.async_offpolicy and self.async_depth == 0:
            self.async_depth = 1


@dataclass
class IterationStats:
    iteration: int
    wall_time: float
    mean_reward: float
    accuracy: float
    metrics: Dict[str, float] = field(default_factory=dict)


class GRPORunner(WorkflowRunner):
    """GRPO over the shared WorkflowRunner (binding-placement) loop."""

    weight_sync_workers = ("rollout", "inference")

    def __init__(self, cfg: ModelConfig, rl: GRPOConfig,
                 hp: Optional[TrainHParams] = None,
                 cluster: Optional[Cluster] = None,
                 device: DeviceLike = None,
                 params: Optional[Any] = None, **kw):
        """``device``: where every worker runs (the card by default; the
        CPU runs the kernels' plain versions).  ``params``: the actor's
        initial params, in place of ``init_model`` with ``rl.seed``."""
        self.device = resolve_device(device)
        self._init_params = params
        self.model_cfg = cfg
        self.rl = rl
        self.hp = hp or TrainHParams()
        assert rl.batch_size % rl.group_size == 0, (
            f"batch_size={rl.batch_size} must be a multiple of "
            f"group_size={rl.group_size} (whole GRPO groups)")
        n_queries = rl.batch_size // rl.group_size
        self.data = PromptDataset(n_queries, prompt_len=rl.prompt_len,
                                  seed=rl.seed)
        super().__init__(iterations=rl.iterations,
                         batch_size=rl.batch_size, mode=rl.mode,
                         profile_batches=rl.profile_batches,
                         cluster=cluster, **kw)

    def reset_stream(self) -> None:
        # recovery determinism: a rebuilt run must see the same prompt
        # sequence a fresh runner would
        self.data = PromptDataset(self.rl.batch_size // self.rl.group_size,
                                  prompt_len=self.rl.prompt_len,
                                  seed=self.rl.seed)

    # ------------------------------------------------------------------
    # declarative surface
    # ------------------------------------------------------------------
    def build_workers(self) -> Dict[str, Any]:
        cfg, rl = self.model_cfg, self.rl
        dev = self.device
        self.actor = ActorWorker(
            "actor/0", cfg=cfg, hp=self.hp, seed=rl.seed,
            devices=self.cluster.allocate("actor", 4), device=dev,
            params=self._init_params)
        # the actor owns them now: a reference kept here would stop its
        # offload from freeing the card
        self._init_params = None
        self.rollout = RolloutWorker(
            "rollout/0", cfg=cfg, max_new_tokens=rl.max_new_tokens,
            temperature=rl.temperature, seed=rl.seed,
            devices=self.cluster.allocate("rollout", 4), device=dev)
        self.inference = InferenceWorker(
            "inference/0", cfg=cfg,
            devices=self.cluster.allocate("inference", 2), device=dev)
        self.reward = RewardWorker(
            "reward/0", prompt_len=rl.prompt_len, group_size=rl.group_size,
            device=dev)
        return {"rollout": self.rollout, "inference": self.inference,
                "reward": self.reward, "actor": self.actor}

    def build_task_fns(self) -> Dict[str, Any]:
        return {
            "rollout": lambda w, c: w.generate(c),
            "inference": lambda w, c: w.compute_logprobs(c),
            "reward": lambda w, c: w.score(c),
            "actor": lambda w, c: w.train(c),
        }

    def build_graph(self) -> FlowGraph:
        return grpo_graph()

    def make_batch(self) -> Dict[str, np.ndarray]:
        return self._expand_groups(self.data.next_batch())

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            total_batch=self.rl.batch_size,
            granularity_divisors=(1, 2, 4),
            device_quantum=2,
            # never pipeline below a GRPO group: a chunk that splits a
            # group degrades grpo_advantages to per-sequence groups of 1
            # (identically zero advantage — no learning signal)
            chunk_multiple=self.rl.group_size,
        )

    # ------------------------------------------------------------------
    def _expand_groups(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Each query is repeated group_size times (GRPO sampling)."""
        g = self.rl.group_size
        return {k: np.repeat(v, g, axis=0) for k, v in batch.items()}

    def plan_execution(self) -> None:
        self.controller.scheduler_cfg = self.scheduler_config()
        if self.rl.async_depth > 0:
            # Horizon plan with the configured staleness bound.  NOTE:
            # async_depth supersedes rl.mode; the AsyncPipelineDriver
            # realizes the cross-iteration overlap directly on the
            # workers while the plan's placement column is still made
            # binding (bind_placement) before the horizon starts.
            self.plan = self.controller.plan_async(
                self.graph(), total_batch=self.rl.batch_size,
                iterations=self.rl.iterations,
                depths=[self.rl.async_depth])
        else:
            self.plan = self.controller.plan(
                self.graph(), total_batch=self.rl.batch_size,
                mode=self.mode)

    # ------------------------------------------------------------------
    def _record_stats(self, it: int, wall: float, out) -> IterationStats:
        rewards = out.get("rewards", np.zeros(1))
        acc = float((rewards > 0).mean())
        st = IterationStats(
            iteration=it, wall_time=wall,
            mean_reward=float(rewards.mean()), accuracy=acc,
            metrics=self.actor.metrics_history[-1]
            if self.actor.metrics_history else {})
        self.stats.append(st)
        reg = _metrics.active()
        if reg is not None and wall > 0:
            tok = self.rl.batch_size * (self.rl.prompt_len
                                        + self.rl.max_new_tokens)
            reg.gauge("grpo/tokens_per_s").set(tok / wall)
            reg.gauge("grpo/mean_reward").set(st.mean_reward)
        return st

    def log_iteration(self, st: IterationStats) -> None:
        print(f"iter {st.iteration:3d}  wall={st.wall_time:6.2f}s "
              f"reward={st.mean_reward:+6.2f} acc={st.accuracy:5.2f} "
              f"loss={st.metrics.get('loss', float('nan')):+.4f}")

    # ------------------------------------------------------------------
    # Bounded-staleness off-policy loop (async_depth = K >= 1)
    # ------------------------------------------------------------------
    def _run_async_horizon(self, verbose: bool) -> None:
        """Drive the whole horizon through the AsyncPipelineDriver:
        generation keeps producing rollouts under parameter version v while
        the trainer advances to v+1, …; the queue's staleness bound K and
        the per-token importance correction keep the update sound.

        Thread discipline: the trainer publishes a ``(version, params)``
        pair after each update, the params a snapshot (the trainer's own
        change in place); the producer thread is the ONLY writer of the
        rollout/inference workers' registered state, and the consumer
        re-scores stale samples with explicit params (no shared-state
        mutation) — so version tags always match the weights a rollout
        was actually generated with."""
        from repro_torch.core.pipeline import AsyncPipelineDriver
        from repro_torch.rl.advantage import staleness_importance_weights

        # the async plan's placement is binding too
        self.controller.bind_placement(self.plan, self.workers)

        # atomically-swapped (version, params) snapshot; version counts
        # completed trainer updates and always matches the params beside it
        self._published = (0, self.snapshot_params())
        t_prev = time.perf_counter()

        def sync(_gate_version: int) -> int:
            version, params = self._published
            # measured resharding sync; the paged engine applies it in
            # flight at its next step boundary and the version tag rides
            # along so per-request weight_versions match the queue tag
            self._sync_weights(params=params, version=version)
            return version  # tag = the version actually pulled

        def produce(i: int, version: int):
            # rollout -> behaviour logprobs -> reward, all at `version`
            batch = self.make_batch()
            chunk = self.task_fns["rollout"](self.rollout, batch)
            chunk = self.task_fns["inference"](self.inference, chunk)
            chunk = self.task_fns["reward"](self.reward, chunk)
            return chunk

        def consume(item):
            nonlocal t_prev
            chunk = item.data
            version = self._published[0]
            staleness = version - item.version
            if staleness > 0 and self.rl.staleness_correction:
                # Re-score the stale rollout at the CURRENT parameters
                # (explicit params: the shared inference worker's state
                # belongs to the producer thread) and damp each token so
                # the loss's behavior-referenced ratio becomes a
                # TRUNCATED importance weight.  The behavior term is
                # old_logprobs — the same prefill recompute the loss
                # references — so the damper cancels token-for-token.
                chunk = self.inference.compute_logprobs(
                    chunk, key="target_logprobs",
                    params=self._published[1])
                rho = staleness_importance_weights(
                    chunk["old_logprobs"], chunk["target_logprobs"],
                    chunk["loss_mask"], staleness=staleness,
                    clip_ratio=self.rl.staleness_clip)
                chunk["advantages"] = chunk["advantages"] * rho
            out = self.task_fns["actor"](self.actor, chunk)
            self._published = (version + 1, self.snapshot_params())
            now = time.perf_counter()
            st = self._record_stats(version, now - t_prev, out)
            t_prev = now
            if verbose:
                print(f"iter {st.iteration:3d}  wall={st.wall_time:6.2f}s "
                      f"stale={staleness} reward={st.mean_reward:+6.2f} "
                      f"acc={st.accuracy:5.2f}")
            return out

        driver = AsyncPipelineDriver(
            produce_fn=produce, consume_fn=consume, sync_fn=sync,
            staleness_bound=self.rl.async_depth,
            name=f"grpo-async-{id(self)}")
        self._driver = driver
        driver.run(self.rl.iterations)

    def snapshot_params(self) -> Any:
        """A copy of the actor's params as they are now: the next train
        step updates the live tensors in place."""
        with torch.no_grad():
            return pytree_map(lambda x: x.clone()
                              if isinstance(x, torch.Tensor) else x,
                              self.actor.params())

    def run_loop(self, verbose: bool = True) -> None:
        if self.rl.async_depth > 0:
            self._run_async_horizon(verbose)
            return
        super().run_loop(verbose)

    def throughput(self) -> float:
        """tokens/sec over the measured iterations (paper metric)."""
        if not self.stats:
            return 0.0
        tok = self.rl.batch_size * (self.rl.prompt_len + self.rl.max_new_tokens)
        return tok * len(self.stats) / sum(s.wall_time for s in self.stats)
