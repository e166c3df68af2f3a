"""Embodied PPO workflow on the M2Flow runtime (paper Fig. 1 bottom-left,
Fig. 9): the third workflow family bound to the shared WorkflowRunner.

The simulator↔policy loop is a CYCLE in the workflow graph.  The
scheduler collapses it into one node (Algorithm 1 line 2), chooses a
realization — **collocated** (members alternate per step on shared
devices) or **hybrid** (members on disjoint device shares, fine-grained-
pipelined over env chunks with double-buffered obs/action queues) — and
records it on the plan's Leaf; the ExecutionFlowManager then runs the
cycle as a real closed loop (obs → action → sim → reward), per step,
through the member workers' ``act`` / ``step_env`` tasks.

The policy is a small decoder-only LM over discretized observations:
prompt = [BOS, obs-token ×4] → one action token (9 discrete actions),
sampled with per-(round, step, env) noise so both realizations draw
identical actions.  Advantages are whitened critic-free GAE with the
terminated/truncated split (timeouts bootstrap, goals do not).

Counterpart of the JAX package's ``rl/embodied_workflow.py``.  Every
worker runs on one device (the card unless ``device="cpu"``); the
simulator and the advantage node are host numpy.  The act path's noise
is the port's counter-based hash (``RolloutWorker.act_noise_fn``), not
threefry.  Checkpointing and resume raise (ROADMAP.md queue 1, item 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import Cluster, CycleSpec, FlowGraph, SchedulerConfig
from repro_torch.core.flowgraph import cycle_node_name
from repro_torch.core.profiler import CostModel, Profiler, measure_onoffload
from repro_torch.core.worker import Worker
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl.advantage import gae_advantages, whiten
from repro_torch.rl.env import NUM_ACTIONS, OBS_DIM, EnvConfig
from repro_torch.rl.runner import WorkflowRunner
from repro_torch.rl.workers import ActorWorker, RolloutWorker, SimulatorWorker
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainHParams

# token layout: PAD, BOS, 24 obs-bin tokens, 9 action tokens
PAD, BOS = 0, 1
OBS_BASE, OBS_BINS = 2, 6
ACT_BASE = OBS_BASE + OBS_BINS * OBS_DIM  # 26
VOCAB = ACT_BASE + NUM_ACTIONS  # 35
SEQ = 1 + OBS_DIM + 1  # BOS + obs + action


def obs_to_tokens(obs: np.ndarray) -> np.ndarray:
    """(N, 4) float obs -> (N, 5) int tokens [BOS, d0..d3]."""
    clipped = np.clip((obs + 1.5) / 3.0, 0.0, 0.999)
    bins = (clipped * OBS_BINS).astype(np.int32)
    toks = OBS_BASE + np.arange(OBS_DIM)[None, :] * OBS_BINS + bins
    return np.concatenate(
        [np.full((obs.shape[0], 1), BOS, np.int32), toks.astype(np.int32)],
        axis=1)


def default_policy_config() -> ModelConfig:
    return get_config("stablelm-12b").reduced().replace(
        name="stablelm-policy", vocab_size=VOCAB, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, max_seq_len=SEQ)


@dataclass
class EmbodiedPPOConfig:
    num_envs: int = 64
    horizon: int = 16       # cycle steps per iteration
    iterations: int = 60
    lr: float = 3e-3
    gamma: float = 0.95
    lam: float = 1.0
    # cycle realization: "auto" lets Algorithm 1 pick the cheaper of the
    # two costed realizations; "collocated"/"hybrid" force one (the
    # paper's Fig.-9 fixed baselines)
    mode: str = "auto"
    cycle_chunks: int = 2   # hybrid double-buffer chunk count
    seed: int = 0
    max_steps: int = 32     # env episode horizon (truncation point)
    # simulated sim/policy step costs (see EnvConfig / RolloutWorker):
    # flat-per-step = LIBERO-like CPU sim, per-env = ManiSkill-like
    step_latency: float = 0.0
    latency_per_env: float = 0.0
    act_latency: float = 0.0
    act_latency_per_env: float = 0.0
    profile_batches: tuple = (16, 64)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0


@dataclass
class EmbodiedIterStats:
    iteration: int
    wall_time: float
    success_rate: float     # successes per env over the horizon
    mean_reward: float
    metrics: Dict[str, float] = field(default_factory=dict)


def embodied_graph() -> FlowGraph:
    """The embodied workflow graph (module-level so tooling — flowlint,
    benchmarks — can build it without constructing a runner)."""
    g = FlowGraph()
    for w in ("simulator", "policy_gen", "advantage", "train"):
        g.add_worker(w)
    g.add_edge("simulator", "policy_gen")
    g.add_edge("policy_gen", "simulator")  # the cycle
    g.add_edge("policy_gen", "advantage")
    g.add_edge("advantage", "train")
    return g


def embodied_cycle_specs(horizon: int = 8,
                         chunks: int = 2) -> Dict[str, CycleSpec]:
    name = cycle_node_name(("policy_gen", "simulator"))
    return {name: CycleSpec(order=("policy_gen", "simulator"),
                            steps=horizon, prime="simulator",
                            chunks=chunks)}


class EmbodiedPPORunner(WorkflowRunner):
    """simulator↔policy cycle + advantage + train through the runtime.

    ``device``: where every worker runs (the card by default).
    ``params``: the policy's initial params, in place of ``init_model``
    with ``rl.seed`` (tests bridge the JAX runner's)."""

    weight_sync_workers = ("policy_gen",)
    versioned_sync_worker = None

    def __init__(self, rl: EmbodiedPPOConfig,
                 cfg: Optional[ModelConfig] = None,
                 hp: Optional[TrainHParams] = None,
                 cluster: Optional[Cluster] = None,
                 device: DeviceLike = None,
                 params: Optional[Any] = None, **kw):
        self.device = resolve_device(device)
        self._init_params = params
        self.rl = rl
        self._rollout_round = 0
        self.model_cfg = cfg or default_policy_config()
        self.hp = hp or TrainHParams(
            optimizer=AdamWConfig(lr=rl.lr, clip_norm=1.0),
            clip_eps_low=0.2, clip_eps_high=0.2)
        super().__init__(iterations=rl.iterations, batch_size=rl.num_envs,
                         mode="auto",  # the cycle realization is forced
                                       # via SchedulerConfig.cycle_mode
                         profile_batches=rl.profile_batches,
                         cluster=cluster,
                         checkpoint_dir=rl.checkpoint_dir,
                         checkpoint_every=rl.checkpoint_every, **kw)

    def reset_stream(self) -> None:
        # recovery determinism: the rollout-round counter seeds each
        # round's randomness; a rebuilt run restarts it like a fresh
        # runner (resume_trainer_checkpoint then advances it to `start`)
        self._rollout_round = 0

    # ------------------------------------------------------------------
    # declarative surface
    # ------------------------------------------------------------------
    def build_workers(self) -> Dict[str, Any]:
        rl, dev = self.rl, self.device
        env_cfg = EnvConfig(num_envs=rl.num_envs, max_steps=rl.max_steps,
                            step_latency=rl.step_latency,
                            latency_per_env=rl.latency_per_env)
        self.actor = ActorWorker(
            "train/0", cfg=self.model_cfg, hp=self.hp, seed=rl.seed,
            devices=self.cluster.allocate("train", 4), device=dev,
            params=self._init_params)
        # the actor owns them now: a reference kept here would stop its
        # offload from freeing the card
        self._init_params = None
        self.policy = RolloutWorker(
            "policy_gen/0", cfg=self.model_cfg, max_new_tokens=1,
            engine="static", seed=rl.seed,
            action_range=(ACT_BASE, ACT_BASE + NUM_ACTIONS),
            act_latency=rl.act_latency,
            act_latency_per_env=rl.act_latency_per_env,
            devices=self.cluster.allocate("policy_gen", 2), device=dev)
        self.simulator = SimulatorWorker(
            "simulator/0", env_cfg=env_cfg, seed=rl.seed,
            devices=self.cluster.allocate("simulator", 1), device=dev)
        self.advantage = EmbodiedAdvantageWorker(
            "advantage/0", gamma=rl.gamma, lam=rl.lam, device=dev)
        return {"simulator": self.simulator, "policy_gen": self.policy,
                "advantage": self.advantage, "train": self.actor}

    def _policy_task(self, w: RolloutWorker, chunk: Dict) -> Dict:
        chunk = dict(chunk)
        chunk["prompt_tokens"] = obs_to_tokens(np.asarray(chunk["obs"]))
        return w.act(chunk)

    def build_task_fns(self) -> Dict[str, Any]:
        return {
            "simulator": lambda w, c: w.step_env(c),
            "policy_gen": self._policy_task,
            "advantage": lambda w, c: w.compute(c),
            "train": lambda w, c: w.train(c),
        }

    def build_graph(self) -> FlowGraph:
        return embodied_graph()

    def cycle_specs(self) -> Dict[str, CycleSpec]:
        return embodied_cycle_specs(horizon=self.rl.horizon,
                                    chunks=self.rl.cycle_chunks)

    def resume_trainer_checkpoint(self) -> int:
        start = super().resume_trainer_checkpoint()
        # keep the act-path RNG stream aligned with the resumed
        # iteration — rounds already consumed before the interruption
        # must not be replayed
        self._rollout_round = max(self._rollout_round, start)
        return start

    def make_batch(self) -> Dict[str, np.ndarray]:
        # rollout_round feeds the act path's noise so each iteration draws
        # fresh exploration noise; carried as a per-env column so the
        # executor's env-axis chunking slices it like any other key
        batch = {"env_ids": np.arange(self.rl.num_envs, dtype=np.int64),
                 "rollout_round": np.full(self.rl.num_envs,
                                          self._rollout_round, np.int64)}
        self._rollout_round += 1
        return batch

    def scheduler_config(self) -> SchedulerConfig:
        rl = self.rl
        return SchedulerConfig(
            total_batch=rl.num_envs,
            # whitening + GAE are batch-global: never pipeline the outer
            # graph below the full env batch
            granularity_divisors=(1,),
            chunk_multiple=rl.num_envs,
            device_quantum=2,
            cycle_mode=None if rl.mode == "auto" else rl.mode,
            cycle_chunks=rl.cycle_chunks)

    # ------------------------------------------------------------------
    # profiling: the base chained-topo profile cannot run a cyclic
    # graph, so measure each member's per-STEP cost directly and scale
    # the cycle members' fits by the horizon (a cycle leaf's cost covers
    # the whole closed loop)
    # ------------------------------------------------------------------
    def profile(self) -> FlowGraph:
        self._sync_weights()
        prof = Profiler(warmup=1, repeats=1)
        sizes = self._profile_sizes()
        T = self.rl.horizon
        sim_w, pol_w = self.simulator, self.policy
        adv_w, train_w = self.advantage, self.actor

        def sim_at(b):
            return self.task_fns["simulator"](sim_w, {
                "env_ids": np.arange(b),
                "actions": np.zeros(b, np.int64), "cycle_step": 0})

        def pol_at(b):
            ids = np.arange(b)
            return self._policy_task(pol_w, {
                "obs": sim_w.env.observe(ids), "env_ids": ids,
                "cycle_step": 0})

        def adv_at(b):
            return self.task_fns["advantage"](adv_w, self._fake_traj(b))

        # build the train input OUTSIDE the timed callable: adv_at's GAE
        # + batch assembly is already measured as the advantage node and
        # must not be double-counted into the train fit
        train_inputs: Dict[int, Dict] = {}

        def train_at(b):
            if b not in train_inputs:
                train_inputs[b] = adv_at(b)
            return self.task_fns["train"](train_w, dict(train_inputs[b]))

        profiles: Dict[str, CostModel] = {}
        for name, w, fn in (("simulator", sim_w, sim_at),
                            ("policy_gen", pol_w, pol_at),
                            ("advantage", adv_w, adv_at),
                            ("train", train_w, train_at)):
            cm = prof.measure(name, fn, sizes)
            if name in ("simulator", "policy_gen"):
                cm.base_time *= T
                cm.slope_time *= T
            if hasattr(w, "_state") and w.state_bytes():
                cm.onload_time, cm.offload_time = measure_onoffload(w)
            cm.base_mem = float(w.state_bytes())
            profiles[name] = cm
        # the sim is instance-bound: extra devices do not speed a step
        profiles["simulator"].scalable = False
        profiles["simulator"].max_useful_devices = 1
        # profiling stepped some envs mid-episode; start training clean
        sim_w.env.reset()
        self.controller.profiles = profiles
        return self.graph()

    def _fake_traj(self, b: int) -> Dict[str, np.ndarray]:
        T = self.rl.horizon
        return {"rewards": np.zeros((T, b), np.float32),
                "terminated": np.zeros((T, b), np.float32),
                "truncated": np.zeros((T, b), np.float32),
                "prompt_tokens": np.ones((T, b, SEQ - 1), np.int32),
                "action_tokens": np.full((T, b), ACT_BASE, np.int32),
                "action_logprobs": np.zeros((T, b), np.float32),
                "successes": 0}

    # ------------------------------------------------------------------
    def _record_stats(self, it: int, wall: float, out) -> EmbodiedIterStats:
        rews = np.asarray(out.get("rewards", np.zeros((1, 1))))
        st = EmbodiedIterStats(
            iteration=it, wall_time=wall,
            success_rate=float(out.get("successes", 0)) / self.rl.num_envs,
            mean_reward=float(rews.sum(0).mean()),
            metrics=self.actor.metrics_history[-1]
            if self.actor.metrics_history else {})
        self.stats.append(st)
        return st

    def log_iteration(self, st: EmbodiedIterStats) -> None:
        if st.iteration % 5 == 0 or st.iteration == self.iterations - 1:
            recent = [s.success_rate for s in self.stats[-10:]]
            print(f"iter {st.iteration:3d} wall={st.wall_time:5.2f}s "
                  f"success/env={st.success_rate:5.2f} "
                  f"avg10={sum(recent) / len(recent):5.2f} "
                  f"reward={st.mean_reward:+6.2f}")

    def success_curve(self) -> List[float]:
        return [s.success_rate for s in self.stats]


class EmbodiedAdvantageWorker(Worker):
    """Whitened critic-free GAE + train-batch assembly as a schedulable
    node (host numpy).  Bootstraps THROUGH truncation (timeout is not a
    terminal state) and resets credit at both kinds of episode end."""

    def __init__(self, name: str, *, gamma: float = 0.95, lam: float = 1.0,
                 devices=(), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.gamma = gamma
        self.lam = lam

    def compute(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        rews = np.asarray(chunk["rewards"], np.float32)        # (T, N)
        term = np.asarray(chunk["terminated"], np.float32)
        trunc = np.asarray(chunk["truncated"], np.float32)
        T, N = rews.shape
        values = np.zeros((T + 1, N), np.float32)  # critic-free PPO
        adv, _ = gae_advantages(rews, values, gamma=self.gamma,
                                lam=self.lam, terminated=term,
                                truncated=trunc)
        adv = whiten(adv)
        prompts = np.asarray(chunk["prompt_tokens"])           # (T, N, S-1)
        acts = np.asarray(chunk["action_tokens"])              # (T, N)
        S = prompts.shape[-1] + 1
        B = T * N
        toks = np.concatenate([prompts, acts[..., None]],
                              axis=-1).reshape(B, S).astype(np.int32)
        old_lp = np.zeros((B, S), np.float32)
        old_lp[:, S - 1] = np.asarray(chunk["action_logprobs"]).reshape(B)
        advantages = np.zeros((B, S), np.float32)
        advantages[:, S - 1] = adv.reshape(B)
        mask = np.zeros((B, S), np.float32)
        mask[:, S - 1] = 1.0
        out = dict(chunk)
        out["tokens"] = toks
        out["old_logprobs"] = old_lp
        out["advantages"] = advantages
        out["loss_mask"] = mask
        return out
