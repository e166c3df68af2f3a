"""RL component workers (paper Fig. 5a) built on the M2Flow Worker base.

Each worker owns its tensors (registered for onload/offload context
switching) and exposes chunk-level task methods the Execution Flow
Manager drives at any granularity — the SPMD-over-any-batch property
elastic pipelining relies on (§3.3).  Chunks travel between workers as
dicts of host numpy arrays; each worker moves what it needs onto its
device and hands numpy back.

Counterpart of the JAX package's ``rl/workers.py``: ``RolloutWorker``
(with the closed-loop ``act`` path of the embodied cycle),
``InferenceWorker``, ``ActorWorker``, ``RewardWorker`` and
``SimulatorWorker``.  The rollout generates on the paged engine, or on
the static ``Engine`` for an arch no paged layout covers.  The act path draws its noise from the
port's counter-based hash of (seed ^ 0x5EED, rollout round, cycle step,
env id) (:func:`~repro_torch.serve.sampling.act_noise`), where the JAX
worker folds a threefry key by the same tuple.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.worker import Worker
from repro_torch.device import DeviceLike
from repro_torch.models import init_model
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.rl.advantage import broadcast_to_tokens, grpo_advantages
from repro_torch.rl.env import EnvConfig, VecReachEnv
from repro_torch.rl.reward import math_reward
from repro_torch.serve import layouts as serve_layouts
from repro_torch.serve.engine import Engine, PagedEngine
from repro_torch.serve.sampling import act_noise
from repro_torch.train.optimizer import init_adamw
from repro_torch.train.trainer import (
    TrainHParams,
    make_prefill_step,
    make_train_step,
)

def rollout_seeds(seed: int) -> Iterator[int]:
    """Base seeds of a rollout worker's successive ``generate`` calls: a
    stream seeded once, one draw in [0, 2^31 - 1) a call.  Request ``i``
    of a call is seeded ``base + i`` by the engine."""
    rng = np.random.default_rng(seed)
    while True:
        yield int(rng.integers(0, 2**31 - 1))


class RolloutWorker(Worker):
    """Generation engine (the paper's SGLang/vLLM role).

    ``engine="paged"`` (what ``"auto"`` picks for every arch a cache
    layout covers: dense, MoE, SSM, hybrid) generates through the
    continuous-batching :class:`~repro_torch.serve.engine.PagedEngine`:
    requests join/leave the decode batch per step, the cache lives in
    the arch's layout (paged KV blocks or constant-size recurrent state),
    and trainer weight updates apply in flight with per-request version
    tags.  ``engine="static"`` keeps the fixed-shape
    :class:`~repro_torch.serve.engine.Engine`; an arch no layout covers
    (windowed dense attention, encoder-decoder, VLM) falls back to it
    under ``"auto"`` with a warning, an ``engine-fallback`` trace instant
    and a ``rollout/engine_fallback`` metric.

    Sampling seeds come from :attr:`seeds` (:func:`rollout_seeds` of
    ``seed + process_index``), one base seed a call; a caller may replace
    the stream (tests feed the JAX worker's base seeds).  The act path's
    noise comes from :attr:`act_noise_fn`, a callable of (rollout round,
    cycle step, env ids, V) returning (B, V) Gumbel draws; tests may
    replace it (with JAX's draws).
    """

    def __init__(self, name: str, *, cfg: ModelConfig,
                 max_new_tokens: int = 16, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0, devices: Sequence[int] = (),
                 process_index: int = 0, engine: str = "auto",
                 max_batch: int = 8, page_size: int = 16,
                 prefix_sharing: bool = True, prefill_chunk: int = 32,
                 action_range: Optional[tuple] = None,
                 act_latency: float = 0.0,
                 act_latency_per_env: float = 0.0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        # [lo, hi) vocab window of action tokens for the closed-loop
        # `act` path (embodied cycles); None for pure text workflows
        self.action_range = action_range
        # artificial act-path latency mimicking a VLA-scale policy
        # forward: flat per call + per env acted on
        self.act_latency = act_latency
        self.act_latency_per_env = act_latency_per_env
        if engine == "auto":
            if serve_layouts.covers(cfg):
                engine = "paged"
            else:
                engine = "static"
                # loud fallback: workloads missing the fast path must
                # show up in logs and flowtrace summaries, not vanish
                warnings.warn(
                    f"RolloutWorker {name!r}: no paged cache layout "
                    f"covers arch {cfg.name!r} (kind={cfg.kind}, "
                    f"sliding_window={cfg.sliding_window}); falling "
                    f"back to the static engine", stacklevel=2)
                tr = _trace.active()
                if tr is not None:
                    tr.instant("engine-fallback", "rollout",
                               worker=name, arch=cfg.name, kind=cfg.kind)
                    reg = _metrics.active()
                    if reg is not None:
                        reg.counter("rollout/engine_fallback").inc()
        assert engine in ("paged", "static"), engine
        self.engine_kind = engine
        if engine == "paged":
            # prefix sharing makes a GRPO group's common prompt prefill
            # once: generate() submits all group members to one engine,
            # the first admission indexes the prompt pages in the radix
            # cache and every sibling adopts them
            self.engine = PagedEngine(
                cfg, max_batch=max_batch, page_size=page_size,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, prefix_sharing=prefix_sharing,
                prefill_chunk=prefill_chunk, device=self.device)
        else:
            self.engine = Engine(cfg, max_new_tokens=max_new_tokens,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p, device=self.device)
        self.seeds: Iterator[int] = rollout_seeds(seed + process_index)
        # the act path's noise: a fixed base seed, hashed with the round,
        # the cycle step and the env id (never consumed sequentially), so
        # any chunking of the env batch draws identical actions
        self.act_noise_fn: Callable[..., torch.Tensor] = (
            lambda rnd, step, ids, V: act_noise(seed ^ 0x5EED, rnd, step,
                                                ids, V, self.device))
        self.register_state("params", None)

    def bind_devices(self, devices: Sequence[int]) -> None:
        """Plan-driven rebinding; the engine's cache lives on one card,
        so a slice that folds onto another card is refused (on one card
        every slice folds onto it)."""
        new = self.mesh_of(tuple(devices))
        if new and new[0] != self.engine.device:
            raise NotImplementedError(
                f"moving {self.name}'s {self.engine_kind} engine from "
                f"{self.engine.device} to {new[0]}: the port runs on one "
                "card (ROADMAP.md queue 1, item 12: multi-device)")
        super().bind_devices(devices)

    def offload(self, keys: Optional[Sequence[str]] = None):
        moved = super().offload(keys)
        if "params" in moved and isinstance(self.engine, PagedEngine):
            # the engine holds the applied weights too: drop them, or
            # the offload frees nothing on the card
            self.engine.release_params()
        return moved

    def release_state(self) -> None:
        """Drop the weights and the engines (their caches and their
        references to the weights) with the registered state."""
        super().release_state()
        if isinstance(self.engine, PagedEngine):
            self.engine.release_params()
        self.engine = None
        self.__dict__.pop("_static_act_engine", None)

    # weight sync (paper §2.1): trainer -> rollout.  On the paged engine
    # this is NOT a barrier — the update is enqueued and applied at the
    # next step boundary while requests stay in flight.
    def update_weights(self, params: Any,
                       version: Optional[int] = None) -> None:
        self.set_state("params", params)
        if isinstance(self.engine, PagedEngine):
            self.engine.update_weights(params, version)

    def generate(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        params = self.get_state("params")
        assert params is not None, "rollout weights not initialized"
        res = self.engine.generate(params, np.asarray(chunk["prompt_tokens"]),
                                   seed=next(self.seeds))
        out = dict(chunk)
        out["tokens"] = res.tokens.numpy()
        out["logprobs"] = res.logprobs.numpy()
        out["lengths"] = res.lengths.numpy()
        if res.weight_versions is not None:
            out["weight_versions"] = np.asarray(res.weight_versions)
        return out

    def request_records(self):
        """(tokens, service_time) per completed request since last call
        (paged engine only) — feeds the profiler's measured tail factor."""
        if isinstance(self.engine, PagedEngine):
            return self.engine.pop_request_records()
        return []

    # closed-loop action path (the embodied sim<->generation cycle):
    # one constrained sampling step per env step, through the engine
    def _act_engine(self) -> Engine:
        if isinstance(self.engine, Engine):
            return self.engine
        # the paged engine has no single-step act path; acting is a
        # prefill-only op, so a static engine (explicit params, no
        # duplicated state) covers it
        if not hasattr(self, "_static_act_engine"):
            self._static_act_engine = Engine(self.cfg, max_new_tokens=1,
                                             device=self.device)
        return self._static_act_engine

    def act(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Per-step action sampling for the cycle executor.  Consumes
        ``prompt_tokens`` (B, S) plus the executor-injected
        ``cycle_step`` / ``env_ids``; emits ``action_tokens``,
        ``action_logprobs`` and env-space ``actions``."""
        assert self.action_range is not None, \
            "RolloutWorker.act needs action_range=(lo, hi)"
        params = self.get_state("params")
        assert params is not None, "rollout weights not initialized"
        lo, hi = self.action_range
        prompts = np.asarray(chunk["prompt_tokens"])
        if self.act_latency or self.act_latency_per_env:
            time.sleep(self.act_latency
                       + self.act_latency_per_env * prompts.shape[0])
        ids = np.asarray(chunk.get("env_ids", np.arange(prompts.shape[0])))
        step = int(chunk.get("cycle_step", 0))
        # noise on (rollout_round, cycle_step, env_id): the round keeps
        # exploration noise FRESH across training iterations (cycle_step
        # restarts at 0 every rollout), while the per-env hash keeps
        # sampling invariant to how the env batch is chunked
        rnd = chunk.get("rollout_round", 0)
        rnd = int(np.asarray(rnd).reshape(-1)[0]) if np.ndim(rnd) else int(rnd)
        tok, lp = self._act_engine().act(
            params, prompts,
            lambda V: self.act_noise_fn(rnd, step, ids, V),
            action_lo=lo, action_hi=hi)
        out = dict(chunk)
        out["action_tokens"] = tok.cpu().numpy()
        out["action_logprobs"] = lp.cpu().numpy()
        out["actions"] = out["action_tokens"] - lo
        return out


class InferenceWorker(Worker):
    """Prefill-only logprob recompute (the paper's 'Inference' box)."""

    def __init__(self, name: str, *, cfg: ModelConfig,
                 devices: Sequence[int] = (), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        self._step = make_prefill_step(cfg)
        self.register_state("params", None)

    def update_weights(self, params: Any) -> None:
        self.set_state("params", params)

    def compute_logprobs(self, chunk: Dict[str, np.ndarray],
                         key: str = "old_logprobs",
                         params: Optional[Any] = None
                         ) -> Dict[str, np.ndarray]:
        """Prefill recompute.  ``key`` lets the async consumer re-score a
        stale rollout at the CURRENT parameter version (e.g. into
        ``'target_logprobs'``) without clobbering the behavior reference;
        explicit ``params`` scores with those weights WITHOUT touching the
        worker's registered state (the producer thread owns that state —
        see GRPORunner._run_async_horizon)."""
        if params is None:
            params = self.get_state("params")
        tokens = torch.tensor(np.asarray(chunk["tokens"]), dtype=torch.long,
                              device=self.device)
        out = dict(chunk)
        out[key] = self._step(params, {"tokens": tokens}).cpu().numpy()
        return out


class ActorWorker(Worker):
    """Trainable policy (actor) with AdamW state; GRPO/PPO loss.

    Its f32 params come from ``init_model`` with a generator seeded
    ``seed``, unless ``params`` hands them in (tests bridge the JAX
    actor's).  The train step updates params and moments in place."""

    def __init__(self, name: str, *, cfg: ModelConfig, hp: TrainHParams,
                 seed: int = 0, devices: Sequence[int] = (),
                 process_index: int = 0, device: DeviceLike = None,
                 params: Optional[Any] = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.cfg = cfg
        self.hp = hp
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_model(gen, cfg, torch.float32, self.device)
        self.register_state("params", params)
        self.register_state("opt", init_adamw(params))
        self._step = make_train_step(cfg, hp)
        self.metrics_history = []

    def params(self) -> Any:
        return self.get_state("params")

    def train(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        params = self.get_state("params")
        opt = self.get_state("opt")
        dev = self.device
        batch = {"tokens": torch.tensor(np.asarray(chunk["tokens"]),
                                        dtype=torch.long, device=dev)}
        # ref_logprobs (the PPO actor's KL anchor) when the chunk has them
        for k in ("old_logprobs", "advantages", "loss_mask", "ref_logprobs"):
            if k in chunk:
                batch[k] = torch.tensor(np.asarray(chunk[k]),
                                        dtype=torch.float32, device=dev)
        params, opt, metrics = self._step(params, opt, batch)
        self.set_state("params", params)
        self.set_state("opt", opt)
        m = {k: float(v) for k, v in metrics.items()}
        self.metrics_history.append(m)
        out = dict(chunk)
        out["metrics"] = m
        return out


class RewardWorker(Worker):
    """Rule-based reward + GRPO group advantage computation (host numpy;
    it owns no device state)."""

    def __init__(self, name: str, *, prompt_len: int, group_size: int = 1,
                 devices: Sequence[int] = (), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.prompt_len = prompt_len
        self.group_size = group_size

    def score(self, chunk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        toks = chunk["tokens"]
        rewards = math_reward(toks, chunk["answers"], self.prompt_len)
        B, S = toks.shape
        mask = np.zeros((B, S), np.float32)
        mask[:, self.prompt_len:] = (toks[:, self.prompt_len:] != 0)
        gs = min(self.group_size, B) if B % max(self.group_size, 1) == 0 else 1
        if gs == 1 and self.group_size > 1:
            warnings.warn(
                f"reward chunk of {B} rows is not a multiple of "
                f"group_size={self.group_size}; group-relative advantages "
                "degrade to 0 (no learning signal). Align the execution "
                "plan's chunk size (SchedulerConfig.chunk_multiple).",
                stacklevel=2)
        adv_seq = grpo_advantages(rewards, gs)
        out = dict(chunk)
        out["rewards"] = rewards
        out["loss_mask"] = mask
        out["advantages"] = broadcast_to_tokens(adv_seq, mask)
        return out


class SimulatorWorker(Worker):
    """Embodied simulator (CPU-bound, instance-replicated — Fig. 3): host
    numpy, no device state."""

    def __init__(self, name: str, *, env_cfg: EnvConfig, seed: int = 0,
                 devices: Sequence[int] = (), process_index: int = 0,
                 device: DeviceLike = None):
        super().__init__(name, devices=devices, process_index=process_index,
                         device=device)
        self.env = VecReachEnv(env_cfg, seed=seed + process_index)
        self.env_cfg = env_cfg

    def step_env(self, chunk: Dict[str, Any]) -> Dict[str, Any]:
        """Closed-loop per-step task for the cycle executor.

        Without ``actions`` in the chunk this is the loop's PRIME call:
        it returns the current observation only.  With ``actions``
        (B,) it steps the env subset named by ``env_ids`` (or all envs),
        returning the post-reset obs the next action must be computed
        from, the step's reward, and the terminated/truncated split plus
        ``terminal_obs`` that correct GAE bootstrapping needs."""
        out = dict(chunk)
        ids = chunk.get("env_ids")
        ids = np.asarray(ids) if ids is not None else None
        if "actions" not in chunk:
            out["obs"] = self.env.observe(ids)
            return out
        obs, rew, done, info = self.env.step(
            np.asarray(chunk["actions"]), ids)
        out["obs"] = obs
        out["rewards"] = rew
        out["dones"] = done
        out["terminated"] = info["terminated"].astype(np.float32)
        out["truncated"] = info["truncated"].astype(np.float32)
        out["terminal_obs"] = info["terminal_obs"]
        out["successes"] = int(info["success"].sum())
        return out

    def observe(self, _chunk: Optional[Dict] = None) -> Dict[str, Any]:
        return {"obs": self.env.observe()}
